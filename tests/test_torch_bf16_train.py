"""Training with bfloat16 activations in the port, on the CPU: the trainer
hands its fused step bf16 reals and z and keeps every parameter, Adam's
state and the EMA shadow in float32 (the feedback samples and the
checkpoints too); one bf16 step against the JAX package's bf16 step on the
same weights and pinned draws; `resolve_packed` / `resolve_fuse_scores`
against the JAX package's; and `python -m stylegan_torch.cli.train` on a
tiny bf16 yaml.

The bf16 step's bars.  Losses: within 5e-2 of JAX's, relative to max(1,
|loss|) (bf16 keeps 8 significant bits, so the two sides' sums over the
networks differ in the third digit).  Gradients (Adam's first moments, b1 =
0): each tensor's relative L2 error from the float64 step (the port's,
which tests/test_torch_train_steps.py holds to JAX's at 1e-8) within 3x
JAX's bf16 error on that tensor, plus 1e-3: both sides round activations to
bf16, at places that differ (XLA fuses elementwise chains and rounds once
per fusion, PyTorch once per op)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from stylegan_tpu import config as jconfig
from stylegan_tpu.io.checkpoint import unflatten_like
from stylegan_tpu.models import configs as jcfg
from stylegan_tpu.models import discriminator_init, generator_init
from stylegan_tpu.train import state as jstate
from stylegan_tpu.train import steps as jsteps
from stylegan_torch import config as tconfig
from stylegan_torch.convert import (discriminator_state_dict_from_jax_params,
                                    flatten_params,
                                    generator_state_dict_from_jax_params)
from stylegan_torch.models import Discriminator, Generator
from stylegan_torch.models import configs as tcfg
from stylegan_torch.ops.precision import get_precision, set_precision
from stylegan_torch.train import (StyleGAN, build_train_step,
                                  create_train_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, DEPTH, BATCH, LATENT, ALPHA = 8, 1, 4, 32, 0.5
N_LAYERS = 4
LOSS_RTOL, GRAD_FACTOR, GRAD_FLOOR = 5e-2, 3.0, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _keep_precision():
    p = get_precision()
    yield
    set_precision(p)


# ----------------------------------------------------------------- trainer --

TRAINER_RES = 16


def _trainer(**kw):
    g_args = {"latent_size": 64, "mapping_layers": 2,
              "blur_filter": [1, 2, 1], "truncation_psi": 0.7,
              "truncation_cutoff": 8}
    opt = {"learning_rate": 0.003, "beta_1": 0.0, "beta_2": 0.99, "eps": 1e-8}
    return StyleGAN(structure="linear", resolution=TRAINER_RES,
                    num_channels=3, latent_size=64, g_args=g_args,
                    d_args={"use_wscale": True, "blur_filter": [1, 2, 1]},
                    g_opt_args=opt, d_opt_args=opt, use_ema=True, seed=0,
                    device="cpu", **kw)


def _record_step_inputs(trainer):
    """Wrap the trainer's steps to record the dtypes of what they are
    handed, and of G's images and D's scores inside them."""
    seen = []
    real = trainer._get_step

    def get_step(depth, with_r1=True, mesh=None):
        step = real(depth, with_r1, mesh)

        def wrapped(state, reals, z, *args, **kwargs):
            hooks = [state.generator.register_forward_hook(
                lambda m, i, o: seen.append(("images", o.images.dtype))),
                state.discriminator.register_forward_hook(
                lambda m, i, o: seen.append(("scores", o.dtype)))]
            seen.append(("reals", reals.dtype))
            seen.append(("z", z.dtype))
            try:
                return step(state, reals, z, *args, **kwargs)
            finally:
                for h in hooks:
                    h.remove()
        return wrapped
    trainer._get_step = get_step
    return seen


@pytest.mark.parametrize("loss,kw", [
    ("logistic", {"r1_interval": 2, "fuse_scores": True}),
    ("relativistic-hinge", {})], ids=["logistic-lazy-r1", "rel-hinge"])
def test_bf16_trainer_steps_in_bf16_with_float32_state(loss, kw):
    """activations_dtype='bfloat16': the step gets bf16 reals and z, G and
    D compute in bf16, the losses come back finite, and the parameters,
    Adam's moments and the shadow stay float32 (as tests/test_trainer.py
    holds the JAX trainer)."""
    t = _trainer(loss=loss, activations_dtype="bfloat16", **kw)
    seen = _record_step_inputs(t)
    imgs = np.random.RandomState(3).randn(4, TRAINER_RES, TRAINER_RES, 3) \
        .astype(np.float32)
    for _ in range(3):
        d, g = t.train_on_batch(imgs, depth=2, alpha=0.5)
        assert np.isfinite(d) and np.isfinite(g)
    assert {dt for _, dt in seen} == {torch.bfloat16}
    assert {what for what, _ in seen} == {"reals", "z", "images", "scores"}
    s = t.state
    for module in (s.generator, s.discriminator, s.g_shadow):
        assert {p.dtype for p in module.parameters()} == {torch.float32}
    assert s.generator.truncation.avg_latent.dtype == torch.float32
    for opt in (s.g_optimizer, s.d_optimizer):
        assert {v.dtype for st in opt.state.values() for v in st.values()
                if v.is_floating_point()} == {torch.float32}


def test_bf16_trainer_float32_stays_float32():
    """The default trainer hands its step float32 (the f32 parity path is
    unchanged)."""
    t = _trainer(loss="logistic")
    seen = _record_step_inputs(t)
    imgs = np.zeros((4, TRAINER_RES, TRAINER_RES, 3), np.float32)
    t.train_on_batch(imgs, depth=1, alpha=1.0)
    assert {dt for _, dt in seen} == {torch.float32}


def test_bf16_trainer_samples_and_checkpoints_in_float32(tmp_path):
    """The feedback samples run on float32 latents, as the JAX trainer's;
    the checkpoint files hold float32 parameters."""
    t = _trainer(loss="logistic", activations_dtype="bfloat16")
    imgs = np.random.RandomState(4).randn(4, TRAINER_RES, TRAINER_RES, 3) \
        .astype(np.float32)
    t.train_on_batch(imgs, depth=2, alpha=1.0)
    out = t.sample(2, 1.0, num_samples=2)
    assert out.dtype == np.float32 and np.isfinite(out).all()
    try:
        t.save_checkpoints(str(tmp_path), 2, 1)
        for kind in ("GEN", "DIS", "GEN_SHADOW", "GEN_OPTIM", "DIS_OPTIM"):
            with np.load(tmp_path / "models" / f"GAN_{kind}_2_1.npz") as z:
                assert {z[k].dtype for k in z.files
                        if z[k].dtype.kind == "f"} == {np.dtype("float32")}
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


# ------------------------------------------------------- the step vs JAX --

def _configs():
    def build(m):
        g = m.GeneratorConfig(
            resolution=RES, latent_size=LATENT, dlatent_size=LATENT,
            truncation_psi=0.7, style_mixing_prob=0.0,
            mapping=m.MappingConfig(latent_size=LATENT, dlatent_size=LATENT,
                                    mapping_fmaps=LATENT, mapping_layers=2,
                                    dlatent_broadcast=N_LAYERS),
            synthesis=m.SynthesisConfig(resolution=RES, dlatent_size=LATENT,
                                        fmap_base=128, fmap_max=32,
                                        blur_filter=(1, 2, 1)))
        d = m.DiscriminatorConfig(resolution=RES, fmap_base=128, fmap_max=32,
                                  blur_filter=(1, 2, 1))
        return g, d
    return build(jcfg), build(tcfg)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("loss", ["logistic", "relativistic-hinge"])
def test_bf16_step_matches_jax_bf16_step(monkeypatch, loss):
    """One step in bf16 on both sides (float32 parameters; reals, z and the
    pinned noise maps bf16), and the port's step in float64 as the truth:
    the bars of the module docstring; every port parameter float32."""
    (jg, jd), (tg, td) = _configs()
    flat = flatten_params(_np(generator_init(jax.random.PRNGKey(0), jg)))
    rs = np.random.RandomState(1)
    for k, v in flat.items():     # the noise term and the W-average matter
        if k.endswith(("noise.weight", "avg_latent", "init_block.const",
                       "init_block.bias")):
            flat[k] = (0.3 * rs.randn(*v.shape)).astype(np.float32)
    d_flat = flatten_params(_np(discriminator_init(jax.random.PRNGKey(1),
                                                   jd)))
    noises = [rs.randn(BATCH, 2 ** (i // 2 + 2), 2 ** (i // 2 + 2), 1)
              .astype(np.float32) for i in range(N_LAYERS)]
    reals = rs.randn(BATCH, RES, RES, 3).astype(np.float32)
    z = rs.randn(BATCH, LATENT).astype(np.float32)

    g_tx, d_tx = jstate.make_g_optimizer(), jstate.make_d_optimizer()
    jst = jstate.create_train_state(
        unflatten_like(generator_init(jax.random.PRNGKey(0), jg), flat,
                       partial=False),
        unflatten_like(discriminator_init(jax.random.PRNGKey(1), jd), d_flat,
                       partial=False), g_tx, d_tx, use_ema=True)
    apply = jsteps.generator_apply

    def pinned(*args, **kwargs):
        kwargs["noises"] = [jnp.asarray(n, jnp.bfloat16) for n in noises]
        return apply(*args, **kwargs)
    monkeypatch.setattr(jsteps, "generator_apply", pinned)
    jstep = jsteps.build_train_step(jg, jd, g_tx, d_tx, donate=False,
                                    depth=DEPTH, loss=loss)
    jst, jm = jstep(jst, jnp.asarray(reals, jnp.bfloat16),
                    jnp.asarray(z, jnp.bfloat16), jax.random.PRNGKey(5),
                    jnp.float32(ALPHA))
    def adam_mu(opt_state):
        is_adam = lambda s: isinstance(s, optax.ScaleByAdamState)  # noqa
        adam, = [s for s in jax.tree_util.tree_leaves(opt_state,
                                                      is_leaf=is_adam)
                 if is_adam(s)]
        return _np(adam.mu)
    jax_mu = {**{f"G {k}": v.numpy() for k, v in
                 generator_state_dict_from_jax_params(
                     adam_mu(jst.g_opt_state)).items()},
              **{f"D {k}": v.numpy() for k, v in
                 discriminator_state_dict_from_jax_params(
                     adam_mu(jst.d_opt_state)).items()}}

    runs = {}
    for dtype, params in ((torch.bfloat16, torch.float32),
                          (torch.float64, torch.float64)):
        gen, dis = Generator(tg).to(params), Discriminator(td).to(params)
        gen.load_state_dict(generator_state_dict_from_jax_params(flat),
                            strict=True)
        dis.load_state_dict(discriminator_state_dict_from_jax_params(d_flat),
                            strict=True)
        state = create_train_state(gen, dis)
        step = build_train_step(tg, td, depth=DEPTH, loss=loss)
        _, m = step(state, torch.from_numpy(reals).to(dtype),
                    torch.from_numpy(z).to(dtype), 5,
                    torch.tensor(ALPHA, dtype=params),
                    noises=[torch.from_numpy(n).to(dtype) for n in noises])
        mu = {}
        for label, module, opt in (("G", gen, state.g_optimizer),
                                   ("D", dis, state.d_optimizer)):
            for name, p in module.named_parameters():
                mu[f"{label} {name}"] = opt.state[p]["exp_avg"] \
                    .double().numpy()
        runs[dtype] = (m, mu, state)

    (m16, mu16, st16), (_, mu64, _) = runs[torch.bfloat16], runs[
        torch.float64]
    for k in ("d_loss", "g_loss"):
        assert m16[k].dtype == torch.float32
        a, b = m16[k].item(), float(jm[k])
        assert abs(a - b) <= LOSS_RTOL * max(1.0, abs(b)), (k, a, b)
    for name, truth in mu64.items():
        norm = np.linalg.norm(truth)
        if norm == 0.0:        # no gradient flows there: both exactly 0
            assert not np.any(mu16[name]) and not np.any(jax_mu[name])
            continue
        port = np.linalg.norm(mu16[name] - truth) / norm
        ref = np.linalg.norm(jax_mu[name] - truth) / norm
        assert port <= GRAD_FACTOR * ref + GRAD_FLOOR, (name, port, ref)
    for module in (st16.generator, st16.discriminator, st16.g_shadow):
        assert {p.dtype for p in module.parameters()} == {torch.float32}


# ----------------------------------------------------------- config, CLI --

KNOBS = [(a, p, f) for a in ("float32", "bfloat16")
         for p in ("auto", True, False) for f in ("auto", True, False)]


@pytest.mark.parametrize("activations,packed,fuse", KNOBS,
                         ids=[f"{a}-packed_{p}-fuse_{f}" for a, p, f in KNOBS])
def test_resolvers_equal_jax(activations, packed, fuse):
    cfgs = []
    for mod in (jconfig, tconfig):
        cfg = mod.get_default_cfg()
        cfg.precision.activations = activations
        cfg.ops.packed = packed
        cfg.ops.fuse_scores = fuse
        cfgs.append(cfg)
    jc, tc = cfgs
    assert tconfig.resolve_packed(tc) == jconfig.resolve_packed(jc)
    assert tconfig.resolve_fuse_scores(tc) == jconfig.resolve_fuse_scores(jc)
    tconfig.apply_runtime_knobs(tc)
    assert get_precision() == ("default" if activations == "bfloat16"
                               else "highest")
    assert torch.backends.cudnn.allow_tf32 == (activations == "bfloat16")


def test_train_cli_bf16_on_cpu(tmp_path):
    """`python -m stylegan_torch.cli.train` on a tiny bf16 yaml (the perf
    yaml's knobs: bf16, packed auto, lazy R1 at 2, remat): it trains every
    depth, says what it computes, and writes float32 checkpoints."""
    from PIL import Image
    data_dir, out_dir = tmp_path / "data", tmp_path / "out_bf16"
    os.makedirs(data_dir)
    rs = np.random.RandomState(2)
    for i in range(8):
        Image.fromarray(rs.randint(0, 255, (16, 16, 3), dtype=np.uint8)) \
            .save(data_dir / f"{i}.png")
    cfg = tmp_path / "toy_bf16.yaml"
    cfg.write_text(f"""
output_dir: '{out_dir}'
structure: 'linear'
feedback_factor: 1
checkpoint_factor: 1
num_works: 1
num_samples: 4
loss: 'logistic'
r1_interval: 2
precision:
  activations: 'bfloat16'
ops:
  packed: 'auto'
  remat: True
model:
  gen: {{latent_size: 32, mapping_layers: 2}}
dataset:
  img_dir: '{data_dir}'
  folder: False
  resolution: 8
sched:
  epochs: [1, 1]
  batch_sizes: [4, 4]
  fade_in_percentage: [50, 50]
""")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    try:
        r = subprocess.run([sys.executable, "-m", "stylegan_torch.cli.train",
                            "--config", str(cfg), "--device", "cpu"],
                           cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
        log = (out_dir / "log.txt").read_text()
        assert "bf16 activations" in log and "scoring on" in log
        rows = (out_dir / "metrics.jsonl").read_text().splitlines()
        assert rows
        models = sorted(os.listdir(out_dir / "models"))
        assert "GAN_GEN_1_1.npz" in models and "GAN_GEN_SHADOW_1_1.npz" \
            in models
        with np.load(out_dir / "models" / "GAN_GEN_1_1.npz") as z:
            assert {z[k].dtype for k in z.files if z[k].dtype.kind == "f"} \
                == {np.dtype("float32")}
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
