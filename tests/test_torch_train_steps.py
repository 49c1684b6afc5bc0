"""The port's fused train step (stylegan_torch/train/steps.py, state.py)
against the JAX package's build_train_step on the CPU: the same weights
(JAX init, converted through the bridge), the same numpy reals and latents,
and the same draws.  The JAX side's draws are pinned here, in the test
only: its `generator_apply` is wrapped to pass fixed noise maps (the port
takes the same maps through `noises=`), style mixing is off
(style_mixing_prob 0), and wgan-gp's interpolation eps is the one JAX draws
from its key, handed to the port.  The JAX package is not changed.

Compared after each of two steps: the losses, every parameter of G, D and
G's EMA shadow, G's W-average and the Adam moments, at atol = rtol = 1e-8.
The steps run in float64 on both sides, because they check the algorithm:
with Adam's b1 = 0 the first step moves each weight by lr * g / (|g| + eps),
about lr (0.003) times the sign of its gradient whatever the gradient's
size, and eps = 1e-8 lies below float32's rounding of a gradient (about
1e-7 of its tensor's scale), so in float32 a weight whose gradient is 0 up
to rounding moves by up to lr either way, differently on the two sides.  In
float64 that rounding (about 1e-16) lies far below eps.  The float32 path is
held by the op-level tests and, on the card, by chip_smoke.py.

Configuration: 8^2 (depths 0-1; depth 1, alpha 0.5, so that both fade
branches of G and D run), fmap_base 128, fmap_max 32, latent 32, 2 mapping
layers, truncation 0.7, batch 4."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from stylegan_tpu.io.checkpoint import unflatten_like
from stylegan_tpu.models import configs as jcfg
from stylegan_tpu.models import discriminator_init, generator_init
from stylegan_tpu.train import state as jstate
from stylegan_tpu.train import steps as jsteps
from stylegan_torch.convert import (discriminator_state_dict_from_jax_params,
                                    flatten_params,
                                    generator_state_dict_from_jax_params)
from stylegan_torch.models import Discriminator, Generator
from stylegan_torch.models import configs as tcfg
from stylegan_torch.train import (build_d_step, build_g_step,
                                  build_sample_fn, build_train_step,
                                  create_train_state,
                                  lazy_reg_adam_correction,
                                  progressive_downsample)

RES, DEPTH, BATCH, LATENT, ALPHA = 8, 1, 4, 32, 0.5
N_LAYERS = 4
TOL = dict(atol=1e-8, rtol=1e-8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many tiny ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(truncation_psi=0.7):
    def build(m):
        g = m.GeneratorConfig(
            resolution=RES, latent_size=LATENT, dlatent_size=LATENT,
            truncation_psi=truncation_psi, style_mixing_prob=0.0,
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


def _noises():
    rs = np.random.RandomState(21)
    return [rs.randn(BATCH, 2 ** (i // 2 + 2), 2 ** (i // 2 + 2), 1)
            for i in range(N_LAYERS)]


def _batch(step):
    rs = np.random.RandomState(100 + step)
    return rs.randn(BATCH, RES, RES, 3), rs.randn(BATCH, LATENT)


class Pair:
    """The same model on both sides, in float64: JAX params, optax state and
    step (every JAX call inside jax.enable_x64); the port's modules,
    TrainState and step."""

    def __init__(self, monkeypatch, step_kw=None, d_opt_args=None,
                 truncation_psi=0.7):
        (jg, jd), (tg, td) = _configs(truncation_psi)
        # noise weights and the W-average non-zero, so that both matter;
        # the init block's const and bias random, so that the bias's
        # gradient is not 0 (at init the lrelu is linear on each channel
        # and the instance norm cancels the bias)
        flat = flatten_params(_np(generator_init(jax.random.PRNGKey(0), jg)))
        rs = np.random.RandomState(1)
        for k, v in flat.items():
            flat[k] = (0.3 * rs.randn(*v.shape) if k.endswith((
                "noise.weight", "avg_latent", "init_block.const",
                "init_block.bias")) else v).astype(np.float64)
        d_flat = {k: v.astype(np.float64) for k, v in flatten_params(_np(
            discriminator_init(jax.random.PRNGKey(1), jd))).items()}
        self.noises = _noises()
        kw = dict(depth=DEPTH, **(step_kw or {}))
        with jax.enable_x64(True):
            g_params = unflatten_like(
                generator_init(jax.random.PRNGKey(0), jg, jnp.float64), flat,
                partial=False)
            d_params = unflatten_like(
                discriminator_init(jax.random.PRNGKey(1), jd, jnp.float64),
                d_flat, partial=False)
            g_tx = jstate.make_g_optimizer()
            d_tx = jstate.make_d_optimizer(**(d_opt_args or {}))
            self.jstate = jstate.create_train_state(g_params, d_params, g_tx,
                                                    d_tx, use_ema=True)
            noises = [jnp.asarray(n) for n in self.noises]
        apply = jsteps.generator_apply

        def pinned(*args, **kwargs):
            kwargs["noises"] = noises
            return apply(*args, **kwargs)
        monkeypatch.setattr(jsteps, "generator_apply", pinned)
        self.jstep = jsteps.build_train_step(jg, jd, g_tx, d_tx,
                                             donate=False, **kw)
        gen, dis = Generator(tg).double(), Discriminator(td).double()
        gen.load_state_dict(generator_state_dict_from_jax_params(flat),
                            strict=True)
        dis.load_state_dict(discriminator_state_dict_from_jax_params(d_flat),
                            strict=True)
        self.state = create_train_state(gen, dis, d_opt_args=d_opt_args)
        self.tstep = build_train_step(tg, td, **kw)
        self.loss = kw.get("loss", "relativistic-hinge")
        self.d_repeats = kw.get("d_repeats", 1)

    def step(self, i, seed_key):
        reals, z = _batch(i)
        key = jax.random.PRNGKey(seed_key)
        with jax.enable_x64(True):
            self.jstate, jm = self.jstep(self.jstate, jnp.asarray(reals),
                                         jnp.asarray(z), key,
                                         jnp.float64(ALPHA))
            gp_eps = None
            if self.loss == "wgan-gp":   # the eps each JAX repeat draws
                gp_eps = [torch.from_numpy(np.array(jax.random.uniform(
                    jax.random.fold_in(jax.random.fold_in(key, rep), 0x6B),
                    (BATCH, 1, 1, 1), jnp.float64)))
                    for rep in range(self.d_repeats)]
        _, tm = self.tstep(self.state, torch.from_numpy(reals),
                           torch.from_numpy(z), seed_key,
                           torch.tensor(ALPHA, dtype=torch.float64),
                           noises=[torch.from_numpy(n) for n in self.noises],
                           gp_eps=gp_eps)
        return jm, tm

    def compare(self, jm, tm):
        for k in ("d_loss", "g_loss"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       err_msg=k, **TOL)
        js, st = _np(self.jstate), self.state
        for label, tree, module, bridge in (
                ("G", js.g_params, st.generator,
                 generator_state_dict_from_jax_params),
                ("shadow", js.g_shadow, st.g_shadow,
                 generator_state_dict_from_jax_params),
                ("D", js.d_params, st.discriminator,
                 discriminator_state_dict_from_jax_params)):
            want = bridge(_np(tree))
            got = module.state_dict()
            assert set(got) == set(want), label
            for name in want:
                np.testing.assert_allclose(got[name].numpy(),
                                           want[name].numpy(),
                                           err_msg=f"{label} {name}", **TOL)
        for label, opt_state, module, opt, bridge in (
                ("G", js.g_opt_state, st.generator, st.g_optimizer,
                 generator_state_dict_from_jax_params),
                ("D", js.d_opt_state, st.discriminator, st.d_optimizer,
                 discriminator_state_dict_from_jax_params)):
            adam, = [s for s in jax.tree_util.tree_leaves(
                opt_state, is_leaf=lambda s: isinstance(
                    s, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState)]
            for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                want = bridge(_np(getattr(adam, moment)))
                for name, p in module.named_parameters():
                    np.testing.assert_allclose(
                        opt.state[p][key].numpy(), want[name].numpy(),
                        err_msg=f"{label} {moment} {name}", **TOL)
                    assert int(opt.state[p]["step"]) == int(adam.count)


def _run(pair, steps=2):
    for i in range(steps):
        pair.compare(*pair.step(i, seed_key=10 + i))


@pytest.mark.parametrize("loss", ["relativistic-hinge", "logistic", "hinge",
                                  "wgan-gp"])
def test_train_step_matches_jax(monkeypatch, loss):
    """One and two steps of each loss; logistic carries R1 (gamma 10) in
    its D loss, wgan-gp the gradient penalty on pinned interpolates."""
    _run(Pair(monkeypatch, {"loss": loss}))


def test_d_repeats_matches_jax(monkeypatch):
    _run(Pair(monkeypatch, {"d_repeats": 2}), steps=1)


def test_separate_r1_update_matches_jax(monkeypatch):
    """R1 as its own Adam update after the D update, with the D optimizer's
    lazy-regularization correction (interval 4) on both sides."""
    args = lazy_reg_adam_correction({}, 4)
    assert args == jstate.lazy_reg_adam_correction({}, 4)
    _run(Pair(monkeypatch, {"loss": "logistic", "r1_separate_reg": True},
              d_opt_args=args))


def test_fused_scores_match_jax(monkeypatch):
    _run(Pair(monkeypatch, {"fuse_scores": True}))


def test_reuse_g_fwd_matches_jax(monkeypatch):
    _run(Pair(monkeypatch, {"reuse_g_fwd": True}))


def test_reuse_g_fwd_matches_recompute(monkeypatch):
    """With the draws pinned and the truncation off (so that the one forward
    sees the same W-average as the two would), one G forward reused for the
    D and G phases gives the two-forward step."""
    states = []
    for reuse in (False, True):
        pair = Pair(monkeypatch, {"reuse_g_fwd": reuse}, truncation_psi=-1.0)
        for i in range(2):
            reals, z = _batch(i)
            pair.tstep(pair.state, torch.from_numpy(reals),
                       torch.from_numpy(z), i, ALPHA,
                       noises=[torch.from_numpy(n) for n in pair.noises])
        states.append(pair.state)
    for m in ("generator", "discriminator", "g_shadow"):
        a, b = (getattr(s, m).state_dict() for s in states)
        for name in a:
            torch.testing.assert_close(b[name], a[name], rtol=1e-5,
                                       atol=1e-6, msg=f"{m} {name}")


def test_d_and_g_steps_compose_to_the_train_step(monkeypatch):
    """build_d_step then build_g_step (the reference's optimize_discriminator
    and optimize_generator) make the fused step's update."""
    fused = Pair(monkeypatch)
    split = Pair(monkeypatch)
    _, (tg, td) = _configs()
    d_step = build_d_step(tg, td, depth=DEPTH)
    g_step = build_g_step(tg, td, depth=DEPTH)
    reals, z = map(torch.from_numpy, _batch(0))
    noises = [torch.from_numpy(n) for n in fused.noises]
    _, m = fused.tstep(fused.state, reals, z, 0, ALPHA, noises=noises)
    st = split.state
    d_loss = d_step(st.generator, st.discriminator, st.d_optimizer, reals, z,
                    0, ALPHA, noises=noises)
    g_loss = g_step(st.generator, st.discriminator, st.g_optimizer,
                    st.g_shadow, reals, z, 1, ALPHA, noises=noises)
    assert torch.equal(d_loss, m["d_loss"]) and torch.equal(g_loss,
                                                            m["g_loss"])
    for mod in ("generator", "discriminator", "g_shadow"):
        a = getattr(fused.state, mod).state_dict()
        b = getattr(st, mod).state_dict()
        for name in a:
            assert torch.equal(a[name], b[name]), (mod, name)


def test_step_draws_come_from_the_seed(monkeypatch):
    """Unpinned, the step's noise and mixing come from its seed: the same
    seed gives the same update, another seed another."""
    results = []
    _, (tg, td) = _configs()
    for seed in (3, 3, 4):
        gen = Generator(tg, generator=torch.Generator().manual_seed(0))
        dis = Discriminator(td, generator=torch.Generator().manual_seed(1))
        state = create_train_state(gen, dis)
        step = build_train_step(tg, td, depth=DEPTH, loss="wgan-gp")
        reals, z = map(torch.from_numpy, _batch(0))
        _, m = step(state, reals, z, seed, ALPHA)
        results.append((m["d_loss"].item(), m["g_loss"].item()))
    assert results[0] == results[1] != results[2]


def test_parallel_options_are_refused():
    """A mesh is a parallel.Mesh (the mesh= path itself runs in
    tests/test_torch_parallel.py); the R1 knobs need the logistic loss."""
    _, (tg, td) = _configs()
    with pytest.raises(TypeError, match="parallel.Mesh"):
        build_train_step(tg, td, depth=1, mesh=object())
    with pytest.raises(ValueError, match="mbstd_scope"):
        build_train_step(tg, td, depth=1, mbstd_scope="host")
    with pytest.raises(ValueError, match="logistic"):
        build_train_step(tg, td, depth=1, loss="hinge", r1_gamma=5.0)


@pytest.mark.parametrize("depth,alpha", [(0, 0.5), (1, 0.3), (2, 1.0)])
def test_progressive_downsample_matches_jax(depth, alpha):
    reals = np.random.RandomState(5).randn(2, RES, RES, 3).astype(np.float32)
    want = jsteps.progressive_downsample(jnp.asarray(reals), 3, depth,
                                         jnp.float32(alpha), "linear")
    got = progressive_downsample(torch.from_numpy(reals), 3, depth,
                                 torch.tensor(alpha), "linear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    t = torch.from_numpy(reals)
    assert progressive_downsample(t, 3, depth, alpha, "fixed") is t


def test_sample_fn_is_seeded_and_leaves_the_w_average():
    _, (tg, _) = _configs()
    gen = Generator(tg, generator=torch.Generator().manual_seed(0))
    before = gen.truncation.avg_latent.clone()
    sample = build_sample_fn(tg, depth=DEPTH)
    z = torch.randn(2, LATENT, generator=torch.Generator().manual_seed(1))
    a, avg = sample(gen, z, 5, 1.0)
    b, _ = sample(gen, z, 5, 1.0)
    assert a.shape == (2, RES, RES, 3) and torch.equal(a, b)
    assert not torch.equal(avg, before)
    assert torch.equal(gen.truncation.avg_latent, before)
