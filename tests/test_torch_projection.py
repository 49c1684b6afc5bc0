"""The port's W-space projection (stylegan_torch/projection.py) against the
JAX package's on the CPU: the same weights (JAX init, converted through the
bridge), and JAX's own draws handed to the port (the mapping's z, the
pinned noise maps, each step's W perturbation).

The five-step comparison runs in float64 on both sides (JAX inside
jax.enable_x64), because it checks the algorithm: Adam's first steps move
each coordinate by about lr times the sign of its gradient, so float32
rounding of a small gradient would move W differently on the two sides.
JAX's pyramid_loss casts the images to float32; in the test only, its step
is handed the same formula without that cast (the float32 pyramid is held
on its own, below).  The JAX package is not changed."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from stylegan_tpu import projection as jproj
from stylegan_tpu.io.checkpoint import unflatten_like
from stylegan_tpu.metrics.swd import laplacian_pyramid as jax_pyramid
from stylegan_tpu.models import configs as jcfg
from stylegan_tpu.models import generator_init
from stylegan_torch import projection as tproj
from stylegan_torch.convert import (flatten_params,
                                    generator_state_dict_from_jax_params,
                                    save_generator_file)
from stylegan_torch.models import Generator
from stylegan_torch.models import configs as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL64 = dict(atol=1e-8, rtol=1e-8)
TOL32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(res):
    """The JAX test's tiny generator (test_projection.py::_tiny_cfg), as
    (JAX config, port config)."""
    def build(m):
        return m.GeneratorConfig(
            resolution=res, latent_size=64, dlatent_size=64,
            truncation_psi=-1.0,
            mapping=m.MappingConfig(latent_size=64, dlatent_size=64,
                                    mapping_fmaps=64, mapping_layers=2,
                                    dlatent_broadcast=(res.bit_length() - 2)
                                    * 2),
            synthesis=m.SynthesisConfig(resolution=res, dlatent_size=64,
                                        fmap_base=256, fmap_max=64,
                                        blur_filter=(1, 2, 1),
                                        structure="linear"))
    return build(jcfg), build(tcfg)


def _models(res, dtype=np.float32):
    """JAX params and the port's Generator holding the same weights, with
    the noise weights, the const input and its bias random (so that every
    W row's gradient is non-zero: at init the input block's maps are flat
    and its instance norm cancels them)."""
    jc, tc = _configs(res)
    flat = flatten_params(jax.tree_util.tree_map(
        np.asarray, generator_init(jax.random.PRNGKey(0), jc)))
    rs = np.random.RandomState(1)
    for k, v in flat.items():
        flat[k] = (0.3 * rs.randn(*v.shape) if k.endswith((
            "noise.weight", "init_block.const", "init_block.bias"))
            else v).astype(dtype)
    jdtype = jnp.float64 if dtype == np.float64 else jnp.float32
    with jax.enable_x64(dtype == np.float64):
        params = unflatten_like(generator_init(jax.random.PRNGKey(0), jc,
                                               jdtype), flat, partial=False)
    gen = Generator(tc).to(torch.float64 if dtype == np.float64
                           else torch.float32)
    gen.load_state_dict(generator_state_dict_from_jax_params(flat),
                        strict=True)
    return jc, tc, params, gen


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def test_w_statistics_matches_jax():
    jc, tc, params, gen = _models(16)
    key = jax.random.PRNGKey(4)
    w_avg, w_std = jproj.w_statistics(jc, params, key, 128)
    z = jax.random.normal(key, (128, jc.effective_latent_size))
    t_avg, t_std = tproj.w_statistics(tc, gen, z=_t(z))
    assert t_avg.shape == (64,)
    np.testing.assert_allclose(t_avg.numpy(), np.asarray(w_avg), **TOL32)
    np.testing.assert_allclose(float(t_std), float(w_std), **TOL32)
    # drawn from a torch.Generator: the same statistics' shape, seeded
    a = tproj.w_statistics(tc, gen, torch.Generator().manual_seed(0), 64)
    b = tproj.w_statistics(tc, gen, torch.Generator().manual_seed(0), 64)
    assert torch.equal(a[0], b[0]) and float(a[1]) > 0


@pytest.mark.parametrize("levels", [1, 3, 4])
def test_pyramid_loss_matches_jax(levels):
    rs = np.random.RandomState(levels)
    a = rs.randn(1, 32, 32, 3).astype(np.float32)
    b = rs.randn(1, 32, 32, 3).astype(np.float32)
    want = float(jproj.pyramid_loss(jnp.asarray(a), jnp.asarray(b), levels))
    got = float(tproj.pyramid_loss(_t(a), _t(b), levels))
    np.testing.assert_allclose(got, want, **TOL32)
    assert float(tproj.pyramid_loss(_t(a), _t(a), levels)) == 0.0


@pytest.mark.parametrize("num_steps", [20, 1000])
def test_lr_schedule_matches_jax(num_steps):
    """The port computes the schedule in Python floats (float64), JAX here
    under enable_x64: near the last step 1 - t / num_steps cancels, which
    float32 would round to 3e-4 relative."""
    cfg_j = jproj.ProjectorConfig(num_steps=num_steps)
    cfg_t = tproj.ProjectorConfig(num_steps=num_steps)
    for t in sorted({0, 1, 2, num_steps // 20, num_steps // 2,
                     int(0.8 * num_steps), num_steps - 1}):
        with jax.enable_x64(True):
            want = float(jproj._lr_schedule(jnp.float64(t), cfg_j))
        np.testing.assert_allclose(tproj._lr_schedule(t, cfg_t), want,
                                   rtol=1e-12, atol=1e-15, err_msg=str(t))


def test_projector_config_matches_jax():
    assert tproj.ProjectorConfig() == tproj.ProjectorConfig(
        **jproj.ProjectorConfig().__dict__)


def _pyramid_loss_f64(a, b, levels):
    """JAX's pyramid_loss without its float32 cast (see the module
    docstring)."""
    loss = 0.0
    for lvl, (xa, xb) in enumerate(zip(jax_pyramid(a, levels),
                                       jax_pyramid(b, levels))):
        loss = loss + (2.0 ** lvl) * jnp.mean(jnp.square(xa - xb))
    return loss


@pytest.mark.parametrize("w_plus", [True, False], ids=["w_plus", "w"])
def test_projection_steps_match_jax_in_float64(monkeypatch, w_plus):
    """Five steps of build_projection_step with JAX's z, noise maps and
    perturbation draws: W and the loss within 1e-8 after every step."""
    monkeypatch.setattr(jproj, "pyramid_loss", _pyramid_loss_f64)
    jc, tc, params, gen = _models(16, np.float64)
    pcfg = dict(num_steps=5, w_plus=w_plus, avg_samples=64,
                pyramid_levels=3)
    key = jax.random.PRNGKey(7)
    target = np.random.RandomState(2).uniform(-1, 1, (16, 16, 3))
    with jax.enable_x64(True):
        jstate, jw_std, jnoises = jproj.init_projection(
            key, jc, params, jproj.ProjectorConfig(**pcfg))
        jstep = jproj.build_projection_step(
            jc, params, jproj.ProjectorConfig(**pcfg), jnoises)
        k_avg, _, _ = jax.random.split(key, 3)
        z = np.asarray(jax.random.normal(
            k_avg, (pcfg["avg_samples"], jc.effective_latent_size)))
    state, w_std, noises = tproj.init_projection(
        0, tc, gen, tproj.ProjectorConfig(**pcfg), z=_t(z),
        noises=[_t(n, np.float64) for n in jnoises])
    np.testing.assert_allclose(state.dlatents.detach().numpy(),
                               np.asarray(jstate.dlatents), **TOL64)
    np.testing.assert_allclose(float(w_std), float(jw_std), **TOL64)
    step = tproj.build_projection_step(tc, gen,
                                       tproj.ProjectorConfig(**pcfg), noises)
    for t in range(pcfg["num_steps"]):
        with jax.enable_x64(True):
            # the perturbation JAX's step draws from its state's key
            _, k_pert = jax.random.split(jstate.key)
            pert = np.asarray(jax.random.normal(k_pert,
                                                jstate.dlatents.shape))
            jstate, jloss = jstep(jstate, jnp.asarray(target),
                                  jnp.float64(t), jw_std)
        state, loss = step(state, _t(target), t, w_std, perturbation=_t(pert))
        np.testing.assert_allclose(float(loss), float(jloss),
                                   err_msg=f"loss {t}", **TOL64)
        np.testing.assert_allclose(state.dlatents.detach().numpy(),
                                   np.asarray(jstate.dlatents),
                                   err_msg=f"W {t}", **TOL64)
    assert all(p.grad is None for p in gen.parameters())


def test_projection_recovers_generated_image():
    """The port's counterpart of test_projection.py's: a target made from a
    W near the mapping prior, with the projector's own pinned noises, is
    recovered (loss and pixel error well below the start's)."""
    _, tc, _, gen = _models(32)
    gen.requires_grad_(False)
    pcfg = tproj.ProjectorConfig(num_steps=200, avg_samples=256,
                                 pyramid_levels=3, initial_lr=0.05)
    state, w_std, noises = tproj.init_projection(1, tc, gen, pcfg)
    w_avg, ws = tproj.w_statistics(tc, gen, torch.Generator().manual_seed(7),
                                   256)
    rs = np.random.RandomState(2)
    w_true = (w_avg + 0.4 * ws * _t(rs.randn(1, tc.num_layers, 64), np.float32)
              / np.sqrt(64))
    with torch.no_grad():
        target = gen.g_synthesis(w_true, depth=tc.synthesis.depth - 1,
                                 alpha=1.0, noises=noises)[0]
        base = tproj._synthesize(tc, gen, state.dlatents, noises, True)[0]
    loss0 = float(tproj.pyramid_loss(base[None], target[None], 3))
    dl, img, losses = tproj.project(1, tc, gen, target.numpy(), pcfg)
    assert dl.shape == (tc.num_layers, 64) and img.shape == target.shape
    assert len(losses) == 200 and all(isinstance(v, float) for v in losses)
    assert losses[-1] < 0.25 * loss0, (loss0, losses[-1])
    mse = float(np.mean((img - target.numpy()) ** 2))
    mse_base = float(np.mean((base.numpy() - target.numpy()) ** 2))
    assert mse < 0.4 * mse_base, (mse, mse_base)
    # the run is a function of its seed
    again = tproj.project(1, tc, gen, target.numpy(),
                          tproj.ProjectorConfig(num_steps=3, avg_samples=256,
                                                pyramid_levels=3))
    once = tproj.project(1, tc, gen, target.numpy(),
                         tproj.ProjectorConfig(num_steps=3, avg_samples=256,
                                               pyramid_levels=3))
    assert np.array_equal(again[0], once[0]) and again[2] == once[2]


def test_project_cli_feeds_generate_samples(tmp_path):
    """python -m stylegan_torch.cli.project on the CPU: w.npy, projected.png
    and target.png; the w.npy through generate_samples --input."""
    res = 16
    cfg_path = tmp_path / "toy.yaml"
    cfg_path.write_text(f"""
structure: 'linear'
model:
  gen:
    mapping_layers: 2
    truncation_psi: -1.0
dataset:
  resolution: {res}
""")
    from stylegan_torch.config import get_default_cfg
    from stylegan_torch.models import generator_config_from_cfg
    cfg = get_default_cfg()
    cfg.merge_from_file(str(cfg_path))
    gen = Generator(generator_config_from_cfg(cfg),
                    generator=torch.Generator().manual_seed(0))
    npz = tmp_path / "gen.npz"
    save_generator_file(gen, str(npz))
    rs = np.random.RandomState(0)
    Image.fromarray(rs.randint(0, 255, (24, 24, 3), np.uint8)).save(
        tmp_path / "target.png")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = tmp_path / "proj"
    try:
        r = subprocess.run(
            [sys.executable, "-m", "stylegan_torch.cli.project", "--config",
             str(cfg_path), "--generator_file", str(npz), "--target",
             str(tmp_path / "target.png"), "--output_dir", str(out),
             "--num_steps", "3", "--device", "cpu"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
        assert "final loss" in r.stdout
        w = np.load(out / "w.npy")
        assert w.shape == (6, 512) and np.isfinite(w).all()
        for name in ("projected.png", "target.png"):
            assert np.asarray(Image.open(out / name)).shape == (res, res, 3)
        r = subprocess.run(
            [sys.executable, "-m", "stylegan_torch.cli.generate_samples",
             "--config", str(cfg_path), "--generator_file", str(npz),
             "--input", str(out / "w.npy"), "--output",
             str(out / "from_w.png"), "--device", "cpu"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
        assert np.asarray(Image.open(out / "from_w.png")).shape == (res, res,
                                                                     3)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
