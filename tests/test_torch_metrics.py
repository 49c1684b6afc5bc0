"""The port's metrics (stylegan_torch/metrics) and its eval_metrics CLI
against the JAX package's on the CPU, on the same seeded inputs and the
same weights (JAX's inception_v3_init / lpips_vgg_init fed to both):

  SWD with JAX's draws pinned          1e-5 relative, per level
  Inception features and class probs   1e-4 relative to the largest value
  FID and IS on the same features      1e-6
  LPIPS distances, crop_and_resize     1e-5
  PPL distances with JAX's draws       2e-2 relative (the 1/eps^2 = 1e8
                                       scale turns float32 rounding of the
                                       two images into a relative error)

then the CLI as a subprocess with --device cpu for every metric, its
argument check before any IO, and its refusal of CUDA where it is missing.
"""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from stylegan_tpu.config import get_default_cfg as jax_default_cfg
from stylegan_tpu.io.checkpoint import (flatten_tree, save_params,
                                        unflatten_like)
from stylegan_tpu.metrics import fid as jfid
from stylegan_tpu.metrics import ppl as jppl
from stylegan_tpu.metrics import swd as jswd
from stylegan_tpu.models import generator_config_from_cfg as jax_gen_cfg
from stylegan_tpu.models import generator_init
from stylegan_tpu.models.synthesis import _make_noise
from stylegan_torch.cli import eval_metrics
from stylegan_torch.cli.common import load_config, load_generator
from stylegan_torch.metrics import fid, ppl, swd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """Weights files take tens of MB: gone once the test has read them."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# --------------------------------------------------------------------------
# SWD

def _jax_swd_draws(key, shapes, n_patches, n_proj):
    """The draws JAX's sliced_wasserstein_distance makes from `key`, per
    level: real indices, fake indices, directions."""
    draws = []
    for shape in shapes:
        key, k1, k2, k3 = jax.random.split(key, 4)
        b, h, w, c = shape
        idx = []
        for k in (k1, k2):
            ka, kb, kc = jax.random.split(k, 3)
            idx.append(tuple(np.array(jax.random.randint(kk, (n_patches,),
                                                         0, hi))
                             for kk, hi in ((ka, b), (kb, max(1, h - 6)),
                                            (kc, max(1, w - 6)))))
        dim = min(7, h) * min(7, w) * c
        draws.append((idx[0], idx[1],
                      np.array(jax.random.normal(k3, (dim, n_proj)))))
    return draws


def test_laplacian_pyramid_matches_jax():
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    want = jswd.laplacian_pyramid(jnp.asarray(x), 3)
    got = swd.laplacian_pyramid(torch.from_numpy(x), 3)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("shift", [0.0, 1.5], ids=["close", "shifted"])
def test_swd_with_jax_draws_matches_jax(shift):
    rs = np.random.RandomState(1)
    real = rs.randn(4, 32, 32, 3).astype(np.float32)
    fake = (rs.randn(4, 32, 32, 3) * (1 + shift) + shift).astype(np.float32)
    key, n_patches, n_proj = jax.random.PRNGKey(3), 256, 32
    want = jswd.sliced_wasserstein_distance(jnp.asarray(real),
                                            jnp.asarray(fake), key=key,
                                            n_patches=n_patches, n_proj=n_proj)
    shapes = [p.shape for p in jswd.laplacian_pyramid(jnp.asarray(real), 3)]
    got = swd.sliced_wasserstein_distance(
        torch.from_numpy(real), torch.from_numpy(fake),
        draws=_jax_swd_draws(key, shapes, n_patches, n_proj))
    assert got.keys() == want.keys() == {"level_32", "level_16", "level_8",
                                         "avg"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k


def test_swd_own_draws_are_seeded():
    rs = np.random.RandomState(2)
    real = torch.from_numpy(rs.randn(2, 16, 16, 3).astype(np.float32))
    fake = torch.from_numpy(rs.randn(2, 16, 16, 3).astype(np.float32) + 1)

    def run(seed):
        return swd.sliced_wasserstein_distance(
            real, fake, generator=torch.Generator().manual_seed(seed),
            n_patches=64, n_proj=8)
    assert run(0) == run(0) != run(1)
    assert swd.sliced_wasserstein_distance(real, real, n_patches=64,
                                           n_proj=8)["avg"] < run(0)["avg"]


# --------------------------------------------------------------------------
# Inception: features, probabilities, FID and IS

@pytest.fixture(scope="module")
def inception():
    return fid.inception_v3_init(0)


@pytest.mark.parametrize("size", [128, 384], ids=["upsample", "downsample"])
def test_inception_features_and_probs_match_jax(inception, size):
    x = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    want = np.asarray(jfid.make_feature_fn(inception)(jnp.asarray(x)))
    got = fid.make_feature_fn(inception, "cpu")(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048) and np.abs(want).max() > 0
    assert _rel(got, want) <= 1e-4
    want_p = np.asarray(jfid.make_probs_fn(inception)(jnp.asarray(x)))
    got_p = fid.make_probs_fn(inception, "cpu")(torch.from_numpy(x)).numpy()
    assert _rel(got_p, want_p) <= 1e-4


def test_fid_and_is_math_match_jax():
    rs = np.random.RandomState(4)
    a = rs.randn(64, 16)
    b = rs.randn(64, 16) * 1.3 + 0.2
    assert abs(fid.fid_from_features(a, b)
               - jfid.fid_from_features(a, b)) <= 1e-6
    mu, sig = fid.compute_statistics(a)
    assert abs(fid.frechet_distance(mu, sig, mu, sig)) <= 1e-6
    logits = rs.randn(40, 10) * 3
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for got, want in zip(fid.inception_score_from_probs(p, splits=4),
                         jfid.inception_score_from_probs(p, splits=4)):
        assert abs(got - want) <= 1e-6


def test_inception_init_and_weights_file(inception, tmp_path):
    """The port's seeded init has JAX's schema, and its weights file is
    validated as JAX's is."""
    mine = inception
    jax_shapes = {name: shape for name, shape in (
        (f"{s[0]}.conv.weight", (s[2], s[1], s[3], s[4]))
        for s in jfid.all_conv_specs())}
    assert {k: mine[k].shape for k in jax_shapes} == jax_shapes
    assert len(mine) == 5 * len(jax_shapes) + 2
    assert all(v.dtype == np.float32 for v in mine.values())
    path = tmp_path / "inc.npz"
    np.savez(path, **mine)
    assert fid.load_inception_weights(str(path), need_fc=True).keys() == \
        mine.keys()
    bad = dict(mine)
    bad["Mixed_5b.branch1x1.conv.weight"] = np.zeros((1, 1, 1, 1),
                                                     np.float32)
    np.savez(path, **bad)
    with pytest.raises(ValueError, match="Mixed_5b.branch1x1.conv.weight"):
        fid.load_inception_weights(str(path))
    np.savez(path, **{k: v for k, v in mine.items() if not k.startswith("fc")})
    fid.load_inception_weights(str(path))
    with pytest.raises(ValueError, match="fc.weight"):
        fid.load_inception_weights(str(path), need_fc=True)


# --------------------------------------------------------------------------
# PPL: LPIPS, the pyramid distance, crop_and_resize, the samples

def test_lpips_matches_jax(tmp_path):
    weights = ppl.lpips_vgg_init(3)
    rs = np.random.RandomState(5)
    a = rs.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rs.randn(*a.shape), -1, 1).astype(np.float32)
    want = np.asarray(jppl.make_lpips_fn(weights)(a, b))
    got = ppl.make_lpips_fn(weights, "cpu")(torch.from_numpy(a),
                                            torch.from_numpy(b)).numpy()
    assert _rel(got, want) <= 1e-5 and want.min() > 0
    mine = ppl.lpips_vgg_init(0)
    want = {}
    for idx in jppl._VGG_CONVS:
        cin, cout = jppl._VGG_CHANNELS[idx]
        want[f"features.{idx}.weight"] = (cout, cin, 3, 3)
        want[f"features.{idx}.bias"] = (cout,)
    for i, dim in enumerate(jppl._LPIPS_DIMS):
        want[f"lin{i}.weight"] = (1, dim, 1, 1)
    assert {k: v.shape for k, v in mine.items()} == want
    np.savez(tmp_path / "lp.npz", **mine)
    assert ppl.load_lpips_weights(str(tmp_path / "lp.npz")).keys() == \
        mine.keys()
    np.savez(tmp_path / "lp.npz", **dict(mine, lin0=np.zeros(3)))
    del mine["lin4.weight"]
    np.savez(tmp_path / "lp.npz", **mine)
    with pytest.raises(ValueError, match="lin4.weight"):
        ppl.load_lpips_weights(str(tmp_path / "lp.npz"))


@pytest.mark.parametrize("size", [64, 512])
def test_crop_and_resize_and_pyramid_distance_match_jax(size):
    rs = np.random.RandomState(size)
    x = rs.randn(2, size, size, 3).astype(np.float32)
    want = np.asarray(jppl.crop_and_resize(jnp.asarray(x)))
    got = ppl.crop_and_resize(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, min(size // 2, 256),
                                       min(size // 2, 256), 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    y = (x + 0.1 * rs.randn(*x.shape)).astype(np.float32)
    want = np.asarray(jppl.make_pyramid_distance()(x, y))
    got = ppl.make_pyramid_distance()(torch.from_numpy(x),
                                      torch.from_numpy(y)).numpy()
    assert _rel(got, want) <= 1e-5


def test_slerp_lerp_match_jax():
    rs = np.random.RandomState(6)
    a, b = rs.randn(5, 32).astype(np.float32), rs.randn(5, 32).astype(
        np.float32)
    t = rs.rand(5, 1).astype(np.float32)
    b[0] = a[0]                         # the degenerate pair: lerp
    for jf, tf in ((jppl.slerp, ppl.slerp), (jppl.lerp, ppl.lerp)):
        np.testing.assert_allclose(
            tf(torch.from_numpy(a), torch.from_numpy(b),
               torch.from_numpy(t)).numpy(),
            np.asarray(jf(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t))),
            atol=1e-5)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A 16^2 yaml-schema generator (JAX init, noise weights and the W
    average non-zero) as .npz, loaded by the port; 8 PNGs as a dataset."""
    tmp = tmp_path_factory.mktemp("torch_metrics")
    data = tmp / "data"
    data.mkdir()
    rs = np.random.RandomState(0)
    for i in range(8):
        Image.fromarray(rs.randint(0, 255, (RES, RES, 3), np.uint8)).save(
            data / f"{i:02d}.png")
    cfg_path = tmp / "toy.yaml"
    cfg_path.write_text(f"""
structure: 'linear'
model:
  gen:
    mapping_layers: 2
    truncation_psi: 0.7
dataset:
  img_dir: '{data}'
  folder: False
  resolution: {RES}
""")
    jopt = jax_default_cfg()
    jopt.merge_from_file(str(cfg_path))
    jc = jax_gen_cfg(jopt)
    params = generator_init(jax.random.PRNGKey(0), jc)
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    for k, v in flat.items():
        if k.endswith("noise.weight") or k.endswith("avg_latent"):
            flat[k] = (0.5 * rs.randn(*v.shape)).astype(np.float32)
    params = unflatten_like(params, flat, partial=False)
    npz = str(tmp / "gen.npz")
    save_params(npz, params)
    gen = load_generator(load_config(str(cfg_path)), npz, torch.device("cpu"))
    yield types.SimpleNamespace(tmp=tmp, cfg=str(cfg_path), npz=npz, jc=jc,
                                params=params, gen=gen)
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("space", ["w", "z"])
def test_ppl_samples_with_jax_draws_match_jax(toy, space):
    """JAX's per-batch draws (ppl.py: fold_in(key, i) split five ways)
    handed to the port; the distances agree to 2e-2 relative."""
    jc, batch, key = toy.jc, 4, jax.random.PRNGKey(7)
    dist = jppl.make_pyramid_distance()
    want = jppl.ppl_samples(jc, toy.params, dist, num_samples=8,
                            batch_size=batch, key=key, space=space)

    def draws(i):
        kz1, kz2, kt, kn, _ = jax.random.split(jax.random.fold_in(key, i), 5)
        return {
            "z1": torch.from_numpy(np.array(
                jax.random.normal(kz1, (batch, jc.latent_size)))),
            "z2": torch.from_numpy(np.array(
                jax.random.normal(kz2, (batch, jc.latent_size)))),
            "t": torch.from_numpy(np.array(
                jax.random.uniform(kt, (batch, 1)))),
            "noises": [torch.from_numpy(np.array(_make_noise(
                kn, l, batch, 2 ** (l // 2 + 2), jnp.float32)))
                for l in range(jc.num_layers)]}
    got = ppl.ppl_samples(toy.gen, ppl.make_pyramid_distance(),
                          num_samples=8, batch_size=batch, space=space,
                          draws=draws)
    assert got.shape == (8,) and np.all(np.isfinite(got))
    assert _rel(got, want) <= 2e-2
    assert abs(ppl.ppl_score(got) - jppl.ppl_score(got)) == 0.0


def test_ppl_own_draws_are_seeded(toy):
    dist = ppl.make_pyramid_distance()
    a, b, c = (ppl.ppl_samples(toy.gen, dist, num_samples=3, batch_size=2,
                               seed=s, sampling="end") for s in (0, 0, 1))
    assert a.shape == (3,) and np.array_equal(a, b) and not np.array_equal(
        a, c)


# --------------------------------------------------------------------------
# python -m stylegan_torch.cli.eval_metrics

def _run(args, ok=True):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m",
                        "stylegan_torch.cli.eval_metrics"] + args, cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    if ok:
        assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    return r


@pytest.mark.parametrize("metric", ["swd", "fid", "is", "ppl", "ppl_z"])
def test_eval_metrics_cli_on_cpu(toy, metric):
    """Every metric end to end on the CPU, printing the JAX CLI's keys."""
    base = ["--config", toy.cfg, "--generator_file", toy.npz, "--device",
            "cpu", "--seed", "1"]
    if metric in ("fid", "is"):
        weights = toy.tmp / "inception.npz"
        if not weights.exists():
            np.savez(weights, **fid.inception_v3_init(0))
        args = ["--metric", metric, "--inception_weights", str(weights),
                "--num_samples", "4", "--batch", "2"]
        keys = ({"fid", "num_samples"} if metric == "fid" else
                {"inception_score", "inception_score_std", "num_samples"})
    elif metric.startswith("ppl"):
        # LPIPS's four pools need a crop of 16 px or more (a 32^2 model):
        # chip_smoke.py runs it at 1024^2
        args = ["--metric", "ppl", "--num_samples", "4", "--batch", "2",
                "--ppl_space", metric[4:] or "w"]
        keys = {"ppl", "distance", "space", "sampling", "num_samples"}
    else:
        args = ["--num_samples", "8", "--batch", "4"]
        keys = {"swd_x1e3_level_16", "swd_x1e3_level_8", "swd_x1e3_avg"}
    r = _run(base + args)
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(result) == keys
    assert all(np.isfinite(v) for v in result.values()
               if isinstance(v, float))
    if metric.startswith("ppl"):
        assert result["distance"] == "pyramid-l2"
        assert result["space"] == (metric[4:] or "w")


def test_eval_metrics_checks_arguments_before_io(toy):
    args = eval_metrics.parse_arguments(
        ["--config", toy.cfg, "--generator_file", str(toy.tmp / "missing"),
         "--metric", "fid", "--device", "cpu"])
    with pytest.raises(SystemExit, match="requires --inception_weights"):
        eval_metrics.main(args)


def test_eval_metrics_refuses_missing_cuda(toy, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = eval_metrics.parse_arguments(
        ["--config", toy.cfg, "--generator_file", toy.npz])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_metrics.main(args)
