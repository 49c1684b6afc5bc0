"""The port's figure, grid and video CLIs (stylegan_torch/cli/generate_*)
against the JAX package's on the CPU: the same .npz and the same pinned
noise maps (the maps JAX draws, handed to the port), the uint8 canvases and
frames within 1 LSB, the float images within 1e-4; then each CLI as a
subprocess with --device cpu, and each refusing CUDA where it is missing.

Configuration: a 16^2 generator of the yaml schema (512 channels, 2 mapping
layers, truncation psi 0.7), random JAX weights with the noise weights and
the W average non-zero."""

import argparse
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

import generate_grid as jgrid
import generate_mixing_figure as jmix
import generate_truncation_figure as jtrunc
import generate_video as jvideo
import stylegan_tpu.models as jmodels
from stylegan_tpu.config import get_default_cfg as jax_default_cfg
from stylegan_tpu.convert import load_generator_file as jax_load_g
from stylegan_tpu.io.checkpoint import (flatten_tree, save_params,
                                        unflatten_like)
from stylegan_tpu.models import generator_config_from_cfg as jax_gen_cfg
from stylegan_tpu.models import generator_init
from stylegan_tpu.models.synthesis import _make_noise
from stylegan_torch.cli import (generate_grid, generate_mixing_figure,
                                generate_truncation_figure, generate_video)
from stylegan_torch.cli.common import load_config, load_generator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, OUT_DEPTH = 16, 2
FLOAT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The yaml, the .npz, the JAX config and params loaded from it, and the
    port's generator loaded from it; the directory is removed afterwards."""
    tmp = tmp_path_factory.mktemp("torch_figures")
    cfg_path = tmp / "toy.yaml"
    cfg_path.write_text(f"""
structure: 'linear'
model:
  gen:
    mapping_layers: 2
    truncation_psi: 0.7
dataset:
  resolution: {RES}
""")
    jopt = jax_default_cfg()
    jopt.merge_from_file(str(cfg_path))
    jc = jax_gen_cfg(jopt)
    params = generator_init(jax.random.PRNGKey(0), jc)
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    rs = np.random.RandomState(0)
    for k, v in flat.items():
        if k.endswith("noise.weight") or k.endswith("avg_latent"):
            flat[k] = (0.5 * rs.randn(*v.shape)).astype(np.float32)
    npz = str(tmp / "gen.npz")
    save_params(npz, unflatten_like(params, flat, partial=False))
    params = jax_load_g(generator_init(jax.random.PRNGKey(0), jc), npz)
    gen = load_generator(load_config(str(cfg_path)), npz, torch.device("cpu"))
    yield types.SimpleNamespace(tmp=tmp, cfg=str(cfg_path), npz=npz, jc=jc,
                                params=params, gen=gen)
    shutil.rmtree(tmp, ignore_errors=True)


def _jax_noises(key, n_layers):
    """The maps JAX's synthesis draws from `key` for a batch, per layer."""
    def draw(batch):
        return [np.asarray(_make_noise(key, i, batch, 2 ** (i // 2 + 2),
                                       jnp.float32)) for i in range(n_layers)]
    return draw


@pytest.fixture
def record_jax(monkeypatch):
    """Record the float outputs of JAX's synthesis_apply / generator_apply,
    which the JAX CLIs import from stylegan_tpu.models at call time."""
    seen = []
    for name in ("synthesis_apply", "generator_apply"):
        orig = getattr(jmodels, name)

        def wrapped(*a, _orig=orig, **kw):
            out = _orig(*a, **kw)
            seen.append(np.asarray(getattr(out, "images", out)))
            return out
        monkeypatch.setattr(jmodels, name, wrapped)
    return seen


def _close_u8(got, want):
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16)).max()
    assert diff <= 1, diff


def _close_float(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=FLOAT_TOL, rtol=FLOAT_TOL)


def test_mixing_figure_matches_jax(toy, record_jax):
    want_png, got_png = str(toy.tmp / "jax_mix.png"), str(toy.tmp / "mix.png")
    # the JAX CLI's main() passes these inline
    assert generate_mixing_figure.SRC_SEEDS == [639, 1995, 687, 615, 1999]
    assert generate_mixing_figure.DST_SEEDS == [888, 888, 888]
    jmix.draw_style_mixing_figure(
        want_png, toy.jc, toy.params, out_depth=OUT_DEPTH,
        src_seeds=generate_mixing_figure.SRC_SEEDS,
        dst_seeds=generate_mixing_figure.DST_SEEDS,
        style_ranges=generate_mixing_figure.STYLE_RANGES)
    canvas, images = generate_mixing_figure.draw_style_mixing_figure(
        got_png, toy.gen, OUT_DEPTH, generate_mixing_figure.SRC_SEEDS,
        generate_mixing_figure.DST_SEEDS, generate_mixing_figure.STYLE_RANGES,
        noises=_jax_noises(jax.random.PRNGKey(0), toy.jc.num_layers))
    assert [len(i) for i in images] == [5, 3, 5, 5, 5]
    _close_float(images, record_jax)
    _close_u8(canvas, np.asarray(Image.open(want_png)))
    _close_u8(np.asarray(Image.open(got_png)), canvas)
    assert canvas.shape == (RES * 4, RES * 6, 3)


def test_truncation_figure_matches_jax(toy, record_jax):
    want_png, got_png = str(toy.tmp / "jax_tr.png"), str(toy.tmp / "tr.png")
    seeds, psis = [91, 388], [1, 0.7, 0.5, 0, -0.5, -1]
    assert (seeds, psis) == (generate_truncation_figure.SEEDS,
                             generate_truncation_figure.PSIS)
    jtrunc.draw_truncation_trick_figure(want_png, toy.jc, toy.params,
                                        out_depth=OUT_DEPTH, seeds=seeds,
                                        psis=psis)
    canvas, images = generate_truncation_figure.draw_truncation_trick_figure(
        got_png, toy.gen, OUT_DEPTH, seeds, psis,
        noises=_jax_noises(jax.random.PRNGKey(0), toy.jc.num_layers))
    _close_float(images, record_jax)
    _close_u8(canvas, np.asarray(Image.open(want_png)))
    assert canvas.shape == (RES * 2, RES * 6, 3)


def test_grid_matches_jax(toy, record_jax):
    """The JAX CLI's own draws (latents, style mixing, noise), reproduced
    from its seed and handed to the port."""
    n_row, n_col, seed = 2, 3, 5
    out = toy.tmp / "jax_grid"
    jgrid.main(argparse.Namespace(config=toy.cfg, generator_file=toy.npz,
                                  n_row=n_row, n_col=n_col, output_dir=str(out),
                                  seed=seed, class_id=None))
    n, jc = n_row * n_col, toy.jc
    _, kz, ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    point = jax.random.normal(kz, (n, jc.latent_size))
    point = (point / jnp.linalg.norm(point)) * (jc.latent_size ** 0.5)
    rng, k_mix_z, k_mix_p, k_cut = jax.random.split(ks, 4)
    latents2 = np.asarray(jax.random.normal(k_mix_z, point.shape))
    cur = 2 * (OUT_DEPTH + 1)
    cutoff = int(jax.random.randint(jax.random.fold_in(k_cut, 0), (), 1,
                                    cur + 1))
    if not float(jax.random.uniform(k_mix_p, ())) < jc.style_mixing_prob:
        cutoff = cur
    got_png = str(toy.tmp / "grid.png")
    images = generate_grid.draw_grid(
        got_png, toy.gen, OUT_DEPTH, n_row, n_col,
        latents=torch.from_numpy(np.asarray(point)),
        noises=_jax_noises(rng, jc.num_layers)(n), mixing=(latents2, cutoff))
    _close_float([images], record_jax)
    _close_u8(np.asarray(Image.open(got_png)),
              np.asarray(Image.open(out / "grid.png")))


@pytest.mark.parametrize("mode", ["walk", "truncation"])
def test_video_matches_jax(toy, record_jax, monkeypatch, mode):
    """JAX's main() with its jit lifted (so that the recorder sees arrays)
    and its optional mp4 writer replaced by one that keeps the frames."""
    args = argparse.Namespace(
        config=toy.cfg, generator_file=toy.npz, mode=mode, num_points=2,
        frames_per_step=3, num_frames=5, fps=10, batch=4, out_depth=None,
        seed=3, output=str(toy.tmp / f"jax_{mode}.gif"))
    jax_frames = []
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", lambda f: f)
        m.setitem(sys.modules, "imageio", types.SimpleNamespace(
            mimwrite=lambda path, frames, fps: jax_frames.extend(frames)))
        jvideo.main(args)
    n_frames = 6 if mode == "walk" else 5
    assert len(jax_frames) == n_frames
    jax_floats = list(np.concatenate(record_jax))[:n_frames]
    nkey = jax.random.PRNGKey(args.seed + 1)
    noises = [np.asarray(jax.random.normal(
        jax.random.fold_in(nkey, i), (1, 2 ** (i // 2 + 2),
                                      2 ** (i // 2 + 2), 1), jnp.float32))
        for i in range(toy.jc.num_layers)]
    args.output = str(toy.tmp / f"{mode}.gif")
    frames, floats = generate_video.make_video(toy.gen, args, noises=noises)
    _close_float(floats, jax_floats)
    for got, want in zip(frames, jax_frames):
        _close_u8(got, np.asarray(want))
    gif = Image.open(args.output)
    assert gif.n_frames == n_frames and gif.size == (RES, RES)


def test_batch1_noise_reaches_synthesis_expanded(toy):
    """A pinned map of batch 1 is expanded to the batch, contiguous, before
    the epilogue (the kernel takes exactly (B, H, W, 1)); the images equal
    those of the same map repeated by hand."""
    from stylegan_torch.models.synthesis import layer_resolution
    n_layers = toy.jc.num_layers
    rs = np.random.RandomState(7)
    one = [torch.from_numpy(rs.randn(1, layer_resolution(i),
                                     layer_resolution(i), 1).astype(np.float32))
           for i in range(n_layers)]
    seen = []
    import stylegan_torch.models.synthesis as syn
    orig = syn.fused_epilogue

    def spy(x, nw, noise, style, *rest):
        seen.append((tuple(noise.shape), noise.is_contiguous()))
        return orig(x, nw, noise, style, *rest)
    dl = torch.from_numpy(rs.randn(3, n_layers, 512).astype(np.float32))
    with torch.inference_mode():
        try:
            syn.fused_epilogue = spy
            got = toy.gen.g_synthesis(dl, depth=OUT_DEPTH, alpha=1.0,
                                      noises=one)
        finally:
            syn.fused_epilogue = orig
        want = toy.gen.g_synthesis(dl, depth=OUT_DEPTH, alpha=1.0,
                                   noises=[n.repeat(3, 1, 1, 1) for n in one])
    assert len(seen) == 2 * (OUT_DEPTH + 1)
    assert all(s[0][0] == 3 and s[1] for s in seen)
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# the CLIs as subprocesses

def _run(module, args, ok=True):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", f"stylegan_torch.cli.{module}"]
                       + args, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    if ok:
        assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    return r


def _cli_cases(t):
    """Per CLI: its arguments writing under directory `t`, the file it
    writes, and that image's (height, width)."""
    return {
        "generate_grid": (["--n_row", "2", "--n_col", "2", "--output_dir",
                           str(t / "cli_grid"), "--seed", "1"],
                          t / "cli_grid" / "grid.png", (2 * RES + 3,) * 2),
        "generate_mixing_figure": (["--output", str(t / "cli_mix.png"),
                                    "--out_depth", str(OUT_DEPTH)],
                                   t / "cli_mix.png", (RES * 4, RES * 6)),
        "generate_truncation_figure": (["--output", str(t / "cli_tr.png"),
                                        "--out_depth", str(OUT_DEPTH)],
                                       t / "cli_tr.png", (RES * 2, RES * 6)),
        "generate_video": (["--output", str(t / "cli.gif"), "--num_points",
                            "2", "--frames_per_step", "2", "--batch", "3"],
                           t / "cli.gif", (RES, RES)),
    }


@pytest.mark.parametrize("module", ["generate_grid", "generate_mixing_figure",
                                    "generate_truncation_figure",
                                    "generate_video"])
def test_cli_runs_on_cpu(toy, module):
    args, out, shape = _cli_cases(toy.tmp)[module]
    _run(module, ["--config", toy.cfg, "--generator_file", toy.npz,
                  "--device", "cpu"] + args)
    img = Image.open(out)
    assert (img.size[1], img.size[0]) == shape
    assert np.asarray(img.convert("RGB")).std() > 0


@pytest.mark.parametrize("module", [generate_grid, generate_mixing_figure,
                                    generate_truncation_figure,
                                    generate_video],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_cli_refuses_missing_cuda(toy, module, monkeypatch, tmp_path):
    """CUDA is the default device: without it the CLI raises before it
    writes anything, rather than carry on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args, out, _ = _cli_cases(tmp_path)[module.__name__.rsplit(".", 1)[1]]
    args = module.parse_arguments(["--config", toy.cfg, "--generator_file",
                                   toy.npz, "--device", "cuda"] + args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(args)
    assert not out.exists()
