"""The port's spatial serving path (stylegan_torch/parallel/spatial.py and
halo.py, the split epilogue of ops/fused.py, the slab ops of ops/linear.py
and ops/primitives.py, the spatial forward of models/synthesis.py and the
spatial artifact of serving.py) on the CPU.

One world of four gloo ranks per module (parallel.spawn;
tests/torch_spatial_worker.py imports torch and the port only) computes
everything that needs ranks: the halo exchange and the slab ops, the
forward split over 4 and over 2 ranks, bf16 through 2 ranks, and the
exported 2-rank artifact.  The test holds it to the unsplit ops, to the
port's one-process forward and, on pinned noise maps, to the JAX package's
H-sharded forward over a 2- or 4-device mesh, at JAX's bar for the
spatial path (rtol=1e-3, atol=1e-4, tests/test_spatial.py).  The toy model
is tests/test_spatial.py's, with weights from JAX params."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

import torch_spatial_worker as worker
from stylegan_tpu.io.checkpoint import unflatten_like
from stylegan_tpu.models import configs as jcfg
from stylegan_tpu.models import generator_apply, generator_init
from stylegan_tpu.ops import fused as jfused
from stylegan_tpu.parallel import spatial as jspatial
from stylegan_torch.convert import (flatten_params,
                                    generator_state_dict_from_jax_params,
                                    save_generator_file)
from stylegan_torch.models import Generator
from stylegan_torch.models.synthesis import layer_resolution
from stylegan_torch.ops import blur2d, conv2d_apply, fused, instance_norm
from stylegan_torch.parallel import (Mesh, build_spatial_sample_fn,
                                     create_spatial_mesh,
                                     initialize_distributed, spawn,
                                     spatial_hbm_estimate)
from stylegan_torch.parallel import halo
from stylegan_torch.serving import (export_generator, load_exported,
                                    make_serving_fn)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, DEPTH, LATENT = worker.RES, worker.DEPTH, worker.LATENT
N_LAYERS = 2 * (DEPTH + 1)
BATCH, SEED = 2, 11
SPATIAL_TOL = dict(rtol=1e-3, atol=1e-4)      # tests/test_spatial.py


def _params():
    """JAX params of the toy model, noise weights made non-zero (they init
    to zero), and the port's state_dict of them."""
    params = generator_init(jax.random.PRNGKey(0), worker.toy_config(jcfg))
    flat = flatten_params(jax.tree_util.tree_map(np.asarray, params))
    rs = np.random.RandomState(0)
    for k, v in flat.items():
        if k.endswith("noise.weight"):
            flat[k] = (0.5 * rs.randn(*v.shape)).astype(np.float32)
    state = {k: np.asarray(v) for k, v in
             generator_state_dict_from_jax_params(flat).items()}
    return unflatten_like(params, flat, partial=False), state


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the module's one world; returns (spec, results, JAX params)."""
    params, state = _params()
    rs = np.random.RandomState(1)
    gen = worker.generator(state)
    spec = {
        "state_dict": state, "seed": SEED,
        "z": rs.randn(BATCH, LATENT).astype(np.float32),
        "noises": [rs.randn(BATCH, layer_resolution(i), layer_resolution(i),
                            1).astype(np.float32) for i in range(N_LAYERS)],
        "x": rs.randn(BATCH, 16, 16, 8).astype(np.float32),
        "w": rs.randn(8, 8, 3, 3).astype(np.float32),
        "bias": rs.randn(8).astype(np.float32),
        "blur": np.outer([1., 2., 1.], [1., 2., 1.]).astype(np.float32) / 16,
        "nw": (0.5 * rs.randn(8)).astype(np.float32),
        "style": (0.5 * rs.randn(BATCH, 16)).astype(np.float32),
        "noise": rs.randn(BATCH, 16, 16, 1).astype(np.float32),
        "cot": rs.randn(BATCH, 16, 16, 8).astype(np.float32),
        "artifact": export_generator(worker.toy_config(), gen, depth=DEPTH,
                                     batch_size=BATCH, spatial_devices=2),
    }
    tmp = tmp_path_factory.mktemp("torch_spatial")
    spawn(worker.world, worker.WORLD, (spec, str(tmp)), device="cpu",
          timeout=120, join_timeout=300)
    path = tmp / "spatial.npz"
    with np.load(path) as f:
        results = dict(f)
    os.remove(path)
    return spec, results, params


def _one_process(spec, **kw):
    """The port's unsplit forward of spec's request."""
    gen = worker.generator(spec["state_dict"])
    with torch.inference_mode():
        return gen(torch.from_numpy(spec["z"]).to(kw.pop("dtype",
                                                         torch.float32)),
                   depth=DEPTH, alpha=1.0, **kw).images.float().numpy()


# ------------------------------------------------------ the split epilogue --

def _epilogue_inputs(dtype, res=16, c=8, batch=BATCH):
    rs = np.random.RandomState(res + c)
    return [torch.from_numpy(a).to(dtype) for a in (
        rs.randn(batch, res, res, c) + 0.5, 0.5 * rs.randn(c),
        rs.randn(batch, res, res, 1), 0.5 * rs.randn(batch, 2 * c))]


def _split_plain(x, nw, noise, style, n):
    """The split epilogue with its plain versions, the n slabs in one
    process: K1-partial per slab, the rank-order merge, K2-apply per
    slab."""
    xs, ns = x.chunk(n, dim=1), noise.chunk(n, dim=1)
    parts = torch.stack([fused._reference_partial(a, nw, b)
                         for a, b in zip(xs, ns)])
    stats = fused.split_stats(parts, xs[0].shape[1] * xs[0].shape[2], style)
    return torch.cat([fused._reference_apply(a, nw, b, style, stats)
                      for a, b in zip(xs, ns)], dim=1)


@pytest.mark.parametrize("n", [2, 4])
def test_split_plain_epilogue_matches_unsplit_and_jax(n):
    """float32: the split plain versions against the unsplit one and
    against the JAX package's fused_epilogue on the same inputs, 1e-5."""
    x, nw, noise, style = _epilogue_inputs(torch.float32)
    got = _split_plain(x, nw, noise, style, n).numpy()
    np.testing.assert_allclose(
        got, fused._reference_epilogue(x, nw, noise, style).numpy(),
        rtol=1e-5, atol=1e-5)
    want = jfused.fused_epilogue(*(jnp.asarray(t.numpy())
                                   for t in (x, nw, noise, style)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_split_plain_epilogue_float64(n):
    """float64 against float64: the merge loses nothing beyond roundoff."""
    x, nw, noise, style = _epilogue_inputs(torch.float64)
    np.testing.assert_allclose(
        _split_plain(x, nw, noise, style, n).numpy(),
        fused._reference_epilogue(x, nw, noise, style).numpy(),
        rtol=1e-12, atol=1e-12)


def test_merge_moments_in_rank_order():
    """Chan's merge of slabs' (mean, M2) gives the plane's mean and M2,
    and merging the same parts twice gives the same bits."""
    y = torch.from_numpy(np.random.RandomState(5).randn(2, 8, 4, 3))
    parts = torch.stack([fused.moments(s) for s in y.chunk(4, dim=1)])
    mean, m2, count = fused.merge_moments(parts, 2 * 4)
    assert count == 8 * 4
    np.testing.assert_allclose(mean.numpy(), y.mean((1, 2)).numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        m2.numpy(), ((y - y.mean((1, 2), keepdim=True)) ** 2).sum((1, 2))
        .numpy(), rtol=1e-12, atol=1e-12)
    again = fused.merge_moments(parts, 2 * 4)
    assert torch.equal(again[0], mean) and torch.equal(again[1], m2)


@pytest.mark.parametrize("n", worker.MESHES)
def test_split_epilogue_refuses_a_gradient(world, n):
    """Now a gradient: the split epilogue under autograd over n ranks (its
    backward K3-partial, the rank-order sum, K3-apply; plain versions on
    the CPU) gives each rank its rows of the unsplit dx and its shares of
    dnoise_weight and dstyle, which sum over the ranks to the unsplit
    ones: 1e-5 / 1e-4 in float32, 1e-12 in float64."""
    spec, results, _ = world
    for tag, dtype, tol in (("float32", torch.float32,
                             dict(rtol=1e-4, atol=1e-5)),
                            ("float64", torch.float64,
                             dict(rtol=1e-12, atol=1e-12))):
        x, nw, noise, style, cot = (torch.from_numpy(spec[k]).to(dtype)
                                    for k in ("x", "nw", "noise", "style",
                                              "cot"))
        dx, dnw, _, dstyle = fused._reference_epilogue_vjp(x, nw, noise,
                                                           style, cot)
        np.testing.assert_allclose(results[f"epilogue_dx_{tag}_n{n}"],
                                   dx.numpy(), **tol)
        for name, want in (("dnw", dnw), ("dstyle", dstyle)):
            shares = results[f"epilogue_{name}_{tag}_n{n}"]
            assert shares.shape == (n,) + tuple(want.shape)
            np.testing.assert_allclose(shares.sum(0), want.numpy(), **tol)


# ------------------------------------------------------ halos and slab ops --

@pytest.mark.parametrize("n", worker.MESHES)
def test_exchange_halo_gives_neighbour_rows(world, n):
    """Each rank's slab between its neighbours' edge rows, zero rows past
    the image's top and bottom: exactly the rows of the zero-padded
    plane."""
    spec, results, _ = world
    for tag, dtype in (("float32", np.float32), ("float64", np.float64)):
        x = spec["x"].astype(dtype)
        padded = np.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0)))
        h = x.shape[1] // n
        got = results[f"halo_{tag}_n{n}"]
        assert got.shape == (n, BATCH, h + 2) + x.shape[2:]
        for r in range(n):
            np.testing.assert_array_equal(got[r], padded[:, r * h:
                                                         (r + 1) * h + 2])


@pytest.mark.parametrize("op", ["conv", "up_nearest", "up_subpixel", "blur",
                                "instance_norm"])
@pytest.mark.parametrize("n", worker.MESHES)
def test_slab_ops_match_unsplit(world, n, op):
    """The 3x3 conv, the upscale conv below the fused threshold (nearest,
    conv, blur), the sub-pixel upscale and the blur on slabs with halos,
    and the instance norm on slabs with merged statistics, gathered,
    against the unsplit ops: 1e-6 in float32; in float64 to roundoff, and
    the blur (the same taps in the same order) exactly."""
    spec, results, _ = world
    for tag, dtype, tol in (("float32", torch.float32, 1e-6),
                            ("float64", torch.float64, 1e-13)):
        x, w, bias, k = (torch.from_numpy(spec[key]).to(dtype)
                         for key in ("x", "w", "bias", "blur"))
        with torch.no_grad():
            want = {
                "conv": lambda: conv2d_apply(x, w, bias),
                "up_nearest": lambda: conv2d_apply(x, w, bias, upscale=True,
                                                   blur_kernel=k),
                "up_subpixel": lambda: conv2d_apply(
                    x, w, bias, upscale=True, blur_kernel=k,
                    fused_resample_threshold=8),
                "blur": lambda: blur2d(x, k),
                "instance_norm": lambda: instance_norm(x),
            }[op]().numpy()
        got = results[f"{op}_{tag}_n{n}"]
        assert got.shape == want.shape
        if op == "blur" and tag == "float64":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ------------------------------------------------------- the split forward --

@pytest.mark.parametrize("n", worker.MESHES)
def test_spatial_matches_one_process(world, n):
    """build_spatial_sample_fn over n gloo ranks, gathered, against the
    port's one-process forward on the same seed (the same noise draws):
    JAX's spatial bar."""
    spec, results, _ = world
    np.testing.assert_allclose(results[f"seeded_n{n}"],
                               _one_process(spec, seed=SEED), **SPATIAL_TOL)


@pytest.mark.parametrize("n", worker.MESHES)
def test_spatial_matches_jax_sharded_forward(world, n):
    """On pinned noise maps: the port's split forward against the JAX
    package's generator_apply jitted with build_spatial_sample_fn's
    out-sharding over its create_spatial_mesh(n), JAX's spatial bar."""
    spec, results, params = world
    mesh = jspatial.create_spatial_mesh(n)
    out_sh = NamedSharding(mesh, PartitionSpec(None, jspatial.SPATIAL_AXIS,
                                               None, None))
    cfg = worker.toy_config(jcfg)

    def fn(p, z, noises):
        images = generator_apply(cfg, p, z, depth=DEPTH, alpha=1.0,
                                 rng=jax.random.PRNGKey(0), train=False,
                                 noises=noises).images
        return jax.lax.with_sharding_constraint(images, out_sh)

    want = jax.jit(fn, out_shardings=out_sh)(
        params, jnp.asarray(spec["z"]),
        [jnp.asarray(a) for a in spec["noises"]])
    assert len(want.sharding.device_set) == n
    np.testing.assert_allclose(results[f"pinned_n{n}"], np.asarray(want),
                               **SPATIAL_TOL)


def test_bf16_two_ranks_within_drift_bar(world):
    """bf16 activations through 2 ranks against the one-process bf16
    forward on the same seed, at tests/test_bf16.py's drift bar: mean |d|
    under 0.02 and max under 0.25 of the image's span."""
    spec, results, _ = world
    want = _one_process(spec, seed=SEED, dtype=torch.bfloat16)
    got = results["bf16_n2"]
    d = np.abs(got - want)
    span = float(want.max() - want.min())
    assert d.mean() < 0.02 * span, (d.mean(), span)
    assert d.max() < 0.25 * span, (d.max(), span)


@pytest.mark.parametrize("n,first", [(1, None), (2, 8), (4, 16), (8, 32)])
def test_first_split_stage(n, first):
    """Stages of side >= 4n split (at least 4 rows a rank); shorter ones
    run whole, as GSynthesis.forward's docstring says: 8x8 first for n=2,
    16x16 for n=4.  One rank runs unsplit (no context at all)."""
    ctx = None if n == 1 else halo.SpatialContext(n, torch.tensor(0))
    split = [res for res in (4, 8, 16, 32, 64, 128) if halo.splits(res, ctx)]
    assert (split[0] if split else None) == first


@pytest.fixture
def world_of_one():
    from stylegan_torch.parallel.distributed import _free_port
    initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cpu",
                           timeout=60)
    yield
    torch.distributed.destroy_process_group()


def test_one_rank_mesh_is_make_serving_fn(world_of_one):
    """A spatial mesh of one rank runs the unsplit forward: bitwise equal
    to make_serving_fn on the same (z, seed)."""
    _, state = _params()
    gen = worker.generator(state)
    z = torch.from_numpy(np.random.RandomState(2).randn(BATCH, LATENT)
                         .astype(np.float32))
    mesh = create_spatial_mesh(1)
    assert mesh.axis_name == "spatial" and mesh.size == 1
    got = build_spatial_sample_fn(gen.cfg, gen, mesh, depth=DEPTH)(z, SEED)
    want = make_serving_fn(gen.cfg, gen, depth=DEPTH, device="cpu")(z, SEED)
    assert torch.equal(got, want)


# ----------------------------------------------------- the spatial artifact --

def test_exported_artifact_is_the_live_spatial_fn(world):
    """The 2-rank artifact (exported in this one process), loaded on two
    gloo ranks: each rank's rows bitwise equal to the live spatial fn's,
    a request served twice bitwise equal, and the gathered image within
    the spatial bar of the one-process forward."""
    spec, results, _ = world
    assert bool(results["artifact_is_live_n2"])
    np.testing.assert_array_equal(results["artifact_n2"],
                                  results["seeded_n2"])
    np.testing.assert_allclose(results["artifact_n2"],
                               _one_process(spec, seed=SEED), **SPATIAL_TOL)


def test_artifact_holds_its_collectives_and_rank_input():
    """The program's collectives are _c10d_functional all-reduces, its rank
    an input, its epilogue the split ops; the meta records N."""
    _, state = _params()
    gen = worker.generator(state)
    blob = export_generator(gen.cfg, gen, depth=DEPTH, batch_size=BATCH,
                            spatial_devices=2)
    ep = torch.export.load(io.BytesIO(blob))
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert torch.ops._c10d_functional.all_reduce.default in targets
    split = [t for t in targets if t in (
        torch.ops.stylegan_torch.epilogue_partial.default,
        torch.ops.stylegan_torch.epilogue_apply.default)]
    # 64^2 over 2 ranks: the 4x4 stage whole (2 calls), 4 stages split
    assert len(split) == 2 * 8
    assert targets.count(torch.ops.stylegan_torch.epilogue.default) == 2
    names = [s.arg.name for s in ep.graph_signature.input_specs
             if s.kind.name == "USER_INPUT"]
    assert "rank" in names


# ------------------------------------------------------------- refusals --

def _toy_mesh(n):
    return Mesh(size=n, rank=0, group=None, axis_name="spatial")


@pytest.mark.parametrize("case", ["too_many_shards", "conditional",
                                  "world_short"])
def test_spatial_refusals(case):
    """What the JAX package refuses, with its words: a resolution that does
    not divide by 4n (16 over 8), a conditional model; and an N-rank
    artifact loaded where the process group has fewer than N ranks."""
    if case == "too_many_shards":
        cfg = worker.toy_config()
        gen = Generator(cfg)
        with pytest.raises(ValueError, match="spatial shards"):
            build_spatial_sample_fn(cfg, gen, _toy_mesh(8), depth=2)
    elif case == "conditional":
        cfg = worker.toy_config(conditional=True)
        gen = Generator(cfg)
        with pytest.raises(ValueError, match="conditional"):
            build_spatial_sample_fn(cfg, gen, _toy_mesh(2), depth=DEPTH)
    else:
        _, state = _params()
        gen = worker.generator(state)
        blob = export_generator(gen.cfg, gen, depth=DEPTH, batch_size=BATCH,
                                spatial_devices=2)
        with pytest.raises(RuntimeError, match="exported for 2 spatial"):
            load_exported(blob, device="cpu")


@pytest.mark.parametrize("args", [(1024, 16, 8), (1024, 16, 2, 4),
                                  (512, 32, 4), (64, 512, 1, 4)])
def test_spatial_hbm_estimate_matches_jax(args):
    assert spatial_hbm_estimate(*args) == jspatial.spatial_hbm_estimate(*args)


# ---------------------------------------------------------------- the CLI --

def test_export_cli_spatial_check_on_cpu(tmp_path):
    """python -m stylegan_torch.cli.export_generator --spatial_devices 2
    --check --device cpu: exported in one process, checked on two gloo
    ranks that the CLI starts, within the JAX CLI's 1e-3 bar."""
    cfg_path = tmp_path / "toy.yaml"
    cfg_path.write_text("""
structure: 'linear'
model:
  gen:
    mapping_layers: 2
    truncation_psi: 0.7
dataset:
  resolution: 16
""")
    from stylegan_torch.config import get_default_cfg
    from stylegan_torch.models import generator_config_from_cfg
    cfg = get_default_cfg()
    cfg.merge_from_file(str(cfg_path))
    gen = Generator(generator_config_from_cfg(cfg),
                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("noise.weight"):
                p.normal_(0.0, 0.5)
    npz, out = tmp_path / "gen.npz", tmp_path / "gen.pt2"
    save_generator_file(gen, str(npz))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "-m", "stylegan_torch.cli.export_generator",
         "--config", str(cfg_path), "--generator_file", str(npz),
         "--output", str(out), "--batch", "2", "--spatial_devices", "2",
         "--check", "--device", "cpu"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    assert "split over 2 ranks matches" in r.stdout
    for path in (npz, out):
        os.remove(path)
