"""The training half of the port's spatial path on the CPU: the
differentiable collectives of stylegan_torch/parallel/halo.py, the split
epilogue's backward (K3-partial, the rank-order sum, K3-apply) of
ops/fused.py, D on slabs of rows, the (data x spatial) train step
(train/steps.py::build_spatial_train_step on a parallel.Mesh2D) and the
trainer's 2-D mesh.

One world of four gloo ranks per module (parallel.spawn;
tests/torch_spatial_train_worker.py imports torch and the port only)
computes everything that needs ranks.  In this module and in the ranks,
the warning autograd gives when it passes a gradient through a collective
that has no backward ("an autograd kernel was not registered") is an
error, so that a collective whose transpose is missing fails loudly.

Bars: the collectives and D against the unsplit ops in float64 at 1e-12;
the split epilogue's plain versions at the op-level 1e-5 / 1e-4 in float32
and 1e-12 in float64; the step against the one-process step in float64 at
1e-8 (tests/test_torch_parallel.py's bar for the data-parallel step), on
the (1 x 2), (2 x 2) and (1 x 4) grids, logistic with R1 (two steps) and
one relativistic-hinge step; against JAX's build_gspmd_train_step on a
(2, 4) mesh of its 8 CPU devices at tests/test_spatial.py's bars (losses
rtol 1e-4, parameters rtol 5e-3 / atol 5e-5, SGD); the trainer on a fixed
(2 x 2) grid against the one-process trainer at rtol 2e-3 / atol 2e-4."""

import json
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
from jax.sharding import Mesh as JaxMesh

import torch_spatial_train_worker as worker
from stylegan_tpu.io.checkpoint import unflatten_like
from stylegan_tpu.models import configs as jcfg
from stylegan_tpu.models import discriminator_init, generator_init
from stylegan_tpu.train import state as jstate
from stylegan_tpu.train import steps as jsteps
from stylegan_torch.convert import (discriminator_state_dict_from_jax_params,
                                    flatten_params,
                                    generator_state_dict_from_jax_params)
from stylegan_torch.losses import _input_grad
from stylegan_torch.models import Discriminator
from stylegan_torch.ops import fused
from stylegan_torch.parallel import Mesh, spawn
from stylegan_torch.parallel import halo
from stylegan_torch.train import build_spatial_train_step, build_train_step
from stylegan_torch.train import create_train_state

pytestmark = pytest.mark.filterwarnings(f"error:.*{worker.UNREGISTERED}")

RES, DEPTH, LATENT = worker.RES, worker.DEPTH, worker.LATENT
BATCH = 4                   # the step's global batch (2 per data row)
JAX_BATCH, JAX_RES = 2, 16  # the JAX comparison's (tests/test_spatial.py)
STEP_LOSSES = (("logistic", 2), ("relativistic-hinge", 1), ("wgan-gp", 1))
TOL = dict(atol=1e-8, rtol=1e-8)
EXACT = dict(atol=1e-12, rtol=1e-12)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _weights(res, dtype, seed=0):
    """JAX params of the toy pair (noise weights, the W-average, the const
    input and its bias random, so that each matters) as flat arrays."""
    jg, jd = worker.toy_configs(jcfg, res=res)
    g = flatten_params(jax.tree_util.tree_map(
        np.asarray, generator_init(jax.random.PRNGKey(seed), jg)))
    rs = np.random.RandomState(seed + 1)
    for k, v in g.items():
        if k.endswith(("noise.weight", "avg_latent", "init_block.const",
                       "init_block.bias")):
            g[k] = 0.3 * rs.randn(*v.shape)
    d = flatten_params(jax.tree_util.tree_map(
        np.asarray, discriminator_init(jax.random.PRNGKey(seed + 2), jd)))
    return ({k: np.asarray(v, dtype) for k, v in g.items()},
            {k: np.asarray(v, dtype) for k, v in d.items()})


def _spec():
    rs = np.random.RandomState(7)
    g, d = _weights(RES, np.float64)
    spec = {"g": g, "d": d, "step_losses": STEP_LOSSES,
            "x": rs.randn(2, 16, 16, 4), "x2": rs.randn(2, 16, 16, 4)}
    for n in worker.SPLITS:
        h = 16 // n
        spec[f"halo_cot_n{n}"] = rs.randn(n, 2, h + 2, 16, 4)
        spec[f"full_cot_n{n}"] = rs.randn(n, 2, 16, 16, 4)
    for res in (8, 16):
        spec[f"images_{res}"] = rs.randn(2, res, res, 3)
    for i in range(2):
        spec[f"reals{i}"] = rs.randn(BATCH, RES, RES, 3)
        spec[f"z{i}"] = rs.randn(BATCH, LATENT)
        spec[f"trainer_reals{i}"] = rs.randn(BATCH, RES, RES, 3).astype(
            np.float32)
    spec["labels"] = rs.randint(0, 3, BATCH)
    jg, jd = _weights(JAX_RES, np.float32, seed=10)
    spec["jax_res"] = JAX_RES
    spec["jax"] = {
        "g": jg, "d": jd,
        "reals": rs.randn(JAX_BATCH, JAX_RES, JAX_RES, 3).astype(np.float32),
        "z": rs.randn(JAX_BATCH, LATENT).astype(np.float32),
        "noises": [rs.randn(JAX_BATCH, 2 ** (i // 2 + 2), 2 ** (i // 2 + 2),
                            1).astype(np.float32)
                   for i in range(2 * (JAX_RES.bit_length() - 2))]}
    return spec


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the module's one world; returns (spec, results, the ranks'
    deep-tail records)."""
    spec = _spec()
    tmp = tmp_path_factory.mktemp("torch_spatial_train")
    spawn(worker.world, worker.WORLD, (spec, str(tmp)), device="cpu",
          timeout=120, join_timeout=400)
    with np.load(tmp / "spatial_train.npz", allow_pickle=False) as f:
        results = dict(f)
    tails = [json.loads((tmp / f"tail_rank{r}.json").read_text())
             for r in range(worker.WORLD)]
    shutil.rmtree(tmp)
    return spec, results, tails


# ---------------------------------------------------------- collectives --

def _unsplit_vjps(spec, n):
    """The unsplit ops' VJPs on the whole plane: the halo rows of every
    slab (rows of the zero-padded plane), their second derivative, every
    rank holding the whole plane (gather_rows), and each rank's rows of
    its own copy (take_rows, zero elsewhere)."""
    x = torch.from_numpy(spec["x"])
    h = x.shape[1] // n
    pad = torch.nn.functional.pad

    def halos(t):
        p = pad(t, (0, 0, 0, 0, 1, 1))
        return torch.stack([p[:, r * h:(r + 1) * h + 2] for r in range(n)])

    cot = torch.from_numpy(spec[f"halo_cot_n{n}"])
    xg = x.clone().requires_grad_(True)
    (halos(xg) * cot).sum().backward()
    want = {"halo": xg.grad}
    xg = x.clone().requires_grad_(True)
    (g1,) = torch.autograd.grad((halos(xg).pow(3) * cot).sum(), xg,
                                create_graph=True)
    (g1.square() * torch.from_numpy(spec["x2"])).sum().backward()
    want["halo_second"] = xg.grad
    full = torch.from_numpy(spec[f"full_cot_n{n}"])
    want["gather"] = full.sum(0)
    take = torch.zeros_like(full)
    for r in range(n):
        take[r, :, r * h:(r + 1) * h] = full[r, :, r * h:(r + 1) * h]
    want["take"] = take
    return want


@pytest.mark.parametrize("op", ["halo", "halo_second", "gather", "take"])
@pytest.mark.parametrize("n", worker.SPLITS)
def test_collective_gradients_match_unsplit(world, n, op):
    """exchange_halo (first and second derivative), gather_rows and
    take_rows under autograd over n ranks: each rank's gradient rows equal
    the unsplit op's, float64."""
    spec, results, _ = world
    got = results[f"{op}_n{n}"]
    want = _unsplit_vjps(spec, n)[op].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **EXACT)


def test_functional_collective_warns_without_a_backward():
    """The rule this module turns into an error: the functional all-reduce
    under autograd has no backward of its own.  halo.psum records its
    transpose instead (one rank here: its gradient is the identity's).
    Autograd gives that warning once per process, so the all-reduce's
    backward runs in a fresh one (worker.functional_collective_warnings),
    whatever this process ran before."""
    from stylegan_torch.parallel import initialize_distributed
    from stylegan_torch.parallel.distributed import _free_port
    initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cpu",
                           timeout=60)
    try:
        ctx = halo.SpatialContext(1, torch.tensor(0))
        x = torch.randn(3, dtype=torch.float64, requires_grad=True)
        (g,) = torch.autograd.grad(halo.psum(x, ctx).pow(2).sum(), x,
                                   create_graph=True)
        (gg,) = torch.autograd.grad(g.sum(), x)
        assert torch.equal(gg, torch.full_like(x, 2.0))
    finally:
        torch.distributed.destroy_process_group()
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    code = ("import json, sys\n"
            "sys.path.insert(0, 'tests')\n"
            "import torch_spatial_train_worker as w\n"
            "print(json.dumps(w.functional_collective_warnings()))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    messages = json.loads(r.stdout.strip().splitlines()[-1])
    assert any(worker.UNREGISTERED in m for m in messages), messages


# ------------------------------------------------ the split epilogue's VJP --

def _epilogue_inputs(dtype, res=16, c=8, batch=2):
    rs = np.random.RandomState(res + c + 1)
    return [torch.from_numpy(a).to(dtype) for a in (
        rs.randn(batch, res, res, c) + 0.5, 0.5 * rs.randn(c),
        rs.randn(batch, res, res, 1), 0.5 * rs.randn(batch, 2 * c),
        rs.randn(batch, res, res, c))]


def _split_vjp(x, nw, noise, style, g, n):
    """K3 split over n slabs of one plane in one process, with the plain
    versions: K1-partial per slab and the merged (mean, rstd), then each
    slab's K3-partial, the rank-order sum and each slab's K3-apply."""
    xs, ns, gs = (t.chunk(n, dim=1) for t in (x, noise, g))
    rows = xs[0].shape[1] * xs[0].shape[2]
    mean, rstd = fused.split_moments(torch.stack([
        fused._reference_partial(a, nw, b) for a, b in zip(xs, ns)]), rows)
    saved = torch.stack([mean, rstd], -1)
    partial = [fused._reference_backward_partial(gg, a, nw, b, saved)
               for gg, a, b in zip(gs, xs, ns)]
    merged = partial[0][0]
    for sums, _ in partial[1:]:
        merged = merged + sums
    apply = [fused._reference_backward_apply(gg, a, nw, b, style, saved,
                                             merged, n * rows,
                                             [True, True, True])
             for gg, a, b in zip(gs, xs, ns)]
    return merged, partial, apply


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n", [2, 4])
def test_split_backward_plain_matches_unsplit(n, dtype):
    """The merged sums equal the whole plane's; each slab's dx and dnoise
    its rows of _reference_epilogue_vjp's; the slabs' dnoise_weight and
    dstyle shares sum to the whole: 1e-5 / 1e-4 in float32, 1e-12 in
    float64."""
    x, nw, noise, style, g = _epilogue_inputs(dtype)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else EXACT
    merged, partial, apply = _split_vjp(x, nw, noise, style, g, n)
    dx, dnw, dn, dstyle = fused._reference_epilogue_vjp(x, nw, noise, style,
                                                         g)
    y = torch.where(x + nw * noise < 0, (x + nw * noise) * 0.2,
                    x + nw * noise)
    centred = y - y.mean((1, 2), keepdim=True)
    whole = torch.stack([g.sum((1, 2)), (g * centred).sum((1, 2))], -1)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), **tol)
    np.testing.assert_allclose(torch.cat([a[0] for a in apply], 1).numpy(),
                               dx.numpy(), **tol)
    np.testing.assert_allclose(torch.cat([a[2] for a in apply], 1).numpy(),
                               dn.numpy(), **tol)
    np.testing.assert_allclose(sum(a[1] for a in apply).numpy(),
                               dnw.numpy(), **tol)
    np.testing.assert_allclose(sum(p[1] for p in partial).numpy(),
                               dstyle.numpy(), **tol)


@pytest.mark.parametrize("n", [2, 4])
def test_split_epilogue_op_fakes(n):
    """The split backward ops' fakes give the kernels' output shapes and
    dtypes, and refuse what the kernels refuse."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from stylegan_torch.ops.kernels import epilogue as kern
    x, nw, noise, style, g = _epilogue_inputs(torch.float32, res=4 * n)
    saved = torch.zeros(2, 8, 2)
    with FakeTensorMode() as mode:
        fx, fnw, fn, fs, fg, fsaved = (mode.from_tensor(t) for t in (
            x, nw, noise, style, g, saved))
        sums, dstyle = kern.epilogue_backward_partial_op(fg, fx, fnw, fn,
                                                         fsaved)
        assert sums.shape == (2, 8, 2) and dstyle.shape == (2, 16)
        grads = kern.epilogue_backward_apply_op(
            fg, fx, fnw, fn, fs, fsaved, sums, n * 16 * n * 4,
            [True, True, False])
        assert [tuple(t.shape) for t in grads] == [tuple(x.shape), (8,)]
        with pytest.raises(ValueError, match="saved"):
            kern.epilogue_backward_partial_op(fg, fx, fnw, fn, fsaved[:1])


# ---------------------------------------------------------------- D slabs --

@pytest.mark.parametrize("n,depth", [(2, DEPTH), (2, DEPTH - 1),
                                     (4, DEPTH)])
def test_discriminator_on_slabs_matches_unsplit(world, n, depth):
    """D's scores from each rank's rows (every rank gets them whole) and
    R1's input gradient rows (seeded 1/n on each rank), gathered, against
    the unsplit D in float64, at depth 2 (alpha 1) and depth 1 (alpha 0.5:
    both fade branches on slabs; 8^2 does not split over 4)."""
    spec, results, _ = world
    res = 2 ** (depth + 2)
    _, td = worker.toy_configs()
    dis = Discriminator(td).double()
    dis.load_state_dict(discriminator_state_dict_from_jax_params(spec["d"]),
                        strict=True)
    alpha = 1.0 if depth == DEPTH else 0.5
    images = torch.from_numpy(spec[f"images_{res}"])

    def fn(t):
        return dis(t, depth, alpha)
    with torch.no_grad():
        scores = fn(images)
    np.testing.assert_allclose(results[f"scores_d{depth}_n{n}"],
                               scores.numpy(), **EXACT)
    np.testing.assert_allclose(results[f"r1_d{depth}_n{n}"],
                               _input_grad(fn, images).detach().numpy(),
                               **EXACT)


@pytest.mark.parametrize("n", worker.SPLITS)
def test_spatial_sample_fn_train_semantics(world, n):
    """build_spatial_sample_fn(train_semantics=True) over n ranks (style
    mixing and the W-average's update from the seed, as the step's G
    forwards draw them), gathered, against the one-process train-mode
    forward on the same seed: tests/test_spatial.py's bar."""
    spec, results, _ = world
    _, _, gen, _ = worker.models(spec, torch.float32)
    with torch.no_grad():
        want = gen(torch.from_numpy(spec["z0"]).float(), DEPTH, 1.0, seed=5,
                   train=True).images
    np.testing.assert_allclose(results[f"train_samples_n{n}"], want.numpy(),
                               rtol=1e-3, atol=1e-4)


# ------------------------------------------------------ the 2-D train step --

def _one_process_steps(spec):
    """The one-process float64 step on the global batches, from the same
    weights and seeds: {loss: [state arrays and losses after each step]}."""
    tg, td = worker.toy_configs()
    out = {}
    for loss, n_steps in STEP_LOSSES:
        _, _, gen, dis = worker.models(spec)
        state = create_train_state(gen, dis)
        step = build_train_step(tg, td, depth=DEPTH, loss=loss)
        out[loss] = []
        for i in range(n_steps):
            _, m = step(state, torch.from_numpy(spec[f"reals{i}"]),
                        torch.from_numpy(spec[f"z{i}"]), 10 + i,
                        torch.tensor(0.5, dtype=torch.float64))
            arrays = worker.state_arrays(state)
            arrays.update(d_loss=m["d_loss"].numpy(),
                          g_loss=m["g_loss"].numpy())
            out[loss].append(arrays)
    tg, td, gen, dis = worker.conditional_models()
    state = create_train_state(gen, dis)
    step = build_train_step(tg, td, depth=DEPTH, loss="conditional-loss",
                            conditional=True)
    _, m = step(state, torch.from_numpy(spec["reals0"]),
                torch.from_numpy(spec["z0"]), 10,
                torch.tensor(0.5, dtype=torch.float64),
                torch.from_numpy(spec["labels"]))
    arrays = worker.state_arrays(state)
    arrays.update(d_loss=m["d_loss"].numpy(), g_loss=m["g_loss"].numpy())
    out["conditional"] = [arrays]
    return out


@pytest.fixture(scope="module")
def one_process(world):
    return _one_process_steps(world[0])


@pytest.mark.parametrize("loss,step", [("logistic", 0), ("logistic", 1),
                                       ("relativistic-hinge", 0),
                                       ("wgan-gp", 0), ("conditional", 0)])
@pytest.mark.parametrize("grid", worker.GRIDS,
                         ids=[f"{d}x{s}" for d, s in worker.GRIDS])
def test_grid_step_matches_one_process(world, one_process, grid, loss, step):
    """build_spatial_train_step on a (data x spatial) grid of gloo ranks,
    each on its shard and rows, the draws (noise, style mixing, wgan-gp's
    interpolates) from the seed: the losses and every parameter, buffer
    (the W-average) and EMA weight of rank 0 against the one-process step
    on the global batch, float64 at 1e-8; logistic carries R1, wgan-gp the
    gradient penalty (its squared norms summed over the row), and a
    conditional model (3 classes, seeded init) D's label planes on
    slabs."""
    _, results, _ = world
    want = one_process[loss][step]
    tag = f"grid{grid[0]}x{grid[1]}/{loss}_s{step}/"
    for name, ref in want.items():
        np.testing.assert_allclose(results[tag + name], ref, err_msg=name,
                                   **TOL)


# ------------------------------------------------ against JAX's GSPMD step --

def test_grid_step_matches_jax_gspmd_step(world, monkeypatch):
    """The (2 x 2) grid's float32 step against JAX's build_gspmd_train_step
    on a (2, 4) mesh of its 8 CPU devices: logistic with R1, SGD(0.01), the
    same weights and reals, the noise maps pinned on both sides (JAX's
    generator_apply wrapped here) and style mixing off, at
    tests/test_spatial.py's bars."""
    spec, results, _ = world
    js = spec["jax"]
    jg_cfg, jd_cfg = worker.toy_configs(jcfg, style_mixing_prob=0.0,
                                        res=JAX_RES)
    noises = [jnp.asarray(n) for n in js["noises"]]
    apply = jsteps.generator_apply

    def pinned(*args, **kwargs):
        kwargs["noises"] = noises
        return apply(*args, **kwargs)
    monkeypatch.setattr(jsteps, "generator_apply", pinned)
    g_params = unflatten_like(generator_init(jax.random.PRNGKey(0), jg_cfg),
                              js["g"], partial=False)
    d_params = unflatten_like(
        discriminator_init(jax.random.PRNGKey(1), jd_cfg), js["d"],
        partial=False)
    g_tx, d_tx = optax.sgd(0.01), optax.sgd(0.01)
    state = jstate.create_train_state(g_params, d_params, g_tx, d_tx,
                                      use_ema=True)
    mesh = JaxMesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                   ("data", "spatial"))
    step = jsteps.build_gspmd_train_step(
        jg_cfg, jd_cfg, g_tx, d_tx, depth=JAX_RES.bit_length() - 3,
        mesh=mesh, loss="logistic", donate=False)
    new, m = step(state, jnp.asarray(js["reals"]), jnp.asarray(js["z"]),
                  jax.random.PRNGKey(14), jnp.float32(0.7))
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(results[f"jax/{k}"], float(m[k]),
                                   rtol=1e-4, err_msg=k)
    for label, tree, bridge in (
            ("G", new.g_params, generator_state_dict_from_jax_params),
            ("D", new.d_params, discriminator_state_dict_from_jax_params),
            ("shadow", new.g_shadow, generator_state_dict_from_jax_params)):
        want = bridge(flatten_params(jax.tree_util.tree_map(np.asarray,
                                                            tree)))
        for name, ref in want.items():
            np.testing.assert_allclose(results[f"jax/{label}/{name}"],
                                       ref.numpy(), rtol=5e-3, atol=5e-5,
                                       err_msg=f"{label} {name}")


# ---------------------------------------------------------------- refusals --

@pytest.mark.parametrize("case", ["one_d_mesh", "too_many_shards", "scope"])
def test_spatial_step_rejects_bad_mesh(case):
    """JAX's words where it asserts (test_gspmd_step_rejects_bad_mesh): a
    mesh without both axes, a resolution that does not split 4 rows a
    rank, an unknown minibatch-stddev scope."""
    from stylegan_torch.parallel import Mesh2D
    tg, td = worker.toy_configs()
    grid = Mesh(8, 0, None)
    mesh2d = Mesh2D((1, 8), grid, Mesh(1, 0, None), Mesh(8, 0, None))
    if case == "one_d_mesh":
        with pytest.raises(ValueError, match="spatial"):
            build_spatial_train_step(tg, td, depth=DEPTH, mesh=grid)
    elif case == "too_many_shards":
        with pytest.raises(ValueError, match="spatial shards"):
            build_spatial_train_step(tg, td, depth=DEPTH, mesh=mesh2d)
    else:
        mesh = Mesh2D((1, 2), Mesh(2, 0, None), Mesh(1, 0, None),
                      Mesh(2, 0, None))
        with pytest.raises(ValueError, match="mbstd_scope"):
            build_spatial_train_step(tg, td, depth=DEPTH, mesh=mesh,
                                     mbstd_scope="host")


# ------------------------------------------------------------- the trainer --

def test_trainer_fixed_2d_mesh_matches_single_device(world):
    """StyleGAN(mesh=a (2 x 2) grid): two train_on_batch steps, each rank
    on its data row's shard, against the one-process trainer on the global
    batch (rtol 2e-3, atol 2e-4, as the JAX test); the step is the spatial
    one; optimize_discriminator refuses the 2-D mesh naming
    train_on_batch, and a batch the data axis does not divide is refused
    naming it."""
    spec, results, _ = world
    single = worker._trainer()
    ref = [single.train_on_batch(spec[f"trainer_reals{i}"], depth=DEPTH,
                                 alpha=0.5) for i in range(2)]
    got = [results[f"trainer_losses{i}"] for i in range(2)]
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-3,
                               atol=2e-4)
    assert any("spatial" in str(k) for k in results["trainer_keys"])
    assert "train_on_batch" in str(results["refusal_optimize"])
    assert "data axis" in str(results["refusal_batch"])


def test_spatial_devices_deep_tail(world):
    """StyleGAN(max_devices=4, spatial_devices=4).train over a world of 4
    at global batches 8, 16, 2: depth 0 on a data group of 2 (4^2 does not
    split; ranks 2 and 3 sit it out), depth 1 on the data axis filled by 4
    (the 1-D group kept), depth 2 at batch 2 on a (1 x 4) grid; finite
    weights."""
    _, results, tails = world
    assert tails[0] == [[0, 2], [1, 4], [2, 1, 4]]
    assert tails[1] == tails[0]
    for t in tails[2:]:
        assert t == [[1, 4], [2, 1, 4]]
    assert bool(results["tail_finite"])
