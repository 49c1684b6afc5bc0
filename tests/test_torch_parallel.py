"""The port's data parallelism (stylegan_torch/parallel/, the mesh= path of
train/steps.py, the adaptive trainer and cli.train --num_devices) on the
CPU: two ranks joined over gloo by the port's own launcher
(parallel.spawn), each rank a process that imports torch and the port only
(tests/torch_parallel_worker.py) and is killed past its test's time limit.

The two-rank step is held to the JAX package's 2-device shard_map step
(conftest.py gives JAX 8 CPU devices) in float64 at the 1e-8 bars of
tests/test_torch_train_steps.py, on its toy model: global batch 4, two rows
per rank, the noise maps and wgan-gp's interpolation eps pinned per rank
(the JAX side's in this test only, through its generator_apply and its
per-shard keys).  It is also held to the port's one-process step on the
global batch, whose chunks=2 minibatch stddev is the ranks' shard-local
statistic."""

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

import torch_parallel_worker as worker
from stylegan_tpu.io.checkpoint import unflatten_like
from stylegan_tpu.models import configs as jcfg
from stylegan_tpu.models import discriminator_init, generator_init
from stylegan_tpu.ops import primitives as jprim
from stylegan_tpu.parallel import mesh as jmesh
from stylegan_tpu.train import state as jstate
from stylegan_tpu.train import steps as jsteps
from stylegan_torch.convert import (discriminator_state_dict_from_jax_params,
                                    flatten_params,
                                    generator_state_dict_from_jax_params)
from stylegan_torch.models import Discriminator, Generator
from stylegan_torch.ops.primitives import minibatch_stddev
from stylegan_torch.parallel import (compatible_mesh_size, create_mesh,
                                     global_shard, initialize_distributed,
                                     spawn)
from stylegan_torch.parallel import mesh as tmesh
from stylegan_torch.train import build_train_step, create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, DEPTH, LATENT, ALPHA = worker.RES, worker.DEPTH, worker.LATENT, 0.5
BATCH, LOCAL = 4, 2
TOL = dict(atol=1e-8, rtol=1e-8)
LIMIT = dict(timeout=120, join_timeout=300)   # seconds per collective, run


def _spawn(fn, *args):
    spawn(fn, 2, args, device="cpu", **LIMIT)


# ------------------------------------------------- mesh sizes and budgets --

class _Cfg(dict):
    __getattr__ = dict.__getitem__


@pytest.mark.parametrize("n,batches", [
    (1, [8]), (2, [8]), (3, [8, 4]), (8, [128, 64, 32, 16, 8, 4, 2]),
    (8, [12]), (6, [9]), (0, [4]), (5, [7, 14])])
def test_compatible_mesh_size_matches_jax(n, batches):
    assert compatible_mesh_size(n, batches) == \
        jmesh.compatible_mesh_size(n, batches)


@pytest.mark.parametrize("cfg,flag", [
    (None, None), (None, 3), ({"data_axis": "auto"}, None),
    ({"data_axis": 2}, None), ({"data_axis": "4"}, None),
    ({"data_axis": 2}, 5), ({}, None)])
def test_resolve_max_devices_matches_jax(monkeypatch, cfg, flag):
    """The flag, then the yaml's parallel.data_axis, then every visible
    device (5 here on both sides)."""
    monkeypatch.setattr(jax, "device_count", lambda: 5)
    monkeypatch.setattr(tmesh, "device_count", lambda device="cuda": 5)
    cfg = None if cfg is None else _Cfg(cfg)
    assert tmesh.resolve_max_devices(cfg, flag) == \
        jmesh.resolve_max_devices(cfg, flag)


def test_create_mesh_and_global_shard():
    """Beyond the world's ranks create_mesh raises, as JAX asserts; a shard
    is this rank's contiguous rows."""
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        create_mesh(2)
    rows = torch.arange(12.0).reshape(6, 2)
    mesh = tmesh.Mesh(size=3, rank=1, group=None)
    assert torch.equal(global_shard(mesh, rows), rows[2:4])
    with pytest.raises(ValueError, match="divide"):
        global_shard(mesh, rows[:4])


@pytest.fixture
def world_of_one():
    """This process as a gloo world of one rank, left again after the
    test."""
    from stylegan_torch.parallel.distributed import _free_port
    initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cpu",
                           timeout=60)
    yield
    torch.distributed.destroy_process_group()


def test_one_rank_mesh_step_is_the_plain_step(world_of_one):
    """A group of one rank: the mesh step (its collectives over one rank)
    gives the one-process step bitwise, draws unpinned and unfolded."""
    tg, td = worker.toy_configs()
    rs = np.random.RandomState(3)
    reals = torch.from_numpy(rs.randn(BATCH, RES, RES, 3).astype(np.float32))
    z = torch.from_numpy(rs.randn(BATCH, LATENT).astype(np.float32))
    out = []
    for mesh in (None, create_mesh(1)):
        state = create_train_state(
            Generator(tg, generator=torch.Generator().manual_seed(0)),
            Discriminator(td, generator=torch.Generator().manual_seed(1)))
        step = build_train_step(tg, td, depth=DEPTH, loss="logistic",
                                mesh=mesh, shard_rng=False)
        _, m = step(state, reals, z, 5, ALPHA)
        out.append((m, worker.state_arrays(state)))
    (m0, a0), (m1, a1) = out
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert a0.keys() == a1.keys()
    assert all(np.array_equal(a0[k], a1[k]) for k in a0)


# ------------------------------------------- two ranks against JAX's mesh --

def _weights():
    """The toy model's float64 weights (JAX init, some leaves randomized as
    in test_torch_train_steps.py) as flat dicts."""
    jg, jd = _jax_configs()
    flat = flatten_params(jax.tree_util.tree_map(
        np.asarray, generator_init(jax.random.PRNGKey(0), jg)))
    rs = np.random.RandomState(1)
    for k, v in flat.items():
        flat[k] = (0.3 * rs.randn(*v.shape) if k.endswith((
            "noise.weight", "avg_latent", "init_block.const",
            "init_block.bias")) else v).astype(np.float64)
    d_flat = {k: v.astype(np.float64) for k, v in flatten_params(
        jax.tree_util.tree_map(np.asarray, discriminator_init(
            jax.random.PRNGKey(1), jd))).items()}
    return flat, d_flat


def _jax_configs():
    tg, td = worker.toy_configs()
    g = jcfg.GeneratorConfig(
        resolution=RES, latent_size=LATENT, dlatent_size=LATENT,
        truncation_psi=tg.truncation_psi, style_mixing_prob=0.0,
        mapping=jcfg.MappingConfig(latent_size=LATENT, dlatent_size=LATENT,
                                   mapping_fmaps=LATENT, mapping_layers=2,
                                   dlatent_broadcast=worker.N_LAYERS),
        synthesis=jcfg.SynthesisConfig(resolution=RES, dlatent_size=LATENT,
                                       fmap_base=128, fmap_max=32,
                                       blur_filter=(1, 2, 1)))
    d = jcfg.DiscriminatorConfig(resolution=RES, fmap_base=128, fmap_max=32,
                                 blur_filter=(1, 2, 1))
    return g, d


def _inputs(steps=2):
    rs = np.random.RandomState(21)
    noises = [rs.randn(BATCH, 2 ** (i // 2 + 2), 2 ** (i // 2 + 2), 1)
              for i in range(worker.N_LAYERS)]
    batches = []
    for i in range(steps):
        rs = np.random.RandomState(100 + i)
        batches.append((rs.randn(BATCH, RES, RES, 3), rs.randn(BATCH, LATENT),
                        10 + i))
    return noises, batches


def _gp_eps(key, rank):
    """The interpolation eps JAX's shard `rank` draws in repeat 0."""
    with jax.enable_x64(True):
        k = jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(key), rank), 0), 0x6B)
        return np.array(jax.random.uniform(k, (LOCAL, 1, 1, 1), jnp.float64))


def _jax_mesh_run(monkeypatch, flat, d_flat, noises, batches, kw):
    """JAX's 2-device shard_map step, each shard's noise pinned to its rows
    of `noises`; the state after each step."""
    jg, jd = _jax_configs()
    with jax.enable_x64(True):
        g_params = unflatten_like(generator_init(
            jax.random.PRNGKey(0), jg, jnp.float64), flat, partial=False)
        d_params = unflatten_like(discriminator_init(
            jax.random.PRNGKey(1), jd, jnp.float64), d_flat, partial=False)
        g_tx, d_tx = jstate.make_g_optimizer(), jstate.make_d_optimizer()
        state = jstate.create_train_state(g_params, d_params, g_tx, d_tx,
                                          use_ema=True)
        pinned_maps = [jnp.asarray(n) for n in noises]
    apply = jsteps.generator_apply

    def pinned(*args, **kwargs):
        i = jax.lax.axis_index("data")
        kwargs["noises"] = [jax.lax.dynamic_slice_in_dim(n, i * LOCAL, LOCAL)
                            for n in pinned_maps]
        return apply(*args, **kwargs)
    monkeypatch.setattr(jsteps, "generator_apply", pinned)
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("data",))
    step = jsteps.build_train_step(jg, jd, g_tx, d_tx, depth=DEPTH,
                                   mesh=mesh, donate=False, **kw)
    out = []
    for reals, z, key in batches:
        with jax.enable_x64(True):
            state, m = step(state, jnp.asarray(reals), jnp.asarray(z),
                            jax.random.PRNGKey(key), jnp.float64(ALPHA))
        out.append((jax.tree_util.tree_map(np.asarray, state),
                    {k: float(v) for k, v in m.items()}))
    return out


def _assert_matches_jax(arrays, jstate_np, metrics):
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(arrays[k], metrics[k], err_msg=k, **TOL)
    for label, tree, bridge in (
            ("G", jstate_np.g_params, generator_state_dict_from_jax_params),
            ("shadow", jstate_np.g_shadow,
             generator_state_dict_from_jax_params),
            ("D", jstate_np.d_params,
             discriminator_state_dict_from_jax_params)):
        want = bridge(tree)
        for name, v in want.items():
            np.testing.assert_allclose(arrays[f"{label}/{name}"], v.numpy(),
                                       err_msg=f"{label} {name}", **TOL)
    for label, opt_state, bridge in (
            ("G", jstate_np.g_opt_state, generator_state_dict_from_jax_params),
            ("D", jstate_np.d_opt_state,
             discriminator_state_dict_from_jax_params)):
        adam, = [s for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            for name, v in bridge(getattr(adam, moment)).items():
                k = f"{label}_adam/{name}/{key}"
                if k in arrays:     # parameters only (not the W-average)
                    np.testing.assert_allclose(
                        arrays[k], v.numpy(), err_msg=k, **TOL)
                    assert int(arrays[f"{label}_adam/{name}/step"]) == \
                        int(adam.count)


def _one_process_run(flat, d_flat, noises, batches, kw, gp_eps,
                     truncation_psi):
    """The port's one-process step on the global batch: the shard-local
    stddev as chunks=2, or the global one as it is."""
    tg, td = worker.toy_configs(truncation_psi)
    gen, dis = Generator(tg).double(), Discriminator(td).double()
    gen.load_state_dict(generator_state_dict_from_jax_params(flat))
    dis.load_state_dict(discriminator_state_dict_from_jax_params(d_flat))
    state = create_train_state(gen, dis)
    kw = dict(kw)
    chunks = 1 if kw.pop("mbstd_scope", None) == "global" else 2
    step = build_train_step(tg, td, depth=DEPTH, mbstd_chunks=chunks, **kw)
    out = []
    for i, (reals, z, key) in enumerate(batches):
        eps = None if gp_eps is None else [
            torch.from_numpy(np.concatenate(gp_eps[i]))]
        _, m = step(state, torch.from_numpy(reals), torch.from_numpy(z), key,
                    ALPHA, noises=[torch.from_numpy(n) for n in noises],
                    gp_eps=eps)
        arrays = worker.state_arrays(state)
        arrays.update(d_loss=m["d_loss"].item(), g_loss=m["g_loss"].item())
        out.append(arrays)
    return out


@pytest.mark.parametrize("kw", [
    {}, {"loss": "logistic"}, {"loss": "wgan-gp"},
    {"loss": "logistic", "mbstd_scope": "global"}],
    ids=["relativistic-hinge", "logistic-r1", "wgan-gp", "mbstd-global"])
def test_two_rank_step_matches_jax_mesh_step(monkeypatch, tmp_path, kw):
    """Two steps: after each, both ranks hold the same bits, and they equal
    JAX's 2-device step (losses, G, D, the shadow, the W-average, Adam's
    moments and counts) at 1e-8."""
    flat, d_flat = _weights()
    noises, batches = _inputs()
    gp_eps = None
    if kw.get("loss") == "wgan-gp":
        gp_eps = [[_gp_eps(key, r) for r in range(2)]
                  for _, _, key in batches]
    spec = {"g": flat, "d": d_flat, "kw": kw, "noises": noises,
            "batches": batches, "alpha": ALPHA, "gp_eps": gp_eps}
    _spawn(worker.mesh_steps, spec, str(tmp_path))
    want = _jax_mesh_run(monkeypatch, flat, d_flat, noises, batches, kw)
    for i, (jst, jm) in enumerate(want):
        a, b = (np.load(tmp_path / f"rank{r}_step{i}.npz") for r in (0, 1))
        assert a.files == b.files
        assert all(np.array_equal(a[k], b[k]) for k in a.files), i
        _assert_matches_jax(a, jst, jm)


@pytest.mark.parametrize("kw", [
    {}, {"loss": "logistic"}, {"loss": "wgan-gp", "mbstd_scope": "global"}],
    ids=["relativistic-hinge", "logistic-r1", "wgan-gp-mbstd-global"])
def test_two_rank_step_is_the_one_process_step_on_the_global_batch(
        tmp_path, kw):
    """Truncation off: two steps of the two ranks equal the port's
    one-process step on the global batch at 1e-8 (global means, R1's global
    sum, the W-average of the global batch's first sample, the stddev
    chunked per rank or over the global batch)."""
    flat, d_flat = _weights()
    flat = {k: v for k, v in flat.items() if not k.startswith("truncation")}
    noises, batches = _inputs()
    gp_eps = None
    if kw.get("loss") == "wgan-gp":
        rs = np.random.RandomState(5)
        gp_eps = [[rs.rand(LOCAL, 1, 1, 1) for _ in range(2)]
                  for _ in batches]
    spec = {"g": flat, "d": d_flat, "kw": kw, "noises": noises,
            "batches": batches, "alpha": ALPHA, "gp_eps": gp_eps,
            "truncation_psi": -1.0}
    _spawn(worker.mesh_steps, spec, str(tmp_path))
    plain = _one_process_run(flat, d_flat, noises, batches, kw, gp_eps,
                             -1.0)
    for i, want in enumerate(plain):
        got = np.load(tmp_path / f"rank0_step{i}.npz")
        assert sorted(want) == sorted(got.files)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, err_msg=f"{i} {k}", **TOL)


def test_replicated_batch_step_equals_one_process_step(tmp_path):
    """Both ranks on the same batch, drawing from the same seed
    (shard_rng=False): the group's means of equal shards are the shard's,
    so the step is the one-process step on that batch (the JAX package's
    test_mesh_step_grad_sync_exact, relativistic hinge)."""
    flat, d_flat = _weights()
    noises, batches = _inputs()
    local = [n[:LOCAL] for n in noises]
    batches = [(r[:LOCAL], z[:LOCAL], k) for r, z, k in batches]
    spec = {"g": flat, "d": d_flat, "kw": {"shard_rng": False},
            "noises": local, "batches": batches, "alpha": ALPHA,
            "replicated": True}
    _spawn(worker.mesh_steps, spec, str(tmp_path))
    tg, td = worker.toy_configs()
    gen, dis = Generator(tg).double(), Discriminator(td).double()
    gen.load_state_dict(generator_state_dict_from_jax_params(flat))
    dis.load_state_dict(discriminator_state_dict_from_jax_params(d_flat))
    state = create_train_state(gen, dis)
    step = build_train_step(tg, td, depth=DEPTH)
    for i, (reals, z, key) in enumerate(batches):
        _, m = step(state, torch.from_numpy(reals), torch.from_numpy(z), key,
                    ALPHA, noises=[torch.from_numpy(n) for n in local])
        want = worker.state_arrays(state)
        want.update(d_loss=m["d_loss"].item(), g_loss=m["g_loss"].item())
        got = np.load(tmp_path / f"rank1_step{i}.npz")
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, err_msg=f"{i} {k}", **TOL)


def test_replicas_stay_bitwise_equal(tmp_path):
    """Three float32 logistic+R1 steps with the ranks' own draws on their
    own shards: parameters, buffers (the W-averages), Adam's moments and
    the EMA shadow are the same bits on both ranks after every step."""
    _spawn(worker.float32_steps, str(tmp_path), 3, "logistic")
    for i in range(3):
        a, b = (np.load(tmp_path / f"rank{r}_step{i}.npz") for r in (0, 1))
        assert len(a.files) > 100 and a.files == b.files
        bad = [k for k in a.files if not np.array_equal(a[k], b[k])]
        assert not bad, (i, bad[:5])
        assert np.isfinite(a["d_loss"]) and np.isfinite(a["g_loss"])
    first, last = (np.load(tmp_path / f"rank0_step{i}.npz") for i in (0, 2))
    assert not np.array_equal(first["D/final_block.dense1.weight"],
                              last["D/final_block.dense1.weight"])


def test_minibatch_stddev_over_the_group_matches_jax(tmp_path):
    """minibatch_stddev(axis_name=mesh) on each rank's rows is the
    one-process statistic of the global batch (JAX's), and so is its input
    gradient."""
    rs = np.random.RandomState(4)
    x, cot = rs.randn(8, 4, 4, 6), rs.randn(8, 4, 4, 7)
    _spawn(worker.mbstd_global, x, cot, str(tmp_path))
    with jax.enable_x64(True):
        want, vjp = jax.vjp(lambda t: jprim.minibatch_stddev(t, 4),
                            jnp.asarray(x))
        (want_grad,) = vjp(jnp.asarray(cot))
    got = [np.load(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]),
                               np.asarray(want), **TOL)
    np.testing.assert_allclose(np.concatenate([g["grad"] for g in got]),
                               np.asarray(want_grad), **TOL)
    # not the shard-local statistic
    local = minibatch_stddev(torch.from_numpy(x), 4, chunks=2).numpy()
    assert not np.allclose(local, np.asarray(want))


# ----------------------------------------------------- trainer and CLI --

def test_adaptive_trainer_sits_a_rank_out_and_resyncs(tmp_path):
    """max_devices=2 at global batches 8, 4, 8 (stddev group 4): depths 0
    and 2 run on both ranks, depth 1 on rank 0 alone (a group of 2 would
    leave shards of 2 < 4).  Rank 1 catches up when the group grows: the
    two end bitwise equal, with rank 0's update count; only rank 0 wrote
    the run's files, one set of checkpoints per tag."""
    _spawn(worker.adaptive_trainer, str(tmp_path))
    trained = [json.loads((tmp_path / f"trained{r}.json").read_text())
               for r in (0, 1)]
    assert trained[0]["trained"] == [[0, 2], [1, 1], [2, 2]]
    assert trained[1]["trained"] == [[0, 2], [2, 2]]
    # 16 images: 2 steps at batch 8, 4 at batch 4, 2 at batch 8
    assert trained[0]["updates"] == trained[1]["updates"] == 8
    a, b = (np.load(tmp_path / f"rank{r}.npz") for r in (0, 1))
    bad = [k for k in a.files if not np.array_equal(a[k], b[k])]
    assert a.files == b.files and not bad, bad[:5]
    run = tmp_path / "run"
    assert sorted(os.listdir(run / "models")) == sorted(
        f"GAN_{k}_{d}_1.npz" for d in range(3)
        for k in ("GEN", "DIS", "GEN_OPTIM", "DIS_OPTIM", "GEN_SHADOW"))
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["depth"] for line in lines] == [0, 1, 2]


def test_train_cli_on_two_ranks(tmp_path):
    """python -m stylegan_torch.cli.train --num_devices 2 --device cpu: the
    command starts two gloo ranks itself, trains two depths at global batch
    8 (a group of two), and rank 0 alone writes the run."""
    from PIL import Image
    data = tmp_path / "data"
    data.mkdir()
    rs = np.random.RandomState(0)
    for i in range(16):
        Image.fromarray(rs.randint(0, 255, (12, 12, 3), np.uint8)).save(
            data / f"{i:02d}.png")
    out = tmp_path / "out"
    cfg = tmp_path / "toy.yaml"
    cfg.write_text(f"""
output_dir: '{out}'
structure: 'linear'
feedback_factor: 1
checkpoint_factor: 1
num_samples: 4
num_works: 1
loss: 'logistic'
model:
  gen: {{latent_size: 32, mapping_layers: 2}}
dataset: {{img_dir: '{data}', folder: False, resolution: 8}}
sched:
  epochs: [1, 1]
  batch_sizes: [8, 8]
  fade_in_percentage: [50, 50]
""")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    try:
        r = subprocess.run(
            [sys.executable, "-m", "stylegan_torch.cli.train", "--config",
             str(cfg), "--num_devices", "2", "--device", "cpu"], cwd=REPO,
            env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
        assert "up to 2 rank(s)" in (out / "log.txt").read_text()
        assert sorted(os.listdir(out / "models")) == sorted(
            f"GAN_{k}_{d}_1.npz" for d in range(2)
            for k in ("GEN", "DIS", "GEN_OPTIM", "DIS_OPTIM", "GEN_SHADOW"))
        lines = (out / "metrics.jsonl").read_text().splitlines()
        assert len(lines) == 2 and all(
            np.isfinite(json.loads(line)["d_loss"]) for line in lines)
    finally:
        shutil.rmtree(out, ignore_errors=True)
