"""Rank bodies for tests/test_torch_spatial_train.py.  `world` runs in each
of four processes that `stylegan_torch.parallel.spawn` starts and joins to
a gloo world on the CPU; it imports torch and the port only (no JAX), and
rank 0 writes what the ranks computed as one .npz for the test to hold
against the unsplit ops, the one-process step and JAX."""

import json
import logging
import os
import warnings

import numpy as np
import torch

from stylegan_torch.convert import (discriminator_state_dict_from_jax_params,
                                    generator_state_dict_from_jax_params)
from stylegan_torch.losses import _input_grad
from stylegan_torch.models import Discriminator, Generator
from stylegan_torch.models import configs as tcfg
from stylegan_torch.parallel import (Mesh2D, build_spatial_sample_fn,
                                     create_mesh, create_mesh_2d,
                                     gather_rows)
from stylegan_torch.parallel import halo
from stylegan_torch.parallel.spatial import spatial_context
from stylegan_torch.train import (StyleGAN, TrainState,
                                  build_spatial_train_step,
                                  create_train_state)

WORLD = 4
RES, DEPTH, LATENT = 16, 2, 32          # the 16^2 output: 4 rows over 4
N_LAYERS = 2 * (DEPTH + 1)
# the grids the step runs on: (data, spatial)
GRIDS = ((1, 2), (2, 2), (1, 4))
SPLITS = (2, 4)                          # the 1-D spatial groups
# autograd passes a gradient through a collective with no backward and
# warns; here that is an error
UNREGISTERED = "an autograd kernel was not registered"


def toy_configs(m=tcfg, truncation_psi=0.7, style_mixing_prob=0.9,
                res=RES, n_classes=0):
    """A float64-sized toy pair: 16^2, fmap_max 32, latent 32, two mapping
    layers, in either package's config classes; conditional with
    `n_classes`."""
    cond = dict(conditional=n_classes > 0, n_classes=n_classes)
    g = m.GeneratorConfig(
        resolution=res, latent_size=LATENT, dlatent_size=LATENT,
        truncation_psi=truncation_psi, style_mixing_prob=style_mixing_prob,
        mapping=m.MappingConfig(latent_size=LATENT * (2 if n_classes else 1),
                                dlatent_size=LATENT, mapping_fmaps=LATENT,
                                mapping_layers=2,
                                dlatent_broadcast=(res.bit_length() - 2) * 2),
        synthesis=m.SynthesisConfig(resolution=res, dlatent_size=LATENT,
                                    fmap_base=128, fmap_max=32,
                                    blur_filter=(1, 2, 1)), **cond)
    d = m.DiscriminatorConfig(resolution=res, fmap_base=128, fmap_max=32,
                              blur_filter=(1, 2, 1), **cond)
    return g, d


def conditional_models(dtype=torch.float64):
    """The toy pair with 3 classes, seeded torch init (no JAX weights)."""
    tg, td = toy_configs(n_classes=3)
    gen = Generator(tg, generator=torch.Generator().manual_seed(0))
    dis = Discriminator(td, generator=torch.Generator().manual_seed(1))
    return tg, td, gen.to(dtype), dis.to(dtype)


def models(spec, dtype=torch.float64, **cfg_kw):
    """G and D of spec's flat weights (JAX layout) in `dtype`."""
    tg, td = toy_configs(**cfg_kw)
    gen, dis = Generator(tg).to(dtype), Discriminator(td).to(dtype)
    gen.load_state_dict(generator_state_dict_from_jax_params(spec["g"]),
                        strict=True)
    dis.load_state_dict(discriminator_state_dict_from_jax_params(spec["d"]),
                        strict=True)
    return tg, td, gen, dis


def sgd_state(gen, dis, lr):
    """A TrainState with SGD on both networks (the JAX test's optax.sgd)."""
    import copy
    return TrainState(gen, dis, torch.optim.SGD(gen.parameters(), lr=lr),
                      torch.optim.SGD(dis.parameters(), lr=lr),
                      copy.deepcopy(gen).requires_grad_(False))


def state_arrays(state, prefix="") -> dict:
    """G, D and the shadow's tensors (parameters and buffers) by name."""
    out = {}
    for label, module in (("G", state.generator), ("D", state.discriminator),
                          ("shadow", state.g_shadow)):
        for name, t in module.state_dict().items():
            out[f"{prefix}{label}/{name}"] = t.detach().numpy().copy()
    return out


def collectives(spec, n, ctx, mesh):
    """The VJPs of exchange_halo, gather_rows and take_rows on this rank in
    float64 (spec's plane x and cotangents), and exchange_halo's second
    derivative, each gathered whole."""
    x = torch.from_numpy(spec["x"])
    h = x.shape[1] // n
    r = mesh.rank
    out = {}
    cot = torch.from_numpy(spec[f"halo_cot_n{n}"])[r]
    slab = x[:, r * h:(r + 1) * h].clone().requires_grad_(True)
    (halo.exchange_halo(slab, ctx) * cot).sum().backward()
    out["halo"] = gather_rows(slab.grad, mesh)

    slab = x[:, r * h:(r + 1) * h].clone().requires_grad_(True)
    (g1,) = torch.autograd.grad(
        (halo.exchange_halo(slab, ctx).pow(3) * cot).sum(), slab,
        create_graph=True)
    (g1.square() * torch.from_numpy(spec["x2"])[:, r * h:(r + 1) * h]) \
        .sum().backward()
    out["halo_second"] = gather_rows(slab.grad, mesh)

    cot = torch.from_numpy(spec[f"full_cot_n{n}"])[r]
    slab = x[:, r * h:(r + 1) * h].clone().requires_grad_(True)
    (halo.gather_rows(slab, ctx) * cot).sum().backward()
    out["gather"] = gather_rows(slab.grad, mesh)

    whole = x.clone().requires_grad_(True)
    (halo.take_rows(whole, ctx) * cot[:, r * h:(r + 1) * h]).sum().backward()
    out["take"] = halo.all_gather(whole.grad, ctx)
    return out


def discriminator_slabs(spec, n, ctx, mesh):
    """D's scores from this rank's rows of spec's images, and R1's input
    gradient rows (losses._input_grad with the rank's context), at depth
    DEPTH (alpha 1) and DEPTH - 1... in float64; each gathered."""
    _, _, _, dis = models(spec)
    out = {}
    for depth, alpha in ((DEPTH, 1.0), (DEPTH - 1, 0.5)):
        res = 2 ** (depth + 2)
        images = torch.from_numpy(spec[f"images_{res}"])
        h = res // n
        if res < 4 * n:
            continue
        slab = images[:, mesh.rank * h:(mesh.rank + 1) * h]

        def fn(t):
            return dis(t, depth, alpha, spatial=ctx)
        fn.spatial = ctx
        with torch.no_grad():
            out[f"scores_d{depth}"] = fn(slab)
        out[f"r1_d{depth}"] = gather_rows(_input_grad(fn, slab).detach(),
                                          mesh)
    return out


def train_samples(spec, mesh):
    """build_spatial_sample_fn(train_semantics=True) on `mesh`: the float32
    toy generator's gathered images of spec's z0 for seed 5 (style mixing
    and the truncation's W-average update on)."""
    tg, _, gen, _ = models(spec, torch.float32)
    fn = build_spatial_sample_fn(tg, gen, mesh, depth=DEPTH,
                                 train_semantics=True)
    return gather_rows(fn(torch.from_numpy(spec["z0"]).float(), 5), mesh)


def _data_shard(t, mesh, b):
    return t[mesh.data.rank * b:(mesh.data.rank + 1) * b]


def grid_steps(spec, mesh: Mesh2D, dtype=torch.float64):
    """spec["step_losses"] steps of build_spatial_train_step on `mesh` from
    spec's weights, on this rank's data shard of spec's reals and z, the
    draws from the seeds; the state (and losses) after each step."""
    out = {}
    for loss, n_steps in spec["step_losses"]:
        tg, td, gen, dis = models(spec, dtype)
        state = create_train_state(gen, dis)
        step = build_spatial_train_step(tg, td, depth=DEPTH, mesh=mesh,
                                        loss=loss)
        for i in range(n_steps):
            reals, z = (torch.from_numpy(spec[f"{k}{i}"]).to(dtype)
                        for k in ("reals", "z"))
            b = reals.shape[0] // mesh.shape[0]
            _, m = step(state, _data_shard(reals, mesh, b),
                        _data_shard(z, mesh, b), 10 + i,
                        torch.tensor(0.5, dtype=dtype))
            tag = f"{loss}_s{i}/"
            out.update(state_arrays(state, tag))
            out[tag + "d_loss"] = m["d_loss"].detach().numpy()
            out[tag + "g_loss"] = m["g_loss"].detach().numpy()
    # a conditional model: the label planes of D's slabs, the labels' rows
    tg, td, gen, dis = conditional_models(dtype)
    state = create_train_state(gen, dis)
    step = build_spatial_train_step(tg, td, depth=DEPTH, mesh=mesh,
                                    loss="conditional-loss",
                                    conditional=True)
    reals, z = (torch.from_numpy(spec[f"{k}0"]).to(dtype)
                for k in ("reals", "z"))
    labels = torch.from_numpy(spec["labels"])
    b = reals.shape[0] // mesh.shape[0]
    _, m = step(state, _data_shard(reals, mesh, b), _data_shard(z, mesh, b),
                10, torch.tensor(0.5, dtype=dtype),
                _data_shard(labels, mesh, b))
    out.update(state_arrays(state, "conditional_s0/"))
    out["conditional_s0/d_loss"] = m["d_loss"].detach().numpy()
    out["conditional_s0/g_loss"] = m["g_loss"].detach().numpy()
    return out


def jax_step(spec, mesh: Mesh2D):
    """One float32 SGD step of build_spatial_train_step (logistic + R1) on
    spec's JAX-test inputs: no style mixing, the noise maps pinned (this
    rank's data shard of them)."""
    tg, td, gen, dis = models(spec["jax"], torch.float32,
                              style_mixing_prob=0.0, res=spec["jax_res"])
    state = sgd_state(gen, dis, 0.01)
    depth = spec["jax_res"].bit_length() - 3
    step = build_spatial_train_step(tg, td, depth=depth, mesh=mesh,
                                    loss="logistic")
    reals, z = (torch.from_numpy(spec["jax"][k]) for k in ("reals", "z"))
    b = reals.shape[0] // mesh.shape[0]
    noises = [_data_shard(torch.from_numpy(n), mesh, b)
              for n in spec["jax"]["noises"]]
    _, m = step(state, _data_shard(reals, mesh, b), _data_shard(z, mesh, b),
                0, torch.tensor(0.7), noises=noises)
    out = state_arrays(state, "jax/")
    out["jax/d_loss"] = m["d_loss"].detach().numpy()
    out["jax/g_loss"] = m["g_loss"].detach().numpy()
    return out


def _trainer(mesh=None, **kw):
    g_args = {"latent_size": LATENT, "mapping_layers": 2, "fmap_base": 128,
              "fmap_max": 32, "blur_filter": [1, 2, 1],
              "truncation_psi": 0.7, "truncation_cutoff": 8}
    d_args = {"use_wscale": True, "fmap_base": 128, "fmap_max": 32,
              "blur_filter": [1, 2, 1]}
    opt = {"learning_rate": 0.003, "beta_1": 0.0, "beta_2": 0.99,
           "eps": 1e-8}
    return StyleGAN(structure="linear", resolution=RES, num_channels=3,
                    latent_size=LATENT, g_args=g_args, d_args=d_args,
                    g_opt_args=opt, d_opt_args=opt, loss="logistic",
                    use_ema=True, seed=0, mesh=mesh, device="cpu", **kw)


def trainer_fixed(spec, mesh: Mesh2D):
    """StyleGAN(mesh=the (2, 2) grid): two train_on_batch steps on this
    rank's data shard of spec's batches; optimize_discriminator's refusal
    and train()'s refusal of a batch the data axis does not divide."""
    trainer = _trainer(mesh)
    out = {}
    for i in range(2):
        reals = spec[f"trainer_reals{i}"]
        b = reals.shape[0] // mesh.shape[0]
        out[f"trainer_losses{i}"] = np.asarray(trainer.train_on_batch(
            _data_shard(reals, mesh, b), depth=DEPTH, alpha=0.5))
    out["trainer_keys"] = np.asarray([str(k) for k in trainer._steps])
    try:
        trainer.optimize_discriminator(np.zeros((1, LATENT), np.float32),
                                       spec["trainer_reals0"][:1],
                                       depth=DEPTH, alpha=0.5)
        out["refusal_optimize"] = np.asarray("")
    except NotImplementedError as e:
        out["refusal_optimize"] = np.asarray(str(e))
    try:
        trainer.train(None, 1, [1, 1, 1], [3, 3, 3], [50, 50, 50],
                      logging.getLogger("spatial"), "unused")
        out["refusal_batch"] = np.asarray("")
    except ValueError as e:
        out["refusal_batch"] = np.asarray(str(e))
    return out


def deep_tail(out_dir):
    """StyleGAN(max_devices=4, spatial_devices=4).train over 16^2 (three
    depths) at global batches 8, 16, 2: a data group of 2 (4^2 is too short
    to split), the data axis filled by 4 (the 1-D group kept), and a
    (1, 4) grid for batch 2.  Returns the (depth, group shape) this rank
    trained and whether its weights are finite."""
    from stylegan_torch.data import SyntheticDataset
    trainer = _trainer(max_devices=4, spatial_devices=4)
    trained = []
    run_depth = trainer._train_depth

    def record(dataset, workers, depth, mesh, *args):
        shape = mesh.shape if isinstance(mesh, Mesh2D) else (mesh.size,)
        trained.append([depth, *map(int, shape)])
        return run_depth(dataset, workers, depth, mesh, *args)
    trainer._train_depth = record
    trainer.train(SyntheticDataset(16, RES, seed=3), num_workers=1,
                  epochs=[1, 1, 1], batch_sizes=[8, 16, 2],
                  fade_in_percentage=[50, 50, 50],
                  logger=logging.getLogger("tail"),
                  output=os.path.join(out_dir, "tail"), num_samples=4,
                  feedback_factor=1)
    return trained, all(bool(torch.isfinite(p).all())
                        for p in trainer.state.generator.parameters())


def functional_collective_warnings():
    """The messages of the warnings that autograd gives when a gradient
    passes through the functional all-reduce, which has no backward of its
    own, on a world of one gloo rank.  Autograd warns once per process, so
    the test runs this in a fresh one."""
    from stylegan_torch.parallel import initialize_distributed
    from stylegan_torch.parallel.distributed import _free_port
    initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cpu",
                           timeout=60)
    try:
        group = halo.SpatialContext(1, torch.tensor(0)).group_name
        x = torch.randn(3, dtype=torch.float64, requires_grad=True)
        ops = torch.ops._c10d_functional
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ops.wait_tensor(ops.all_reduce(x, "sum", group)).sum().backward()
        return [str(w.message) for w in caught]
    finally:
        torch.distributed.destroy_process_group()


def world(rank, device, spec, out_dir):
    """Every check of the module in one world of WORLD ranks."""
    torch.set_num_threads(1)
    warnings.filterwarnings("error", message=f".*{UNREGISTERED}")
    out = {}
    meshes = {n: create_mesh(n, axis_name="spatial") for n in SPLITS}
    for n, mesh in meshes.items():
        if not mesh.is_member:
            continue
        ctx = spatial_context(mesh, device)
        out.update({f"{k}_n{n}": v for k, v in
                    collectives(spec, n, ctx, mesh).items()})
        out.update({f"{k}_n{n}": v for k, v in
                    discriminator_slabs(spec, n, ctx, mesh).items()})
        out[f"train_samples_n{n}"] = train_samples(spec, mesh)
    grids = {shape: create_mesh_2d(*shape) for shape in GRIDS}
    for shape, mesh in grids.items():
        if mesh.is_member:
            tag = f"grid{shape[0]}x{shape[1]}/"
            out.update({tag + k: v for k, v in grid_steps(spec, mesh).items()
                        if rank == 0})
            if shape == (2, 2):
                out.update(jax_step(spec, mesh))
                out.update(trainer_fixed(spec, mesh))
    trained, finite = deep_tail(out_dir)
    with open(os.path.join(out_dir, f"tail_rank{rank}.json"), "w") as f:
        json.dump(trained, f)
    out["tail_finite"] = np.asarray(finite)
    if rank == 0:
        np.savez(os.path.join(out_dir, "spatial_train.npz"),
                 **{k: v.detach().numpy() if torch.is_tensor(v) else v
                    for k, v in out.items()})
