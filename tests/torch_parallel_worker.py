"""Rank bodies for tests/test_torch_parallel.py.  Each runs in a process
that `stylegan_torch.parallel.spawn` starts and joins to a gloo world on the
CPU; it imports torch and the port only (no JAX), and writes what it
computed as .npz files for the test to hold against JAX and against the
other ranks."""

import os

import numpy as np
import torch

from stylegan_torch.convert import (discriminator_state_dict_from_jax_params,
                                    generator_state_dict_from_jax_params)
from stylegan_torch.models import Discriminator, Generator
from stylegan_torch.models import configs as tcfg
from stylegan_torch.parallel import create_mesh, global_shard
from stylegan_torch.train import build_train_step, create_train_state

RES, DEPTH, LATENT, N_LAYERS = 8, 1, 32, 4


def toy_configs(truncation_psi=0.7):
    """The float64 toy model of tests/test_torch_train_steps.py."""
    g = tcfg.GeneratorConfig(
        resolution=RES, latent_size=LATENT, dlatent_size=LATENT,
        truncation_psi=truncation_psi, style_mixing_prob=0.0,
        mapping=tcfg.MappingConfig(latent_size=LATENT, dlatent_size=LATENT,
                                   mapping_fmaps=LATENT, mapping_layers=2,
                                   dlatent_broadcast=N_LAYERS),
        synthesis=tcfg.SynthesisConfig(resolution=RES, dlatent_size=LATENT,
                                       fmap_base=128, fmap_max=32,
                                       blur_filter=(1, 2, 1)))
    d = tcfg.DiscriminatorConfig(resolution=RES, fmap_base=128, fmap_max=32,
                                 blur_filter=(1, 2, 1))
    return g, d


def state_arrays(state) -> dict:
    """Every tensor of a TrainState by name: G, D, shadow (buffers too) and
    both Adams' moments and counts."""
    out = {}
    for label, module in (("G", state.generator), ("D", state.discriminator),
                          ("shadow", state.g_shadow)):
        for name, t in module.state_dict().items():
            out[f"{label}/{name}"] = t.detach().cpu().numpy().copy()
    for label, module, opt in (("G", state.generator, state.g_optimizer),
                               ("D", state.discriminator, state.d_optimizer)):
        for name, p in module.named_parameters():
            for key, v in opt.state[p].items():
                out[f"{label}_adam/{name}/{key}"] = \
                    v.detach().cpu().numpy().copy()
    return out


def _shard(mesh, x):
    return None if x is None else global_shard(mesh, torch.from_numpy(x))


def mesh_steps(rank, device, spec, out_dir):
    """spec["steps"] fused steps of build_train_step(mesh=2 ranks) from the
    flat float64 weights in `spec`, each rank on its rows of the global
    reals, z and pinned noise (or, with spec["replicated"], on the whole
    batch); the state after each step into rank{r}_step{i}.npz."""
    torch.set_num_threads(1)
    mesh = create_mesh(2)
    tg, td = toy_configs(spec.get("truncation_psi", 0.7))
    gen, dis = Generator(tg).double(), Discriminator(td).double()
    gen.load_state_dict(generator_state_dict_from_jax_params(spec["g"]),
                        strict=True)
    dis.load_state_dict(discriminator_state_dict_from_jax_params(spec["d"]),
                        strict=True)
    state = create_train_state(gen, dis)
    step = build_train_step(tg, td, depth=DEPTH, mesh=mesh, **spec["kw"])
    take = (lambda x: None if x is None else torch.from_numpy(x)) \
        if spec.get("replicated") else (lambda x: _shard(mesh, x))
    for i, (reals, z, key) in enumerate(spec["batches"]):
        gp_eps = spec.get("gp_eps")
        _, m = step(state, take(reals), take(z), key, spec["alpha"],
                    noises=[take(n) for n in spec["noises"]],
                    gp_eps=None if gp_eps is None
                    else [torch.from_numpy(gp_eps[i][rank])])
        arrays = state_arrays(state)
        arrays.update(d_loss=m["d_loss"].numpy(), g_loss=m["g_loss"].numpy())
        np.savez(os.path.join(out_dir, f"rank{rank}_step{i}.npz"), **arrays)


def mbstd_global(rank, device, x, cot, out_dir):
    """minibatch_stddev over the group's global batch: this rank's rows of
    the output and of the input gradient (x, cot: global float64 arrays)."""
    from stylegan_torch.ops.primitives import minibatch_stddev
    mesh = create_mesh(2)
    xr = _shard(mesh, x).requires_grad_(True)
    y = minibatch_stddev(xr, 4, axis_name=mesh)
    (y * _shard(mesh, cot)).sum().backward()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), y=y.detach().numpy(),
             grad=xr.grad.numpy())


def float32_steps(rank, device, out_dir, n_steps, loss):
    """n_steps float32 steps with the step's own draws (shard_rng) from
    seeded weights, each rank on its own seeded shard; the state after each
    step into rank{r}_step{i}.npz."""
    torch.set_num_threads(1)
    mesh = create_mesh(2)
    tg, td = toy_configs()
    gen = Generator(tg, generator=torch.Generator().manual_seed(0))
    dis = Discriminator(td, generator=torch.Generator().manual_seed(1))
    state = create_train_state(gen, dis)
    step = build_train_step(tg, td, depth=DEPTH, mesh=mesh, loss=loss)
    for i in range(n_steps):
        rs = np.random.RandomState(100 * i + rank)
        reals = torch.from_numpy(rs.randn(2, RES, RES, 3).astype(np.float32))
        z = torch.from_numpy(rs.randn(2, LATENT).astype(np.float32))
        _, m = step(state, reals, z, 7 + i, 0.5)
        arrays = state_arrays(state)
        arrays.update(d_loss=m["d_loss"].numpy(), g_loss=m["g_loss"].numpy())
        np.savez(os.path.join(out_dir, f"rank{rank}_step{i}.npz"), **arrays)


def adaptive_trainer(rank, device, out_dir):
    """StyleGAN(max_devices=2).train over 16^2 (three depths) at global
    batches 8, 4, 8: groups of 2, 1 (4 < 2 x the stddev group of 4) and 2.
    Writes which depths this rank trained and under which group size, and
    its final state."""
    import json
    import logging

    from stylegan_torch.data import SyntheticDataset
    from stylegan_torch.train import StyleGAN
    torch.set_num_threads(1)
    g_args = {"latent_size": 32, "mapping_layers": 2, "fmap_base": 64,
              "fmap_max": 16, "blur_filter": [1, 2, 1]}
    d_args = {"fmap_base": 64, "fmap_max": 16, "blur_filter": [1, 2, 1]}
    trainer = StyleGAN(structure="linear", resolution=16, num_channels=3,
                       latent_size=32, g_args=g_args, d_args=d_args,
                       g_opt_args={}, d_opt_args={}, use_ema=True,
                       max_devices=2, device=device)
    trained = []
    run_depth = trainer._train_depth

    def record(dataset, workers, depth, mesh, *args):
        trained.append([depth, mesh.size if mesh is not None else 1])
        return run_depth(dataset, workers, depth, mesh, *args)
    trainer._train_depth = record
    logger = logging.getLogger(f"adaptive.rank{rank}")
    trainer.train(SyntheticDataset(16, 16, seed=3), num_workers=1,
                  epochs=[1, 1, 1], batch_sizes=[8, 4, 8],
                  fade_in_percentage=[50, 50, 50], logger=logger,
                  output=os.path.join(out_dir, "run"), num_samples=4,
                  feedback_factor=1)
    with open(os.path.join(out_dir, f"trained{rank}.json"), "w") as f:
        json.dump({"trained": trained, "updates": trainer._update_count},
                  f)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **state_arrays(trainer.state))
