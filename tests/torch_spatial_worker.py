"""Rank bodies for tests/test_torch_spatial.py.  `world` runs in each of
four processes that `stylegan_torch.parallel.spawn` starts and joins to a
gloo world on the CPU; it imports torch and the port only (no JAX), and
rank 0 writes what the ranks computed, gathered, as one .npz for the test to
hold against the unsplit ops, the one-process forward and JAX."""

import os

import numpy as np
import torch

from stylegan_torch.models import Generator
from stylegan_torch.models import configs as tcfg
from stylegan_torch.ops import blur2d, conv2d_apply, instance_norm
from stylegan_torch.parallel import (build_spatial_sample_fn,
                                     create_spatial_mesh, gather_rows)
from stylegan_torch.parallel import halo
from stylegan_torch.parallel.spatial import spatial_context
from stylegan_torch.serving import load_exported

RES, LATENT = 64, 32
DEPTH = RES.bit_length() - 3          # the 64^2 output
WORLD = 4
MESHES = (4, 2)                       # the world, and its first two ranks


def toy_config(m=tcfg, conditional=False):
    """tests/test_spatial.py's toy generator (res 64, fmap_max 64, two
    mapping layers), in either package's config classes."""
    return m.GeneratorConfig(
        resolution=RES, latent_size=LATENT, dlatent_size=LATENT,
        truncation_psi=0.7, conditional=conditional,
        n_classes=3 if conditional else 0,
        mapping=m.MappingConfig(
            latent_size=LATENT * (2 if conditional else 1),
            dlatent_size=LATENT, mapping_fmaps=LATENT, mapping_layers=2,
            dlatent_broadcast=(RES.bit_length() - 2) * 2),
        synthesis=m.SynthesisConfig(resolution=RES, dlatent_size=LATENT,
                                    fmap_base=256, fmap_max=64,
                                    blur_filter=(1, 2, 1), structure="linear"))


def generator(state_dict):
    gen = Generator(toy_config())
    gen.load_state_dict({k: torch.from_numpy(v)
                         for k, v in state_dict.items()}, strict=True)
    return gen.requires_grad_(False)


def halo_ops(spec, ctx, mesh):
    """Each rank's slab of spec's planes through exchange_halo and the slab
    forms of the 3x3 conv, the upscale convs, the blur and the instance
    norm (the unfused epilogue's), gathered."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split(".")[-1]
        x = torch.from_numpy(spec["x"]).to(dtype)
        w = torch.from_numpy(spec["w"]).to(dtype)
        bias = torch.from_numpy(spec["bias"]).to(dtype)
        k = torch.from_numpy(spec["blur"]).to(dtype)
        slab = halo.take_rows(x, ctx)
        out[f"halo_{tag}"] = halo.all_gather(halo.exchange_halo(slab, ctx),
                                             ctx)
        ops = {
            "conv": lambda s: conv2d_apply(s, w, bias, spatial=ctx),
            "up_nearest": lambda s: conv2d_apply(
                s, w, bias, upscale=True, blur_kernel=k, spatial=ctx),
            "up_subpixel": lambda s: conv2d_apply(
                s, w, bias, upscale=True, blur_kernel=k,
                fused_resample_threshold=8, spatial=ctx),
            "blur": lambda s: blur2d(s, k, ctx),
            "instance_norm": lambda s: instance_norm(s, spatial=ctx),
        }
        with torch.no_grad():
            for name, op in ops.items():
                out[f"{name}_{tag}"] = gather_rows(op(slab), mesh)
    return out


def world(rank, device, spec, out_dir):
    """Every check of the module in one world of WORLD ranks: on the
    spatial mesh of all four and on that of the first two, the halo ops,
    the spatial forward (seeded, and on pinned noise maps), each rank's
    slab against its rows of the gathered image; on two ranks also the
    bf16 forward and the exported artifact, served twice."""
    torch.set_num_threads(1)
    gen = generator(spec["state_dict"])
    cfg = gen.cfg
    z = torch.from_numpy(spec["z"])
    pinned = [torch.from_numpy(a) for a in spec["noises"]]
    meshes = {n: create_spatial_mesh(n) for n in MESHES}
    out = {}
    for n, mesh in meshes.items():
        if not mesh.is_member:
            continue
        ctx = spatial_context(mesh, device)
        out.update({f"{k}_n{n}": v for k, v in halo_ops(spec, ctx,
                                                        mesh).items()})
        fn = build_spatial_sample_fn(cfg, gen, mesh, depth=DEPTH)
        slab = fn(z, spec["seed"])
        full = gather_rows(slab, mesh)
        rows = RES // n
        assert torch.equal(slab, full[:, mesh.rank * rows:
                                      (mesh.rank + 1) * rows])
        out[f"seeded_n{n}"] = full
        with torch.inference_mode():
            out[f"pinned_n{n}"] = gather_rows(
                gen(z, depth=DEPTH, alpha=1.0, noises=pinned,
                    spatial=ctx).images, mesh)
        if n == 2:
            out["bf16_n2"] = gather_rows(
                fn(z.to(torch.bfloat16), spec["seed"]), mesh).float()
            serve = load_exported(spec["artifact"], device="cpu", mesh=mesh)
            got = serve(z, spec["seed"])
            again = serve(z, spec["seed"])
            out["artifact_is_live_n2"] = torch.tensor(
                torch.equal(got, slab) and torch.equal(again, got))
            out["artifact_n2"] = gather_rows(got, mesh)
    if rank == 0:
        np.savez(os.path.join(out_dir, "spatial.npz"),
                 **{k: v.numpy() for k, v in out.items()})
