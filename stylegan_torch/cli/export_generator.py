"""Export a trained generator as a ``torch.export`` serving artifact (the
port's counterpart of ``export_generator.py``).

    python -m stylegan_torch.cli.export_generator \\
        --config configs/sample_ffhq_1024.yaml \\
        --generator_file models/GAN_GEN_SHADOW_8_12.npz \\
        --output ffhq1024_b8.pt2 --batch 8 --check

Bakes the weights into one file (``stylegan_torch/serving.py``) that a
serving host loads with ``stylegan_torch.serving.load_exported`` without the
model code, the config or the checkpoint; it needs ``stylegan_torch.ops``
importable and, on the card, the kernel library built from the repo's
sources.  `--check` reloads the artifact on the same device and asserts that
it matches ``make_serving_fn`` bitwise on a probe batch.  Runs on CUDA
unless --device cpu.

`--spatial_devices N` exports the forward split by height over N ranks
(``serving.py``), from this one process.  Its `--check` loads the artifact
on N ranks, one process each (a ``torchrun --nproc_per_node N`` world, or
N processes that this command starts; NCCL on the card, gloo on the CPU
and for ranks that share one card, ``--device cuda:0``), gathers
the images and holds them to ``make_serving_fn`` at rtol=1e-3, atol=1e-3,
the JAX CLI's bar for a sharded artifact (the split statistics sum in
another order).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_arguments(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="./configs/sample.yaml")
    p.add_argument("--generator_file", type=str, required=True,
                   help="trained generator weights (.npz, or a reference .pth)")
    p.add_argument("--output", type=str, required=True,
                   help="artifact path (suggested suffix: .pt2)")
    p.add_argument("--batch", type=int, default=8,
                   help="static serving batch size (one artifact per batch)")
    p.add_argument("--out_depth", type=int, default=None,
                   help="synthesis depth (default: full config resolution)")
    p.add_argument("--platforms", type=str, default="cuda,cpu",
                   help="comma-separated devices the artifact may be loaded "
                        "on: cuda, cpu")
    p.add_argument("--spatial_devices", type=int, default=1,
                   help="an artifact split by height over N devices")
    p.add_argument("--train_quirks", action="store_true",
                   help="export with the reference's train-mode sampling "
                        "semantics (style mixing + truncation) instead of "
                        "deterministic eval")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and verify it matches the live "
                        "generator on a probe batch")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; with --spatial_devices rank r on "
                        "card r, NCCL), 'cuda:i' (every rank on card i, "
                        "gloo) or 'cpu'")
    return p.parse_args(argv)


def _generator(args, device):
    """(the generator on `device`, its depth)."""
    from stylegan_torch.cli.common import load_config, load_generator
    generator = load_generator(load_config(args.config), args.generator_file,
                               device)
    depth = (args.out_depth if args.out_depth is not None
             else generator.cfg.synthesis.depth - 1)
    return generator, depth


def _probe(args, gen_cfg):
    """The probe request of --check: z and the labels' arguments."""
    z = torch.randn((args.batch, gen_cfg.latent_size),
                    generator=torch.Generator().manual_seed(1))
    extra = ()
    if gen_cfg.conditional:
        extra = (torch.zeros((args.batch,), dtype=torch.long),)
    return z, extra


def main(args):
    from stylegan_torch import resolve_device

    device = resolve_device(args.device)
    if args.spatial_devices > 1 and "RANK" in os.environ and \
            "WORLD_SIZE" in os.environ:                  # torchrun
        return _torchrun_main(args)
    generator, depth = _generator(args, device)
    blob = _export(args, generator, depth)
    if args.check and args.spatial_devices > 1:
        from stylegan_torch.cli.common import rank_backend
        from stylegan_torch.parallel import spawn
        spawn(_check_rank, args.spatial_devices, (args,),
              backend=rank_backend(args.device), device=args.device)
    elif args.check:
        _check(args, generator, depth, device)
    print("Done.")
    return blob


def _export(args, generator, depth):
    from stylegan_torch.serving import export_generator
    blob = export_generator(
        generator.cfg, generator, depth=depth, batch_size=args.batch,
        platforms=[s.strip() for s in args.platforms.split(",") if s.strip()],
        train_quirks=args.train_quirks, spatial_devices=args.spatial_devices)
    with open(args.output, "wb") as f:
        f.write(blob)
    res = 2 ** (depth + 2)
    spatial = (f", split over {args.spatial_devices} devices"
               if args.spatial_devices > 1 else "")
    print(f"Exported {res}x{res} generator (batch {args.batch}, "
          f"platforms {args.platforms}{spatial}) to {args.output} "
          f"({len(blob) / 1e6:.1f} MB)")
    return blob


def _live(args, generator, depth, device, z, extra):
    from stylegan_torch.serving import make_serving_fn
    live = make_serving_fn(generator.cfg, generator, depth=depth,
                           train_quirks=args.train_quirks, device=device)
    return live(z, 7, *extra).cpu().numpy()


def _check(args, generator, depth, device):
    """The artifact, reloaded, against make_serving_fn: bitwise."""
    from stylegan_torch.serving import load_exported
    z, extra = _probe(args, generator.cfg)
    got = load_exported(args.output, device=device)(z, 7, *extra)
    got = got.cpu().numpy()
    np.testing.assert_array_equal(
        got, _live(args, generator, depth, device, z, extra))
    print(f"Check OK: artifact output matches the live generator "
          f"bit-for-bit ({got.shape}).")


def _check_rank(rank, device, args):
    _spatial_check(args, device, *_generator(args, device))


def _spatial_check(args, device, generator, depth):
    """On each rank of the artifact's mesh: serve the probe; rank 0 holds
    the gathered images to make_serving_fn at the JAX CLI's bar."""
    from stylegan_torch.parallel import create_spatial_mesh, gather_rows
    from stylegan_torch.serving import load_exported
    mesh = create_spatial_mesh(args.spatial_devices)
    if not mesh.is_member:              # a torchrun world of more ranks
        return
    z, extra = _probe(args, generator.cfg)
    serve = load_exported(args.output, device=device, mesh=mesh)
    got = gather_rows(serve(z, 7, *extra), mesh).cpu().numpy()
    if mesh.rank == 0:
        # the split statistics sum in another order: near-equality, as the
        # JAX CLI's check of a sharded artifact
        np.testing.assert_allclose(
            got, _live(args, generator, depth, device, z, extra),
            rtol=1e-3, atol=1e-3)
        print(f"Check OK: the artifact split over {mesh.size} ranks matches "
              f"the live generator to float32 roundoff ({got.shape}).")


def _torchrun_main(args):
    """Under torchrun: rank 0 exports, then every rank checks."""
    import torch.distributed as dist

    from stylegan_torch.cli.common import rank_backend
    from stylegan_torch.parallel import initialize_distributed
    device = initialize_distributed(device=args.device,
                                    backend=rank_backend(args.device))
    try:
        generator, depth = _generator(args, device)
        blob = _export(args, generator, depth) if dist.get_rank() == 0 \
            else None
        dist.barrier()
        if args.check:
            _spatial_check(args, device, generator, depth)
    finally:
        dist.destroy_process_group()
    print("Done.")
    return blob


if __name__ == "__main__":
    main(parse_arguments())
