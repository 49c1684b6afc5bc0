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
"""

from __future__ import annotations

import argparse

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
                   help="a spatially sharded artifact for N devices (not yet "
                        "ported: must be 1)")
    p.add_argument("--train_quirks", action="store_true",
                   help="export with the reference's train-mode sampling "
                        "semantics (style mixing + truncation) instead of "
                        "deterministic eval")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and verify it matches the live "
                        "generator on a probe batch")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(args):
    from stylegan_torch import resolve_device
    from stylegan_torch.cli.common import load_config, load_generator
    from stylegan_torch.serving import (export_generator, load_exported,
                                        make_serving_fn)

    opt = load_config(args.config)
    device = resolve_device(args.device)
    generator = load_generator(opt, args.generator_file, device)
    gen_cfg = generator.cfg
    depth = (args.out_depth if args.out_depth is not None
             else gen_cfg.synthesis.depth - 1)

    blob = export_generator(
        gen_cfg, generator, depth=depth, batch_size=args.batch,
        platforms=[s.strip() for s in args.platforms.split(",") if s.strip()],
        train_quirks=args.train_quirks, spatial_devices=args.spatial_devices)
    with open(args.output, "wb") as f:
        f.write(blob)
    res = 2 ** (depth + 2)
    print(f"Exported {res}x{res} generator (batch {args.batch}, "
          f"platforms {args.platforms}) to {args.output} "
          f"({len(blob) / 1e6:.1f} MB)")

    if args.check:
        serve = load_exported(args.output, device=device)
        z = torch.randn((args.batch, gen_cfg.latent_size),
                        generator=torch.Generator().manual_seed(1))
        extra = ()
        if gen_cfg.conditional:
            extra = (torch.zeros((args.batch,), dtype=torch.long),)
        got = serve(z, 7, *extra).cpu().numpy()
        live = make_serving_fn(gen_cfg, generator, depth=depth,
                               train_quirks=args.train_quirks, device=device)
        want = live(z, 7, *extra).cpu().numpy()
        np.testing.assert_array_equal(got, want)
        print(f"Check OK: artifact output matches the live generator "
              f"bit-for-bit ({got.shape}).")
    print("Done.")
    return blob


if __name__ == "__main__":
    main(parse_arguments())
