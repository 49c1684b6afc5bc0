"""Generate one n_row x n_col sample grid (the port's counterpart of
``generate_grid.py``).

    python -m stylegan_torch.cli.generate_grid --config configs/sample_ffhq_1024.yaml \\
        --generator_file g.npz --n_row 10 --n_col 4 --output_dir out/

One forward of n_row * n_col hypersphere-projected latents (the latent
matrix divided by its Frobenius norm, times sqrt(latent_size), as the JAX
CLI does) with train-mode sampling (style mixing, truncation in the training
branch), written as ``grid.png`` by ``save_image_grid``.  Runs on CUDA
unless --device cpu.  The weights load partially, as the JAX CLI's do (a
key the file lacks keeps its initial value; a ``.npz`` shape mismatch warns,
a ``.pth`` one raises).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="./configs/sample.yaml")
    parser.add_argument("--generator_file", action="store", type=str,
                        required=True)
    parser.add_argument("--n_row", action="store", type=int, default=10)
    parser.add_argument("--n_col", action="store", type=int, default=4)
    parser.add_argument("--output_dir", action="store", type=str,
                        default="output/")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--class_id", type=int, default=None,
                        help="class label for conditional models")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def draw_grid(path, generator, out_depth, n_row, n_col, seed=0,
              class_id=None, latents=None, noises=None, mixing=None):
    """Write the grid of one train-mode forward to `path`; returns its
    images (N, H, W, C) as float numpy.  `latents` (N, latent_size),
    `noises` (per-layer maps, or a callable batch -> maps) and `mixing`
    ((latents2, cutoff), see Generator.forward) pin the draws, which
    otherwise come from `seed`."""
    from stylegan_torch.cli.common import device_of, pinned_noises
    from stylegan_torch.io import adjust_dynamic_range, save_image_grid
    cfg = generator.cfg
    device = device_of(generator)
    n = n_row * n_col
    rng = torch.Generator().manual_seed(seed)
    if latents is None:
        latents = torch.randn((n, cfg.latent_size), generator=rng)
        latents = latents / torch.linalg.norm(latents) * cfg.latent_size ** 0.5
    labels = None
    if cfg.conditional:
        if class_id is None:
            raise ValueError("conditional model: pass --class_id")
        labels = torch.full((n,), class_id, dtype=torch.long, device=device)
    if mixing is not None:
        mixing = (torch.as_tensor(mixing[0]).to(device), int(mixing[1]))
    with torch.inference_mode():
        out = generator(torch.as_tensor(latents).to(device), depth=out_depth,
                        alpha=1.0, seed=seed, train=True, labels=labels,
                        noises=pinned_noises(noises, n, device), mixing=mixing)
    imgs = out.images.float().cpu().numpy()
    save_image_grid(adjust_dynamic_range(imgs), path, nrow=n_row)
    return imgs


def main(args):
    from stylegan_torch import resolve_device
    from stylegan_torch.cli.common import load_config, load_generator

    opt = load_config(args.config)
    device = resolve_device(args.device)
    generator = load_generator(opt, args.generator_file, device)
    out_depth = int(np.log2(opt.dataset.resolution)) - 2
    seed = (args.seed if args.seed is not None
            else int.from_bytes(os.urandom(4), "little"))
    print("Generating scale synchronized images ...")
    os.makedirs(args.output_dir, exist_ok=True)
    images = draw_grid(os.path.join(args.output_dir, "grid.png"), generator,
                       out_depth, args.n_row, args.n_col, seed=seed,
                       class_id=args.class_id)
    print("Done.")
    return images


if __name__ == "__main__":
    main(parse_arguments())
