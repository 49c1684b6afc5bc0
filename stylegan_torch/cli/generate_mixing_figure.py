"""Style-mixing figure (the port's counterpart of
``generate_mixing_figure.py``).

    python -m stylegan_torch.cli.generate_mixing_figure \\
        --config configs/sample_ffhq_1024.yaml --generator_file g.npz \\
        --output figure03-style-mixing.png --out_depth 8

Seeded source/destination latents -> W through the mapping network, the
source W rows of each style range spliced into the destination W,
synthesised, and pasted on one canvas.  The latents are the reference's
``np.random.RandomState(seed)`` draws with its default seeds and style
ranges, so figures are comparable; the ranges are clamped to the model's W
count, so that shallow models render too.  Every synthesis call draws its
noise from seed 0, as the JAX CLI uses one key for all of them.  Runs on
CUDA unless --device cpu.  The weights load partially, as the JAX CLI's do
(a key the file lacks keeps its initial value; a ``.npz`` shape mismatch
warns, a ``.pth`` one raises).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

SRC_SEEDS = [639, 1995, 687, 615, 1999]
DST_SEEDS = [888, 888, 888]
STYLE_RANGES = [range(0, 2)] * 1 + [range(2, 8)] * 1 + [range(8, 14)] * 1


def draw_style_mixing_figure(png, generator, out_depth, src_seeds,
                             dst_seeds, style_ranges, noises=None):
    """Write the figure to `png`; returns (canvas uint8 (H, W, 3), the
    synthesised float images in call order: sources, destinations, then
    each row's mixes).  `noises` pins the noise maps (per-layer maps, or a
    callable batch -> maps)."""
    from PIL import Image
    from stylegan_torch.cli.common import (device_of, map_latents,
                                           pinned_noises, to_u8)
    cfg = generator.cfg
    device = device_of(generator)
    n_col, n_row = len(src_seeds), len(dst_seeds)
    w = h = 2 ** (out_depth + 2)
    latent_size = cfg.mapping.latent_size
    images = []

    @torch.inference_mode()
    def synth(dl):
        out = generator.g_synthesis(
            torch.as_tensor(dl).to(device), depth=out_depth, alpha=1.0,
            seed=0, noises=pinned_noises(noises, len(dl), device))
        images.append(out.float().cpu().numpy())
        return images[-1]

    def mapping(seeds):
        return map_latents(generator, np.stack(
            [np.random.RandomState(s).randn(latent_size)
             for s in seeds]).astype(np.float32))

    src_dl, dst_dl = mapping(src_seeds), mapping(dst_seeds)
    src_images, dst_images = synth(src_dl), synth(dst_dl)

    canvas = Image.new("RGB", (w * (n_col + 1), h * (n_row + 1)), "white")
    for col, img in enumerate(src_images):
        canvas.paste(Image.fromarray(to_u8(img), "RGB"), ((col + 1) * w, 0))
    for row, img in enumerate(dst_images):
        canvas.paste(Image.fromarray(to_u8(img), "RGB"), (0, (row + 1) * h))
        row_dl = np.stack([dst_dl[row]] * n_col)
        # the reference's ranges are sized for the 14-layer 256^2 model
        rows = [i for i in style_ranges[row] if i < row_dl.shape[1]]
        row_dl[:, rows] = src_dl[:, rows]
        for col, mimg in enumerate(synth(row_dl)):
            canvas.paste(Image.fromarray(to_u8(mimg), "RGB"),
                         ((col + 1) * w, (row + 1) * h))
    canvas.save(png)
    return np.asarray(canvas), images


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="./configs/sample_race_256.yaml")
    parser.add_argument("--generator_file", action="store", type=str,
                        required=True)
    parser.add_argument("--output", default="figure03-style-mixing.png")
    parser.add_argument("--out_depth", type=int, default=6)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def main(args):
    from stylegan_torch import resolve_device
    from stylegan_torch.cli.common import load_config, load_generator

    opt = load_config(args.config)
    device = resolve_device(args.device)
    generator = load_generator(opt, args.generator_file, device)
    out = draw_style_mixing_figure(args.output, generator,
                                   out_depth=args.out_depth,
                                   src_seeds=SRC_SEEDS, dst_seeds=DST_SEEDS,
                                   style_ranges=STYLE_RANGES)
    print("Done.")
    return out


if __name__ == "__main__":
    main(parse_arguments())
