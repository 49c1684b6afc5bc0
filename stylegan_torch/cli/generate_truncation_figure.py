"""Truncation-trick psi-sweep figure (the port's counterpart of
``generate_truncation_figure.py``): rows are seeds, columns are psi in
[1, .7, .5, 0, -.5, -1], each W truncated toward the stored
``truncation.avg_latent`` before synthesis.

    python -m stylegan_torch.cli.generate_truncation_figure \\
        --config configs/sample_ffhq_1024_truncation.yaml \\
        --generator_file g.npz --output figure08-truncation-trick.png \\
        --out_depth 8

The config must enable truncation (truncation_psi > 0), as in JAX.  Every
synthesis call draws its noise from seed 0.  Runs on CUDA unless --device
cpu.  The weights load partially, as the JAX CLI's do (a key the file lacks
keeps its initial value; a ``.npz`` shape mismatch warns, a ``.pth`` one
raises).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

SEEDS = [91, 388]
PSIS = [1, 0.7, 0.5, 0, -0.5, -1]


def draw_truncation_trick_figure(png, generator, out_depth, seeds, psis,
                                 noises=None):
    """Write the figure to `png`; returns (canvas uint8, the float images of
    each row).  `noises` pins the noise maps (per-layer maps, or a callable
    batch -> maps)."""
    from PIL import Image
    from stylegan_torch.cli.common import (device_of, map_latents,
                                           pinned_noises, to_u8)
    cfg = generator.cfg
    device = device_of(generator)
    w = h = 2 ** (out_depth + 2)
    latents = np.stack([np.random.RandomState(s).randn(cfg.mapping.latent_size)
                        for s in seeds]).astype(np.float32)
    dlatents = map_latents(generator, latents)
    dlatent_avg = generator.truncation.avg_latent.cpu().numpy()

    images = []
    canvas = Image.new("RGB", (w * len(psis), h * len(seeds)), "white")
    for row, dlatent in enumerate(dlatents):
        row_dl = ((dlatent[None] - dlatent_avg)
                  * np.reshape(psis, [-1, 1, 1]) + dlatent_avg)
        with torch.inference_mode():
            out = generator.g_synthesis(
                torch.from_numpy(row_dl.astype(np.float32)).to(device),
                depth=out_depth, alpha=1.0, seed=0,
                noises=pinned_noises(noises, len(psis), device))
        images.append(out.float().cpu().numpy())
        for col, img in enumerate(images[-1]):
            canvas.paste(Image.fromarray(to_u8(img), "RGB"),
                         (col * w, row * h))
    canvas.save(png)
    return np.asarray(canvas), images


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="./configs/sample.yaml")
    parser.add_argument("--generator_file", action="store", type=str,
                        required=True)
    parser.add_argument("--output", default="figure08-truncation-trick.png")
    parser.add_argument("--out_depth", type=int, default=5)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def main(args):
    from stylegan_torch import resolve_device
    from stylegan_torch.cli.common import load_config, load_generator
    from stylegan_torch.models import generator_config_from_cfg

    opt = load_config(args.config)
    assert generator_config_from_cfg(opt).use_truncation, \
        "truncation figure needs a config with truncation_psi > 0"
    device = resolve_device(args.device)
    generator = load_generator(opt, args.generator_file, device)
    out = draw_truncation_trick_figure(args.output, generator,
                                       out_depth=args.out_depth, seeds=SEEDS,
                                       psis=PSIS)
    print("Done.")
    return out


if __name__ == "__main__":
    main(parse_arguments())
