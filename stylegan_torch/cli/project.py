"""Project a target image into the generator's W(+) space (the port's
counterpart of ``project.py``).

    python -m stylegan_torch.cli.project --config configs/sample.yaml \\
        --generator_file out/models/GAN_GEN_SHADOW_8_4.npz \\
        --target photo.png --output_dir projected/ --num_steps 1000

Optimizes a W+ code (``stylegan_torch/projection.py``) so that the generator
reconstructs the target, then writes ``w.npy`` (which
``python -m stylegan_torch.cli.generate_samples --input w.npy`` takes),
``projected.png`` and ``target.png``.  Runs on CUDA unless --device cpu.
The weights load partially, as the JAX CLI's do.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="./configs/sample.yaml")
    parser.add_argument("--generator_file", type=str, required=True,
                        help="trained generator weights (.npz or .pth)")
    parser.add_argument("--target", type=str, required=True,
                        help="image to project (any PIL-readable format)")
    parser.add_argument("--output_dir", type=str, default="projected/")
    parser.add_argument("--num_steps", type=int, default=1000)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--w_plus", dest="w_plus", action="store_true",
                        default=True, help="per-layer W+ (default)")
    parser.add_argument("--no_w_plus", dest="w_plus", action="store_false",
                        help="optimize a single shared W instead of W+")
    parser.add_argument("--pyramid_levels", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def load_target(path: str, resolution: int, channels: int) -> np.ndarray:
    """The image at `path` resized (LANCZOS) to resolution^2, as float32
    HWC in [-1, 1]."""
    from PIL import Image
    img = Image.open(path)
    img = img.convert("RGB" if channels == 3 else "L")
    img = img.resize((resolution, resolution), Image.LANCZOS)
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr * 2.0 - 1.0


def main(args):
    from stylegan_torch import resolve_device
    from stylegan_torch.cli.common import load_config, load_generator
    from stylegan_torch.io import adjust_dynamic_range, save_single_image
    from stylegan_torch.projection import ProjectorConfig, project

    opt = load_config(args.config)
    device = resolve_device(args.device)
    generator = load_generator(opt, args.generator_file, device)
    if generator.cfg.conditional:
        raise ValueError("projection targets unconditional generators")

    target = load_target(args.target, opt.dataset.resolution,
                         opt.dataset.channels)
    pcfg = ProjectorConfig(num_steps=args.num_steps, w_plus=args.w_plus,
                           initial_lr=args.lr,
                           pyramid_levels=args.pyramid_levels)

    def progress(t, loss):
        print(f"step {t:5d}/{args.num_steps}  loss {loss:.5f}")

    dlatents, image, losses = project(args.seed, generator.cfg, generator,
                                      target, pcfg, callback=progress)

    os.makedirs(args.output_dir, exist_ok=True)
    w_path = os.path.join(args.output_dir, "w.npy")
    np.save(w_path, dlatents)
    save_single_image(adjust_dynamic_range(image),
                      os.path.join(args.output_dir, "projected.png"))
    save_single_image(adjust_dynamic_range(target),
                      os.path.join(args.output_dir, "target.png"))
    print(f"final loss {losses[-1]:.5f}")
    print(f"Saved {w_path} (usable with generate_samples --input) and "
          f"projected.png to {args.output_dir}")
    print("Done.")
    return dlatents, image, losses


if __name__ == "__main__":
    main(parse_arguments())
