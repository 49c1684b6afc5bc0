"""Generate single image samples from a trained generator (the port's
counterpart of ``generate_samples.py``).

    python -m stylegan_torch.cli.generate_samples --config configs/sample_ffhq_1024.yaml \\
        --generator_file g.npz --num_samples 4 --output_dir out/

Random hypersphere-projected Z samples (z * sqrt(latent)/|z|, reference
:97-98), or synthesis from a saved W code (.npy) via --input.  Like the
reference, sampling uses train-mode semantics (style mixing + truncation in
the training branch); --eval gives deterministic truncation-free sampling.
Runs on CUDA unless --device cpu.  The weights are a JAX-package ``.npz`` or a
reference ``.pth``, loaded strictly (every key, every shape), where the JAX
CLI loads partially.
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
                        required=True,
                        help="pretrained generator weights (.npz, or a reference .pth)")
    parser.add_argument("--num_samples", action="store", type=int, default=300)
    parser.add_argument("--output_dir", action="store", type=str,
                        default="output/")
    parser.add_argument("--input", action="store", type=str, default=None,
                        help="the dlatent code (W) for a certain sample (.npy)")
    parser.add_argument("--output", action="store", type=str,
                        default="output.png")
    parser.add_argument("--eval", action="store_true",
                        help="disable train-mode sampling quirks")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--class_id", type=int, default=None,
                        help="class label for conditional models")
    parser.add_argument("--spatial_devices", type=int, default=1,
                        help="shard each image over N devices (not yet "
                             "ported: must be 1)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def main(args):
    from stylegan_torch import resolve_device
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    from stylegan_torch.convert import load_generator_file
    from stylegan_torch.io import adjust_dynamic_range, save_single_image
    from stylegan_torch.models import Generator, generator_config_from_cfg
    from stylegan_torch.serving import make_serving_fn

    if args.spatial_devices > 1:
        raise NotImplementedError(
            "--spatial_devices > 1 arrives with the port's parallel slice")
    opt = get_default_cfg()
    opt.merge_from_file(args.config)
    opt.freeze()
    apply_runtime_knobs(opt)
    device = resolve_device(args.device)

    print("Creating generator object ...")
    gen_cfg = generator_config_from_cfg(opt)
    generator = Generator(gen_cfg)
    print("Loading the generator weights from:", args.generator_file)
    # strict: a sampler has no use for a partly initialised generator
    load_generator_file(generator, args.generator_file, strict=True)
    generator.requires_grad_(False).to(device)

    latent_size = opt.model.gen.latent_size
    out_depth = int(np.log2(opt.dataset.resolution)) - 2

    if args.input is None:
        os.makedirs(args.output_dir, exist_ok=True)
        rng = torch.Generator().manual_seed(
            args.seed if args.seed is not None
            else int.from_bytes(os.urandom(4), "little"))
        serve = make_serving_fn(gen_cfg, generator, depth=out_depth,
                                train_quirks=not args.eval, device=device)
        extra = ()
        if gen_cfg.conditional:
            if args.class_id is None:
                raise ValueError("conditional model: pass --class_id")
            extra = (torch.full((1,), args.class_id, dtype=torch.long),)

        print("Generating scale synchronized images ...")
        for img_num in range(1, args.num_samples + 1):
            point = torch.randn((1, latent_size), generator=rng)
            point = point / torch.linalg.norm(point) * latent_size ** 0.5
            request_seed = int(torch.randint(0, 2 ** 31 - 1, (),
                                             generator=rng))
            img = serve(point, request_seed, *extra)
            img = adjust_dynamic_range(img.float().cpu().numpy())
            save_single_image(img, os.path.join(args.output_dir,
                                                f"{img_num}.png"))
        print("Generated %d images at %s" % (args.num_samples,
                                             args.output_dir))
    else:
        code = torch.as_tensor(np.load(args.input), dtype=torch.float32)
        with torch.inference_mode():
            img = generator.g_synthesis(code[None].to(device),
                                        depth=out_depth, alpha=1.0,
                                        seed=args.seed or 0)
        img = adjust_dynamic_range(img.float().cpu().numpy())
        save_single_image(img, args.output)
    print("Done.")


if __name__ == "__main__":
    main(parse_arguments())
