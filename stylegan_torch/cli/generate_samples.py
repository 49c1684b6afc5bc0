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

--spatial_devices N splits each image by height over N devices
(``parallel/spatial.py``; eval semantics and batch 1 per image, as the JAX
CLI's), one process each: the ranks of a ``torchrun --nproc_per_node N``
world, or N processes that this command starts.  Rank 0 gathers each image
and writes the PNGs.  The backend is NCCL on the card and gloo on the CPU;
``--device cuda:0`` puts every rank on card 0, over gloo.

    torchrun --nproc_per_node 2 -m stylegan_torch.cli.generate_samples \\
        --config configs/sample_ffhq_1024.yaml --generator_file g.npz \\
        --num_samples 4 --spatial_devices 2
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
                        help="split each image by height over N devices, "
                             "one process each (module docstring)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; with --spatial_devices rank r "
                             "on card r, NCCL), 'cuda:i' (every rank on card "
                             "i, gloo) or 'cpu'")
    return parser.parse_args(argv)


def _load(args, device):
    """(config, the generator with the file's weights, frozen, on
    `device`)."""
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    from stylegan_torch.convert import load_generator_file
    from stylegan_torch.models import Generator, generator_config_from_cfg

    opt = get_default_cfg()
    opt.merge_from_file(args.config)
    opt.freeze()
    apply_runtime_knobs(opt)
    print("Creating generator object ...")
    generator = Generator(generator_config_from_cfg(opt))
    print("Loading the generator weights from:", args.generator_file)
    # strict: a sampler has no use for a partly initialised generator
    load_generator_file(generator, args.generator_file, strict=True)
    return opt, generator.requires_grad_(False).to(device)


def _run_seed(args) -> int:
    return args.seed if args.seed is not None \
        else int.from_bytes(os.urandom(4), "little")


def _requests(seed: int, num_samples: int, latent_size: int):
    """(image number, hypersphere-projected z (1, latent), request seed) of
    each image, drawn from the run's seed."""
    rng = torch.Generator().manual_seed(seed)
    for img_num in range(1, num_samples + 1):
        point = torch.randn((1, latent_size), generator=rng)
        point = point / torch.linalg.norm(point) * latent_size ** 0.5
        yield img_num, point, int(torch.randint(0, 2 ** 31 - 1, (),
                                                generator=rng))


def _save(img, path):
    from stylegan_torch.io import adjust_dynamic_range, save_single_image
    save_single_image(adjust_dynamic_range(img.float().cpu().numpy()), path)


def main(args):
    from stylegan_torch import resolve_device
    from stylegan_torch.serving import make_serving_fn

    device = resolve_device(args.device)
    if args.spatial_devices > 1 and args.input is None:
        return _spatial_main(args)
    opt, generator = _load(args, device)
    gen_cfg = generator.cfg
    out_depth = int(np.log2(opt.dataset.resolution)) - 2

    if args.input is None:
        os.makedirs(args.output_dir, exist_ok=True)
        serve = make_serving_fn(gen_cfg, generator, depth=out_depth,
                                train_quirks=not args.eval, device=device)
        extra = ()
        if gen_cfg.conditional:
            if args.class_id is None:
                raise ValueError("conditional model: pass --class_id")
            extra = (torch.full((1,), args.class_id, dtype=torch.long),)

        print("Generating scale synchronized images ...")
        for img_num, point, request_seed in _requests(
                _run_seed(args), args.num_samples, opt.model.gen.latent_size):
            _save(serve(point, request_seed, *extra),
                  os.path.join(args.output_dir, f"{img_num}.png"))
        print("Generated %d images at %s" % (args.num_samples,
                                             args.output_dir))
    else:
        code = torch.as_tensor(np.load(args.input), dtype=torch.float32)
        with torch.inference_mode():
            img = generator.g_synthesis(code[None].to(device),
                                        depth=out_depth, alpha=1.0,
                                        seed=args.seed or 0)
        _save(img, args.output)
    print("Done.")


def _spatial_main(args):
    """Join torchrun's world, or start --spatial_devices ranks here (one run
    seed for all), and sample split over them."""
    import torch.distributed as dist

    from stylegan_torch.cli.common import rank_backend
    from stylegan_torch.parallel import initialize_distributed, spawn
    backend = rank_backend(args.device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        device = initialize_distributed(device=args.device, backend=backend)
        try:
            seed = [_run_seed(args)]
            dist.broadcast_object_list(seed, src=0)
            _spatial_samples(args, device, seed[0])
        finally:
            dist.destroy_process_group()
    else:
        spawn(_spatial_rank, args.spatial_devices, (args, _run_seed(args)),
              backend=backend, device=args.device)
    print("Done.")


def _spatial_rank(rank, device, args, seed):
    _spatial_samples(args, device, seed)


def _spatial_samples(args, device, seed: int):
    """This rank's part of each image's split forward; rank 0 writes the
    gathered PNGs."""
    from stylegan_torch.parallel import (build_spatial_sample_fn,
                                         create_spatial_mesh, gather_rows)
    opt, generator = _load(args, device)
    if generator.cfg.conditional:
        raise ValueError("--spatial_devices does not support conditional "
                         "models yet")
    mesh = create_spatial_mesh(args.spatial_devices)
    if not mesh.is_member:              # a torchrun world of more ranks
        return
    out_depth = int(np.log2(opt.dataset.resolution)) - 2
    sample = build_spatial_sample_fn(generator.cfg, generator, mesh,
                                     depth=out_depth)
    if mesh.rank == 0:
        os.makedirs(args.output_dir, exist_ok=True)
        print(f"Generating images split over {mesh.size} ranks ...")
    for img_num, point, request_seed in _requests(
            seed, args.num_samples, opt.model.gen.latent_size):
        img = gather_rows(sample(point, request_seed), mesh)
        if mesh.rank == 0:
            _save(img, os.path.join(args.output_dir, f"{img_num}.png"))
    if mesh.rank == 0:
        print("Generated %d images at %s" % (args.num_samples,
                                             args.output_dir))


if __name__ == "__main__":
    main(parse_arguments())
