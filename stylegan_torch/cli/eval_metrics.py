"""Evaluate a trained generator against the training set (the port's
counterpart of ``eval_metrics.py``).

Metrics:
  swd (default): Sliced Wasserstein Distance over a Laplacian pyramid
      (ProGAN metric; no pretrained features).
  fid: Frechet Inception Distance; requires --inception_weights, a local
      ``.npz`` of torchvision inception_v3 state_dict tensors (see
      stylegan_torch/metrics/fid.py for the one-line conversion recipe).
  is: Inception Score (mean/std over 10 splits); the same weights file,
      with the fc classifier head.
  ppl: Perceptual Path Length (latent-space smoothness); LPIPS-VGG16 with
      --lpips_weights, else a pyramid-L2 fallback that needs no weights.
      --ppl_space w|z, --ppl_sampling full|end.

    python -m stylegan_torch.cli.eval_metrics --config configs/sample_ffhq_128.yaml \\
        --generator_file out/models/GAN_GEN_SHADOW_5_32.npz --num_samples 256
    python -m stylegan_torch.cli.eval_metrics --config ... --generator_file ... \\
        --metric fid --inception_weights /weights/inception_v3.npz

The arguments are checked before any dataset IO or generation.  Reals come
from the configured dataset (``stylegan_torch.data.make_dataset``), fakes
from train-mode sampling of --batch latents per forward, every draw from
--seed.  Prints one JSON line with the JAX CLI's keys.  Runs on CUDA unless
--device cpu.  The weights load partially, as the JAX CLI's do (a key the
file lacks keeps its initial value; a ``.npz`` shape mismatch warns, a
``.pth`` one raises).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="./configs/sample.yaml")
    parser.add_argument("--generator_file", type=str, required=True)
    parser.add_argument("--num_samples", type=int, default=256)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--metric", choices=["swd", "fid", "is", "ppl"],
                        default="swd")
    parser.add_argument("--inception_weights", type=str, default=None,
                        help="torchvision-schema inception_v3 .npz "
                             "(required for --metric fid / is)")
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help="vgg16+lin lpips .npz for --metric ppl "
                             "(omit to use the pyramid-L2 fallback)")
    parser.add_argument("--ppl_space", choices=["w", "z"], default="w")
    parser.add_argument("--ppl_sampling", choices=["full", "end"],
                        default="full")
    parser.add_argument("--class_id", type=int, default=None,
                        help="conditional models: restrict --metric ppl to "
                             "one class (default: labels sampled uniformly "
                             "over n_classes from --seed)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def generate_fakes(generator, num_samples: int, batch: int,
                   seed: int) -> torch.Tensor:
    """Train-mode samples (B, H, W, C) on the generator's device, --batch
    per forward, each forward's latents, labels and noise from (seed,
    forward index)."""
    from stylegan_torch.cli.common import device_of
    from stylegan_torch.models.synthesis import stream_seed
    cfg = generator.cfg
    device = device_of(generator)
    out_depth = cfg.synthesis.depth - 1
    fakes = []
    for k, i in enumerate(range(0, num_samples, batch)):
        n = min(batch, num_samples - i)
        g = torch.Generator().manual_seed(stream_seed(seed, 4, k))
        z = torch.randn((n, cfg.latent_size), generator=g)
        labels = (torch.randint(0, cfg.n_classes, (n,), generator=g)
                  .to(device) if cfg.conditional else None)
        with torch.inference_mode():
            fakes.append(generator(
                z.to(device), depth=out_depth, alpha=1.0,
                seed=stream_seed(seed, 5, k), train=True,
                labels=labels).images)
    return torch.cat(fakes)[:num_samples]


def main(args):
    from stylegan_torch import resolve_device
    from stylegan_torch.cli.common import load_config, load_generator

    opt = load_config(args.config)
    # pure argument validation: fail before any dataset IO or generation
    if args.metric in ("fid", "is") and not args.inception_weights:
        raise SystemExit(
            f"--metric {args.metric} requires --inception_weights "
            "<inception_v3.npz>; without pretrained weights use the "
            "default --metric swd")
    device = resolve_device(args.device)
    generator = load_generator(opt, args.generator_file, device)

    if args.metric == "ppl":
        from stylegan_torch.metrics import (load_lpips_weights, make_lpips_fn,
                                            make_pyramid_distance,
                                            ppl_samples, ppl_score)
        if args.lpips_weights:
            dist_fn, dist_name = (make_lpips_fn(
                load_lpips_weights(args.lpips_weights), device), "lpips-vgg16")
        else:
            dist_fn, dist_name = make_pyramid_distance(), "pyramid-l2"
        # conditional: labels sampled uniformly per batch (seed-determined)
        # unless --class_id pins a single class
        labels = n_classes = None
        if opt.conditional:
            if args.class_id is not None:
                if not 0 <= args.class_id < opt.n_classes:
                    sys.exit(f"--class_id {args.class_id} out of range for "
                             f"n_classes={opt.n_classes}")
                labels = torch.full((args.batch,), args.class_id,
                                    dtype=torch.long)
            else:
                n_classes = opt.n_classes
        d = ppl_samples(generator, dist_fn, num_samples=args.num_samples,
                        batch_size=args.batch, seed=args.seed,
                        space=args.ppl_space, sampling=args.ppl_sampling,
                        labels=labels, n_classes=n_classes)
        result = {"ppl": round(ppl_score(d), 4),
                  "distance": dist_name, "space": args.ppl_space,
                  "sampling": args.ppl_sampling,
                  "num_samples": args.num_samples}
        if opt.conditional:
            result["labels"] = (f"class {args.class_id}"
                                if args.class_id is not None
                                else f"uniform over {opt.n_classes}")
        print(json.dumps(result))
        return result

    # real samples (IS scores generated images only: no dataset needed)
    reals = None
    if args.metric != "is":
        from stylegan_torch.data import make_dataset
        dataset = make_dataset(opt.dataset, conditional=opt.conditional)
        rs = np.random.RandomState(args.seed)
        idx = rs.choice(len(dataset), size=args.num_samples, replace=False)
        reals = torch.from_numpy(np.stack(
            [dataset.get(int(i), rs)[0] if opt.conditional
             else dataset.get(int(i), rs) for i in idx])).to(device)

    fakes = generate_fakes(generator, args.num_samples, args.batch,
                           args.seed).float()

    if args.metric == "is":
        from stylegan_torch.metrics import compute_inception_score
        mean, std = compute_inception_score(
            torch.clamp((fakes + 1) / 2, 0, 1), args.inception_weights,
            batch_size=args.batch, device=device)
        result = {"inception_score": round(mean, 4),
                  "inception_score_std": round(std, 4),
                  "num_samples": args.num_samples}
    elif args.metric == "fid":
        from stylegan_torch.metrics import compute_fid
        # datasets / generator produce [-1, 1]; FID's pipeline takes [0, 1]
        fid = compute_fid(torch.clamp((reals + 1) / 2, 0, 1),
                          torch.clamp((fakes + 1) / 2, 0, 1),
                          args.inception_weights, batch_size=args.batch,
                          device=device)
        result = {"fid": round(fid, 4), "num_samples": args.num_samples}
    else:
        from stylegan_torch.metrics import sliced_wasserstein_distance
        swd = sliced_wasserstein_distance(
            reals, fakes, generator=torch.Generator().manual_seed(
                args.seed + 1))
        result = {f"swd_x1e3_{k}": round(v * 1e3, 3) for k, v in swd.items()}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(parse_arguments())
