"""Latent-walk / truncation-sweep snapshot videos (the port's counterpart of
``generate_video.py``):

  --mode walk        a smooth loop through random latent endpoints (slerp in
                     Z, mapped to W), the per-layer noise pinned for temporal
                     coherence;
  --mode truncation  one seed swept through psi 1 -> -1 -> 1 against the
                     stored W average.

    python -m stylegan_torch.cli.generate_video --config configs/sample_ffhq_1024.yaml \\
        --generator_file g.npz --output walk.gif --mode walk

Frames are synthesised --batch at a time (the last batch padded with the
first frames).  The noise maps are drawn once, of batch 1, from --seed + 1,
and shared by every frame.  Writes an animated GIF with PIL, and an mp4 too
when ``imageio`` (with ffmpeg) imports.  Runs on CUDA unless --device cpu.
The weights load partially, as the JAX CLI's do (a key the file lacks keeps
its initial value; a ``.npz`` shape mismatch warns, a ``.pth`` one raises).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="./configs/sample.yaml")
    parser.add_argument("--generator_file", type=str, required=True)
    parser.add_argument("--output", type=str, default="video.gif")
    parser.add_argument("--mode", choices=["walk", "truncation"],
                        default="walk")
    parser.add_argument("--num_points", type=int, default=6,
                        help="walk: number of latent endpoints in the loop")
    parser.add_argument("--frames_per_step", type=int, default=24,
                        help="walk: frames between consecutive endpoints")
    parser.add_argument("--num_frames", type=int, default=96,
                        help="truncation: frames in the psi sweep")
    parser.add_argument("--fps", type=int, default=24)
    parser.add_argument("--batch", type=int, default=8,
                        help="frames synthesized per call")
    parser.add_argument("--out_depth", type=int, default=None,
                        help="output resolution depth (default: full)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def slerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Spherical interpolation between latent vectors, batched over t."""
    a_n = a / np.linalg.norm(a)
    b_n = b / np.linalg.norm(b)
    omega = np.arccos(np.clip(np.dot(a_n, b_n), -1.0, 1.0))
    if omega < 1e-6:
        return a[None] + t[:, None] * (b - a)[None]
    so = np.sin(omega)
    return (np.sin((1.0 - t)[:, None] * omega) / so * a[None]
            + np.sin(t[:, None] * omega) / so * b[None])


def walk_dlatents(generator, args) -> np.ndarray:
    from stylegan_torch.cli.common import map_latents
    rng = np.random.RandomState(args.seed)
    pts = rng.randn(args.num_points, generator.cfg.mapping.latent_size)
    pts = np.concatenate([pts, pts[:1]], axis=0)          # close the loop
    t = np.arange(args.frames_per_step) / args.frames_per_step
    zs = np.concatenate([slerp(pts[i], pts[i + 1], t)
                         for i in range(args.num_points)]).astype(np.float32)
    return map_latents(generator, zs)


def truncation_dlatents(generator, args) -> np.ndarray:
    from stylegan_torch.cli.common import map_latents
    assert generator.cfg.use_truncation, \
        "truncation mode needs a checkpoint with an avg_latent buffer"
    z = np.random.RandomState(args.seed).randn(
        1, generator.cfg.mapping.latent_size).astype(np.float32)
    dl = map_latents(generator, z)[0]
    avg = generator.truncation.avg_latent.cpu().numpy()
    psis = np.cos(np.linspace(0, 2 * np.pi, args.num_frames))  # 1 -> -1 -> 1
    return (dl[None] - avg) * psis[:, None, None] + avg


def render_frames(generator, dlatents: np.ndarray, out_depth: int,
                  batch: int, noises):
    """Synthesise (F, num_layers, D) dlatents `batch` frames per call with
    the pinned batch-1 `noises`; returns (uint8 frames, float frames)."""
    from stylegan_torch.cli.common import device_of, pinned_noises, to_u8
    device = device_of(generator)
    noises = pinned_noises(noises, 1, device)
    n_frames = len(dlatents)
    pad = (-n_frames) % batch
    dl_all = np.concatenate([dlatents, dlatents[:pad]]) if pad else dlatents
    floats = []
    for i in range(0, len(dl_all), batch):
        dl = torch.from_numpy(np.asarray(dl_all[i:i + batch], np.float32))
        with torch.inference_mode():
            imgs = generator.g_synthesis(dl.to(device), depth=out_depth,
                                         alpha=1.0, noises=noises)
        floats.extend(imgs.float().cpu().numpy())
    floats = floats[:n_frames]
    return [to_u8(f) for f in floats], floats


def make_video(generator, args, noises=None):
    """The frames of args.mode, written to args.output (GIF, and an mp4
    when imageio imports); returns (uint8 frames, float frames).  `noises`
    pins the per-layer (1, H, W, 1) maps, else drawn from args.seed + 1."""
    from stylegan_torch.models.synthesis import layer_resolution, make_noise
    cfg = generator.cfg
    out_depth = (cfg.synthesis.depth - 1 if args.out_depth is None
                 else args.out_depth)
    if args.mode == "walk":
        dlatents = walk_dlatents(generator, args)
    else:
        dlatents = truncation_dlatents(generator, args)
    if dlatents.ndim == 2:   # (F, D) -> broadcast to all layers
        dlatents = np.repeat(dlatents[:, None], cfg.num_layers, axis=1)
    elif dlatents.shape[1] == 1:
        dlatents = np.repeat(dlatents, cfg.num_layers, axis=1)
    print(f"{len(dlatents)} frames at depth {out_depth} ({args.mode})")

    if noises is None:     # one map per layer, the same for every frame
        noises = [make_noise(args.seed + 1, l, 1, layer_resolution(l), "cpu")
                  for l in range(cfg.num_layers)]
    frames, floats = render_frames(generator, dlatents, out_depth, args.batch,
                                   noises)

    from PIL import Image
    pil = [Image.fromarray(f if f.shape[-1] == 3 else f[..., 0])
           for f in frames]
    out = args.output
    os.makedirs(os.path.dirname(os.path.abspath(out)) or ".", exist_ok=True)
    if not out.endswith(".gif"):
        out = os.path.splitext(out)[0] + ".gif"
    pil[0].save(out, save_all=True, append_images=pil[1:],
                duration=int(1000 / args.fps), loop=0)
    print("Wrote", out)
    try:  # optional mp4 if an ffmpeg-backed imageio is available
        import imageio
        mp4 = os.path.splitext(args.output)[0] + ".mp4"
        imageio.mimwrite(mp4, frames, fps=args.fps)
        print("Wrote", mp4)
    except Exception:
        pass
    return frames, floats


def main(args):
    from stylegan_torch import resolve_device
    from stylegan_torch.cli.common import load_config, load_generator

    opt = load_config(args.config)
    device = resolve_device(args.device)
    generator = load_generator(opt, args.generator_file, device)
    out = make_video(generator, args)
    print("Done.")
    return out


if __name__ == "__main__":
    main(parse_arguments())
