"""Long-horizon training-quality evidence run on the port (the counterpart
of ``tools/train_quality_run.py``).

Trains the full perf stack at a fixed depth (default 128^2, --res selects):
logistic + lazy R1 (interval 16), bf16 activations, fused scoring on R1's
off-steps, one G forward per update, EMA 0.999 (``packed_layout`` is
accepted and gives the unpacked math), on the structured synthetic dataset
of the JAX tool, for --steps fused updates (default 10k), tracking the EMA
generator's SWD against held-out reals every --eval_every steps and
archiving sample grids.  The claim evidenced is "the perf stack trains to
improving sample quality over a long horizon", not dataset-level fidelity.

    python -m stylegan_torch.tools.train_quality_run --steps 10000 \\
        --out runs/quality_128 [--device cpu]

Randomness is pinned, not matched: the data comes from the JAX tool's numpy
streams (the same pool, eval reals and batches), z from the trainer's
device generator, the eval latents from a CPU ``torch.Generator`` seeded
1234 and the SWD draws from one seeded 4321.  The eval reads the shadow
generator through the trainer's sampler with explicit seeds and discards
the W average it returns, so it consumes none of the trainer's randomness.

Outputs: <out>/metrics.jsonl (one line per eval: step, swd levels),
<out>/grid_<step>.png sample grids, <out>/reals.png, <out>/summary.json,
with the JAX tool's keys.  Runs on CUDA unless --device cpu; a missing GPU
is an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

EVAL_SAMPLES = 256       # eval fakes per SWD, drawn 32 at a time
EVAL_CHUNK = 32
EVAL_Z_SEED = 1234
EVAL_NOISE_SEED = 9000   # + the chunk's first index
SWD_SEED = 4321


def structured_batch(rs: np.random.RandomState, n: int,
                     res: int) -> np.ndarray:
    """Smooth colored gradient-blobs in [-1, 1] NHWC — structured enough
    that SWD separates a learning generator from noise (same family as the
    round-2 runs, so curves are comparable)."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, res), np.linspace(-1, 1, res),
                         indexing="ij")
    out = np.empty((n, res, res, 3), np.float32)
    for i in range(n):
        img = np.zeros((res, res, 3), np.float32)
        # background color gradient
        g = rs.randn(2, 3).astype(np.float32) * 0.3
        img += xx[..., None] * g[0] + yy[..., None] * g[1]
        for _ in range(rs.randint(2, 5)):
            cx, cy = rs.uniform(-0.7, 0.7, 2)
            sig = rs.uniform(0.1, 0.45)
            color = rs.uniform(-1, 1, 3).astype(np.float32)
            blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig ** 2))
            img += blob[..., None] * color
        out[i] = np.tanh(img)
    return out


def save_grid(path: str, images: np.ndarray, cols: int = 6) -> None:
    from PIL import Image
    imgs = np.clip((images + 1) / 2, 0, 1)
    n, h, w, c = imgs.shape
    rows = (n + cols - 1) // cols
    canvas = np.zeros((rows * h, cols * w, c), np.float32)
    for i, im in enumerate(imgs):
        r, cc = divmod(i, cols)
        canvas[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = im
    Image.fromarray((canvas * 255).astype(np.uint8)).save(path)


def build_trainer(res: int, seed: int, device, **overrides):
    """The JAX tools' trainer on the port: the default config's networks at
    `res`, logistic + lazy R1/16, bf16 activations (TF32 for what runs in
    float32), EMA 0.999, fused scoring, one G forward per update; keyword
    `overrides` replace StyleGAN arguments (the conditional run's)."""
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    from stylegan_torch.train import StyleGAN
    opt = get_default_cfg()
    opt.merge_from_list([
        "dataset.resolution", res,
        "loss", "logistic",
        "r1_interval", 16,
        "precision.activations", "bfloat16",
        "ops.packed", True,
    ])
    apply_runtime_knobs(opt)
    kw = dict(
        structure="linear", resolution=res, num_channels=3,
        latent_size=opt.model.gen.latent_size,
        g_args=opt.model.gen, d_args=opt.model.dis,
        g_opt_args=opt.model.g_optim, d_opt_args=opt.model.d_optim,
        loss="logistic", use_ema=True, ema_decay=0.999,
        seed=seed, activations_dtype="bfloat16", packed_layout=True,
        r1_interval=16, fuse_scores=True, reuse_g_fwd=True, device=device)
    kw.update(overrides)
    return StyleGAN(**kw)


def eval_latents(trainer, n: int = EVAL_SAMPLES):
    """The eval's fixed float32 latents, from a CPU generator (the same z on
    the CPU and on the card), on the trainer's device."""
    import torch
    g = torch.Generator().manual_seed(EVAL_Z_SEED)
    return torch.randn((n, trainer.latent_size), generator=g).to(
        trainer.device)


def sample_shadow(trainer, depth: int, eval_z, alpha: float = 1.0,
                  label=None):
    """Side-effect-free samples of the EMA generator: the trainer's
    train-mode sampler on `eval_z` in chunks of 32, chunk i's noise and
    mixing from seed 9000 + i, every image of class `label` if given; the W
    average it returns is discarded.  float32 (N, H, W, C) on the device."""
    import torch
    fn = trainer._get_sample_fn(depth)
    fakes = []
    for i in range(0, len(eval_z), EVAL_CHUNK):
        z = eval_z[i:i + EVAL_CHUNK]
        labels = (None if label is None else torch.full(
            (len(z),), label, dtype=torch.long, device=z.device))
        imgs, _ = fn(trainer.state.g_shadow, z, EVAL_NOISE_SEED + i,
                     float(alpha), labels)
        fakes.append(imgs.float())
    return torch.cat(fakes)


def eval_swd_levels(reals, fakes, draws=None) -> dict:
    """SWD of the eval, per level and averaged: its draws from a host
    generator seeded 4321, or `draws` pinned (as the tests pin JAX's)."""
    import torch
    from stylegan_torch.metrics import sliced_wasserstein_distance
    return sliced_wasserstein_distance(
        reals, fakes, generator=torch.Generator().manual_seed(SWD_SEED),
        draws=draws)


def swd_x1e3(reals, fakes) -> dict:
    """eval_swd_levels x1e3, rounded to 0.01 as the JAX tools report it."""
    return {k: round(float(v) * 1e3, 2)
            for k, v in eval_swd_levels(reals, fakes).items()}


def parse_arguments(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--res", type=int, default=128,
                    help="training resolution (power of two)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--eval_every", type=int, default=500)
    ap.add_argument("--grid_every", type=int, default=2000)
    ap.add_argument("--out", default="runs/quality_128")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget_s", type=float, default=None,
                    help="stop cleanly after this many seconds")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_arguments(argv)
    import torch
    from stylegan_torch import resolve_device
    device = resolve_device(args.device)
    RES = args.res
    os.makedirs(args.out, exist_ok=True)

    trainer = build_trainer(RES, args.seed, device)
    depth = trainer.depth - 1  # full resolution, no progressive schedule

    rs = np.random.RandomState(args.seed)
    # finite training set (like a real dataset; also keeps host-side data
    # generation off the step's critical path) + horizontal-flip augment
    print("# generating 2048-image training pool...", file=sys.stderr,
          flush=True)
    pool = structured_batch(rs, 2048, RES)
    eval_reals = structured_batch(np.random.RandomState(777), 256, RES)
    save_grid(os.path.join(args.out, "reals.png"), eval_reals[:36])
    eval_reals_t = torch.from_numpy(eval_reals).to(device)
    eval_z = eval_latents(trainer)

    def eval_swd(step):
        fakes = sample_shadow(trainer, depth, eval_z)
        return swd_x1e3(eval_reals_t, fakes), fakes.cpu().numpy()

    t0 = time.time()
    metrics_path = os.path.join(args.out, "metrics.jsonl")
    history = []
    with open(metrics_path, "a") as mf:
        for step in range(args.steps + 1):
            if step % args.eval_every == 0 or step == args.steps:
                swd, fakes = eval_swd(step)
                rec = {"step": step, "elapsed_s": round(time.time() - t0, 1),
                       "swd_x1e3": swd}
                history.append(rec)
                mf.write(json.dumps(rec) + "\n")
                mf.flush()
                print(json.dumps(rec), flush=True)
                if step % args.grid_every == 0 or step == args.steps:
                    save_grid(os.path.join(args.out, f"grid_{step:06d}.png"),
                              fakes[:36])
            if step == args.steps:
                break
            if args.budget_s and time.time() - t0 > args.budget_s:
                print(f"# budget hit at step {step}", flush=True)
                break
            idx = rs.randint(0, len(pool), args.batch)
            reals = pool[idx]
            flip = rs.rand(args.batch) < 0.5
            reals[flip] = reals[flip, :, ::-1]
            # the losses stay on the device between log points, so the
            # steps queue back to back
            d_loss, g_loss = trainer.train_on_batch(reals, depth, alpha=1.0,
                                                    fetch=False)
            if step % 100 == 0:
                print(f"# step {step}: d={float(d_loss):.4f} "
                      f"g={float(g_loss):.4f} "
                      f"({time.time()-t0:.0f}s)", file=sys.stderr, flush=True)

    summary = {
        "steps_completed": history[-1]["step"] if history else 0,
        "swd_avg_first": history[0]["swd_x1e3"].get("avg"),
        "swd_avg_last": history[-1]["swd_x1e3"].get("avg"),
        "wall_s": round(time.time() - t0, 1),
        "config": f"{RES}^2 logistic lazy-R1/16 packed bf16 EMA batch "
                  f"{args.batch}",
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({**summary, "history": history}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
