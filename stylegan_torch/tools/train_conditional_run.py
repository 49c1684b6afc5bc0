"""Class-conditional training-quality evidence run on the port (the
counterpart of ``tools/train_conditional_run.py``).

Trains the conditional path end to end — class embedding concatenated to
the latent (reference GAN.py:233-236, 262-270), label planes concatenated
to the D input (GAN.py:402-437), ConditionalGANLoss — on a synthetic
dataset of four visually distinct blob families, tracking PER-CLASS SWD of
the EMA generator against held-out reals of that class.  Falling per-class
SWD (and cross-class SWD staying higher than own-class) shows that the
conditional machinery trains, not just steps.

    python -m stylegan_torch.tools.train_conditional_run --steps 2000 \\
        --out runs/conditional_64 [--device cpu]

The trainer is the JAX tool's: bf16 activations, EMA 0.999, int64 labels,
--loss (conditional-loss by default).  The eval reads the shadow generator
side-effect free, as ``train_quality_run.sample_shadow`` does: fixed
latents from a CPU generator seeded 1234, noise seeds 9000 + i, the SWD's
draws from a host generator seeded 4321.

Outputs: <out>/metrics.jsonl, <out>/grid_c<k>_<step>.png per class,
<out>/reals_c<k>.png, <out>/summary.json, with the JAX tool's keys.  Runs on
CUDA unless --device cpu; a missing GPU is an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from stylegan_torch.tools.train_quality_run import (build_trainer,
                                                    eval_latents,
                                                    sample_shadow, save_grid,
                                                    swd_x1e3)

N_CLASSES = 4


def class_batch(rs: np.random.RandomState, n: int, res: int,
                cls: int) -> np.ndarray:
    """Four visually distinct families in [-1, 1] NHWC:
    0: few large warm blobs on a dark field; 1: many small cool blobs;
    2: horizontal stripes + one blob; 3: rings (annular blobs)."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, res), np.linspace(-1, 1, res),
                         indexing="ij")
    out = np.empty((n, res, res, 3), np.float32)
    for i in range(n):
        img = np.zeros((res, res, 3), np.float32)
        if cls == 0:
            img -= 0.6
            for _ in range(rs.randint(1, 3)):
                cx, cy = rs.uniform(-0.5, 0.5, 2)
                sig = rs.uniform(0.35, 0.6)
                color = np.array([rs.uniform(0.4, 1.0),
                                  rs.uniform(0.0, 0.5),
                                  rs.uniform(-0.3, 0.2)], np.float32)
                img += np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                              / (2 * sig ** 2))[..., None] * color
        elif cls == 1:
            img += 0.2
            for _ in range(rs.randint(8, 14)):
                cx, cy = rs.uniform(-0.9, 0.9, 2)
                sig = rs.uniform(0.05, 0.12)
                color = np.array([rs.uniform(-0.4, 0.1),
                                  rs.uniform(0.0, 0.6),
                                  rs.uniform(0.4, 1.0)], np.float32)
                img += np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                              / (2 * sig ** 2))[..., None] * color
        elif cls == 2:
            freq = rs.uniform(3, 6)
            phase = rs.uniform(0, np.pi)
            img += (np.sin(yy * freq * np.pi + phase)[..., None]
                    * rs.uniform(0.3, 0.7, 3).astype(np.float32))
            cx, cy = rs.uniform(-0.6, 0.6, 2)
            img += np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 0.08)[
                ..., None] * rs.uniform(-1, 1, 3).astype(np.float32)
        else:
            img -= 0.2
            for _ in range(rs.randint(2, 4)):
                cx, cy = rs.uniform(-0.6, 0.6, 2)
                r0 = rs.uniform(0.25, 0.5)
                d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
                ring = np.exp(-((d - r0) ** 2) / (2 * 0.05 ** 2))
                img += ring[..., None] * rs.uniform(0.3, 1.0, 3).astype(
                    np.float32)
        out[i] = np.tanh(img)
    return out


def parse_arguments(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval_every", type=int, default=400)
    ap.add_argument("--pool_per_class", type=int, default=512)
    ap.add_argument("--out", default="runs/conditional_64")
    ap.add_argument("--loss", default="conditional-loss",
                    help="conditional-loss (reference BCE) | "
                         "conditional-relativistic-hinge | "
                         "conditional-logistic (beyond-reference variants)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget_s", type=float, default=None)
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

    def log(m):
        print(f"# {m}", file=sys.stderr, flush=True)

    # the JAX tool's trainer: no lazy R1, fused scoring or G-forward reuse
    trainer = build_trainer(
        RES, args.seed, device, conditional=True, n_classes=N_CLASSES,
        loss=args.loss, r1_interval=1, fuse_scores=False, reuse_g_fwd=False)
    depth = trainer.depth - 1

    rs = np.random.RandomState(args.seed)
    log(f"generating {N_CLASSES}x{args.pool_per_class} training pool...")
    pools = [class_batch(rs, args.pool_per_class, RES, k)
             for k in range(N_CLASSES)]
    eval_rs = np.random.RandomState(777)
    eval_reals = [class_batch(eval_rs, 128, RES, k) for k in range(N_CLASSES)]
    for k in range(N_CLASSES):
        save_grid(os.path.join(args.out, f"reals_c{k}.png"),
                  eval_reals[k][:16], cols=4)
    eval_reals = [torch.from_numpy(r).to(device) for r in eval_reals]
    eval_z = eval_latents(trainer, 128)

    def swd_of(reals, fakes):
        return swd_x1e3(reals, fakes)["avg"]

    def eval_all(step, grids=False):
        rec = {"step": step, "elapsed_s": round(time.time() - t0, 1)}
        fakes_by_class = [sample_shadow(trainer, depth, eval_z, label=k)
                          for k in range(N_CLASSES)]
        for k in range(N_CLASSES):
            rec[f"swd_own_c{k}"] = swd_of(eval_reals[k], fakes_by_class[k])
        # cross-class control: class-0 fakes vs class-1 reals should stay
        # clearly worse than own-class once conditioning is learned
        rec["swd_cross_c0_vs_r1"] = swd_of(eval_reals[1], fakes_by_class[0])
        rec["swd_cross_c1_vs_r0"] = swd_of(eval_reals[0], fakes_by_class[1])
        if grids:
            for k in range(N_CLASSES):
                save_grid(os.path.join(args.out,
                                       f"grid_c{k}_{step:06d}.png"),
                          fakes_by_class[k][:16].cpu().numpy(), cols=4)
        history.append(rec)
        mf.write(json.dumps(rec) + "\n")
        mf.flush()
        print(json.dumps(rec), flush=True)

    t0 = time.time()
    history = []
    mf = open(os.path.join(args.out, "metrics.jsonl"), "a")
    for step in range(args.steps + 1):
        if step % args.eval_every == 0 or step == args.steps:
            eval_all(step, grids=(step % (2 * args.eval_every) == 0
                                  or step == args.steps))
        if step == args.steps:
            break
        if args.budget_s and time.time() - t0 > args.budget_s:
            log(f"budget hit at step {step}")
            break
        labels = rs.randint(0, N_CLASSES, args.batch)
        reals = np.stack([pools[c][rs.randint(0, args.pool_per_class)]
                          for c in labels])
        flip = rs.rand(args.batch) < 0.5
        reals[flip] = reals[flip, :, ::-1]
        # the losses stay on the device between log points, so the steps
        # queue back to back
        d_loss, g_loss = trainer.train_on_batch(reals, depth, alpha=1.0,
                                                labels=labels.astype(np.int64),
                                                fetch=False)
        if step % 100 == 0:
            log(f"step {step}: d={float(d_loss):.4f} g={float(g_loss):.4f} "
                f"({time.time()-t0:.0f}s)")
    mf.close()

    own_first = np.mean([history[0][f"swd_own_c{k}"]
                         for k in range(N_CLASSES)])
    own_last = np.mean([history[-1][f"swd_own_c{k}"]
                        for k in range(N_CLASSES)])
    cross_last = np.mean([history[-1]["swd_cross_c0_vs_r1"],
                          history[-1]["swd_cross_c1_vs_r0"]])
    summary = {
        "steps_completed": history[-1]["step"],
        "swd_own_avg_first": round(float(own_first), 2),
        "swd_own_avg_last": round(float(own_last), 2),
        "swd_cross_avg_last": round(float(cross_last), 2),
        "conditioning_separates": bool(cross_last > own_last * 1.2),
        "wall_s": round(time.time() - t0, 1),
        "config": f"{RES}^2 conditional ({N_CLASSES} classes) "
                  f"{args.loss} packed bf16 EMA batch {args.batch}",
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({**summary, "history": history}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
