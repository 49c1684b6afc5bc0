"""Progressive-growing quality-evidence run on the port (the counterpart of
``tools/train_progressive_run.py``).

Drives the reference's defining training mode, the full linear schedule
4^2 -> final res with per-depth batch sizes and 50% fade-in (reference
models/GAN.py:682-826, config.py:38-42), on the perf stack of
``train_quality_run.build_trainer`` (logistic + lazy R1/16, bf16
activations, EMA, fused scoring, one G forward per update), tracking the
EMA generator's SWD at each depth's native resolution and archiving
per-depth sample grids.

Two artifacts beyond the fixed-depth run:

* the generator grows: per-depth SWD curves and grids across the depth
  transitions with fade-in alpha ramps;
* checkpoint + resume across a depth boundary is bit-identical: the run
  saves the full train state (``save_full_state``) and a sidecar of every
  stream the next steps draw from at the boundary before the final depth,
  and records the next --resume_k step losses; ``--verify_resume``
  restores both in a fresh process, replays those steps from the restored
  z stream and data stream, and requires exact float equality.

    python -m stylegan_torch.tools.train_progressive_run --out runs/progressive_128
    python -m stylegan_torch.tools.train_progressive_run --out runs/progressive_128 \\
        --verify_resume

The sidecar (``boundary_rng.npz``) holds the trainer's z stream (the state
of its device ``torch.Generator``), its count of draws outside the step,
the update count (which seeds each step's noise and style mixing and picks
the lazy-R1 phase) and the numpy MT19937 state of the data stream.  The
proof window (the --resume_k steps after the boundary, in the run and in
the replay) runs under cuDNN's deterministic algorithms: its default
backward algorithms may sum in another order from run to run.
``resume_check.json`` records that mode.  The eval touches none of the
trainer's randomness: fixed latents from a CPU generator, explicit noise
seeds, the W average it returns discarded, the SWD's draws from a fixed
host generator (``train_quality_run.sample_shadow`` / ``swd_x1e3``).

The JAX tool's ``warm_depth`` has no counterpart: it compiled the next
depth's programs in background threads, and the port compiles nothing.

Outputs: <out>/metrics.jsonl (one line per eval), <out>/grid_d<depth>_*.png,
<out>/boundary_ckpt.npz + boundary_rng.npz + resume_expected.json,
<out>/resume_check.json (verify mode), <out>/summary.json, with the JAX
tool's keys.  Runs on CUDA unless --device cpu; a missing GPU is an error.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

from stylegan_torch.tools.train_quality_run import (build_trainer,
                                                    eval_latents,
                                                    sample_shadow, save_grid,
                                                    structured_batch,
                                                    swd_x1e3)

DETERMINISM = "cudnn.deterministic"


def downsample_np(images, factor):
    """Box-downsample NHWC float images by an integer factor (matches the
    step's progressive avg-pool semantics for eval reals)."""
    if factor <= 1:
        return images
    n, h, w, c = images.shape
    return images.reshape(n, h // factor, factor, w // factor, factor,
                          c).mean(axis=(2, 4))


def draw_batch(pool, rs, batch):
    idx = rs.randint(0, len(pool), batch)
    reals = pool[idx]
    flip = rs.rand(batch) < 0.5
    reals[flip] = reals[flip, :, ::-1]
    return reals


def fade_alpha(depth, ticker, steps_d, fade_pct):
    """Alpha of a depth's step `ticker` (1-based): a linear ramp over the
    first fade_pct percent of its steps; depth 0 does not fade."""
    if depth == 0:
        return 1.0
    fade_point = int(fade_pct / 100.0 * steps_d)
    return min(1.0, ticker / fade_point) if fade_point > 0 else 1.0


def eval_every_of(steps_d, resume_k):
    """A depth's eval cadence, never inside the resume-proof window."""
    return max(resume_k + 1, steps_d // 4)


def evals_before(ticker, every):
    """Whether an eval precedes a depth's step `ticker`."""
    return ticker == 1 or ticker % every == 0


def eval_schedule(steps_per_depth, fade_pct, resume_k):
    """(step, depth, local_step, alpha) of every eval of a run that is not
    cut short, in order, as main() records them."""
    out, step = [], 0
    for depth, steps_d in enumerate(steps_per_depth):
        every = eval_every_of(steps_d, resume_k)
        for ticker in range(1, steps_d + 1):
            if evals_before(ticker, every):
                alpha = fade_alpha(depth, ticker, steps_d, fade_pct)
                out.append((step, depth, ticker - 1, round(float(alpha), 4)))
            step += 1
        out.append((step, depth, steps_d, 1.0))
    return out


def save_rng_sidecar(path, trainer, rs, step_index, depth):
    st = rs.get_state()
    np.savez(path, z_state=trainer._z.get_state().numpy(),
             draws=trainer._draws, rs_keys=st[1], rs_pos=st[2],
             rs_has_gauss=st[3], rs_cached=st[4], step_index=step_index,
             depth=depth, update_count=trainer._update_count)


def load_rng_sidecar(path, trainer, rs):
    import torch
    d = np.load(path)
    trainer._z.set_state(torch.from_numpy(np.array(d["z_state"])))
    trainer._draws = int(d["draws"])
    trainer._update_count = int(d["update_count"])
    rs.set_state(("MT19937", d["rs_keys"], int(d["rs_pos"]),
                  int(d["rs_has_gauss"]), float(d["rs_cached"])))
    return int(d["step_index"]), int(d["depth"])


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms inside, the setting restored
    after."""
    import torch
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def parse_arguments(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/progressive_128")
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--steps_per_depth", default="800,800,1200,1600,2400,5200")
    ap.add_argument("--batches", default="128,128,128,64,32,16")
    ap.add_argument("--fade_pct", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pool", type=int, default=2048)
    ap.add_argument("--resume_k", type=int, default=8,
                    help="steps recorded/replayed for the resume proof")
    ap.add_argument("--budget_s", type=float, default=None)
    ap.add_argument("--verify_resume", action="store_true",
                    help="restore the boundary checkpoint in this fresh "
                         "process and replay K steps bit-identically")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_arguments(argv)
    import torch
    from stylegan_torch import resolve_device
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    RES = args.res
    n_depths = int(np.log2(RES)) - 1
    steps_per_depth = [int(s) for s in args.steps_per_depth.split(",")]
    batches = [int(b) for b in args.batches.split(",")]
    assert len(steps_per_depth) == n_depths and len(batches) == n_depths, \
        (steps_per_depth, batches, n_depths)
    boundary_depth = n_depths - 1  # checkpoint right before the final depth

    def log(msg):
        print(f"# {msg}", file=sys.stderr, flush=True)

    trainer = build_trainer(RES, args.seed, device)

    rs = np.random.RandomState(args.seed)
    log(f"generating {args.pool}-image training pool...")
    pool = structured_batch(rs, args.pool, RES)
    ckpt_stem = os.path.join(args.out, "boundary_ckpt")
    rng_path = os.path.join(args.out, "boundary_rng.npz")
    expected_path = os.path.join(args.out, "resume_expected.json")

    def fade(depth, ticker, steps_d):
        return fade_alpha(depth, ticker, steps_d, args.fade_pct)

    # ------------------------------------------------------------------
    if args.verify_resume:
        with open(expected_path) as f:
            expected = json.load(f)
        trainer.restore_full_state(ckpt_stem)
        step_index, depth = load_rng_sidecar(rng_path, trainer, rs)
        assert depth == boundary_depth, (depth, boundary_depth)
        steps_d = steps_per_depth[depth]
        batch = batches[depth]
        log(f"replaying {len(expected['losses'])} steps at depth {depth} "
            f"from the boundary checkpoint (fresh process)")
        replayed = []
        with deterministic():
            for ticker in range(1, len(expected["losses"]) + 1):
                alpha = fade(depth, ticker, steps_d)
                reals = draw_batch(pool, rs, batch)
                d_loss, g_loss = trainer.train_on_batch(reals, depth, alpha)
                replayed.append([d_loss, g_loss])
                log(f"replay step {ticker}: d={d_loss:.6f} g={g_loss:.6f}")
        diffs = [max(abs(a[0] - b[0]), abs(a[1] - b[1]))
                 for a, b in zip(expected["losses"], replayed)]
        check = {
            "steps_replayed": len(replayed),
            "expected": expected["losses"],
            "replayed": replayed,
            "max_abs_diff": max(diffs),
            "bit_identical": all(d == 0.0 for d in diffs),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "deterministic": DETERMINISM,
        }
        with open(os.path.join(args.out, "resume_check.json"), "w") as f:
            json.dump(check, f, indent=1)
        print(json.dumps({k: check[k] for k in
                          ("steps_replayed", "max_abs_diff",
                           "bit_identical")}), flush=True)
        sys.exit(0 if check["bit_identical"] else 1)

    # ------------------------------------------------------------------
    # main progressive run
    eval_reals_full = structured_batch(np.random.RandomState(777), 256, RES)
    eval_reals_by_depth = {
        d: torch.from_numpy(np.ascontiguousarray(downsample_np(
            eval_reals_full, 2 ** (n_depths - 1 - d)))).to(device)
        for d in range(n_depths)}
    eval_z = eval_latents(trainer)

    t0 = time.time()
    metrics_path = os.path.join(args.out, "metrics.jsonl")
    history = []
    expected_losses = []
    global_step = 0
    aborted = None
    mf = open(metrics_path, "a")

    def do_eval(depth, ticker, alpha, grid=False):
        fakes = sample_shadow(trainer, depth, eval_z, alpha)
        swd = swd_x1e3(eval_reals_by_depth[depth], fakes)
        rec = {"step": global_step, "depth": depth, "res": 2 ** (depth + 2),
               "local_step": ticker, "alpha": round(float(alpha), 4),
               "elapsed_s": round(time.time() - t0, 1), "swd_x1e3": swd}
        history.append(rec)
        mf.write(json.dumps(rec) + "\n")
        mf.flush()
        print(json.dumps(rec), flush=True)
        if grid:
            save_grid(os.path.join(
                args.out, f"grid_d{depth}_{ticker:06d}.png"),
                fakes[:36].cpu().numpy())

    for depth in range(n_depths):
        steps_d = steps_per_depth[depth]
        batch = batches[depth]
        res_d = 2 ** (depth + 2)
        every = eval_every_of(steps_d, args.resume_k)
        log(f"=== depth {depth} ({res_d}^2), {steps_d} steps, batch {batch}")
        if depth == boundary_depth:
            # checkpoint at the depth boundary: full train state + RNG +
            # data-stream state, before the first step of the final depth
            trainer.save_full_state(ckpt_stem, depth, 0)
            save_rng_sidecar(rng_path, trainer, rs, global_step, depth)
            log(f"saved boundary checkpoint at step {global_step}")

        for ticker in range(1, steps_d + 1):
            alpha = fade(depth, ticker, steps_d)
            if evals_before(ticker, every):
                do_eval(depth, ticker - 1, alpha, grid=(ticker == 1))
            reals = draw_batch(pool, rs, batch)
            # the losses stay on the device except in the resume-proof
            # window, so the steps queue back to back
            in_proof = depth == boundary_depth and ticker <= args.resume_k
            with deterministic() if in_proof else contextlib.nullcontext():
                d_loss, g_loss = trainer.train_on_batch(reals, depth, alpha,
                                                        fetch=in_proof)
            if in_proof:
                expected_losses.append([d_loss, g_loss])
                if ticker == args.resume_k:
                    with open(expected_path, "w") as f:
                        json.dump({"losses": expected_losses,
                                   "depth": depth,
                                   "deterministic": DETERMINISM}, f)
            global_step += 1
            if ticker % 200 == 0:
                log(f"d{depth} step {ticker}/{steps_d}: d={float(d_loss):.4f} "
                    f"g={float(g_loss):.4f} ({time.time()-t0:.0f}s)")
            if args.budget_s and time.time() - t0 > args.budget_s:
                aborted = f"budget hit at depth {depth} step {ticker}"
                log(aborted)
                break
        do_eval(depth, steps_d if not aborted else ticker, 1.0, grid=True)
        if aborted:
            break

    mf.close()
    final = [h for h in history if h["depth"] == n_depths - 1]
    summary = {
        "schedule": {"steps_per_depth": steps_per_depth, "batches": batches,
                     "fade_pct": args.fade_pct},
        "depths_completed": history[-1]["depth"] + 1 if history else 0,
        "total_steps": global_step,
        "final_depth_swd_avg_first": (final[0]["swd_x1e3"].get("avg")
                                      if final else None),
        "final_depth_swd_avg_last": (final[-1]["swd_x1e3"].get("avg")
                                     if final else None),
        "wall_s": round(time.time() - t0, 1),
        "aborted": aborted,
        "config": f"{RES}^2 progressive linear, logistic lazy-R1/16 packed "
                  f"bf16 EMA fuse_scores reuse_g_fwd",
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({**summary, "history": history}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
