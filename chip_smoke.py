#!/usr/bin/env python3
"""On-card correctness check of the PyTorch/CUDA port (stylegan_torch) on
one NVIDIA card, with device timings of its hand-written kernels.

    python3 chip_smoke.py

It holds the CUDA kernels and the served and trained networks to their plain
versions, the CPU and float64, counts the kernels' calls and launches, and
times each kernel against its bytes bound.  End-to-end speed (img/s, ms a
request or a step, MFU, idle shares) is gpubench's: python3 -m gpubench.run.

Phases, each fatal on failure:

1. build   compile the epilogue kernels (csrc/epilogue.cu) with nvcc for sm_90a;
2. kernel  at each of the 9 epilogue shapes of a 1024^2 forward, batch 8, in
           float32 and bfloat16: run the kernel and the plain PyTorch version
           (ops/fused.py::_reference_epilogue) on the same CUDA tensors, hold
           max |diff| to its tolerance and two kernel calls to bitwise
           equality, print the plan taken (path, cluster, CUDA launches per
           call), time both with CUDA events (device time from CUDA-graph
           replays with x warm in L2, and with x and out rotated over more
           than 100 MB of buffers so that L2 is cold; and eager calls); hold
           it too at ragged shapes that take its scalar (unvectorised) path;
           check the autograd.Function's gradients against autograd of the
           plain version; then hold the forward to the plain version at the 9
           shapes in float32 at projection's batch 1 (timed, with the plain
           version and the bytes bound) and at the batch sizes the tool CLIs
           of phase 7 give it (3, 5, 6, 16, 40), with the same bar and
           bitwise repeat, printing each plan;
3. slice   build the FFHQ-1024 generator of configs/sample_ffhq_1024.yaml with
           seeded random weights (noise weights included), serve 3 requests of
           batch 8 at 1024^2 through make_serving_fn, check shapes, finiteness
           and 18 kernel calls per forward, and hold the first 2 images of a
           request to the same generator on the CPU (plain path, TF32 off) at
           max |diff| <= 1e-2; profile one more forward (torch.profiler): each
           epilogue kernel must show in it as many launches as the plans
           make (26 per forward), each with device time;
4. cli     save the same weights as a JAX-package .npz and run
           `python -m stylegan_torch.cli.generate_samples` on them;
5. train   (a) the epilogue's backward kernels against autograd of the plain
           version at the 9 epilogue shapes, batch 2 and 8, float32 and
           bfloat16, two calls bitwise equal, with the plan taken (path,
           cluster, CUDA launches per call), timed at batch 2 in both dtypes
           (graph replay, cold L2, eager; the plain VJP in float32) against
           the bytes bound; and at batch 1 as projection asks it (dx and
           dstyle only, the plan without dnoise), timed, with its plan;
           (b) FFHQ-1024 training at depth 8, batch 2 (sched.batch_sizes[8]),
           loss logistic with R1, alpha 0.5, seeded random weights and seeded
           numpy reals: 3 steps (finite losses, peak memory), 36 forward and
           18 backward epilogue kernel calls per step with the CUDA launches
           the plans make, no call of the plain version, the backward calls
           whose incoming gradient had to be copied to NHWC, a profiled step
           (each epilogue kernel as often as the plans launch it), then one
           relativistic-hinge step; (c) one depth-5 step of the same model on
           the card and on the CPU with the draws pinned (and on the CPU in
           float64 as the ground truth): losses, gradients and weights within
           the stated bars;
6. trainer (a) progressive FFHQ-1024 training through StyleGAN.train (the
           yaml with one epoch per depth) from 24 seeded 1024^2 PNGs in two
           folders: the decoder in use (native or PIL); depths 7 (batch 4)
           and 8 (batch 2), fade 50%, grids at least twice per depth
           (2051x2051x3), the five checkpoint files of tags 7_1 and 8_1,
           finite losses and throughput windows at depth 8 in metrics.jsonl,
           32/16 (depth 7) and 36/18 (depth 8) forward/backward epilogue
           calls per step plus the feedback forwards, no plain call, every
           batch on the card bitwise equal to the loader's numpy batch (the
           pinned ring); (b) restore_full_state into a fresh trainer, bitwise
           (every tensor, moment and step, update_count), one more step with
           fetch=False under CUDA's sync debug mode set to error; the train
           CLI (--start_depth 8 and the five _8_1 files, 4 images) in a
           subprocess, and the sample CLI on its GAN_GEN_SHADOW_8_1.npz;
7. tools   the generation CLIs on FFHQ-1024 (configs/sample_ffhq_1024.yaml,
           and its _truncation variant for the truncation figure and sweep):
           seeded weights, noise weights included, the W average the mean of
           mapped W over a seeded batch; each CLI's main() in process with
           the kernel's counters reset: the grid (10x4, one forward), the
           mixing figure (5 forwards) and the truncation figure (2) at depth
           8, the video's walk (2 points x 8 frames) and truncation sweep (16
           frames), 2 forwards of 8 each, and eval_metrics on 24 seeded 1024^2
           PNGs with --num_samples 16: swd, fid and is (a seeded-init
           Inception .npz), ppl with the pyramid-L2 fallback and with a
           seeded-init LPIPS .npz (2 forwards each); each output's shape and
           finiteness, 18 epilogue calls per forward and no plain call; then
           one subprocess of every CLI, all at once, on the card, convert
           included (a synthetic official TF pickle of the same generator,
           its .npz bitwise; --export_pth of G and D, their state_dicts and
           blur buffers); then the mixing figure at depth 5 on the card and
           on the CPU with the noise maps drawn on the CPU (max |diff| <=
           1e-2) and Inception features of 4 of its images (<= 1e-3
           relative, TF32 off);
8. export  FFHQ-1024 (configs/sample_ffhq_1024.yaml, seeded weights with
           non-zero noise weights, eval mode, float32 with TF32 off):
           (a) one served request under utils.profiling.trace, whose trace
           JSON (build/chip_smoke/serve_trace/) must list each epilogue
           kernel as often as the wrapper launched it; (b) export_generator
           at batch 8 on the card: 3 requests through load_exported, each
           bitwise equal to make_serving_fn, and one request served twice
           bitwise equal, with cuDNN's default algorithms (the fused upscale
           runs as a sub-pixel convolution where no gradient is recorded),
           18 nodes of the forward op and 18 kernel calls per request, no
           plain call; a batch-2 depth-5 artifact exported on the card and
           run on the CPU within 1e-2; (c) project at 1024^2, W+, 100 steps
           on the generator's own image of a W near w_avg: 18 x 101 forward
           and 18 x 100 backward kernel calls, no plain call, the loss curve
           falling; (d) 5 steps at depth 5 on the card, the CPU and the CPU in
           float64 with pinned draws: the losses at w_avg, the first step's
           gradient and W after the 5 steps (bars stated at CHECK_W_FACTOR);
           (e) the project and export_generator --check CLIs and
           generate_samples --input on (c)'s w.npy, as subprocesses on the
           card;
9. bf16    configs/sample_ffhq_1024_tpu_perf.yaml (bf16 activations, float32
           parameters): (a) phase 3's generator on bf16 z, batch 8 at
           1024^2: 18 kernel calls per forward and no plain call, the drift
           from float32 on the same z and pinned noise within
           tests/test_bf16.py's bars (mean |diff| < 0.02, max < 0.25 of the
           span), two runs bitwise equal; (b) the perf config's trainer at
           depth 8, batch 2 (logistic, lazy R1 at 16, remat, fused scoring on
           the off-steps): 3 R1 steps and 3 off-steps, finite losses, each
           step's epilogue calls in its D update (18 forward) and G update
           (18 forward, 16 recomputed, 18 backward), no plain call, one
           profiled step of each (the kernels as the plans launch them, and
           their device time inside it); float32 parameters after; (c) one
           depth-5 R1 step on the card and on the CPU in bf16 and on the CPU
           in float64, draws pinned: losses and each gradient within the bars
           at BF16_LOSS_RTOL; (d) the train CLI on a copy of the perf yaml
           over 24 seeded 1024^2 PNGs, depths 7 and 8: finite losses, float32
           checkpoints;
10. parallel data parallelism on FFHQ-1024 (stylegan_torch/parallel, the
           mesh= step): (a) a world of one rank over NCCL, the mesh= step at
           depth 8, batch 2, logistic + R1: its first step's losses and
           gradients, under cuDNN's deterministic algorithms, bitwise equal
           to two runs of the mesh=None step on the same inputs and draws
           (a tensor that is not is named, and held to 10x the two plain
           runs' spread), then 3 steps with 36 forward and 18 backward
           kernel calls per step, no plain call; (b) two ranks spawned on the
           one card over gloo (NCCL refuses two ranks on one device), the
           same step at global batch 4 (2 per rank), a first step and 3 more:
           after each, the two ranks' parameters, buffers (the W-average),
           Adam moments and counts and EMA shadow bitwise equal (sha256),
           finite losses, each rank's kernel calls as (a)'s, no plain call
           (two ranks sharing one card: a correctness run); (c) the two
           ranks' depth-5 step against the one-process step on the global
           batch with chunks=2 minibatch stddev, draws pinned, on the card
           and on the CPU in float64: phase 5(c)'s bars; (d) the train CLI
           under `torchrun --standalone --nproc_per_node 1` (NCCL) on 8
           seeded 1024^2 PNGs, depths 7-8: finite losses, the checkpoint
           files written once;
11. spatial serving (stylegan_torch/parallel/spatial.py), each 1024^2
           image split by height over ranks: (a) the split epilogue
           (K1-partial, the rank-order merge, K2-apply) at the 9 shapes cut
           into 2 and 4 slabs, batch 1 and 8, float32 and bf16, against the
           split plain version (phase 2's bars), against the unsplit kernel
           and bitwise on repeat, each entry timed stage by stage against
           its bytes bound on R/n rows and the launch floor (an empty
           kernel's graph replay), K1-partial also cold in L2, one line per
           case; (b) a one-rank NCCL mesh bitwise equal to
           make_serving_fn; (c) 2 and 4 ranks sharing the card over gloo,
           batch 1 and 8: rank 0's gathered images within 1e-2 and JAX's
           rtol=1e-3, atol=1e-3 of the one-process forward, each rank's
           slab equal to its rows, each rank's kernel calls per request,
           peak memory beside the one-process forward's and
           spatial_hbm_estimate (a correctness and memory run), a bf16
           request within the drift bar; (d) the 2-rank artifact, exported
           in one process, on both ranks bitwise equal to the live spatial
           fn and to itself when served twice; (e) generate_samples
           --spatial_devices 2 (its PNGs within a level of the one-process
           --eval CLI's) and export_generator --spatial_devices 2 --check
           (depth 5) as subprocesses;
12. spatial train the (data x spatial) train step
           (train/steps.py::build_spatial_train_step): (a) K3's split entries
           (K3-partial, the rank-order sum, K3-apply; csrc/epilogue.cu's
           sgt_epilogue_backward_partial / _apply) at the 9 shapes cut into
           2 and 4 slabs, batch 2 and 1, float32 and bf16, against the
           split plain version and the unsplit K3 (phase 5(a)'s bars),
           bitwise on repeat, each entry timed stage by stage (K3-partial
           also cold in L2) against its bytes bound and the launch floor,
           with the sums over one rank's calls of a 1024^2 G backward, one
           line per case; (b) one depth-5 step on (1 x 2) and (2 x 2) grids
           of gloo ranks sharing the card, global batch 4, draws pinned:
           every rank's state bitwise rank 0's, rank 0's within phase 5(c)'s
           bars of the one-process step and float64; (c) depth-8 batch-2
           logistic + R1 steps on the (1 x 2) grid: each rank's kernel calls
           per step (counted from 0 after the first step), no plain call,
           finite losses and states equal on both ranks, each rank's peak
           memory; (d) the train CLI with parallel.spatial: 2, --num_devices
           2 --device cuda:0 on 8 seeded 1024^2 PNGs, depths 7-8 on (1 x 2)
           grids;
13. evidence the evidence tools (stylegan_torch/tools/): (a) K1+K2 and K3
           at the planes of the tools' schedules (the 128^2 progressive
           run's 128x{4,8,16}^2x512, 64x32^2x512, 32x64^2x256,
           16x128^2x128, the conditional run's 32x{4..32}^2x512), float32
           and bfloat16, against their plain versions with phases 2 and
           5(a)'s bars, two calls bitwise equal, each case's plans printed,
           the batch-128 planes timed against the bytes bound; (b) the
           progressive tool at 32^2 (4 depths, batches 128, 128, 128, 64,
           24-32 steps a depth, resume_k 8) in process: every eval's SWD
           finite, the evals on the tool's schedule, each kernel's calls
           and CUDA launches over its steps and evals as the plans make
           them, no plain call, the boundary checkpoint written; then its
           --verify_resume in a fresh process: bit_identical, exit 0;
           (c) the conditional tool at 32^2, batch 32, 24 steps: finite
           per-class SWD, the calls and launches, no plain call;
           (d) measure_latency's flagship 1024^2 generator at batch 1, 2, 4
           and 8 (18 calls a request, its latencies positive and finite);
           (e) the fidelity gate on a synthetic official pickle of the
           seeded FFHQ-1024 generator with a seeded-init Inception .npz, 8
           seeded 1024^2 PNGs and --skip_golden: pass, FID a finite float,
           PPL skipped;
14. stylegan2 StyleGAN2 config F at 1024^2, batch 8 (configs/torch/
           sample_ffhq_1024_stylegan2.yaml, seeded random weights): (a) the
           epilogue2 kernel against its plain version at the forward's 17
           planes, two calls bitwise equal, the 17 calls timed against
           their bytes bound; the up-layers' kernel (the FIR inside the
           epilogue) against its plain version in float64 at the 8
           up-layer planes, two calls bitwise equal, the 8 calls timed
           against their bytes bound, beside the pair it replaces (the
           depthwise FIR, then the epilogue2 kernel: library_ms) and the
           plain version in float32; the up-convolution kernel against its
           plain version (the grouped transposed convolution) in float64 at
           the 8 up-convolutions, two calls bitwise equal, the 8 calls timed
           against their operations' bound at the float32 peak, beside
           cuDNN's grouped conv_transpose2d (library_ms); (b)
           make_serving_fn's images against plainref/stylegan2.py on the
           card (image_gap under 1e-4), 17 epilogue2 calls a forward, 8
           launches of the up-layers' kernel and 17 of the two kernels, 8
           up-convolution launches, a repeated request bitwise equal to the
           first; (c) no depthwise convolution and no cuDNN backward-data
           (dgrad_engine) kernel in a profiled request, the up-convolution
           kernel 8 times; (d) a torch.export artifact bitwise equal to
           make_serving_fn.
15. stylegan3 StyleGAN3-T at 1024^2, batch 8 (configs/torch/
           sample_ffhq_1024_stylegan3t.yaml, seeded random weights): (a) the
           filtered leaky ReLU kernel against its plain version (the
           upfirdn2d chain) in float64 at the forward's 14 filtered layers,
           two calls bitwise equal, the 14 calls timed against their bound
           (gpubench/counts3.py: operations at the float32 peak or bytes at
           the HBM rate, whichever is longer, by call) and beside the plain
           chain in float32; (b) make_serving_fn's images against
           plainref/stylegan3.py on the card (image_gap under 1e-4), 15
           filtered calls and 14 kernel launches a forward; (c) a repeated
           request bitwise equal to the first, and a torch.export artifact
           bitwise equal to make_serving_fn; (d) no depthwise or transposed
           convolution kernel in a profiled request, the filtered kernel 14
           times.

Each phase prints its seconds.  `python3 chip_smoke.py --only 3 8 14` runs the
build and just those phases (to try a change; no result lines).

The last two lines are {"kernels": [...]} with the kernels' measurements and
{"ok": true, "device": {...}}; the card's name and power limit precede them.
Exits non-zero without a result when CUDA is missing or the port is absent.
"""

import contextlib
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "sample_ffhq_1024.yaml")
BATCH = 8
DEPTH = 8                       # 1024^2
REQUESTS = 3
COLD_BYTES = 128 << 20          # > 2x the H100's 50 MB L2
HBM_BYTES_PER_S = 3.35e12       # H100 SXM published HBM3 rate
# (resolution, channels) of the 9 stages; each runs the epilogue twice
EPILOGUE_SHAPES = [(4, 512), (8, 512), (16, 512), (32, 512), (64, 256),
                   (128, 128), (256, 64), (512, 32), (1024, 16)]
# (B, H, W, C, offset in elements of x and out from a 16-byte boundary) off
# the main path: C not a multiple of the vector width, or unaligned pointers,
# take the kernel's scalar loads; ragged rows and channels are masked
RAGGED_SHAPES = [(3, 7, 9, 17, 0), (2, 5, 1, 20, 0), (2, 33, 31, 48, 1)]
F32_TOL = 1e-4       # reduction order over up to 2^20 values per (b, c)
# bf16 bar against the plain version on the same bf16 tensors, in ulps at the
# output's magnitude: the plain version rounds x + w*n and the lrelu to bf16
# (two half-ulps of |y|, which the normalisation scales to the output's
# magnitude) and both sides round the output once
BF16_ULPS = 4
CPU_TOL = 1e-2       # BASELINE.md / tests/test_full_scale_parity.py bar
TRAIN_BATCH = 2      # sched.batch_sizes[8]: FFHQ-1024 trains at batch 2
GRAD_BATCHES = (TRAIN_BATCH, BATCH)
# bf16 gradients against the plain version in bf16, relative L2 (on the CPU
# at these shapes: 0.014-0.084); see check_grads
BF16_GRAD_REL_L2 = 0.15


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def counter(name):
    """The epilogue's counter `name` (``utils.profiling.counters``)."""
    from stylegan_torch.utils.profiling import counters
    return counters["epilogue." + name]


def zero(*names):
    """Sets the epilogue's counters `names` to 0."""
    from stylegan_torch.utils.profiling import counters
    for name in names:
        counters["epilogue." + name] = 0


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters=20, warmup=3):
    """Median device time of fn() over `iters` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def graph_time_ms(fn, calls=10, replays=10):
    """Device time of one fn(i) call: fn(0) .. fn(calls - 1) captured in a
    CUDA graph, replayed, median replay time over `calls`.  Leaves out the
    host's launch overhead, which cuda_time_ms of an eager call includes.
    The warm-up call runs on the capture's stream, so the kernel wrapper's
    plan already exists when the capture starts; each captured two-pass
    call takes a workspace of its own, whose ticket zeroing (a memset of
    B x chunks int32) the replay times too."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(calls):
            fn(i)
    ms = cuda_time_ms(graph.replay, iters=replays) / calls
    del graph
    return ms


def bf16_bound(ref):
    # bfloat16 keeps 8 significant bits: one ulp at magnitude m is
    # 2**(floor(log2 m) - 7)
    m = float(ref.abs().max())
    return BF16_ULPS * 2.0 ** (math.floor(math.log2(m)) - 7)


def cold_time_ms(fn, x):
    """Device time of one fn(x') call with x' and its output cold in L2: a
    graph of calls rotating over copies of x, every output kept alive."""
    n = max(2, math.ceil(COLD_BYTES / (2 * x.numel() * x.element_size())))
    xs = [x.clone() for _ in range(n)]
    keep = []

    def call(i):
        keep.append(fn(xs[i % n]))
    ms = graph_time_ms(call, calls=n, replays=5)
    del xs, keep
    return ms


def epilogue_inputs(g, dev, dtype, res, c, batch=BATCH):
    shape = (batch, res, res, c)
    x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(dtype)
    nw = 0.5 * torch.randn(c, generator=g, device=dev)
    noise = torch.randn((batch, res, res, 1), generator=g,
                        device=dev).to(dtype)
    style = 0.5 * torch.randn((batch, 2 * c), generator=g, device=dev)
    return x, nw, noise, style


def phase_kernel(dev):
    """Kernel vs plain version at every epilogue shape; returns the summary
    over the main path's 18 calls (float32, and the same in bfloat16)."""
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    g = torch.Generator(device=dev).manual_seed(0)
    summary = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "cold_ms": 0.0, "bf16_ms": 0.0, "bf16_cold_ms": 0.0,
               "bf16_bound_ms": 0.0, "max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for res, c in EPILOGUE_SHAPES:
            args = epilogue_inputs(g, dev, dtype, res, c)
            x, nw, noise, style = args
            shape = tuple(x.shape)
            plan = kern.plan_for(x)
            with torch.no_grad():
                got = fused.fused_epilogue(*args)
                again = fused.fused_epilogue(*args)
                ref = fused._reference_epilogue(*args)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != x.shape:
                    fail(f"kernel output {got.dtype} {tuple(got.shape)}")
                if not torch.equal(got, again):
                    fail(f"epilogue {shape} {dtype}: two calls differ")
                err = float((got.float() - ref.float()).abs().max())
                tol = F32_TOL if dtype == torch.float32 else bf16_bound(ref)
                if dtype == torch.bfloat16:
                    # the kernel computes in f32 and rounds once: it is within
                    # one bf16 ulp of the plain version run in f32
                    ref32 = fused._reference_epilogue(
                        *(t.float() for t in args))
                    mag = torch.maximum(ref32.abs(), got.float().abs())
                    ulp = 2.0 ** (torch.floor(torch.log2(
                        mag.clamp_min(1e-30))) - 7)
                    ulps = float(((got.float() - ref32).abs()
                                  / (ulp + 1e-5)).max())
                    if not ulps <= 1.0:
                        fail(f"epilogue {shape} bf16: {ulps} ulps from the "
                             "f32 plain version")
                    del ref32, ulp

                def kernel(i=0):
                    return fused.fused_epilogue(*args)

                def plain(i=0):
                    return fused._reference_epilogue(*args)
                ms, plain_ms = graph_time_ms(kernel), graph_time_ms(plain)
                cold_ms = cold_time_ms(
                    lambda xi: fused.fused_epilogue(xi, nw, noise, style), x)
                call_ms = cuda_time_ms(kernel)
                plain_call_ms = cuda_time_ms(plain)
            nbytes = kern.bytes_moved(x)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            name = "f32" if dtype == torch.float32 else "bf16"
            log(json.dumps({"epilogue": f"{BATCH}x{res}x{res}x{c}",
                            "dtype": name, "max_abs_err": err, "tol": tol,
                            "deterministic": True, "path": plan["path"],
                            "cluster": plan["cluster"],
                            "chunk_c": plan["chunk_c"],
                            "cuda_launches_per_call": plan["launches"],
                            "ms": ms, "cold_ms": cold_ms, "plain_ms": plain_ms,
                            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
                            "bytes": nbytes, "bound_ms": bound_ms,
                            "GB_per_s": nbytes / ms / 1e6,
                            "cold_GB_per_s": nbytes / cold_ms / 1e6}))
            if not err <= tol:
                fail(f"epilogue {shape} {name}: max |diff| {err} > {tol}")
            if dtype == torch.float32:   # the main path: two calls per stage
                summary["ms"] += 2 * ms
                summary["cold_ms"] += 2 * cold_ms
                summary["call_ms"] += 2 * call_ms
                summary["plain_ms"] += 2 * plain_ms
                summary["bound_ms"] += 2 * bound_ms
                summary["max_abs_err"] = max(summary["max_abs_err"], err)
            else:
                summary["bf16_ms"] += 2 * ms
                summary["bf16_cold_ms"] += 2 * cold_ms
                summary["bf16_bound_ms"] += 2 * bound_ms
            del x, noise, got, again, ref, args, kernel, plain
        for b, h, w, c, offset in RAGGED_SHAPES:
            check_ragged(fused, g, dev, dtype, (b, h, w, c), offset)

    # gradients through the autograd.Function vs autograd of the plain version
    shape = (BATCH, 64, 64, 256)
    ins = [torch.randn(shape, generator=g, device=dev) + 0.5,
           0.5 * torch.randn(256, generator=g, device=dev),
           torch.randn((BATCH, 64, 64, 1), generator=g, device=dev),
           0.5 * torch.randn((BATCH, 512), generator=g, device=dev)]
    cot = torch.randn(shape, generator=g, device=dev)
    grads = []
    for fn in (fused.fused_epilogue, fused._reference_epilogue):
        ts = [t.clone().requires_grad_(True) for t in ins]
        fn(*ts).backward(cot)
        grads.append([t.grad for t in ts])
    for name, a, b in zip(("x", "noise_weight", "noise", "style"), *grads):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        log(f"grad {name}: max |diff| {err:.3e} (max |grad| {scale:.3e})")
        if not err <= F32_TOL * max(1.0, scale):
            fail(f"epilogue gradient {name}: max |diff| {err}")
    log(json.dumps({"epilogue_18_calls": summary}))
    return summary


GRAD_NAMES = ("x", "noise_weight", "noise", "style")
# the gradients a train step asks of the epilogue: the noise maps are inputs,
# not parameters
TRAIN_NEEDS = (True, True, False, True)


def kernel_grads(kern, args, cot, needs=(True, True, True, True)):
    """The kernels' gradients: the forward saving its statistics, then the
    backward."""
    x, nw, noise, style = args
    saved = torch.empty((x.shape[0], x.shape[-1], 2), device=x.device)
    kern.epilogue_forward(x, nw, noise, style, saved)
    return kern.epilogue_backward(cot, x, nw, noise, style, saved, needs)


def plain_grads(fused, args, cot):
    """Autograd of the plain version on copies of the same tensors."""
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    y = fused._reference_epilogue(*leaves)
    return torch.autograd.grad(y, leaves, cot.to(y.dtype))


def ulps_from(got, ref):
    """Largest distance in bf16 ulps at each element's magnitude, with an
    absolute floor of 1e-5 for elements near 0 (as phase 2)."""
    mag = torch.maximum(ref.abs(), got.abs())
    ulp = 2.0 ** (torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    return float(((got - ref).abs() / (ulp + 1e-5)).max())


def check_grads(fused, args, cot, got, where):
    """Hold the kernels' gradients to the plain version's; returns the
    largest f32-bar ratio (err / bar) for the report."""
    worst = 0.0
    if args[0].dtype == torch.float32:
        for name, a, r in zip(GRAD_NAMES, got, plain_grads(fused, args, cot)):
            err, scale = float((a - r).abs().max()), float(r.abs().max())
            bar = F32_TOL * max(1.0, scale)
            worst = max(worst, err / bar)
            if not err <= bar:
                fail(f"epilogue backward {where} d{name}: max |diff| {err} > "
                     f"{bar}")
        return worst
    # bf16: the kernels compute in f32 from the bf16 values and round dx and
    # dnoise once, so they are within 1 bf16 ulp of the plain version run in
    # f32 on the same values, and the f32 gradients within the f32 bar
    ref32 = plain_grads(fused, [t.float() for t in args], cot.float())
    for name, a, r in zip(GRAD_NAMES, got, ref32):
        a = a.float()
        if a.dtype == r.dtype and name in ("x", "noise"):
            u = ulps_from(a, r)
            if not u <= 1.0:
                fail(f"epilogue backward {where} d{name}: {u} ulps from the "
                     "f32 plain version")
        else:
            err, bar = float((a - r).abs().max()), F32_TOL * max(
                1.0, float(r.abs().max()))
            worst = max(worst, err / bar)
            if not err <= bar:
                fail(f"epilogue backward {where} d{name}: max |diff| {err} > "
                     f"{bar} from the f32 plain version")
    # against the plain version in bf16 only in the mean: it rounds
    # u = x + nw * n to bf16, which puts the lrelu's slope on the other side
    # of 0 at a few elements, each a jump of 0.8 |dy|
    for name, a, r in zip(GRAD_NAMES, got, plain_grads(fused, args, cot)):
        a, r = a.float(), r.float()
        rel = float((a - r).norm() / r.norm())
        if not rel <= BF16_GRAD_REL_L2:
            fail(f"epilogue backward {where} d{name}: relative L2 {rel} from "
                 f"the bf16 plain version > {BF16_GRAD_REL_L2}")
    return worst


def cold_pairs_time_ms(fn, x, cot):
    """Device time of one fn(x', cot') call with both cold in L2: a graph of
    calls rotating over copies, every output kept alive."""
    n = max(2, math.ceil(COLD_BYTES / (3 * x.numel() * x.element_size())))
    xs = [(x.clone(), cot.clone()) for _ in range(n)]
    keep = []

    def call(i):
        keep.append(fn(*xs[i % n]))
    ms = graph_time_ms(call, calls=n, replays=5)
    del xs, keep
    return ms


def phase_grad_kernel(dev):
    """The backward kernels (K3) against autograd of the plain version at
    the 9 epilogue shapes, batch 2 and 8, float32 and bfloat16, two calls
    bitwise equal; timed at the training batch.  Returns the summary over
    the 18 calls of one batch-2 G backward."""
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    g = torch.Generator(device=dev).manual_seed(3)
    summary = {"ms": 0.0, "cold_ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "bf16_ms": 0.0, "bf16_cold_ms": 0.0,
               "bf16_call_ms": 0.0, "bf16_bound_ms": 0.0, "max_abs_err": 0.0,
               "worst_bar_ratio": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for batch in GRAD_BATCHES:
            for res, c in EPILOGUE_SHAPES:
                args = epilogue_inputs(g, dev, dtype, res, c, batch)
                x, nw, noise, style = args
                cot = torch.randn(x.shape, generator=g, device=dev).to(dtype)
                where = f"{batch}x{res}x{res}x{c} {dtype}"
                got = kernel_grads(kern, args, cot)
                again = kernel_grads(kern, args, cot)
                torch.cuda.synchronize()
                for name, a, b in zip(GRAD_NAMES, got, again):
                    if a.dtype != b.dtype or not torch.equal(a, b):
                        fail(f"epilogue backward {where} d{name}: two calls "
                             "differ")
                worst = check_grads(fused, args, cot, got, where)
                plan = kern.bwd_plan_for(x)
                line = {"epilogue_backward": where, "worst_bar_ratio": worst,
                        "deterministic": True, "path": plan["path"],
                        "cluster": plan["cluster"],
                        "chunk_c": plan["chunk_c"],
                        "cuda_launches_per_call": plan["launches"]}
                if batch == TRAIN_BATCH:
                    saved = torch.empty((batch, c, 2), device=dev)
                    kern.epilogue_forward(x, nw, noise, style, saved)

                    def kernel(i=0, xi=x, ci=cot):
                        return kern.epilogue_backward(
                            ci, xi, nw, noise, style, saved, TRAIN_NEEDS)

                    def plain(i=0):
                        return fused._reference_epilogue_vjp(x, nw, noise,
                                                             style, cot)
                    ms = graph_time_ms(kernel)
                    cold_ms = cold_pairs_time_ms(
                        lambda xi, ci: kernel(0, xi, ci), x, cot)
                    call_ms = cuda_time_ms(kernel)
                    nbytes = kern.bytes_moved_backward(x)
                    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
                    line.update(ms=ms, cold_ms=cold_ms, call_ms=call_ms,
                                bound_ms=bound_ms, bytes=nbytes,
                                GB_per_s=nbytes / ms / 1e6,
                                cold_GB_per_s=nbytes / cold_ms / 1e6)
                    if dtype == torch.float32:
                        plain_ms = graph_time_ms(plain)
                        line.update(plain_ms=plain_ms)
                        for k, v in (("ms", ms), ("cold_ms", cold_ms),
                                     ("call_ms", call_ms),
                                     ("plain_ms", plain_ms),
                                     ("bound_ms", bound_ms)):
                            summary[k] += 2 * v
                        summary["max_abs_err"] = max(
                            summary["max_abs_err"], max(
                                float((a - r).abs().max()) for a, r in zip(
                                    got, plain_grads(fused, args, cot))))
                    else:
                        for k, v in (("bf16_ms", ms),
                                     ("bf16_cold_ms", cold_ms),
                                     ("bf16_call_ms", call_ms),
                                     ("bf16_bound_ms", bound_ms)):
                            summary[k] += 2 * v
                    del saved, kernel, plain
                summary["worst_bar_ratio"] = max(summary["worst_bar_ratio"],
                                                 worst)
                log(json.dumps(line))
                del args, x, cot, got, again
    log(json.dumps({"epilogue_backward_18_calls": summary}))
    return summary


# the gradients projection asks of the epilogue: the generator is frozen,
# so dx and dstyle only (dx not at the input block's first epilogue)
PROJECT_NEEDS = (True, False, False, True)


def phase_grad_kernel_b1(dev):
    """The backward kernels at projection's batch 1 and gradients, at the 9
    epilogue shapes in float32: against autograd of the plain version, two
    calls bitwise equal, the plan printed, timed (graph replay) with the
    plain VJP and the bytes bound.  Returns the summary over the 18 calls
    of one projection step's backward."""
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    g = torch.Generator(device=dev).manual_seed(9)
    b1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
          "worst_bar_ratio": 0.0}
    for res, c in EPILOGUE_SHAPES:
        args = epilogue_inputs(g, dev, torch.float32, res, c, PROJECT_BATCH)
        x, nw, noise, style = args
        cot = torch.randn(x.shape, generator=g, device=dev)
        where = f"{PROJECT_BATCH}x{res}x{res}x{c} f32"
        got = kernel_grads(kern, args, cot, PROJECT_NEEDS)
        again = kernel_grads(kern, args, cot, PROJECT_NEEDS)
        torch.cuda.synchronize()
        ref = plain_grads(fused, args, cot)
        for name, a, b, r, need in zip(GRAD_NAMES, got, again, ref,
                                       PROJECT_NEEDS):
            if not need:
                if a is not None:
                    fail(f"epilogue backward {where}: d{name} not asked for")
                continue
            if not torch.equal(a, b):
                fail(f"epilogue backward {where} d{name}: two calls differ")
            err, scale = float((a - r).abs().max()), float(r.abs().max())
            bar = F32_TOL * max(1.0, scale)
            b1["worst_bar_ratio"] = max(b1["worst_bar_ratio"], err / bar)
            b1["max_abs_err"] = max(b1["max_abs_err"], err)
            if not err <= bar:
                fail(f"epilogue backward {where} d{name}: max |diff| {err} "
                     f"> {bar}")
        saved = torch.empty((PROJECT_BATCH, c, 2), device=dev)
        kern.epilogue_forward(x, nw, noise, style, saved)
        ms = graph_time_ms(lambda i: kern.epilogue_backward(
            cot, x, nw, noise, style, saved, PROJECT_NEEDS))
        plain_ms = graph_time_ms(lambda i: fused._reference_epilogue_vjp(
            x, nw, noise, style, cot))
        bound_ms = kern.bytes_moved_backward(x) / HBM_BYTES_PER_S * 1e3
        plan = kern.bwd_plan_for(x)
        log(json.dumps({"epilogue_backward": where, "needs": PROJECT_NEEDS,
                        "deterministic": True, "plan": plan, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms}))
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("bound_ms", bound_ms)):
            b1[k] += 2 * v
        del args, x, cot, got, again, ref, saved
    log(json.dumps({"epilogue_backward_batch1_18_calls": b1}))
    return b1


def check_ragged(fused, g, dev, dtype, shape, offset):
    """Kernel vs plain version at a shape off the main path; x starts
    `offset` elements past a 16-byte boundary."""
    b, h, w, c = shape
    n = b * h * w * c
    x = torch.empty(n + offset, dtype=dtype, device=dev)[offset:].view(shape)
    x.copy_(torch.randn(shape, generator=g, device=dev) + 0.5)
    args = (x, 0.5 * torch.randn(c, generator=g, device=dev),
            torch.randn((b, h, w, 1), generator=g, device=dev).to(dtype),
            0.5 * torch.randn((b, 2 * c), generator=g, device=dev))
    with torch.no_grad():
        got = fused.fused_epilogue(*args)
        again = fused.fused_epilogue(*args)
        ref = fused._reference_epilogue(*args)
    if not torch.equal(got, again):
        fail(f"epilogue {shape} {dtype} offset {offset}: two calls differ")
    err = float((got.float() - ref.float()).abs().max())
    tol = F32_TOL if dtype == torch.float32 else bf16_bound(ref)
    log(json.dumps({"epilogue": "x".join(map(str, shape)),
                    "x_offset_elements": offset, "dtype": str(dtype),
                    "max_abs_err": err, "tol": tol}))
    if not err <= tol:
        fail(f"epilogue {shape} {dtype} offset {offset}: max |diff| {err} "
             f"> {tol}")


def random_state_dict(generator, seed=0):
    """Every parameter and buffer drawn from a seeded numpy generator, at
    the scale of its layer's init (noise weights too, which init to 0)."""
    rs = np.random.default_rng(seed)
    sd = {}
    for name, t in generator.state_dict().items():
        if name.endswith("weight") and t.ndim >= 2:
            scale = 100.0 if name.startswith("g_mapping") else 1.0  # 1/lrmul
        elif name.endswith("const"):
            scale = 1.0
        else:                     # biases, noise weights, the W average
            scale = 0.2
        sd[name] = torch.from_numpy(np.asarray(
            rs.standard_normal(tuple(t.shape), dtype=np.float32) * scale,
            dtype=np.float32))
    return sd


def forward_launches(kern, dev, batch=BATCH):
    """Launches of each forward epilogue kernel in one float32 1024^2
    forward, by the plans."""
    want = dict.fromkeys(kern.KERNEL_NAMES, 0)
    for res, c in EPILOGUE_SHAPES:
        x = torch.empty((batch, res, res, c), device=dev)
        for name in kern.KERNELS_BY_PATH[kern.plan_for(x)["path"]]:
            want[name] += 2
    return want


def phase_slice(dev):
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    from stylegan_torch.models import Generator, generator_config_from_cfg
    from stylegan_torch.models.synthesis import layer_resolution, make_noise
    from stylegan_torch.ops.kernels import epilogue as kern
    from stylegan_torch.serving import make_serving_fn

    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.freeze()
    apply_runtime_knobs(cfg)          # float32, TF32 off
    gen_cfg = generator_config_from_cfg(cfg)
    cpu_gen = Generator(gen_cfg)
    cpu_gen.load_state_dict(random_state_dict(cpu_gen), strict=True)
    cpu_gen.requires_grad_(False)
    n_params = sum(p.numel() for p in cpu_gen.parameters())
    gen = Generator(gen_cfg)
    gen.load_state_dict(cpu_gen.state_dict(), strict=True)
    gen.requires_grad_(False).to(dev)
    log(f"generator: FFHQ-1024, {n_params} parameters, "
        f"{gen_cfg.num_layers} layers, truncation "
        f"{'on' if gen_cfg.use_truncation else 'off'}")

    serve = make_serving_fn(gen_cfg, gen, depth=DEPTH, device=dev)
    rs = np.random.default_rng(1)
    zs = [rs.standard_normal((BATCH, gen_cfg.latent_size), dtype=np.float32)
          for _ in range(REQUESTS)]
    zero("launches", "cuda_launches")
    outs = [serve(z, i) for i, z in enumerate(zs)]
    launches, cuda_launches = counter("launches"), counter("cuda_launches")
    for out in outs:
        if tuple(out.shape) != (BATCH, 1024, 1024, 3):
            fail(f"served shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            fail("served images hold non-finite values")
    if launches != 18 * REQUESTS:
        fail(f"epilogue kernel calls {launches}, want {18 * REQUESTS}")
    log(f"served {REQUESTS} requests of batch {BATCH} at 1024^2: "
        f"{launches} epilogue calls ({cuda_launches} CUDA launches)")

    # the same generator on the CPU, plain path, with the request's noise
    noises = [make_noise(0, i, BATCH, layer_resolution(i), dev)[:2].cpu()
              for i in range(gen_cfg.num_layers)]
    torch.set_num_threads(os.cpu_count() or 1)
    with torch.inference_mode():
        want = cpu_gen(torch.from_numpy(zs[0][:2]), depth=DEPTH, alpha=1.0,
                       noises=noises).images
    err = float((outs[0][:2].cpu() - want).abs().max())
    log(f"card vs CPU, 2 images at 1024^2: max |diff| {err:.3e} "
        f"(bar {CPU_TOL})")
    if not err <= CPU_TOL:
        fail(f"card vs CPU max |diff| {err} > {CPU_TOL}")

    epilogue_ms = profile_forward(serve, zs[0], kern,
                                  forward_launches(kern, dev))
    return launches, cuda_launches, epilogue_ms


def profile_forward(serve, z, kern, per_forward):
    """The epilogue kernels' device time in one profiled forward, read by
    the wrapper's kernel names; it is fresh only if the profiler shows
    each kernel as many times as the plans launch it per forward
    (`per_forward`), all of them the wrapper's CUDA launches, and each with
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    zero("cuda_launches")
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        serve(z, 0)
        torch.cuda.synchronize()
    wrapper_launches = counter("cuda_launches")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    by_name = {name: [e for e in kernels if name in e.key]
               for name in kern.KERNEL_NAMES}
    ms = {name: sum(e.self_device_time_total for e in es) / 1e3
          for name, es in by_name.items()}
    count = {name: sum(e.count for e in es) for name, es in by_name.items()}
    epilogue = sum(ms.values())
    log(json.dumps({"epilogue_kernels_device_ms": epilogue,
                    "epilogue_by_kernel_ms": ms,
                    "epilogue_launches_by_kernel": count,
                    "wrapper_cuda_launches": wrapper_launches}))
    if count != per_forward or sum(count.values()) != wrapper_launches:
        fail(f"the profiled forward shows epilogue launches {count}; the "
             f"plans make {per_forward}, the wrapper counted "
             f"{wrapper_launches}")
    stale = [name for name in kern.KERNEL_NAMES
             if per_forward[name] and not ms[name] > 0]
    if stale:
        fail(f"the profiled forward shows no device time in {stale}")
    return epilogue


TRAIN_DEPTH = 8                 # 1024^2
TRAIN_STEPS = 3
CHECK_DEPTH = 5                 # 128^2: both kernel paths, fused resampling
# card vs CPU after one step, and both against the same step in float64 on
# the CPU.  Losses: float32 sums in another order over the network, as the
# 1024^2 forward's 1e-2 image bar but relative.  Adam's first moments (b1 =
# 0: the gradients, clipped for G): the card's error from float64 within an
# order of magnitude of the CPU's own float32 error (cuDNN sums in other
# orders and takes FFT and implicit-GEMM algorithms for some convolutions),
# plus 1e-5 of the tensor's largest for tensors the CPU gets exactly.
# Weights, the card's against float64's: Adam's first step moves each by
# lr * g / (|g| + eps), about lr times the sign of its gradient whatever its
# size, so a weight whose gradient is 0 up to float32 rounding moves by up
# to lr either way: within 1e-4 wherever the float64 gradient's magnitude
# exceeds that bar of its tensor's gradient error, and everywhere within
# 2 lr.
CHECK_LOSS_RTOL = 1e-3
CHECK_GRAD_FACTOR = 10.0


def train_models(cfg, dev, dtype=torch.float32, remat=False):
    """FFHQ-1024 G and D (configs/sample_ffhq_1024.yaml over the defaults)
    with seeded random weights, on `dev`; with `remat`, each block
    recomputed in the backward (the trainer's ops.remat)."""
    from dataclasses import replace

    from stylegan_torch.models import (Discriminator, Generator,
                                       discriminator_config_from_cfg,
                                       generator_config_from_cfg)
    gen_cfg = generator_config_from_cfg(cfg)
    dis_cfg = discriminator_config_from_cfg(cfg)
    if remat:
        gen_cfg = replace(gen_cfg, synthesis=replace(gen_cfg.synthesis,
                                                     remat=True))
        dis_cfg = replace(dis_cfg, remat=True)
    gen, dis = Generator(gen_cfg), Discriminator(dis_cfg)
    gen.load_state_dict(random_state_dict(gen, seed=10), strict=True)
    dis.load_state_dict(random_state_dict(dis, seed=11), strict=True)
    return gen_cfg, dis_cfg, gen.to(dev, dtype), dis.to(dev, dtype)


def train_step_fn(cfg, gen_cfg, dis_cfg, depth, loss, **kw):
    """The yaml's fused step; `kw` (mesh=, mbstd_chunks=) passes through."""
    from stylegan_torch.train import build_train_step
    if loss in ("logistic",):
        kw["r1_gamma"] = cfg.r1_gamma
    return build_train_step(gen_cfg, dis_cfg, depth=depth, loss=loss,
                            d_repeats=cfg.d_repeats, use_ema=cfg.use_ema,
                            ema_decay=cfg.ema_decay, drift=cfg.drift, **kw)


def train_batch(gen_cfg, batch, seed):
    """Seeded numpy reals in [-1, 1] at the full resolution (NHWC) and
    latents."""
    rs = np.random.default_rng(seed)
    res = gen_cfg.resolution
    reals = rs.uniform(-1.0, 1.0, (batch, res, res, 3)).astype(np.float32)
    z = rs.standard_normal((batch, gen_cfg.latent_size), dtype=np.float32)
    return torch.from_numpy(reals), torch.from_numpy(z)


def expected_train_launches(kern, dev, batch):
    """Launches of each epilogue kernel in one train step, by the plans:
    two G forwards of 18 calls, one G backward of 18 (no dnoise)."""
    want = dict.fromkeys(kern.KERNEL_NAMES + kern.BWD_KERNEL_NAMES, 0)
    for res, c in EPILOGUE_SHAPES:
        x = torch.empty((batch, res, res, c), device=dev)
        for name in kern.KERNELS_BY_PATH[kern.plan_for(x)["path"]]:
            want[name] += 2 * 2
        for name in kern.BWD_KERNELS_BY_PATH[kern.bwd_plan_for(x)["path"]]:
            want[name] += 2
    return want


def phase_train(dev):
    """FFHQ-1024 training steps at depth 8 on the card; returns the
    kernel counts and losses for the report."""
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    from stylegan_torch.train import create_train_state

    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.freeze()
    apply_runtime_knobs(cfg)          # float32, TF32 off
    batch = cfg.sched.batch_sizes[TRAIN_DEPTH]
    gen_cfg, dis_cfg, gen, dis = train_models(cfg, dev)
    state = create_train_state(gen, dis, dict(cfg.model.g_optim),
                               dict(cfg.model.d_optim), use_ema=cfg.use_ema)
    step = train_step_fn(cfg, gen_cfg, dis_cfg, TRAIN_DEPTH, cfg.loss)
    alpha = torch.tensor(0.5, device=dev)
    n_g = sum(p.numel() for p in gen.parameters())
    n_d = sum(p.numel() for p in dis.parameters())
    log(f"train: FFHQ-1024 depth {TRAIN_DEPTH}, batch {batch}, loss "
        f"{cfg.loss} (R1 gamma {cfg.r1_gamma}), d_repeats {cfg.d_repeats}, "
        f"EMA {cfg.ema_decay}, alpha 0.5; G {n_g} and D {n_d} parameters")

    batches = [tuple(t.to(dev) for t in train_batch(gen_cfg, batch, 20 + i))
               for i in range(TRAIN_STEPS + 2)]
    torch.cuda.reset_peak_memory_stats()
    zero("launches", "cuda_launches", "backward_launches",
         "backward_cuda_launches", "backward_g_copies")
    fused.plain_calls = 0
    losses = []
    for i in range(TRAIN_STEPS):
        _, m = step(state, *batches[i], 1 + i, alpha)
        losses.append((m["d_loss"].item(), m["g_loss"].item()))
    fwd, bwd = counter("launches"), counter("backward_launches")
    plain = fused.plain_calls
    bwd_cuda = counter("backward_cuda_launches")
    g_copies = counter("backward_g_copies")
    peak = torch.cuda.max_memory_allocated()
    log(json.dumps({"peak_memory_GiB": peak / 2 ** 30, "losses": losses,
                    "epilogue_forward_calls": fwd,
                    "epilogue_backward_calls": bwd,
                    "epilogue_backward_cuda_launches": bwd_cuda,
                    "backward_g_copies": g_copies, "plain_calls": plain}))
    if not all(math.isfinite(v) for pair in losses for v in pair):
        fail(f"train losses not finite: {losses}")
    if fwd != 36 * TRAIN_STEPS or bwd != 18 * TRAIN_STEPS:
        fail(f"train steps made {fwd} forward and {bwd} backward epilogue "
             f"calls, want {36 * TRAIN_STEPS} and {18 * TRAIN_STEPS}")
    if plain != 0:
        fail(f"the plain epilogue ran {plain} times on the card's train path")
    want = expected_train_launches(kern, dev, batch)
    want_bwd_cuda = TRAIN_STEPS * sum(want[n] for n in kern.BWD_KERNEL_NAMES)
    if bwd_cuda != want_bwd_cuda:
        fail(f"train steps made {bwd_cuda} backward CUDA launches, the plans "
             f"{want_bwd_cuda}")

    profile_train_step(step, state, batches[-2], alpha, kern, want)

    # one relativistic-hinge step on the same state
    rh = train_step_fn(cfg, gen_cfg, dis_cfg, TRAIN_DEPTH,
                       "relativistic-hinge")
    zero("launches", "backward_launches")
    fused.plain_calls = 0
    _, m = rh(state, *batches[-1], 99, alpha)
    rh_losses = (m["d_loss"].item(), m["g_loss"].item())
    log(json.dumps({"relativistic_hinge_losses": rh_losses,
                    "epilogue_forward_calls": counter("launches"),
                    "epilogue_backward_calls": counter("backward_launches"),
                    "plain_calls": fused.plain_calls}))
    if not all(math.isfinite(v) for v in rh_losses):
        fail(f"relativistic-hinge losses not finite: {rh_losses}")
    if (counter("launches"), counter("backward_launches"),
            fused.plain_calls) != (36, 18, 0):
        fail("relativistic-hinge step: wrong epilogue calls")
    del state, step, rh, gen, dis, batches
    torch.cuda.empty_cache()
    return {"peak_memory_GiB": peak / 2 ** 30, "losses": losses,
            "forward_calls": fwd, "backward_calls": bwd,
            "backward_cuda_launches": bwd_cuda,
            "backward_g_copies": g_copies}


def profile_train_step(step, state, batch, alpha, kern, want):
    """One profiled train step: each epilogue kernel must show as often as
    the plans launch it (`want`), each with device time; returns the
    kernels' device ms in the step by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        step(state, *batch, 7, alpha)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    # by "::name<": PyTorch's multi_tensor_apply_kernel (the optimizers'
    # foreach ops) also contains "apply_kernel"
    count = {name: sum(e.count for e in kernels if f"::{name}<" in e.key)
             for name in want}
    ms = {name: sum(e.self_device_time_total for e in kernels
                    if f"::{name}<" in e.key) / 1e3 for name in want}
    log(json.dumps({"epilogue_by_kernel_ms": ms,
                    "epilogue_launches_by_kernel": count}))
    if count != want:
        fail(f"the profiled train step shows epilogue launches {count}; "
             f"the plans make {want}")
    if not all(ms[name] > 0 for name in want if want[name]):
        fail(f"the profiled train step shows no device time in {ms}")
    return ms


def phase_train_vs_cpu(dev):
    """One depth-5 step of the FFHQ-1024 model on the card and on the CPU in
    float32, and on the CPU in float64, with the draws pinned and TF32 off:
    losses, Adam's first moments and every weight of G, D and the shadow
    within the bars above."""
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    from stylegan_torch.train import create_train_state

    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.freeze()
    apply_runtime_knobs(cfg)
    batch = cfg.sched.batch_sizes[TRAIN_DEPTH]
    reals, z, noises, latents2 = pinned_inputs(cfg, batch, 30)
    results = []
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = torch.device("cpu")
    for device, dtype in ((dev, torch.float32), (cpu, torch.float32),
                          (cpu, torch.float64)):
        gen_cfg, dis_cfg, gen, dis = train_models(cfg, device, dtype)
        state = create_train_state(gen, dis, dict(cfg.model.g_optim),
                                   dict(cfg.model.d_optim))
        step = train_step_fn(cfg, gen_cfg, dis_cfg, CHECK_DEPTH, cfg.loss)
        put = lambda t: t.to(device, dtype)
        _, m = step(state, put(reals), put(z), 0,
                    torch.tensor(0.5, device=device, dtype=dtype),
                    noises=[put(n) for n in noises],
                    mixing=(put(latents2), MIXING_CUTOFF))
        results.append(step_result(m, state))
        log(f"train check on {device.type} {dtype}: losses "
            f"{results[-1][0]}")
        del state, step, gen, dis
        torch.cuda.empty_cache()
    report = dict(check_vs_float64(cfg, *results, "card", "cpu"),
                  depth=CHECK_DEPTH)
    log(json.dumps({"train_card_vs_cpu": report}))
    return report


MIXING_CUTOFF = 5    # the pinned mixing: layers >= 5 of the 12 at depth 5


def pinned_inputs(cfg, batch, seed):
    """Seeded reals, z, the noise maps of CHECK_DEPTH and the second
    latents of the style mixing, for steps whose draws are pinned."""
    from stylegan_torch.models import generator_config_from_cfg
    from stylegan_torch.models.synthesis import layer_resolution
    rs = np.random.default_rng(seed)
    reals, z = train_batch(generator_config_from_cfg(cfg), batch, seed + 1)
    noises = [torch.from_numpy(rs.standard_normal(
        (batch, layer_resolution(i), layer_resolution(i), 1),
        dtype=np.float32)) for i in range(2 * (CHECK_DEPTH + 1))]
    latents2 = torch.from_numpy(rs.standard_normal(tuple(z.shape),
                                                   dtype=np.float32))
    return reals, z, noises, latents2


def step_result(m, state):
    """(losses, weights by module, Adam's first moments) of a train step,
    on the CPU in float64."""
    return ((m["d_loss"].item(), m["g_loss"].item()),
            {k: {n: t.detach().cpu().double() for n, t in getattr(state, k)
                 .state_dict().items()}
             for k in ("generator", "discriminator", "g_shadow")},
            moments(state))


def check_vs_float64(cfg, got, yard, truth, what, yard_what):
    """Hold a float32 step's result (`got`, a step_result) to the float64
    one (`truth`), with a yardstick float32 step (`yard`) that is known
    good: losses within CHECK_LOSS_RTOL of the yardstick's; each gradient
    (Adam's first moment) within CHECK_GRAD_FACTOR times the yardstick's
    error from float64, plus 1e-5 of its scale; each weight within 1e-4 of
    float64 wherever its gradient is not 0 up to float32 rounding, and
    within 2 lr everywhere (Adam moves a weight whose gradient is 0 up to
    rounding by +-lr); the shadow within 2 lr (1 - ema_decay)."""
    (lc, wc, mc), (lh, _, mh), (_, w64, m64) = got, yard, truth
    worst = {}
    for a, b, name in zip(lc, lh, ("d_loss", "g_loss")):
        rel = abs(a - b) / max(1.0, abs(b))
        worst[name] = rel
        if not rel <= CHECK_LOSS_RTOL:
            fail(f"{what} vs {yard_what} {name}: {a} vs {b}")
    grad = {"bar_ratio": 0.0, f"{what}_rel": 0.0, f"{yard_what}_rel": 0.0}
    noise = {}      # per tensor: the float32 gradient's error bar
    for name, t64 in m64.items():
        scale = float(t64.abs().max())
        err = float((mc[name] - t64).abs().max())
        err_yard = float((mh[name] - t64).abs().max())
        bar = noise[name] = CHECK_GRAD_FACTOR * err_yard + 1e-5 * scale
        if bar > 0:     # else no gradient flows there: both exactly 0
            grad["bar_ratio"] = max(grad["bar_ratio"], err / bar)
        if scale > 0:
            grad[f"{what}_rel"] = max(grad[f"{what}_rel"], err / scale)
            grad[f"{yard_what}_rel"] = max(grad[f"{yard_what}_rel"],
                                           err_yard / scale)
        if not err <= bar:
            fail(f"{what} gradient (Adam first moment) {name}: {err} from "
                 f"float64, the {yard_what}'s float32 {err_yard}")
    lr = cfg.model.g_optim.learning_rate
    weights = {"max_abs_diff": 0.0, "beyond_1e-4": 0, "elements": 0}
    for k, label in (("generator", "G"), ("discriminator", "D")):
        for name, t64 in w64[k].items():
            d = (wc[k][name] - t64).abs()
            key = f"{label} {name}"
            # buffers (the W-average) have no gradient of their own
            sure = (m64[key].abs() > noise[key] if key in m64
                    else torch.ones_like(d, dtype=torch.bool))
            beyond = d > 1e-4
            weights["max_abs_diff"] = max(weights["max_abs_diff"],
                                          float(d.max()))
            weights["beyond_1e-4"] += int(beyond.sum())
            weights["elements"] += d.numel()
            if bool((beyond & sure).any()) or not float(d.max()) <= 2 * lr:
                fail(f"{what} vs float64 {k} {name}: max |diff| "
                     f"{float(d.max())}, {int((beyond & sure).sum())} "
                     "elements beyond 1e-4 whose gradient is not 0 up to "
                     "float32 rounding")
    shadow = max(float((wc["g_shadow"][n] - t).abs().max())
                 for n, t in w64["g_shadow"].items())
    if not shadow <= 2 * lr * (1 - cfg.ema_decay) + 1e-5:
        fail(f"{what} vs float64 shadow: max |diff| {shadow}")
    return {"loss_rel_diff": worst, "grads_vs_float64": grad,
            "weights_vs_float64": weights, "shadow_max_abs_diff": shadow}


def moments(state):
    """Adam's first moments of G and D by parameter name (b1 = 0: the last
    step's gradients, clipped for G)."""
    out = {}
    for label, module, opt in (("G", state.generator, state.g_optimizer),
                               ("D", state.discriminator, state.d_optimizer)):
        for name, p in module.named_parameters():
            # a copy: on the CPU .cpu() would alias the moment a later
            # step updates in place
            out[f"{label} {name}"] = opt.state[p]["exp_avg"].detach() \
                .cpu().clone()
    return out


TRAINER_IMAGES = 24             # seeded 1024^2 PNGs, two FFHQ-style folders
TRAINER_START_DEPTH = 7         # 512^2 at batch 4, then 1024^2 at batch 2
TRAINER_FEEDBACK = 4            # grids at i = 1, 2, 4, 6 and 1, 4, 8, 12
GRID_SIDE = 2 * 1024 + 3        # 2x2 samples at 1024^2, 1 px padding
RESUME_IMAGES = 4


def write_pngs(root, n, res, seed):
    """n seeded noise images in two subdirectories (the FFHQ layout), PNG at
    zlib level 1: noise does not compress, and level 6 takes seconds each."""
    from PIL import Image
    rs = np.random.default_rng(seed)
    for i in range(n):
        sub = os.path.join(root, f"{(i % 2) * 1000:05d}")
        os.makedirs(sub, exist_ok=True)
        Image.fromarray(rs.integers(0, 256, (res, res, 3), dtype=np.uint8)
                        ).save(os.path.join(sub, f"{i:05d}.png"),
                               compress_level=1)


def trainer_cfg(img_dir, output_dir):
    """configs/sample_ffhq_1024.yaml over the defaults, with a local image
    directory, one epoch per depth (the yaml lists 6 epochs for 9 depths),
    4 feedback samples and a checkpoint every epoch."""
    from stylegan_torch.config import get_default_cfg
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(["output_dir", output_dir, "dataset.img_dir", img_dir,
                         "sched.epochs", [1] * 9, "num_samples", 4,
                         "feedback_factor", TRAINER_FEEDBACK,
                         "checkpoint_factor", 1])
    return cfg


def phase_trainer(dev):
    """FFHQ-1024 progressive training through StyleGAN.train on the card
    from image files (depths 7 and 8), then its resume in process and
    through the CLIs; returns the measurements for the report."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        return trainer_run(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def trainer_run(dev, tmp):
    import yaml
    from PIL import Image
    from stylegan_torch.cli.train import build_trainer
    from stylegan_torch.config import apply_runtime_knobs
    from stylegan_torch.data import DataLoader, make_dataset, native
    from stylegan_torch.ops import fused
    from stylegan_torch.utils import make_logger

    data_dir, out = os.path.join(tmp, "ffhq"), os.path.join(tmp, "run")
    write_pngs(data_dir, TRAINER_IMAGES, 1024, seed=40)
    cfg = trainer_cfg(data_dir, out)
    cfg.freeze()
    apply_runtime_knobs(cfg)          # float32, TF32 off
    dataset = make_dataset(cfg.dataset)
    decoder = native.decoder()
    log(json.dumps({"trainer_decoder": decoder,
                    "native_build_error": native.build_error}))

    trainer = build_trainer(cfg, dev)
    os.makedirs(out)
    logger = make_logger("chip_smoke_trainer", out, "log")
    steps = []              # (depth, images on the card, fwd, bwd calls)
    real_step = trainer.train_on_batch

    def step(images, depth, alpha, labels=None, fetch=True):
        f0, b0 = counter("launches"), counter("backward_launches")
        result = real_step(images, depth, alpha, labels, fetch=fetch)
        steps.append((depth, images.clone(), counter("launches") - f0,
                      counter("backward_launches") - b0))
        return result
    trainer.train_on_batch = step

    zero("launches", "cuda_launches", "backward_launches",
          "backward_cuda_launches", "backward_g_copies")
    fused.plain_calls = 0
    trainer.train(dataset=dataset, num_workers=cfg.num_works,
                  epochs=cfg.sched.epochs,
                  batch_sizes=cfg.sched.batch_sizes,
                  fade_in_percentage=cfg.sched.fade_in_percentage,
                  logger=logger, output=out, num_samples=cfg.num_samples,
                  start_depth=TRAINER_START_DEPTH,
                  feedback_factor=cfg.feedback_factor,
                  checkpoint_factor=cfg.checkpoint_factor)
    torch.cuda.synchronize()
    counts = {"forward": counter("launches"),
              "forward_cuda": counter("cuda_launches"),
              "backward": counter("backward_launches"),
              "backward_cuda": counter("backward_cuda_launches"),
              "g_copies": counter("backward_g_copies"),
              "plain_calls": fused.plain_calls}
    trainer.train_on_batch = real_step

    # the schedule's outputs
    with open(os.path.join(out, "log.txt")) as f:
        text = f.read()
    for d in (TRAINER_START_DEPTH, TRAINER_START_DEPTH + 1):
        if f"Currently working on depth: {d + 1}" not in text:
            fail(f"trainer: depth {d} was not announced")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if not rows or not all(math.isfinite(r["d_loss"]) and
                           math.isfinite(r["g_loss"]) for r in rows):
        fail(f"trainer: losses not finite: {rows}")
    grids = sorted(os.listdir(os.path.join(out, "samples")))
    per_depth = {d: sum(g.startswith(f"gen_{d}_") for g in grids)
                 for d in (TRAINER_START_DEPTH, TRAINER_START_DEPTH + 1)}
    if min(per_depth.values()) < 2:
        fail(f"trainer: grids per depth {per_depth}")
    for g in grids:
        shape = np.asarray(Image.open(os.path.join(out, "samples", g))).shape
        if shape != (GRID_SIDE, GRID_SIDE, 3):
            fail(f"trainer: grid {g} has shape {shape}")
    models = set(os.listdir(os.path.join(out, "models")))
    want_files = {f"GAN_{k}_{d}_1.npz" for d in (7, 8) for k in (
        "GEN", "DIS", "GEN_OPTIM", "DIS_OPTIM", "GEN_SHADOW")}
    if not want_files <= models:
        fail(f"trainer: missing checkpoints {sorted(want_files - models)}")

    # the epilogue calls: per step by the plans, plus the feedback forwards
    per_step = {TRAINER_START_DEPTH: (32, 16), TRAINER_START_DEPTH + 1: (36, 18)}
    bad = [(d, f, b) for d, _, f, b in steps if (f, b) != per_step[d]]
    if bad:
        fail(f"trainer: epilogue calls per step {bad[:4]}, want {per_step}")
    want_fwd = sum(f for _, _, f, _ in steps) + sum(
        n * (2 * (d + 1)) for d, n in per_depth.items())
    want_bwd = sum(b for _, _, _, b in steps)
    if counts["forward"] != want_fwd or counts["backward"] != want_bwd:
        fail(f"trainer: epilogue calls {counts}, want {want_fwd} forward "
             f"and {want_bwd} backward")
    if counts["plain_calls"] != 0:
        fail(f"trainer: the plain epilogue ran {counts['plain_calls']} times")

    # every batch that reached the card equals the loader's, bitwise
    for d in (TRAINER_START_DEPTH, TRAINER_START_DEPTH + 1):
        want = list(DataLoader(dataset, cfg.sched.batch_sizes[d],
                               cfg.num_works))
        got = [img for depth, img, _, _ in steps if depth == d]
        if len(got) != len(want) or not all(
                torch.equal(g.cpu(), torch.from_numpy(w))
                for g, w in zip(got, want)):
            fail(f"trainer: the batches on the card at depth {d} differ from "
                 "the loader's")
    first = steps[0][1]
    step_counts = {d: sum(1 for s in steps if s[0] == d) for d in per_depth}
    del steps

    # the trainer's log holds throughput windows at depth 8
    if not any(r["depth"] == TRAINER_START_DEPTH + 1 and r["imgs_per_sec"]
               for r in rows):
        fail("trainer: no windowed img/s at depth 8")
    report = {"decoder": decoder, "steps": step_counts,
              "grids": per_depth, "epilogue_calls": counts}
    log(json.dumps({"trainer": report}))

    # (b) resume: the full state into a fresh trainer, bitwise
    full = os.path.join(tmp, "full_state")
    trainer.save_full_state(full, depth=8, epoch=1)
    fresh = build_trainer(cfg, dev)
    meta = fresh.restore_full_state(full)
    if meta.get("update_count") != trainer._update_count or \
            fresh._update_count != trainer._update_count:
        fail(f"resume: update_count {meta} vs {trainer._update_count}")
    for part in ("generator", "discriminator", "g_shadow"):
        a = getattr(trainer.state, part).state_dict()
        b = getattr(fresh.state, part).state_dict()
        if set(a) != set(b) or not all(torch.equal(a[k], b[k]) for k in a):
            fail(f"resume: {part} differs after restore_full_state")
    for opt, mod in (("g_optimizer", "generator"),
                     ("d_optimizer", "discriminator")):
        pa = dict(getattr(trainer.state, mod).named_parameters())
        pb = dict(getattr(fresh.state, mod).named_parameters())
        sa, sb = getattr(trainer.state, opt).state, \
            getattr(fresh.state, opt).state
        for name in pa:
            x, y = sa[pa[name]], sb[pb[name]]
            if not all(torch.equal(x[k].cpu(), y[k].cpu())
                       for k in ("step", "exp_avg", "exp_avg_sq")):
                fail(f"resume: {opt} state of {name} differs")
    del trainer
    # fetch=False waits for nothing: no call on its way synchronises
    torch.cuda.set_sync_debug_mode("error")
    try:
        d, g = fresh.train_on_batch(first[:2], 8, 1.0, fetch=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    d_loss, g_loss = float(d), float(g)
    if not (math.isfinite(d_loss) and math.isfinite(g_loss)):
        fail(f"resume: losses {d_loss}, {g_loss}")
    del fresh, first
    torch.cuda.empty_cache()

    # the train CLI from the five _8_1 files, then the sample CLI on its
    # shadow generator
    small, out2 = os.path.join(tmp, "small"), os.path.join(tmp, "resumed")
    write_pngs(small, RESUME_IMAGES, 1024, seed=41)
    with open(CONFIG) as f:
        doc = yaml.safe_load(f)
    doc.update(output_dir=out2, num_samples=4, checkpoint_factor=1,
               feedback_factor=TRAINER_FEEDBACK)
    doc["dataset"]["img_dir"] = small
    doc["sched"]["epochs"] = [1] * 9
    cfg_path = os.path.join(tmp, "resume.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(doc, f)
    mdir = os.path.join(out, "models")
    flags = []
    for flag, kind in (("--generator_file", "GEN"),
                       ("--gen_shadow_file", "GEN_SHADOW"),
                       ("--discriminator_file", "DIS"),
                       ("--gen_optim_file", "GEN_OPTIM"),
                       ("--dis_optim_file", "DIS_OPTIM")):
        flags += [flag, os.path.join(mdir, f"GAN_{kind}_8_1.npz")]
    run([sys.executable, "-m", "stylegan_torch.cli.train", "--config",
         cfg_path, "--start_depth", "8"] + flags, "train CLI")
    shadow = os.path.join(out2, "models", "GAN_GEN_SHADOW_8_1.npz")
    if not os.path.exists(shadow):
        fail("train CLI wrote no GAN_GEN_SHADOW_8_1.npz")
    samples = os.path.join(tmp, "samples")
    run([sys.executable, "-m", "stylegan_torch.cli.generate_samples",
         "--config", cfg_path, "--generator_file", shadow, "--num_samples",
         "2", "--output_dir", samples, "--seed", "0"], "generate_samples")
    for i in (1, 2):
        img = np.asarray(Image.open(os.path.join(samples, f"{i}.png")))
        if img.shape != (1024, 1024, 3):
            fail(f"sample {i}.png from the resumed run has shape {img.shape}")
    log(f"resume: full state bitwise, one more step without a sync "
        f"({d_loss:.4f}, {g_loss:.4f}); train CLI from the _8_1 files; "
        "2 samples from its shadow")
    return report


def run(cmd, what):
    """Run a CLI from the repo root; fail with its output if it fails."""
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        fail(f"{what} exited {r.returncode}:\n{r.stdout[-4000:]}\n"
             f"{r.stderr[-4000:]}")
    return r


def phase_cli():
    """Phase 3's seeded generator saved as a JAX-package .npz, and the
    sample CLI on it."""
    from PIL import Image
    from stylegan_torch.convert import save_generator_file
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "gen.npz")
        save_generator_file(ffhq_generator(torch.device("cpu")), npz)
        out_dir = os.path.join(tmp, "samples")
        run([sys.executable, "-m", "stylegan_torch.cli.generate_samples",
             "--config", CONFIG, "--generator_file", npz, "--num_samples",
             "2", "--output_dir", out_dir, "--seed", "0"], "generate_samples")
        for i in (1, 2):
            img = np.asarray(Image.open(os.path.join(out_dir, f"{i}.png")))
            if img.shape != (1024, 1024, 3):
                fail(f"sample {i}.png has shape {img.shape}")
        log("cli: 2 samples at 1024^2")


# the batch sizes the tool CLIs give the epilogue kernel (phase 7): the
# mixing figure's 3 and 5, the truncation figure's 6, eval_metrics' default
# 16 and the grid's 10x4
TOOL_BATCHES = (3, 5, 6, 16, 40)
# projection's (phase 8(c)): one image, forward and backward
PROJECT_BATCH = 1


def phase_kernel_batches(dev):
    """The forward kernel against its plain version at the 9 epilogue shapes
    in float32 at projection's batch and the tool CLIs' batch sizes, with
    phase 2's bar and its bitwise repeat, printing the plan of each; at
    projection's batch also timed (graph replay) with the plain version
    and the bytes bound.  Returns ({batch: max |diff|}, the batch-1
    summary over the 18 calls of one forward)."""
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    g = torch.Generator(device=dev).manual_seed(7)
    worst = {}
    b1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
          "per_forward": dict.fromkeys(kern.KERNEL_NAMES, 0)}
    for batch in (PROJECT_BATCH,) + TOOL_BATCHES:
        err_b, plans = 0.0, []
        for res, c in EPILOGUE_SHAPES:
            args = epilogue_inputs(g, dev, torch.float32, res, c, batch)
            with torch.no_grad():
                got = fused.fused_epilogue(*args)
                again = fused.fused_epilogue(*args)
                ref = fused._reference_epilogue(*args)
            shape = tuple(args[0].shape)
            if not torch.equal(got, again):
                fail(f"epilogue {shape} f32: two calls differ")
            err = float((got - ref).abs().max())
            if not err <= F32_TOL:
                fail(f"epilogue {shape} f32: max |diff| {err} > {F32_TOL}")
            plan = kern.plan_for(args[0])
            plans.append(f"{res}x{c}:p{plan['path']}c{plan['cluster']}"
                         f"s{plan['splits']}k{plan['chunks']}")
            err_b = max(err_b, err)
            if batch == PROJECT_BATCH:
                with torch.no_grad():
                    ms = graph_time_ms(lambda i: fused.fused_epilogue(*args))
                    plain_ms = graph_time_ms(
                        lambda i: fused._reference_epilogue(*args))
                bound_ms = kern.bytes_moved(args[0]) / HBM_BYTES_PER_S * 1e3
                log(json.dumps({"epilogue": "x".join(map(str, shape)),
                                "dtype": "f32", "max_abs_err": err,
                                "plan": plan, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms}))
                for k, v in (("ms", ms), ("plain_ms", plain_ms),
                             ("bound_ms", bound_ms)):
                    b1[k] += 2 * v
                b1["max_abs_err"] = max(b1["max_abs_err"], err)
                for name in kern.KERNELS_BY_PATH[plan["path"]]:
                    b1["per_forward"][name] += 2
            del args, got, again, ref
        worst[batch] = err_b
        log(json.dumps({"epilogue_batch": batch, "dtype": "f32",
                        "max_abs_err": err_b, "tol": F32_TOL,
                        "deterministic": True, "plans": plans}))
    log(json.dumps({"epilogue_batch1_18_calls": b1}))
    torch.cuda.empty_cache()
    return worst, b1


TRUNC_CONFIG = os.path.join(REPO, "configs", "sample_ffhq_1024_truncation.yaml")
# epilogue calls of one forward at out_depth 8
PER_FORWARD = 18
TOOL_SAMPLES = 16               # eval_metrics --num_samples (one batch of 16)
TOOL_IMAGES = 24                # seeded 1024^2 PNGs the metrics read as reals
INCEPTION_REL_TOL = 1e-3        # card vs CPU Inception features, TF32 off


def official_pickle(path, state_dict, out_depth):
    """A synthetic official-format TF pickle (a (G, D, Gs) tuple of
    dnnlib.tflib.network.Network states, the arrays in TF layouts) holding
    the reference-keyed generator `state_dict`, as the TF-import tests
    build one."""
    import pickle
    import types

    class Network:
        def __init__(self, name, variables, components=None):
            self.name, self.variables = name, variables
            self.components = components or {}

        def __getstate__(self):
            return {"version": 3, "name": self.name, "static_kwargs": {},
                    "components": dict(self.components),
                    "build_module_src": "raise RuntimeError('never run')",
                    "build_func_name": "G_style", "variables": self.variables}
    Network.__module__, Network.__qualname__ = "dnnlib.tflib.network", "Network"
    saved = {m: sys.modules.get(m) for m in
             ("dnnlib", "dnnlib.tflib", "dnnlib.tflib.network")}
    for m in saved:
        sys.modules[m] = types.ModuleType(m)
    sys.modules["dnnlib.tflib.network"].Network = Network

    epi = {"epi1.top_epi.noise.weight": "Noise/weight",
           "epi1.style_mod.lin.weight": "StyleMod/weight",
           "epi1.style_mod.lin.bias": "StyleMod/bias"}
    epi2 = {k.replace("epi1", "epi2"): v for k, v in epi.items()}
    init = {"const": "Const/const", "bias": "Const/bias",
            "conv.weight": "Conv/weight", "conv.bias": "Conv/bias",
            **{k: "Const/" + v for k, v in epi.items()},
            **{k: "Conv/" + v for k, v in epi2.items()}}
    block = {"conv0_up.weight": "Conv0_up/weight",
             "conv0_up.bias": "Conv0_up/bias",
             "conv1.weight": "Conv1/weight", "conv1.bias": "Conv1/bias",
             **{k: "Conv0_up/" + v for k, v in epi.items()},
             **{k: "Conv1/" + v for k, v in epi2.items()}}
    syn, mapping, top = [], [], []
    for key, t in state_dict.items():
        v = t.detach().cpu().numpy()
        if v.ndim == 2 and key.endswith("weight"):
            v = v.T                                   # (in, out)
        elif v.ndim == 4 and key.endswith("weight"):
            v = v.transpose(2, 3, 1, 0)               # HWIO
        v = np.ascontiguousarray(v)
        parts = key.split(".")
        if key.startswith("g_mapping.map.dense"):
            mapping.append((f"Dense{parts[2][5:]}/{parts[3]}", v))
        elif key == "truncation.avg_latent":
            top.append(("dlatent_avg", v))
        elif key.startswith("g_synthesis.to_rgb."):
            if int(parts[2]) == out_depth:
                syn.append((f"ToRGB_lod0/{parts[3]}", v))
        elif key.startswith("g_synthesis.init_block."):
            syn.append(("4x4/" + init[".".join(parts[2:])], v))
        else:
            res = 2 ** (int(parts[2]) + 3)
            syn.append((f"{res}x{res}/" + block[".".join(parts[3:])], v))
    syn.append(("noise0", np.zeros((1, 1, 4, 4), np.float32)))  # dropped
    gs = Network("G", top, {"synthesis": Network("G_synthesis", syn),
                            "mapping": Network("G_mapping", mapping)})
    try:
        with open(path, "wb") as f:
            pickle.dump((Network("G", []), Network("D", []), gs), f)
    finally:
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod


def tools_yaml(tmp, data_dir):
    """configs/sample_ffhq_1024.yaml with the seeded PNGs as its dataset."""
    import yaml
    with open(CONFIG) as f:
        doc = yaml.safe_load(f)
    doc["dataset"]["img_dir"] = data_dir
    path = os.path.join(tmp, "tools.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    return path


def phase_tools(dev):
    """Phase 7: every generation CLI of the port on FFHQ-1024; returns the
    epilogue launches of each in-process run."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        return tools_run(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def tools_run(dev, tmp):
    from PIL import Image
    from stylegan_torch.cli import (eval_metrics, generate_grid,
                                    generate_mixing_figure,
                                    generate_truncation_figure,
                                    generate_video)
    from stylegan_torch.cli.common import load_config, load_generator
    from stylegan_torch.config import get_default_cfg
    from stylegan_torch.convert import (save_discriminator_file,
                                        save_generator_file)
    from stylegan_torch.metrics import (inception_v3_init, lpips_vgg_init,
                                        make_feature_fn)
    from stylegan_torch.models import (Discriminator, Generator,
                                       discriminator_config_from_cfg,
                                       generator_config_from_cfg)
    from stylegan_torch.models.synthesis import layer_resolution, make_noise
    from stylegan_torch.ops import fused

    # FFHQ-1024 with truncation: seeded weights, noise weights included, and
    # the W average the mean of mapped W over a seeded batch
    cfg = get_default_cfg()
    cfg.merge_from_file(TRUNC_CONFIG)
    cfg.freeze()
    gen = Generator(generator_config_from_cfg(cfg))
    gen.load_state_dict(random_state_dict(gen, seed=3), strict=True)
    with torch.no_grad():
        z = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (256, gen.cfg.latent_size), dtype=np.float32))
        gen.truncation.avg_latent.copy_(gen.g_mapping(z)[:, 0].mean(0))
    npz = os.path.join(tmp, "gen.npz")
    save_generator_file(gen, npz)
    data_dir = os.path.join(tmp, "ffhq")
    write_pngs(data_dir, TOOL_IMAGES, 1024, seed=50)
    cfg_path = tools_yaml(tmp, data_dir)
    inception = os.path.join(tmp, "inception.npz")
    np.savez(inception, **inception_v3_init(0))
    lpips = os.path.join(tmp, "lpips.npz")
    np.savez(lpips, **lpips_vgg_init(0))

    def t(name):
        return os.path.join(tmp, name)
    full = gen.cfg.synthesis.depth - 1              # 8: 1024^2
    small = min(5, full)                            # 5: 128^2
    base = ["--generator_file", npz]
    plain_cfg, trunc_cfg = ["--config", cfg_path], ["--config", TRUNC_CONFIG]
    runs = [
        ("generate_grid", generate_grid, plain_cfg + base + [
            "--n_row", "10", "--n_col", "4", "--output_dir", t("grid"),
            "--seed", "0"], 1),
        ("generate_mixing_figure", generate_mixing_figure, plain_cfg + base
         + ["--output", t("mix.png"), "--out_depth", str(full)], 5),
        ("generate_truncation_figure", generate_truncation_figure, trunc_cfg
         + base + ["--output", t("trunc.png"), "--out_depth", str(full)],
         2),
        ("generate_video_walk", generate_video, plain_cfg + base + [
            "--output", t("walk.gif"), "--mode", "walk", "--num_points", "2",
            "--frames_per_step", "8"], 2),
        ("generate_video_truncation", generate_video, trunc_cfg + base + [
            "--output", t("sweep.gif"), "--mode", "truncation",
            "--num_frames", "16"], 2),
    ]
    metric = plain_cfg + base + ["--num_samples", str(TOOL_SAMPLES)]
    ppl_forwards = 2 * math.ceil(TOOL_SAMPLES / 16)   # ppl_samples: a, b
    runs += [
        ("eval_metrics_swd", eval_metrics, metric + ["--metric", "swd"], 1),
        ("eval_metrics_fid", eval_metrics, metric + [
            "--metric", "fid", "--inception_weights", inception], 1),
        ("eval_metrics_is", eval_metrics, metric + [
            "--metric", "is", "--inception_weights", inception], 1),
        ("eval_metrics_ppl", eval_metrics, metric + ["--metric", "ppl"],
         ppl_forwards),
        ("eval_metrics_ppl_lpips", eval_metrics, metric + [
            "--metric", "ppl", "--lpips_weights", lpips], ppl_forwards),
    ]
    launches = {}
    for name, module, argv, forwards in runs:
        zero("launches")
        fused.plain_calls = 0
        out = module.main(module.parse_arguments(argv + ["--device",
                                                         dev.type]))
        launches[name] = counter("launches")
        check_tool_output(name, out, tmp, 2 ** (full + 2))
        want = forwards * PER_FORWARD
        log(f"tools: {name}, {counter('launches')} epilogue calls (want "
            f"{want}), {fused.plain_calls} plain")
        if counter("launches") != want or fused.plain_calls:
            fail(f"{name}: {counter('launches')} kernel calls (want {want}), "
                 f"{fused.plain_calls} plain calls")
        torch.cuda.empty_cache()

    # one subprocess of every CLI, all at once, on the card: the python -m
    # entry points; convert imports a synthetic official pickle of the same
    # generator and exports G and D .pth files
    pkl = t("official.pkl")
    official_pickle(pkl, gen.state_dict(), gen.cfg.synthesis.depth - 1)
    dis = Discriminator(discriminator_config_from_cfg(cfg),
                        generator=torch.Generator().manual_seed(5))
    dis_npz = t("dis.npz")
    save_discriminator_file(dis, dis_npz)
    sub_depth = ["--out_depth", str(small)]
    m = [sys.executable, "-m"]
    cmds = {
        "convert": m + ["stylegan_torch.cli.convert"] + trunc_cfg + [
            "--input_file", pkl, "--output_file", t("converted.npz")],
        "convert_export_gen": m + ["stylegan_torch.cli.convert"] + trunc_cfg
        + ["--export_pth", "--input_file", npz, "--output_file",
           t("gen.pth")],
        "convert_export_dis": m + ["stylegan_torch.cli.convert"] + trunc_cfg
        + ["--export_pth", "--network", "dis", "--input_file", dis_npz,
           "--output_file", t("dis.pth")],
        "generate_grid": m + ["stylegan_torch.cli.generate_grid"] + plain_cfg
        + base + ["--n_row", "2", "--n_col", "1", "--output_dir",
                  t("sub_grid")],
        "generate_mixing_figure": m + [
            "stylegan_torch.cli.generate_mixing_figure"] + plain_cfg + base
        + sub_depth + ["--output", t("sub_mix.png")],
        "generate_truncation_figure": m + [
            "stylegan_torch.cli.generate_truncation_figure"] + trunc_cfg
        + base + sub_depth + ["--output", t("sub_trunc.png")],
        "generate_video": m + ["stylegan_torch.cli.generate_video"]
        + plain_cfg + base + sub_depth + [
            "--output", t("sub.gif"), "--num_points", "2",
            "--frames_per_step", "2", "--batch", "2"],
        "eval_metrics": m + ["stylegan_torch.cli.eval_metrics"] + plain_cfg
        + base + ["--num_samples", "4", "--batch", "4"],
    }
    run_all(cmds)
    check_converted(gen, dis, tmp)
    res, res_small = 2 ** (full + 2), 2 ** (small + 2)
    for name, shape in (("sub_grid/grid.png", (res + 2, 2 * res + 3, 3)),
                        ("sub_mix.png", (4 * res_small, 6 * res_small, 3)),
                        ("sub_trunc.png", (2 * res_small, 6 * res_small, 3))):
        got = np.asarray(Image.open(t(name))).shape
        if got != shape:
            fail(f"subprocess {name}: shape {got}, want {shape}")

    # card against CPU: the mixing figure at 128^2 with the noise maps drawn
    # on the CPU and handed to both, then Inception features of 4 images
    opt = load_config(cfg_path)               # float32, TF32 off
    card = load_generator(opt, npz, dev)
    cpu = load_generator(opt, npz, torch.device("cpu"))
    torch.set_num_threads(os.cpu_count() or 1)

    def noises(batch):
        return [make_noise(0, i, batch, layer_resolution(i), "cpu")
                for i in range(gen.cfg.num_layers)]
    args = (small, generate_mixing_figure.SRC_SEEDS,
            generate_mixing_figure.DST_SEEDS,
            generate_mixing_figure.STYLE_RANGES)
    _, on_card = generate_mixing_figure.draw_style_mixing_figure(
        t("card.png"), card, *args, noises=noises)
    _, on_cpu = generate_mixing_figure.draw_style_mixing_figure(
        t("cpu.png"), cpu, *args, noises=noises)
    fig_err = max(float(np.abs(a - b).max()) for a, b in zip(on_card, on_cpu))
    if not fig_err <= CPU_TOL:
        fail(f"mixing figure card vs CPU: max |diff| {fig_err} > {CPU_TOL}")
    imgs01 = np.clip((on_cpu[0][:4] + 1) / 2, 0, 1)
    params = inception_v3_init(0)
    f_card = make_feature_fn(params, dev)(imgs01).cpu().numpy()
    f_cpu = make_feature_fn(params, "cpu")(imgs01).numpy()
    inc_rel = float(np.abs(f_card - f_cpu).max() / np.abs(f_cpu).max())
    if not inc_rel <= INCEPTION_REL_TOL:
        fail(f"Inception features card vs CPU: {inc_rel} relative > "
             f"{INCEPTION_REL_TOL}")
    log(f"tools: card vs CPU, mixing figure at {res_small}^2 max |diff| "
        f"{fig_err:.3e} (bar {CPU_TOL}); Inception features of 4 images "
        f"{inc_rel:.3e} relative (bar {INCEPTION_REL_TOL})")
    return {"launches": launches, "mixing_card_vs_cpu": fig_err,
            "inception_card_vs_cpu": inc_rel}


def check_tool_output(name, out, tmp, res):
    """Shapes and finiteness of what one in-process CLI run returned at
    res^2, and the file it wrote."""
    from PIL import Image

    def finite(arrays):
        if not all(np.isfinite(a).all() for a in arrays):
            fail(f"{name}: non-finite images")
    if name == "generate_grid":
        finite([out])
        want = [(40, res, res, 3), (4 * (res + 1) + 1, 10 * (res + 1) + 1, 3)]
        got = [out.shape, np.asarray(Image.open(
            os.path.join(tmp, "grid", "grid.png"))).shape]
    elif name in ("generate_mixing_figure", "generate_truncation_figure"):
        canvas, images = out
        finite(images)
        want = ([(4 * res, 6 * res, 3), [5, 3, 5, 5, 5]]
                if name == "generate_mixing_figure"
                else [(2 * res, 6 * res, 3), [6, 6]])
        got = [canvas.shape, [len(i) for i in images]]
    elif name.startswith("generate_video"):
        frames, floats = out
        finite(floats)
        gif = Image.open(os.path.join(
            tmp, "walk.gif" if name.endswith("walk") else "sweep.gif"))
        # PIL merges equal consecutive frames of a GIF into one
        want = [16, (res, res, 3), (res, res), True]
        got = [len(frames), frames[0].shape, gif.size,
               1 < gif.n_frames <= 16]
    else:
        if not all(math.isfinite(v) for v in out.values()
                   if isinstance(v, float)):
            fail(f"{name}: non-finite result {out}")
        keys = {"eval_metrics_swd": {"swd_x1e3_avg"},
                "eval_metrics_fid": {"fid"},
                "eval_metrics_is": {"inception_score"}}.get(name, {"ppl"})
        want, got = keys, keys & set(out)
    if got != want:
        fail(f"{name}: output {got}, want {want}")


def check_converted(gen, dis, tmp):
    """The converted .npz holds the pickle's tensors bitwise (the lower-lod
    to_rgb heads are not in an official pickle); the exported .pth files
    hold G's and D's state_dicts and their blur buffers."""
    from stylegan_torch.convert import state_dict_from_flat
    with np.load(os.path.join(tmp, "converted.npz")) as z:
        meta = json.loads(z["__metadata__"].tobytes().decode())
        got = state_dict_from_flat({k: z[k] for k in z.files
                                    if k != "__metadata__"})
    if meta != {"source": "official.pkl",
                "resolution": gen.cfg.resolution}:
        fail(f"convert: metadata {meta}")
    out_depth = gen.cfg.synthesis.depth - 1
    for k, v in gen.state_dict().items():
        lower_rgb = (k.startswith("g_synthesis.to_rgb.")
                     and int(k.split(".")[2]) != out_depth)
        if not lower_rgb and not torch.equal(got[k], v):
            fail(f"convert: {k} differs from the pickle's")
    for name, module, blur in (("gen.pth", gen, "conv0_up.intermediate"),
                               ("dis.pth", dis, "blur")):
        sd = torch.load(os.path.join(tmp, name), map_location="cpu",
                        weights_only=True)
        own = module.state_dict()
        extra = set(sd) - set(own)
        if not extra or not all(k.endswith(f"{blur}.kernel") for k in extra):
            fail(f"convert --export_pth {name}: keys {sorted(extra)[:4]}")
        for k, v in own.items():
            if not torch.equal(sd[k], v.cpu()):
                fail(f"convert --export_pth {name}: {k} differs")


PROJECT_STEPS = 100
CHECK_STEPS = 5
# phase 8(d): the card's projection against float64 on the CPU, as phase
# 5(c) holds a train step.  The losses of steps 0 and 1, whose forward runs
# at W = w_avg (the lr is 0 at step 0): float32 sums in another order over
# the network, within 1e-3 relative of the CPU.  The first step's gradient
# (Adam's first moment): the card's error from float64 within 10x the CPU
# float32 run's own (cuDNN sums in other orders and takes other
# algorithms), plus 1e-5 of its largest.  W after the 5 steps: Adam moves
# each coordinate by about lr times the sign of its gradient, so a
# coordinate whose gradient is 0 up to float32 rounding moves either way
# and W's error grows with the steps; the card's from float64 within 10x
# the CPU float32's, plus 1e-6 of W's largest.  The later losses follow
# those W and are reported
CHECK_W_FACTOR = 10.0
CHECK_SAME_W_STEPS = 2


def phase_export_project(dev):
    """Phase 8: tracing, torch.export serving and W-space projection at
    FFHQ-1024 on the card; returns the report."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p8_")
    try:
        return export_project_run(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def reset_counts(kern, fused):
    zero("launches", "cuda_launches", "backward_launches",
         "backward_cuda_launches", "backward_g_copies", "partial_launches",
         "apply_launches")
    fused.plain_calls = 0


def export_project_run(dev, tmp):
    from PIL import Image
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    from stylegan_torch.convert import save_generator_file
    from stylegan_torch.models import Generator, generator_config_from_cfg
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    from stylegan_torch.serving import (export_generator, load_exported,
                                        make_serving_fn)
    from stylegan_torch.utils import trace

    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.freeze()
    apply_runtime_knobs(cfg)          # float32, TF32 off
    gen_cfg = generator_config_from_cfg(cfg)
    gen = Generator(gen_cfg)
    gen.load_state_dict(random_state_dict(gen), strict=True)
    npz = os.path.join(tmp, "gen.npz")
    save_generator_file(gen, npz)
    gen.requires_grad_(False).eval().to(dev)
    report = {}
    rs = np.random.default_rng(80)
    zs = [rs.standard_normal((BATCH, gen_cfg.latent_size), dtype=np.float32)
          for _ in range(REQUESTS + 1)]
    serve = make_serving_fn(gen_cfg, gen, depth=DEPTH, device=dev)
    serve(zs[-1], 1000)
    torch.cuda.synchronize()
    per_forward = forward_launches(kern, dev)

    # (a) one served request under utils.profiling.trace
    trace_dir = os.path.join(REPO, "build", "chip_smoke", "serve_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    zero("cuda_launches")
    with trace(trace_dir):
        serve(zs[0], 0)
        torch.cuda.synchronize()
    wrapper = counter("cuda_launches")
    (trace_file,) = [os.path.join(trace_dir, f)
                     for f in os.listdir(trace_dir)]
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    device_kernels = [e for e in events if e.get("cat") == "kernel"]
    count = {name: sum(f"::{name}<" in e.get("name", "")
                       for e in device_kernels)
             for name in kern.KERNEL_NAMES}
    report["trace"] = {"file": os.path.relpath(trace_file, REPO),
                       "bytes": os.path.getsize(trace_file),
                       "device_kernels": len(device_kernels),
                       "epilogue_launches_by_kernel": count,
                       "wrapper_cuda_launches": wrapper}
    log(json.dumps({"phase8_trace": report["trace"]}))
    if count != per_forward or sum(count.values()) != wrapper:
        fail(f"the trace of one served request shows epilogue launches "
             f"{count}; the plans make {per_forward}, the wrapper counted "
             f"{wrapper}")

    # (b) torch.export serving at batch 8, on the card
    blob = export_generator(gen_cfg, gen, depth=DEPTH, batch_size=BATCH)
    path = os.path.join(tmp, "gen_b8.pt2")
    with open(path, "wb") as f:
        f.write(blob)
    served = load_exported(path, device=dev)
    nodes = sum(n.op == "call_function"
                and n.target is torch.ops.stylegan_torch.epilogue.default
                for n in served.exported.graph.nodes)
    reset_counts(kern, fused)
    outs = [served(zs[i], i) for i in range(REQUESTS)]
    calls, plain = counter("launches"), fused.plain_calls
    # requests replay bit for bit with cuDNN's default algorithms: the
    # exported program against make_serving_fn for each request, and one
    # request served twice; the differences are reported either way (on
    # the host, where make_serving_fn's serve returns its images)
    outs = [out.cpu() for out in outs]
    replays = [serve(zs[i], i) for i in range(REQUESTS)]
    again = serve(zs[0], 0)
    equal = [bool(torch.equal(out, want)) for out, want in zip(outs, replays)]
    replay_equal = bool(torch.equal(again, replays[0]))
    diff = {"export_vs_serve": max(float((out - want).abs().max())
                                   for out, want in zip(outs, replays)),
            "serve_vs_serve": float((again - replays[0]).abs().max())}
    report["export"] = {
        "bytes": len(blob), "graph_epilogue_nodes": nodes,
        "epilogue_calls": calls,
        "plain_calls": plain, "bitwise_equal_export_vs_serve": equal,
        "bitwise_equal_serve_vs_serve": replay_equal,
        "max_abs_diff": diff}
    if nodes != PER_FORWARD or calls != PER_FORWARD * REQUESTS or plain:
        fail(f"exported program: {nodes} epilogue nodes, {calls} kernel "
             f"calls and {plain} plain calls over {REQUESTS} requests")
    if not all(equal) or not replay_equal:
        fail(f"served requests do not replay bit for bit: exported program "
             f"vs make_serving_fn {equal}, one request twice "
             f"{replay_equal}; max |diff| {diff}")
    del outs, replays, again, served, blob
    # a batch-2 depth-5 artifact exported on the card, loaded on the CPU
    small = export_generator(gen_cfg, gen, depth=CHECK_DEPTH,
                             batch_size=2)
    on_card = load_exported(small, device=dev).exported.module()
    on_cpu = load_exported(small, device="cpu").exported.module()
    z2 = torch.from_numpy(rs.standard_normal((2, gen_cfg.latent_size),
                                             dtype=np.float32))
    maps = [torch.from_numpy(rs.standard_normal(
        (2, 2 ** (i // 2 + 2), 2 ** (i // 2 + 2), 1), dtype=np.float32))
        for i in range(2 * (CHECK_DEPTH + 1))]
    torch.set_num_threads(os.cpu_count() or 1)
    with torch.inference_mode():
        want = on_cpu(z2, maps)
        got = on_card(z2.to(dev), [m.to(dev) for m in maps]).cpu()
    err = float((got - want).abs().max())
    report["export"]["depth5_card_vs_cpu"] = err
    log(json.dumps({"phase8_export": report["export"]}))
    if not err <= CPU_TOL:
        fail(f"depth-5 artifact, card vs CPU: max |diff| {err} > {CPU_TOL}")
    del on_card, on_cpu, small

    # (c) projection at 1024^2, W+, on a target the generator makes from a
    # W near w_avg with the projector's own pinned noises
    report["project"] = project_on_card(dev, gen_cfg, gen, kern, fused, tmp)
    w_path = report["project"].pop("w_path")

    # (d) depth 5 on the card and the CPU, pinned draws, float64 truth
    report["project_vs_cpu"] = project_vs_cpu(dev, cfg)

    # (e) the CLIs as subprocesses on the card
    target = os.path.join(tmp, "target.png")
    Image.fromarray(np.random.default_rng(81).integers(
        0, 256, (1024, 1024, 3), dtype=np.uint8)).save(target)

    def t(name):
        return os.path.join(tmp, name)
    run_all({
        "project": [sys.executable, "-m", "stylegan_torch.cli.project",
                    "--config", CONFIG, "--generator_file", npz, "--target",
                    target, "--output_dir", t("proj"), "--num_steps", "5"],
        "export_generator": [
            sys.executable, "-m", "stylegan_torch.cli.export_generator",
            "--config", CONFIG, "--generator_file", npz, "--output",
            t("cli.pt2"), "--batch", "2", "--check"],
        "generate_samples_input": [
            sys.executable, "-m", "stylegan_torch.cli.generate_samples",
            "--config", CONFIG, "--generator_file", npz, "--input", w_path,
            "--output", t("from_w.png")]}, label="8(e)")
    for name in ("proj/projected.png", "proj/target.png", "from_w.png"):
        shape = np.asarray(Image.open(t(name))).shape
        if shape != (1024, 1024, 3):
            fail(f"phase 8 CLI output {name} has shape {shape}")
    if np.load(t("proj/w.npy")).shape != (gen_cfg.num_layers,
                                          gen_cfg.dlatent_size):
        fail("the project CLI's w.npy has the wrong shape")
    return report


def project_on_card(dev, gen_cfg, gen, kern, fused, tmp):
    """Phase 8(c): 100 projection steps at 1024^2 with the exact epilogue
    calls, the loss curve and the w.npy it writes."""
    from stylegan_torch.projection import (ProjectorConfig, init_projection,
                                           project, w_statistics)
    pcfg = ProjectorConfig(num_steps=PROJECT_STEPS)
    seed = 5
    _, _, noises = init_projection(seed, gen_cfg, gen, pcfg)
    w_avg, ws = w_statistics(gen_cfg, gen, torch.Generator().manual_seed(7),
                             256)
    rs = np.random.default_rng(82)
    w_true = w_avg + 0.4 * ws * torch.from_numpy(rs.standard_normal(
        (1, gen_cfg.num_layers, gen_cfg.dlatent_size),
        dtype=np.float32)).to(dev) / gen_cfg.dlatent_size ** 0.5
    with torch.no_grad():
        target = gen.g_synthesis(w_true, depth=DEPTH, alpha=1.0,
                                 noises=noises)[0]
    torch.cuda.synchronize()
    reset_counts(kern, fused)
    dl, img, losses = project(seed, gen_cfg, gen, target, pcfg)
    counts = {"forward_calls": counter("launches"),
              "forward_cuda_launches": counter("cuda_launches"),
              "backward_calls": counter("backward_launches"),
              "backward_cuda_launches": counter("backward_cuda_launches"),
              "backward_g_copies": counter("backward_g_copies"),
              "plain_calls": fused.plain_calls}
    want = (PER_FORWARD * (PROJECT_STEPS + 1), PER_FORWARD * PROJECT_STEPS)
    if (counts["forward_calls"], counts["backward_calls"]) != want or \
            counts["plain_calls"]:
        fail(f"projection made epilogue calls {counts}, want {want} and no "
             "plain call")
    if not (np.isfinite(img).all() and np.isfinite(dl).all()
            and all(math.isfinite(v) for v in losses)):
        fail("projection output not finite")
    if img.shape != (1024, 1024, 3) or dl.shape != (gen_cfg.num_layers,
                                                    gen_cfg.dlatent_size):
        fail(f"projection output shapes {img.shape} {dl.shape}")
    if not losses[-1] < losses[0]:
        fail(f"projection loss {losses[0]} -> {losses[-1]}: no descent")
    w_path = os.path.join(tmp, "w.npy")
    np.save(w_path, dl)
    report = {"steps": PROJECT_STEPS,
              "losses_every_10": losses[::10] + [losses[-1]],
              "pixel_mse": float(np.mean((img - target.cpu().numpy()) ** 2)),
              **counts, "w_path": w_path}
    log(json.dumps({"phase8_project": {k: v for k, v in report.items()
                                       if k != "w_path"}}))
    return report


def project_vs_cpu(dev, cfg):
    """Phase 8(d): 5 projection steps of the FFHQ-1024 model's first 6
    stages (128^2) on the card, on the CPU, and on the CPU in float64, with
    the z of w_statistics, the noise maps and each step's perturbation
    pinned: the losses and W within the bars above."""
    from stylegan_torch.models import Generator, generator_config_from_cfg
    from stylegan_torch.models.synthesis import layer_resolution
    from stylegan_torch.projection import (ProjectorConfig,
                                           build_projection_step,
                                           init_projection, w_statistics)
    small = cfg.clone()
    small.defrost()
    small.dataset.resolution = 2 ** (CHECK_DEPTH + 2)
    small.freeze()
    gen_cfg = generator_config_from_cfg(small)
    sd = random_state_dict(Generator(gen_cfg), seed=12)
    pcfg = ProjectorConfig(num_steps=CHECK_STEPS, avg_samples=256)
    rs = np.random.default_rng(83)
    n_layers, dl_size = gen_cfg.num_layers, gen_cfg.dlatent_size
    z = rs.standard_normal((256, gen_cfg.latent_size))
    noises = [rs.standard_normal((1, layer_resolution(i), layer_resolution(i),
                                  1)) for i in range(n_layers)]
    perts = rs.standard_normal((CHECK_STEPS, n_layers, dl_size))
    # the target: the same model's image of a W near w_avg (as phase 8(c))
    ref = Generator(gen_cfg)
    ref.load_state_dict(sd, strict=True)
    ref.requires_grad_(False)
    w_avg, w_std = w_statistics(gen_cfg, ref, z=torch.from_numpy(z).float())
    w_true = w_avg + 0.4 * w_std * torch.from_numpy(rs.standard_normal(
        (1, n_layers, dl_size), dtype=np.float32)) / dl_size ** 0.5
    with torch.no_grad():
        target = ref.g_synthesis(
            w_true, depth=CHECK_DEPTH, alpha=1.0,
            noises=[torch.from_numpy(n).float() for n in noises])[0].numpy()
    del ref
    runs = []
    for device, dtype in ((dev, torch.float32), (torch.device("cpu"),
                                                 torch.float32),
                          (torch.device("cpu"), torch.float64)):
        def put(a):
            return torch.as_tensor(a).to(device, dtype)
        gen = Generator(gen_cfg)
        gen.load_state_dict(sd, strict=True)
        gen.requires_grad_(False).to(device, dtype)
        state, w_std, pinned = init_projection(
            0, gen_cfg, gen, pcfg, z=put(z), noises=[put(n) for n in noises])
        step = build_projection_step(gen_cfg, gen, pcfg, pinned)
        losses, moment = [], None
        for t in range(CHECK_STEPS):
            losses.append(float(step(state, put(target), t, w_std,
                                     perturbation=put(perts[t]))[1]))
            if t == 0:     # a copy: Adam updates its moments in place
                moment = state.optimizer.state[state.dlatents]["exp_avg"] \
                    .detach().cpu().double().clone()
        log(f"projection check on {device.type} {dtype}: losses {losses}")
        runs.append((losses, moment, state.dlatents.detach().cpu().double()))
        del gen, state, step
    (lc, mc, wc), (lh, mh, wh), (l64, m64, w64) = runs
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(lc, lh)]

    def bar_check(card, cpu, truth, floor):
        err_card = float((card - truth).abs().max())
        err_cpu = float((cpu - truth).abs().max())
        bar = CHECK_W_FACTOR * err_cpu + floor * float(truth.abs().max())
        return {"card": err_card, "cpu_f32": err_cpu, "bar": bar}
    grad = bar_check(mc, mh, m64, 1e-5)
    w = bar_check(wc, wh, w64, 1e-6)
    report = {"depth": CHECK_DEPTH, "steps": CHECK_STEPS,
              "loss_rel_diff": loss_rel, "losses_card": lc,
              "losses_cpu_f32": lh, "losses_f64": l64,
              "grad_err_vs_f64": grad, "w_err_vs_f64": w}
    log(json.dumps({"phase8_project_vs_cpu": report}))
    if not max(loss_rel[:CHECK_SAME_W_STEPS]) <= CHECK_LOSS_RTOL:
        fail(f"projection losses at w_avg, card vs CPU: {lc} vs {lh}")
    for name, r in (("first-step gradient", grad), ("W", w)):
        if not r["card"] <= r["bar"]:
            fail(f"projection {name}, card vs float64: {r}")
    return report


# --------------------------------------------------------------------------
# Phase 9: the bf16 activation path on the card
# --------------------------------------------------------------------------

PERF_CONFIG = os.path.join(REPO, "configs", "sample_ffhq_1024_tpu_perf.yaml")
# tests/test_bf16.py's bars on the bf16 forward's drift from float32, as
# shares of the float32 image's span
BF16_DRIFT_MEAN, BF16_DRIFT_MAX = 0.02, 0.25
# one bf16 step on the card against the same bf16 step on the CPU and
# float64 on the CPU: losses within 5e-2 of the CPU's (bf16 keeps 8
# significant bits, so sums over the network differ in the third digit);
# each gradient tensor's relative L2 error from float64 within 3x the CPU
# bf16 step's own, plus 1e-3 (cuDNN's bf16 algorithms round in other places
# than oneDNN's, and accumulate in float32 as it does)
BF16_LOSS_RTOL = 5e-2
BF16_GRAD_FACTOR, BF16_GRAD_FLOOR = 3.0, 1e-3
BF16_CHECK_DEPTH = CHECK_DEPTH
BF16_STEPS = 3                  # steps of each kind in 9(b)
BF16_CLI_IMAGES = 24            # depth 7: 6 steps at batch 4, 8: 12 at 2


def perf_cfg(**overrides):
    """configs/sample_ffhq_1024_tpu_perf.yaml over the defaults: bf16
    activations, logistic loss with lazy R1 at interval 16, remat."""
    from stylegan_torch.config import get_default_cfg
    cfg = get_default_cfg()
    cfg.merge_from_file(PERF_CONFIG)
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    cfg.freeze()
    return cfg


def phase_bf16(dev):
    """Phase 9: the bf16 forward, train steps, a depth-5 step against the
    CPU and float64, and the perf config through the train CLI; returns
    the report."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p9_")
    try:
        return {"forward": bf16_forward(dev), "train": bf16_train(dev),
                "vs_cpu": bf16_vs_cpu(dev), "cli": bf16_cli(dev, tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bf16_forward(dev):
    """9(a): phase 3's generator (float32 weights) on bf16 z, batch 8 at
    1024^2: 18 kernel calls per forward and no plain call, the drift from
    float32 on the same z and pinned noise within tests/test_bf16.py's
    bars, two runs bitwise equal."""
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    from stylegan_torch.models import Generator, generator_config_from_cfg
    from stylegan_torch.models.synthesis import layer_resolution
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    from stylegan_torch.ops.precision import set_precision

    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.freeze()
    gen_cfg = generator_config_from_cfg(cfg)
    gen = Generator(gen_cfg)
    gen.load_state_dict(random_state_dict(gen), strict=True)
    gen.requires_grad_(False).eval().to(dev)
    rs = np.random.default_rng(90)
    z = torch.from_numpy(rs.standard_normal(
        (BATCH, gen_cfg.latent_size), dtype=np.float32)).to(dev)
    noises = [torch.from_numpy(rs.standard_normal(
        (BATCH, layer_resolution(i), layer_resolution(i), 1),
        dtype=np.float32)).to(dev) for i in range(gen_cfg.num_layers)]

    def forward(dtype):
        with torch.inference_mode():
            return gen(z.to(dtype), depth=DEPTH, alpha=1.0,
                       noises=[n.to(dtype) for n in noises]).images

    set_precision("highest")          # the float32 reference: TF32 off
    ref = forward(torch.float32)
    apply_runtime_knobs(perf_cfg())   # bf16: TF32 for the float32 ops
    reset_counts(kern, fused)
    out = forward(torch.bfloat16)
    again = forward(torch.bfloat16)
    calls, plain = counter("launches"), fused.plain_calls
    if out.dtype != torch.bfloat16 or tuple(out.shape) != (BATCH, 1024,
                                                           1024, 3):
        fail(f"bf16 forward: {out.dtype} {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        fail("bf16 forward: non-finite values")
    d = (out.float() - ref).abs()
    span = float(ref.max() - ref.min())
    drift = {"mean_abs": float(d.mean()), "max_abs": float(d.max()),
             "span": span, "mean_bar": BF16_DRIFT_MEAN * span,
             "max_bar": BF16_DRIFT_MAX * span}
    replay = bool(torch.equal(out, again))
    del d, out, again, ref

    report = {"epilogue_calls": calls, "plain_calls": plain, "drift": drift,
              "bitwise_equal_two_runs": replay}
    log(json.dumps({"phase9_forward": report}))
    if calls != 2 * PER_FORWARD or plain:
        fail(f"bf16 forward: {calls} epilogue calls and {plain} plain calls "
             f"over 2 forwards, want {2 * PER_FORWARD} and 0")
    if not (drift["mean_abs"] < drift["mean_bar"]
            and drift["max_abs"] < drift["max_bar"]):
        fail(f"bf16 forward drift from float32 beyond the bars: {drift}")
    if not replay:
        fail("bf16 forward: two runs of one request differ")
    del gen
    torch.cuda.empty_cache()
    return report


def bf16_step_launches(kern, dev, batch):
    """Launches of each epilogue kernel in one bf16 perf-config step, by
    the plans: two G forwards of 18 calls, the 16 calls of the growth
    blocks recomputed in the backward (remat), one G backward of 18."""
    want = dict.fromkeys(kern.KERNEL_NAMES + kern.BWD_KERNEL_NAMES, 0)
    for res, c in EPILOGUE_SHAPES:
        x = torch.empty((batch, res, res, c), device=dev,
                        dtype=torch.bfloat16)
        for name in kern.KERNELS_BY_PATH[kern.plan_for(x)["path"]]:
            want[name] += 2 * (2 + (res > 4))
        for name in kern.BWD_KERNELS_BY_PATH[kern.bwd_plan_for(x)["path"]]:
            want[name] += 2
    return want


@contextlib.contextmanager
def g_update_marks(kern):
    """The epilogue counts at the start of each G update, so that a step's
    calls split into its D update and its G update."""
    from stylegan_torch.train import steps as steps_mod
    marks, real = [], steps_mod._Phases.g_update

    def g_update(self, *args, **kwargs):
        marks.append((counter("launches"), counter("backward_launches")))
        return real(self, *args, **kwargs)
    steps_mod._Phases.g_update = g_update
    try:
        yield marks
    finally:
        steps_mod._Phases.g_update = real


def bf16_train(dev):
    """9(b): the perf config's trainer (bf16, logistic with lazy R1 at 16,
    remat, fused scoring on the off-steps) at depth 8, batch 2, seeded
    weights: BF16_STEPS R1 steps and off-steps through train_on_batch,
    finite losses, the epilogue calls of each step's D and G updates, no
    plain call; one profiled step of each (kernels as the plans launch
    them, and their device time inside it); float32 parameters after."""
    from stylegan_torch.cli.train import build_trainer
    from stylegan_torch.config import apply_runtime_knobs
    from stylegan_torch.models import generator_config_from_cfg
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern

    cfg = perf_cfg()
    apply_runtime_knobs(cfg)
    trainer = build_trainer(cfg, dev)
    s = trainer.state
    s.generator.load_state_dict(random_state_dict(s.generator, seed=10))
    s.discriminator.load_state_dict(random_state_dict(s.discriminator,
                                                      seed=11))
    alpha = torch.tensor(0.5, device=dev)
    batch = TRAIN_BATCH
    reals, _ = (t.to(dev) for t in train_batch(
        generator_config_from_cfg(cfg), batch, 20))
    want = bf16_step_launches(kern, dev, batch)
    report = {"r1_interval": trainer.r1_interval,
              "fuse_scores": trainer.fuse_scores,
              "precision": cfg.precision.activations}
    if not trainer.fuse_scores:
        fail("the perf config's trainer does not fuse the scoring")
    for name, with_r1 in (("r1_step", True), ("off_step", False)):
        def one():
            trainer._update_count = 0 if with_r1 else 1  # the R1 phase
            return trainer.train_on_batch(reals, TRAIN_DEPTH, 0.5,
                                          fetch=False)
        reset_counts(kern, fused)
        losses = []
        with g_update_marks(kern) as marks:
            for i in range(BF16_STEPS):
                start = (counter("launches"), counter("backward_launches"))
                losses.append([float(v) for v in one()])
                marks[i] = (marks[i][0] - start[0], marks[i][1] - start[1])
        fwd, bwd, plain = (counter("launches"), counter("backward_launches"),
                           fused.plain_calls)
        per_step = {"d_update_forward": marks[0][0],
                    "d_update_backward": marks[0][1],
                    "g_update_forward": fwd // BF16_STEPS - marks[0][0],
                    "g_update_backward": bwd // BF16_STEPS - marks[0][1]}
        step = trainer._get_step(TRAIN_DEPTH, with_r1)
        z16 = torch.randn((batch, trainer.latent_size), device=dev,
                          dtype=torch.bfloat16)
        kernel_ms = profile_train_step(
            step, s, (reals.to(torch.bfloat16), z16), alpha, kern, want)
        report[name] = {"losses": losses,
                        "epilogue_calls_per_step": per_step,
                        "plain_calls": plain,
                        "epilogue_kernels_in_step_ms": kernel_ms}
        if not all(math.isfinite(v) for pair in losses for v in pair):
            fail(f"bf16 {name}: losses not finite: {losses}")
        if any(m != marks[0] for m in marks) or per_step != {
                "d_update_forward": PER_FORWARD, "d_update_backward": 0,
                "g_update_forward": PER_FORWARD + 16,
                "g_update_backward": PER_FORWARD} or plain:
            fail(f"bf16 {name}: epilogue calls per step {marks} "
                 f"({per_step}), {plain} plain calls")
    params = {p.dtype for m in (s.generator, s.discriminator, s.g_shadow)
              for p in m.parameters()}
    report["parameter_dtypes"] = sorted(str(d) for d in params)
    log(json.dumps({"phase9_train": report}))
    if params != {torch.float32}:
        fail(f"bf16 training changed the parameters' dtypes: {params}")
    del trainer, s, reals
    torch.cuda.empty_cache()
    return report


def bf16_vs_cpu(dev):
    """9(c): one depth-5 step of the perf config's R1 step (bf16, remat,
    gamma 10 x 16) on the card and on the CPU in bf16, and in float64 on
    the CPU, with the draws pinned: losses, each gradient tensor (Adam's
    first moment) and the parameters' dtype within the bars above."""
    from stylegan_torch.config import apply_runtime_knobs
    from stylegan_torch.models import generator_config_from_cfg
    from stylegan_torch.models.synthesis import layer_resolution
    from stylegan_torch.train import build_train_step, create_train_state

    cfg = perf_cfg()
    apply_runtime_knobs(cfg)
    batch = TRAIN_BATCH
    rs = np.random.default_rng(91)
    reals, z = train_batch(generator_config_from_cfg(cfg), batch, 92)
    noises = [torch.from_numpy(rs.standard_normal(
        (batch, layer_resolution(i), layer_resolution(i), 1),
        dtype=np.float32)) for i in range(2 * (BF16_CHECK_DEPTH + 1))]
    latents2 = torch.from_numpy(rs.standard_normal(tuple(z.shape),
                                                   dtype=np.float32))
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = torch.device("cpu")
    runs = []
    for device, dtype in ((dev, torch.bfloat16), (cpu, torch.bfloat16),
                          (cpu, torch.float64)):
        params = torch.float64 if dtype == torch.float64 else torch.float32
        gen_cfg, dis_cfg, gen, dis = train_models(cfg, device, params,
                                                  remat=True)
        state = create_train_state(gen, dis, dict(cfg.model.g_optim),
                                   dict(cfg.model.d_optim))
        step = build_train_step(gen_cfg, dis_cfg, depth=BF16_CHECK_DEPTH,
                                loss=cfg.loss, use_ema=cfg.use_ema,
                                ema_decay=cfg.ema_decay,
                                r1_gamma=cfg.r1_gamma * cfg.r1_interval,
                                fuse_scores=True)
        put = lambda t: t.to(device, dtype)
        _, m = step(state, put(reals), put(z), 0,
                    torch.tensor(0.5, device=device, dtype=params),
                    noises=[put(n) for n in noises],
                    mixing=(put(latents2), 5))
        losses = (m["d_loss"].item(), m["g_loss"].item())
        log(f"bf16 check on {device.type} {dtype}: losses {losses}")
        dtypes = {p.dtype for mod in (state.generator, state.discriminator,
                                      state.g_shadow)
                  for p in mod.parameters()}
        runs.append((losses, moments(state), dtypes))
        del state, step, gen, dis
        torch.cuda.empty_cache()
    (lc, mc, dc), (lh, mh, _), (_, m64, _) = runs
    loss_rel = {name: abs(a - b) / max(1.0, abs(b))
                for name, a, b in zip(("d_loss", "g_loss"), lc, lh)}
    worst = {"ratio": 0.0, "card_rel_l2": 0.0, "cpu_rel_l2": 0.0,
             "worst_tensor": None}
    bad = []
    for name, truth in m64.items():
        norm = float(truth.norm())
        card = float((mc[name].double() - truth).norm())
        cpu_err = float((mh[name].double() - truth).norm())
        if norm == 0.0:       # no gradient flows there: both exactly 0
            if card or cpu_err:
                bad.append((name, card, cpu_err))
            continue
        card, cpu_err = card / norm, cpu_err / norm
        bar = BF16_GRAD_FACTOR * cpu_err + BF16_GRAD_FLOOR
        if card / bar > worst["ratio"]:
            worst.update(ratio=card / bar, worst_tensor=(
                name, truth.numel(), card, cpu_err))
        worst["card_rel_l2"] = max(worst["card_rel_l2"], card)
        worst["cpu_rel_l2"] = max(worst["cpu_rel_l2"], cpu_err)
        if not card <= bar:
            bad.append((name, card, cpu_err))
    report = {"depth": BF16_CHECK_DEPTH, "losses_card": lc,
              "losses_cpu_bf16": lh, "loss_rel_diff": loss_rel,
              "grads_vs_float64": worst,
              "parameter_dtypes": sorted(str(d) for d in dc)}
    log(json.dumps({"phase9_vs_cpu": report}))
    if not max(loss_rel.values()) <= BF16_LOSS_RTOL:
        fail(f"bf16 step, card vs CPU losses: {lc} vs {lh}")
    if bad:
        fail(f"bf16 step, card gradients vs float64 beyond the bar: "
             f"{bad[:5]}")
    if dc != {torch.float32}:
        fail(f"bf16 step on the card: parameters {dc} after the step")
    return report


def bf16_cli(dev, tmp):
    """9(d): `python -m stylegan_torch.cli.train --config` a copy of the
    perf config on 24 seeded 1024^2 PNGs, depths 7 and 8 (one epoch each,
    4 feedback samples): finite losses in metrics.jsonl, a checkpoint that
    reads back with float32 parameters."""
    import yaml
    from stylegan_torch.convert import load_generator_file
    from stylegan_torch.models import Generator, generator_config_from_cfg

    data_dir, out = os.path.join(tmp, "ffhq"), os.path.join(tmp, "run")
    write_pngs(data_dir, BF16_CLI_IMAGES, 1024, seed=93)
    with open(PERF_CONFIG) as f:
        doc = yaml.safe_load(f)
    doc["output_dir"] = out
    doc["dataset"]["img_dir"] = data_dir
    doc["sched"]["epochs"] = [1] * 9
    doc["num_samples"] = 4
    path = os.path.join(tmp, "perf.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    run([sys.executable, "-m", "stylegan_torch.cli.train", "--config", path,
         "--start_depth", str(TRAINER_START_DEPTH)], "train CLI (bf16)")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(out, "log.txt")) as f:
        text = f.read()
    if not rows or not all(math.isfinite(r["d_loss"]) and
                           math.isfinite(r["g_loss"]) for r in rows):
        fail(f"bf16 train CLI: losses not finite: {rows}")
    if "bf16 activations" not in text:
        fail("bf16 train CLI: the log does not say it trains in bf16")
    gen = Generator(generator_config_from_cfg(perf_cfg()))
    load_generator_file(gen, os.path.join(out, "models",
                                          "GAN_GEN_SHADOW_8_1.npz"))
    dtypes = {p.dtype for p in gen.parameters()}
    if dtypes != {torch.float32}:
        fail(f"bf16 train CLI: checkpoint parameters {dtypes}")
    report = {"feedback_rows": len(rows),
              "losses": [(r["d_loss"], r["g_loss"]) for r in rows]}
    log(json.dumps({"phase9_cli": report}))
    return report


PAR_STEPS = 3
PAR_BATCH = 4             # the two ranks' global batch: 2 each, as 5(b)'s
PAR_TIMEOUT = 600         # s: each collective's wait, and the two ranks' run
PAR_OUT = os.path.join(REPO, "build", "chip_smoke", "parallel")
PAR_CLI_IMAGES = 8


def phase_parallel(dev):
    """Phase 10: the data-parallel path (stylegan_torch/parallel, the mesh=
    step, the train CLI under torchrun) on FFHQ-1024, each part fatal."""
    from stylegan_torch.parallel import spawn
    report = {"one_rank_nccl": parallel_one_rank(dev)}
    shutil.rmtree(PAR_OUT, ignore_errors=True)
    os.makedirs(PAR_OUT)
    spawn(parallel_rank, 2, (PAR_OUT,), backend="gloo", device="cuda:0",
          timeout=PAR_TIMEOUT, join_timeout=PAR_TIMEOUT)
    report["two_ranks_gloo"] = parallel_two_ranks()
    # the CLI's rank runs on the card while this process computes 10(c)
    # (one step on the card, one in float64 on the CPU)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(PAR_OUT)) as tmp:
        cli = parallel_cli_start(tmp)
        try:
            report["vs_one_process"] = parallel_vs_one_process(dev)
            report["cli_torchrun"] = parallel_cli_finish(cli)
        finally:
            if cli["proc"].poll() is None:
                cli["proc"].kill()
                cli["proc"].wait()
            cli["log"].close()
    shutil.rmtree(PAR_OUT)
    return report


def ffhq_cfg():
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.freeze()
    apply_runtime_knobs(cfg)          # float32, TF32 off
    return cfg


def reset_train_counts():
    from stylegan_torch.ops import fused
    zero("launches", "backward_launches")
    fused.plain_calls = 0


def train_counts():
    from stylegan_torch.ops import fused
    return {"forward_calls": counter("launches"),
            "backward_calls": counter("backward_launches"),
            "plain_calls": fused.plain_calls}


def check_train_counts(counts, steps, what):
    want = {"forward_calls": 36 * steps, "backward_calls": 18 * steps,
            "plain_calls": 0}
    if counts != want:
        fail(f"{what}: epilogue calls {counts}, want {want}")


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside, the process's setting
    restored after."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def parallel_one_rank(dev):
    """10(a): a world of one rank over NCCL; the mesh= step at depth 8,
    batch 2, logistic + R1.  Its first step from the seeded state against
    two runs of the mesh=None step from the same state on the same inputs
    and draws (rank 0's), the three under cuDNN's deterministic algorithms
    (an all-reduce over one rank and a mean over one change no bit): the
    losses and gradients (Adam's first moments) bitwise equal; a tensor
    that is not is reported by name and held to within CHECK_GRAD_FACTOR
    times the two plain runs' spread plus 1e-5 of the scale; then
    PAR_STEPS steps (cuDNN's default algorithms): finite losses, 36 forward
    and 18 backward kernel calls per step, no plain call; and `replicate`
    over the rank leaves the state's digests as they were."""
    from stylegan_torch.models.synthesis import stream_seed
    from stylegan_torch.parallel import (create_mesh, initialize_distributed,
                                         replicate)
    from stylegan_torch.train import create_train_state
    from stylegan_torch.train.steps import SHARD_STREAM

    cfg = ffhq_cfg()
    batch = cfg.sched.batch_sizes[TRAIN_DEPTH]
    rank_dev = initialize_distributed(f"localhost:{free_port()}", 1, 0,
                                      device=dev, timeout=PAR_TIMEOUT)
    try:
        if torch.distributed.get_backend() != "nccl":
            fail(f"10(a): backend {torch.distributed.get_backend()}")
        mesh = create_mesh(1)
        alpha = torch.tensor(0.5, device=rank_dev)
        results = {}
        for label, m in (("plain", None), ("plain_again", None),
                         ("mesh", mesh)):
            gen_cfg, dis_cfg, gen, dis = train_models(cfg, rank_dev)
            state = create_train_state(gen, dis, dict(cfg.model.g_optim),
                                       dict(cfg.model.d_optim),
                                       use_ema=cfg.use_ema)
            step = train_step_fn(cfg, gen_cfg, dis_cfg, TRAIN_DEPTH,
                                 cfg.loss, mesh=m)
            reals, z = (t.to(rank_dev) for t in train_batch(gen_cfg, batch,
                                                            40))
            # the mesh step folds its rank into the seed (shard_rng)
            seed = 5 if m is not None else stream_seed(5, SHARD_STREAM, 0)
            with cudnn_deterministic():
                _, out = step(state, reals, z, seed, alpha)
                results[label] = step_result(out, state)
            if m is not None:
                batches = [tuple(t.to(rank_dev) for t in train_batch(
                    gen_cfg, batch, 41 + i)) for i in range(PAR_STEPS)]
                reset_train_counts()
                losses = []
                for i, b in enumerate(batches):
                    _, out = step(state, *b, 6 + i, alpha)
                    losses.append((out["d_loss"].item(),
                                   out["g_loss"].item()))
                counts = train_counts()
                # NCCL takes only card tensors: Adam's step counts (on the
                # host) travel through the card, and come back unchanged
                before = state_digests(state)
                replicate(mesh, state)
                if state_digests(state) != before:
                    fail("10(a): replicate over one NCCL rank changed the "
                         "state")
            del state, step, gen, dis
            torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()
    (lp, _, mp), (la, _, ma), (lm, _, mm) = (
        results[k] for k in ("plain", "plain_again", "mesh"))
    loss_diff = [abs(a - b) for a, b in zip(lm, lp)]
    loss_spread = [abs(a - b) for a, b in zip(la, lp)]
    differ = [name for name, ref in mp.items()
              if not torch.equal(mm[name], ref)]
    differ += [k for k, a, b in zip(("d_loss", "g_loss"), lm, lp) if a != b]
    ratio = 0.0
    for name, ref in mp.items():
        spread = float((ma[name] - ref).abs().max())
        err = float((mm[name] - ref).abs().max())
        bar = CHECK_GRAD_FACTOR * spread + 1e-5 * float(ref.abs().max())
        if bar > 0:
            ratio = max(ratio, err / bar)
        if not err <= bar:
            fail(f"10(a): mesh step gradient {name} {err} from the plain "
                 f"step's, whose two runs differ by {spread}")
    for d, sp, ref in zip(loss_diff, loss_spread, lp):
        if not d <= CHECK_GRAD_FACTOR * sp + 1e-5 * max(1.0, abs(ref)):
            fail(f"10(a): mesh step losses {lm}, plain {lp}, {la}")
    if not all(math.isfinite(v) for pair in losses for v in pair):
        fail(f"10(a): losses not finite: {losses}")
    check_train_counts(counts, PAR_STEPS, "10(a)")
    report = {"backend": "nccl", "world": 1,
              "cudnn_deterministic_bitwise": not differ,
              "differ_from_plain": differ,
              "first_step_losses": {"mesh": lm, "plain": lp,
                                    "plain_again": la},
              "grad_bar_ratio": ratio, "losses": losses, **counts}
    log(json.dumps({"phase10_one_rank_nccl": report}))
    return report


def state_digests(state):
    """sha256 of each part of a TrainState: G, D and the shadow (parameters
    and buffers, the W-average among them) and both Adams' moments and
    counts."""
    import hashlib
    out = {}
    for label, module in (("G", state.generator), ("D", state.discriminator),
                          ("shadow", state.g_shadow)):
        h = hashlib.sha256()
        for name, t in module.state_dict().items():
            h.update(name.encode())
            h.update(t.detach().cpu().numpy().tobytes())
        out[label] = h.hexdigest()
    for label, module, opt in (("G_adam", state.generator, state.g_optimizer),
                               ("D_adam", state.discriminator,
                                state.d_optimizer)):
        h = hashlib.sha256()
        for name, p in module.named_parameters():
            for key, v in sorted(opt.state[p].items()):
                h.update(f"{name}/{key}".encode())
                h.update(v.detach().cpu().numpy().tobytes())
        out[label] = h.hexdigest()
    return out


def parallel_rank(rank, device, out_dir):
    """One of the two ranks of 10(b) and 10(c), on the one card over gloo.
    (b): the mesh= step at depth 8, global batch PAR_BATCH, logistic + R1:
    a first step and PAR_STEPS more, the state's digests after each, the
    kernel calls of the PAR_STEPS into b_rank{rank}.json.  (c): one
    depth-5 step on this rank's rows of pinned_inputs(cfg, PAR_BATCH, 70),
    rank 0's result into c_rank0.pt."""
    from stylegan_torch.parallel import create_mesh, global_shard, replicate
    from stylegan_torch.train import create_train_state

    cfg = ffhq_cfg()
    mesh = create_mesh(2)
    gen_cfg, dis_cfg, gen, dis = train_models(cfg, device)
    state = create_train_state(gen, dis, dict(cfg.model.g_optim),
                               dict(cfg.model.d_optim), use_ema=cfg.use_ema)
    replicate(mesh, state)
    step = train_step_fn(cfg, gen_cfg, dis_cfg, TRAIN_DEPTH, cfg.loss,
                         mesh=mesh)
    alpha = torch.tensor(0.5, device=device)
    batches = [tuple(global_shard(mesh, t).to(device) for t in train_batch(
        gen_cfg, PAR_BATCH, 50 + i)) for i in range(PAR_STEPS + 1)]
    _, out = step(state, *batches[0], 0, alpha)
    digests = [state_digests(state)]
    reset_train_counts()
    losses = []
    for i in range(PAR_STEPS):
        _, out = step(state, *batches[1 + i], 1 + i, alpha)
        losses.append((out["d_loss"].item(), out["g_loss"].item()))
        digests.append(state_digests(state))
    counts = train_counts()
    with open(os.path.join(out_dir, f"b_rank{rank}.json"), "w") as f:
        json.dump({"losses": losses, "digests": digests, **counts}, f)
    del state, step, gen, dis, batches
    torch.cuda.empty_cache()

    reals, z, noises, latents2 = (
        [global_shard(mesh, t).to(device) for t in x] if isinstance(x, list)
        else global_shard(mesh, x).to(device)
        for x in pinned_inputs(cfg, PAR_BATCH, 70))
    gen_cfg, dis_cfg, gen, dis = train_models(cfg, device)
    state = create_train_state(gen, dis, dict(cfg.model.g_optim),
                               dict(cfg.model.d_optim))
    step = train_step_fn(cfg, gen_cfg, dis_cfg, CHECK_DEPTH, cfg.loss,
                         mesh=mesh)
    _, out = step(state, reals, z, 0, alpha, noises=noises,
                  mixing=(latents2, MIXING_CUTOFF))
    if rank == 0:
        torch.save(step_result(out, state),
                   os.path.join(out_dir, "c_rank0.pt"))


def parallel_two_ranks():
    """10(b)'s verdict from the ranks' files: the same state digests after
    the first step and after every later one, finite losses, each rank's kernel
    calls as 10(a)'s, no plain call."""
    ranks = []
    for r in (0, 1):
        with open(os.path.join(PAR_OUT, f"b_rank{r}.json")) as f:
            ranks.append(json.load(f))
    for i, (a, b) in enumerate(zip(ranks[0]["digests"],
                                   ranks[1]["digests"])):
        if a != b:
            bad = [k for k in a if a[k] != b[k]]
            fail(f"10(b): the ranks' {bad} differ after step {i}")
    for r, rep in enumerate(ranks):
        if not all(math.isfinite(v) for pair in rep["losses"] for v in pair):
            fail(f"10(b): rank {r} losses not finite: {rep['losses']}")
        check_train_counts({k: rep[k] for k in ("forward_calls",
                                                "backward_calls",
                                                "plain_calls")},
                           PAR_STEPS, f"10(b) rank {r}")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        fail(f"10(b): the ranks report other losses: {ranks[0]['losses']}, "
             f"{ranks[1]['losses']}")
    report = {"backend": "gloo", "world": 2, "global_batch": PAR_BATCH,
              "note": "two ranks sharing one card: a correctness run, not "
                      "a scaling figure",
              "losses": ranks[0]["losses"],
              "digests_equal_after_steps": len(ranks[0]["digests"]),
              "calls_by_rank": [{k: r[k] for k in ("forward_calls",
                                                   "backward_calls",
                                                   "plain_calls")}
                                for r in ranks]}
    log(json.dumps({"phase10_two_ranks_gloo": report}))
    return report


def parallel_vs_one_process(dev):
    """10(c): the two ranks' depth-5 step (c_rank0.pt) against the
    one-process step on the global batch with chunks=2 minibatch stddev
    (the ranks' shard-local statistic), the same pinned draws: on the card
    (the yardstick) and on the CPU in float64 (the truth), within phase
    5(c)'s bars (check_vs_float64)."""
    from stylegan_torch.train import create_train_state

    cfg = ffhq_cfg()
    reals, z, noises, latents2 = pinned_inputs(cfg, PAR_BATCH, 70)
    results = []
    for device, dtype in ((dev, torch.float32),
                          (torch.device("cpu"), torch.float64)):
        gen_cfg, dis_cfg, gen, dis = train_models(cfg, device, dtype)
        state = create_train_state(gen, dis, dict(cfg.model.g_optim),
                                   dict(cfg.model.d_optim))
        step = train_step_fn(cfg, gen_cfg, dis_cfg, CHECK_DEPTH, cfg.loss,
                             mbstd_chunks=2)
        put = lambda t: t.to(device, dtype)
        _, m = step(state, put(reals), put(z), 0,
                    torch.tensor(0.5, device=device, dtype=dtype),
                    noises=[put(n) for n in noises],
                    mixing=(put(latents2), MIXING_CUTOFF))
        results.append(step_result(m, state))
        del state, step, gen, dis
        torch.cuda.empty_cache()
    got = torch.load(os.path.join(PAR_OUT, "c_rank0.pt"))
    report = dict(check_vs_float64(cfg, got, results[0], results[1],
                                   "two_ranks", "one_process"),
                  depth=CHECK_DEPTH, global_batch=PAR_BATCH)
    log(json.dumps({"phase10_vs_one_process": report}))
    return report


def parallel_cli_start(tmp):
    """10(d), started: `torchrun --standalone --nproc_per_node 1 -m
    stylegan_torch.cli.train` on the FFHQ yaml over PAR_CLI_IMAGES seeded
    1024^2 PNGs, depths 7 and 8, one epoch each.  Returns what
    parallel_cli_finish waits for; the caller ends the process."""
    import yaml
    data_dir, out = os.path.join(tmp, "ffhq"), os.path.join(tmp, "run")
    write_pngs(data_dir, PAR_CLI_IMAGES, 1024, seed=95)
    with open(CONFIG) as f:
        doc = yaml.safe_load(f)
    doc.update(output_dir=out, num_samples=4)
    doc["dataset"]["img_dir"] = data_dir
    doc["sched"]["epochs"] = [1] * 9
    path = os.path.join(tmp, "ffhq.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    log_path = os.path.join(tmp, "cli.log")
    log_file = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "stylegan_torch.cli.train",
         "--config", path, "--start_depth", str(TRAINER_START_DEPTH)],
        cwd=REPO, stdout=log_file, stderr=subprocess.STDOUT, text=True)
    return {"proc": proc, "log": log_file, "log_path": log_path, "out": out}


def parallel_cli_finish(cli):
    """10(d)'s verdict: the CLI joined torchrun's world (NCCL) and exited 0
    within 600 s, finite losses in metrics.jsonl, the five checkpoint files
    of tags 7_1 and 8_1 written once."""
    try:
        rc = cli["proc"].wait(timeout=600)
    except subprocess.TimeoutExpired:
        fail("10(d): the train CLI under torchrun did not finish in 600 s")
    cli["log"].flush()
    if rc != 0:
        with open(cli["log_path"]) as f:
            fail(f"10(d): the train CLI under torchrun exited {rc}:\n"
                 f"{f.read()[-6000:]}")
    out = cli["out"]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(out, "log.txt")) as f:
        text = f.read()
    if not rows or not all(math.isfinite(r["d_loss"]) and
                           math.isfinite(r["g_loss"]) for r in rows):
        fail(f"10(d): losses not finite: {rows}")
    if "up to 1 rank(s)" not in text:
        fail("10(d): the log does not show the rank budget")
    files = sorted(os.listdir(os.path.join(out, "models")))
    want = sorted(f"GAN_{k}_{d}_1.npz" for d in (
        TRAINER_START_DEPTH, TRAINER_START_DEPTH + 1) for k in (
        "GEN", "DIS", "GEN_OPTIM", "DIS_OPTIM", "GEN_SHADOW"))
    if files != want:
        fail(f"10(d): checkpoint files {files}, want {want}")
    report = {"feedback_rows": len(rows),
              "losses": [(r["d_loss"], r["g_loss"]) for r in rows],
              "checkpoints": len(files)}
    log(json.dumps({"phase10_cli": report}))
    return report


def run_all(cmds, label="tools"):
    """Start every command at once from the repo root; fail with the output
    of any that fails."""
    procs = {}
    for name, cmd in cmds.items():
        procs[name] = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    try:
        for name, p in procs.items():
            out, err = p.communicate(timeout=600)
            if p.returncode != 0:
                fail(f"{name} exited {p.returncode}:\n{out[-3000:]}\n"
                     f"{err[-3000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"{label}: {len(cmds)} CLI subprocesses on the card, concurrently: "
        + ", ".join(cmds))


# ------------------------------------------------------------------------
# Phase 11: spatial serving (stylegan_torch/parallel/spatial.py)

SPATIAL_RES = 2 ** (DEPTH + 2)  # 1024
SPATIAL_RANKS = (2, 4)
SPATIAL_BATCHES = (1, BATCH)    # generate_samples' batch, serving's
SPATIAL_REQUESTS = 2
SPATIAL_SEED = 70
SPATIAL_TIMEOUT = 300           # s: each collective's wait, and a world's run
SPATIAL_OUT = os.path.join(REPO, "build", "chip_smoke", "spatial")
JAX_SPATIAL_TOL = dict(rtol=1e-3, atol=1e-3)  # the JAX export CLI's bar


def phase_spatial(dev):
    """Phase 11: each 1024^2 image split by height over ranks, each part
    fatal: (a) the split epilogue entries at every shape, (b) a one-rank
    NCCL mesh bitwise against make_serving_fn, (c) 2 and 4 ranks sharing
    the card over gloo against the one-process forward, with their kernel
    calls and peak memory, (d) the 2-rank artifact against the live fn,
    (e) the two CLIs as subprocesses."""
    shutil.rmtree(SPATIAL_OUT, ignore_errors=True)
    os.makedirs(SPATIAL_OUT)
    report = {"kernels": spatial_kernels(dev)}
    report["one_rank_nccl"] = spatial_one_rank(dev)
    report["ranks"] = spatial_ranks(dev)
    report["cli"] = spatial_cli()
    shutil.rmtree(SPATIAL_OUT)
    return report


def split_epilogue(kern, fused, x, nw, noise, style, n, plain=False):
    """The split epilogue over n slabs of x's rows in one process: each
    slab's K1-partial (kernel or plain version), the rank-order merge, each
    slab's K2-apply; (the slabs' outputs concatenated, the merged (mean,
    rstd * (s0 + 1)))."""
    partial = fused._reference_partial if plain else kern.epilogue_partial
    apply = fused._reference_apply if plain else kern.epilogue_apply
    xs = [t.contiguous() for t in x.chunk(n, dim=1)]
    ns = [t.contiguous() for t in noise.chunk(n, dim=1)]
    parts = torch.stack([partial(a, nw, b) for a, b in zip(xs, ns)])
    stats = fused.split_stats(parts, xs[0].shape[1] * xs[0].shape[2], style)
    return torch.cat([apply(a, nw, b, style, stats)
                      for a, b in zip(xs, ns)], dim=1), stats


def launch_floor_ms():
    """Device time of one launch of an empty kernel (torch.cuda._sleep(0):
    a kernel that returns at once) by graph replay, as graph_time_ms times
    the kernels: no launch of a kernel can take less."""
    return graph_time_ms(lambda i: torch.cuda._sleep(0))


def spatial_kernels(dev):
    """11(a): K1-partial, the merge and K2-apply at the 9 epilogue shapes
    cut into 2 and 4 slabs, batch 1 and 8, float32 and bf16: against the
    split plain version (phase 2's bars), against the unsplit kernel
    (float32 1e-4 * max(1, |ref|); bf16 phase 2's ulp bar), two runs
    bitwise; each entry timed (CUDA graph replay, as phase 2; K1-partial
    also with its slab cold in L2) on one slab of each stage that the
    forward splits (res >= 4n), beside its bytes bound on the R/n rows, the
    launch floor and the plain version, printed stage by stage.  The
    partial's error is that of the merged statistics K2-apply reads.
    Returns the sums over a rank's split calls of one forward (two per
    split stage), by case, each with its stages."""
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    g = torch.Generator(device=dev).manual_seed(11)
    floor = launch_floor_ms()
    sums, vs_unsplit = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        for batch in SPATIAL_BATCHES:
            for n in SPATIAL_RANKS:
                s = sums[f"{name}_b{batch}_n{n}"] = dict.fromkeys(
                    ("partial_ms", "partial_cold_ms", "apply_ms",
                     "plain_partial_ms", "plain_apply_ms", "partial_bound_ms",
                     "apply_bound_ms", "floor_ms", "stats_max_abs_err",
                     "max_abs_err", "calls_per_forward"), 0.0)
                s["stages"] = []
                for res, c in EPILOGUE_SHAPES:
                    args = epilogue_inputs(g, dev, dtype, res, c, batch)
                    x, nw, noise, style = args
                    with torch.no_grad():
                        got, stats = split_epilogue(kern, fused, *args, n)
                        again, _ = split_epilogue(kern, fused, *args, n)
                        ref, ref_stats = split_epilogue(kern, fused, *args,
                                                        n, plain=True)
                        unsplit = fused.fused_epilogue(*args)
                    torch.cuda.synchronize()
                    where = f"split epilogue {batch}x{res}x{res}x{c}/{n} {name}"
                    if got.dtype != dtype or got.shape != x.shape:
                        fail(f"{where}: {got.dtype} {tuple(got.shape)}")
                    if not torch.equal(got, again):
                        fail(f"{where}: two runs differ")
                    err = float((got.float() - ref.float()).abs().max())
                    tol = F32_TOL if dtype == torch.float32 \
                        else bf16_bound(ref)
                    if not err <= tol:
                        fail(f"{where}: {err} from the split plain version "
                             f"(bar {tol})")
                    err_u = float((got.float() - unsplit.float()).abs().max())
                    tol_u = F32_TOL * max(1.0, float(unsplit.abs().max())) \
                        if dtype == torch.float32 else bf16_bound(unsplit)
                    if not err_u <= tol_u:
                        fail(f"{where}: {err_u} from the unsplit kernel "
                             f"(bar {tol_u})")
                    s["max_abs_err"] = max(s["max_abs_err"], err)
                    s["stats_max_abs_err"] = max(
                        s["stats_max_abs_err"],
                        float((stats - ref_stats).abs().max()))
                    vs_unsplit = max(vs_unsplit, err_u)
                    if res >= 4 * n:          # a stage the forward splits
                        t = spatial_times(kern, fused, args, n)
                        t["floor_ms"] = floor
                        for k, v in t.items():
                            s[k] += 2 * v
                        s["stages"].append({"stage": f"{res}x{res}x{c}",
                                            "rows": res * res // n, **t})
                        s["calls_per_forward"] += 2
                    del x, noise, got, again, ref, unsplit, args
        for k, v in sums.items():
            if k.startswith(name):
                log(json.dumps({"phase11_split_epilogue": {k: v}}))
    f32 = [v for k, v in sums.items() if k.startswith("f32")]
    return {"by_case": sums, "main": sums[f"f32_b{BATCH}_n2"],
            "max_abs_err": max(v["max_abs_err"] for v in f32),
            "stats_max_abs_err": max(v["stats_max_abs_err"] for v in f32),
            "max_abs_err_vs_unsplit": vs_unsplit}


def spatial_times(kern, fused, args, n):
    """One call of each entry on slab 0 of this stage (the others are the
    same size): device ms by graph replay (K1-partial also cold in L2),
    the plain versions', and the bytes bounds on the slab's rows."""
    x, nw, noise, style = args
    xs, ns = x.chunk(n, dim=1)[0].contiguous(), \
        noise.chunk(n, dim=1)[0].contiguous()
    with torch.no_grad():
        parts = torch.stack([kern.epilogue_partial(xs, nw, ns)] * n)
        stats = fused.split_stats(parts, xs.shape[1] * xs.shape[2], style)
        times = {
            "partial_ms": graph_time_ms(
                lambda i: kern.epilogue_partial(xs, nw, ns)),
            "partial_cold_ms": cold_time_ms(
                lambda x1: kern.epilogue_partial(x1, nw, ns), xs),
            "apply_ms": graph_time_ms(
                lambda i: kern.epilogue_apply(xs, nw, ns, style, stats)),
            "plain_partial_ms": graph_time_ms(
                lambda i: fused._reference_partial(xs, nw, ns)),
            "plain_apply_ms": graph_time_ms(
                lambda i: fused._reference_apply(xs, nw, ns, style, stats)),
        }
    times["partial_bound_ms"] = kern.bytes_moved_partial(xs) \
        / HBM_BYTES_PER_S * 1e3
    times["apply_bound_ms"] = kern.bytes_moved_apply(xs) \
        / HBM_BYTES_PER_S * 1e3
    return times


def ffhq_generator(dev):
    """FFHQ-1024's generator with phase 3's seeded weights, on `dev`."""
    from stylegan_torch.models import Generator, generator_config_from_cfg
    gen = Generator(generator_config_from_cfg(ffhq_cfg()))
    gen.load_state_dict(random_state_dict(gen), strict=True)
    return gen.requires_grad_(False).eval().to(dev)


def spatial_z(batch, latent, i=0):
    rs = np.random.default_rng(SPATIAL_SEED + 100 * batch + i)
    return torch.from_numpy(rs.standard_normal((batch, latent),
                                               dtype=np.float32))


def spatial_one_rank(dev):
    """11(b): a world of one NCCL rank: build_spatial_sample_fn on
    create_spatial_mesh(1) bitwise equal to make_serving_fn on the same
    (z, seed), batch 8 at 1024^2."""
    from stylegan_torch.parallel import (build_spatial_sample_fn,
                                         create_spatial_mesh,
                                         initialize_distributed)
    from stylegan_torch.serving import make_serving_fn
    rank_dev = initialize_distributed(f"localhost:{free_port()}", 1, 0,
                                      device=dev, timeout=SPATIAL_TIMEOUT)
    try:
        if torch.distributed.get_backend() != "nccl":
            fail(f"11(b): backend {torch.distributed.get_backend()}")
        gen = ffhq_generator(rank_dev)
        z = spatial_z(BATCH, gen.cfg.latent_size)
        mesh = create_spatial_mesh(1)
        got = build_spatial_sample_fn(gen.cfg, gen, mesh,
                                      depth=DEPTH)(z, 5).cpu()
        want = make_serving_fn(gen.cfg, gen, depth=DEPTH,
                               device=rank_dev)(z, 5)
        if not torch.equal(got, want):
            fail(f"11(b): the one-rank mesh differs from make_serving_fn by "
                 f"{float((got - want).abs().max())}")
    finally:
        torch.distributed.destroy_process_group()
    del gen, got, want
    torch.cuda.empty_cache()
    report = {"backend": "nccl", "world": 1, "bitwise": True,
              "shape": [BATCH, SPATIAL_RES, SPATIAL_RES, 3]}
    log(json.dumps({"phase11_one_rank_nccl": report}))
    return report


def spatial_rank(rank, device, n, artifact):
    """A rank of 11(c)/(d), sharing the card over gloo: per batch, a
    warm-up, then SPATIAL_REQUESTS requests with the kernel counts and the
    peak memory; its slab against its rows of the gathered image;
    rank 0 keeps the gathered images.  With `artifact` (n = 2): loaded
    here, its rows against the live fn's and a request served twice; and a
    bf16 request."""
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    from stylegan_torch.parallel import (build_spatial_sample_fn,
                                         create_spatial_mesh, gather_rows)
    from stylegan_torch.serving import load_exported

    ffhq_cfg()                          # float32, TF32 off
    gen = ffhq_generator(device)
    mesh = create_spatial_mesh(n)
    fn = build_spatial_sample_fn(gen.cfg, gen, mesh, depth=DEPTH)
    rows = SPATIAL_RES // n
    report, keep = {"rank": rank}, {}
    for batch in SPATIAL_BATCHES:
        zs = [spatial_z(batch, gen.cfg.latent_size, i)
              for i in range(SPATIAL_REQUESTS + 1)]
        fn(zs[-1], 99)                  # warm-up
        torch.cuda.synchronize()
        reset_counts(kern, fused)
        torch.cuda.reset_peak_memory_stats(device)
        for i in range(SPATIAL_REQUESTS):
            slab = fn(zs[i], i)
        counts = {"partial": counter("partial_launches"),
                  "apply": counter("apply_launches"),
                  "unsplit": counter("launches"),
                  "plain": fused.plain_calls}
        peak = torch.cuda.max_memory_allocated(device)
        full = gather_rows(slab, mesh)
        if not torch.equal(slab, full[:, rank * rows:(rank + 1) * rows]):
            fail(f"11(c) rank {rank}/{n}: its slab differs from its rows of "
                 "the gathered image")
        report[f"b{batch}"] = {"calls": counts, "peak_bytes": peak}
        keep[f"b{batch}"] = full.cpu()
        del full, slab
    if artifact:
        serve = load_exported(artifact, device=device, mesh=mesh)
        z = spatial_z(BATCH, gen.cfg.latent_size)
        got, again, live = serve(z, 3), serve(z, 3), fn(z, 3)
        if not (torch.equal(got, live) and torch.equal(again, got)):
            fail(f"11(d) rank {rank}: the artifact differs from the live "
                 f"spatial fn by {float((got - live).abs().max())}, or "
                 "from itself")
        report["artifact"] = {"bitwise_live": True, "replay_bitwise": True}
        z1 = spatial_z(1, gen.cfg.latent_size)
        keep["bf16"] = gather_rows(fn(z1.to(torch.bfloat16), 0), mesh).cpu()
    with open(os.path.join(SPATIAL_OUT, f"n{n}_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    if rank == 0:
        torch.save(keep, os.path.join(SPATIAL_OUT, f"n{n}_images.pt"))


def spatial_ranks(dev):
    """11(c) and (d): the worlds of 2 and 4 ranks on the card over gloo
    (NCCL refuses two ranks on one device): rank 0's gathered images
    against the one-process forward (<= 1e-2 and JAX's 1e-3/1e-3), each
    rank's calls (K1-partial and K2-apply per split stage, the unsplit
    kernel per whole stage, no plain call), its peak memory beside the
    one-process forward's and spatial_hbm_estimate (a correctness and
    memory run: the ranks share one card); the 2-rank artifact exported
    here, in one process, and checked on the ranks."""
    from stylegan_torch.parallel import spatial_hbm_estimate, spawn
    from stylegan_torch.serving import export_generator, make_serving_fn

    gen = ffhq_generator(dev)
    serve = make_serving_fn(gen.cfg, gen, depth=DEPTH, device=dev)
    want, one_peak = {}, {}
    for batch in SPATIAL_BATCHES:
        zs = [spatial_z(batch, gen.cfg.latent_size, i)
              for i in range(SPATIAL_REQUESTS + 1)]
        serve(zs[-1], 99)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(SPATIAL_REQUESTS):
            out = serve(zs[i], i)
        one_peak[batch] = torch.cuda.max_memory_allocated(dev)
        want[f"b{batch}"] = out.cpu()
    with torch.inference_mode():
        want["bf16"] = gen(spatial_z(1, gen.cfg.latent_size).to(dev).to(
            torch.bfloat16), depth=DEPTH, alpha=1.0, seed=0).images.float() \
            .cpu()
    artifact = os.path.join(SPATIAL_OUT, "spatial2.pt2")
    with open(artifact, "wb") as f:
        f.write(export_generator(gen.cfg, gen, depth=DEPTH, batch_size=BATCH,
                                 spatial_devices=2))
    del gen, serve, out
    torch.cuda.empty_cache()

    report = {"note": "ranks sharing one card over gloo: a correctness and "
                      "memory run, not a scaling figure",
              "one_process_peak_bytes": {f"b{b}": one_peak[b]
                                         for b in SPATIAL_BATCHES}}
    for n in SPATIAL_RANKS:
        spawn(spatial_rank, n, (n, artifact if n == 2 else None),
              backend="gloo", device="cuda:0", timeout=SPATIAL_TIMEOUT,
              join_timeout=SPATIAL_TIMEOUT)
        ranks = []
        for r in range(n):
            with open(os.path.join(SPATIAL_OUT, f"n{n}_rank{r}.json")) as f:
                ranks.append(json.load(f))
        got = torch.load(os.path.join(SPATIAL_OUT, f"n{n}_images.pt"))
        split = sum(1 for res, _ in EPILOGUE_SHAPES if res >= 4 * n)
        want_calls = {"partial": 2 * split, "apply": 2 * split,
                      "unsplit": 2 * (len(EPILOGUE_SHAPES) - split),
                      "plain": 0}
        rep = {"world": n, "by_rank": ranks}
        for batch in SPATIAL_BATCHES:
            key = f"b{batch}"
            a, b = got[key], want[key]
            if tuple(a.shape) != (batch, SPATIAL_RES, SPATIAL_RES, 3) or \
                    not bool(torch.isfinite(a).all()):
                fail(f"11(c) {n} ranks batch {batch}: {tuple(a.shape)}, or "
                     "non-finite values")
            err = float((a - b).abs().max())
            if not err <= CPU_TOL:
                fail(f"11(c) {n} ranks batch {batch}: max |diff| {err} from "
                     f"the one-process forward (bar {CPU_TOL})")
            if not torch.allclose(a, b, **JAX_SPATIAL_TOL):
                fail(f"11(c) {n} ranks batch {batch}: outside rtol=1e-3, "
                     "atol=1e-3 of the one-process forward")
            for r in ranks:
                calls = r[key]["calls"]
                if calls != {k: v * SPATIAL_REQUESTS
                             for k, v in want_calls.items()}:
                    fail(f"11(c) {n} ranks batch {batch} rank {r['rank']}: "
                         f"calls {calls}, want {want_calls} per request")
            est = spatial_hbm_estimate(SPATIAL_RES, 16, n, 4) * batch
            rep[key] = {
                "max_abs_diff": err, "bar": CPU_TOL,
                "jax_tol": JAX_SPATIAL_TOL,
                "peak_bytes_by_rank": [r[key]["peak_bytes"] for r in ranks],
                "one_process_peak_bytes": one_peak[batch],
                "hbm_estimate_1024x16_f32": est,
                "calls_per_request": want_calls}
        if n == 2:
            d = (got["bf16"] - want["bf16"]).abs()
            span = float(want["bf16"].max() - want["bf16"].min())
            drift = {"mean_abs": float(d.mean()), "max_abs": float(d.max()),
                     "span": span}
            if not (drift["mean_abs"] < BF16_DRIFT_MEAN * span
                    and drift["max_abs"] < BF16_DRIFT_MAX * span):
                fail(f"11(c) bf16 over 2 ranks: drift {drift} from the "
                     "one-process bf16 forward")
            rep["bf16_drift"] = drift
            rep["artifact"] = [r["artifact"] for r in ranks]
        log(json.dumps({f"phase11_{n}_ranks_gloo": rep}))
        report[f"n{n}"] = rep
    return report


def spatial_cli():
    """11(e): generate_samples --spatial_devices 2 (1024^2) and
    export_generator --spatial_devices 2 --check (at depth 5: 11(d) holds
    the 1024^2 artifact) as subprocesses, two gloo ranks each on the card,
    beside the one-process generate_samples --eval: the same PNGs within a
    level of 255 (the 1e-3 bar after rounding)."""
    from PIL import Image
    from stylegan_torch.convert import save_generator_file
    gen = ffhq_generator(torch.device("cpu"))
    npz = os.path.join(SPATIAL_OUT, "gen.npz")
    save_generator_file(gen, npz)
    del gen
    base = [sys.executable, "-m"]
    common = ["--config", CONFIG, "--generator_file", npz]
    spatial = ["--spatial_devices", "2", "--device", "cuda:0"]
    dirs = {k: os.path.join(SPATIAL_OUT, k) for k in ("split", "one")}
    run_all({
        "generate_samples_spatial": base + [
            "stylegan_torch.cli.generate_samples"] + common + [
            "--num_samples", "2", "--seed", "3", "--output_dir",
            dirs["split"]] + spatial,
        "generate_samples_eval": base + [
            "stylegan_torch.cli.generate_samples"] + common + [
            "--num_samples", "2", "--seed", "3", "--output_dir",
            dirs["one"], "--eval"],
        "export_generator_spatial_check": base + [
            "stylegan_torch.cli.export_generator"] + common + [
            "--output", os.path.join(SPATIAL_OUT, "cli.pt2"), "--batch", "2",
            "--out_depth", str(CHECK_DEPTH), "--check"] + spatial},
        label="11(e)")
    worst = 0
    for i in (1, 2):
        a, b = (np.asarray(Image.open(os.path.join(dirs[k], f"{i}.png")))
                .astype(int) for k in ("split", "one"))
        if a.shape != (SPATIAL_RES, SPATIAL_RES, 3):
            fail(f"11(e): sample {i}.png has shape {a.shape}")
        worst = max(worst, int(np.abs(a - b).max()))
    if worst > 1:
        fail(f"11(e): the split CLI's PNGs differ from the one-process "
             f"CLI's by {worst} levels")
    report = {"png_max_level_diff": worst}
    log(json.dumps({"phase11_cli": report}))
    return report


# ------------------------------------------------------------------------
# Phase 12: the spatial train step (train/steps.py::build_spatial_train_step)

SP_TRAIN_GRIDS = ((1, 2), (2, 2))   # (data, spatial) grids of 12(b)
SP_TRAIN_WORLD = 4
SP_TRAIN_STEPS = 2                  # depth-8 steps of 12(c)
SP_TRAIN_SPLITS = (2, 4)            # slabs of one plane in 12(a)
SP_TRAIN_BATCHES = (TRAIN_BATCH, 1)  # 12(a): the step's batch; batch 1
SP_TRAIN_OUT = os.path.join(REPO, "build", "chip_smoke", "spatial_train")
SP_CLI_IMAGES = 8                   # seeded 1024^2 PNGs: depth 7 takes 2
                                    # steps at batch 4, depth 8 4 at 2
# kernel calls of one depth-8 step on a (1, 2) grid, per rank: two G
# forwards, 8 split stages (8^2 .. 1024^2) of two epilogues each, the 4^2
# stage whole; one G backward
SP_STEP_CALLS = {"forward": 4, "partial": 32, "apply": 32, "backward": 2,
                 "backward_partial": 16, "backward_apply": 16, "plain": 0}


def phase_spatial_train(dev):
    """Phase 12: the (data x spatial) train step on FFHQ-1024, each part
    fatal: (a) K3's split entries at every split shape, (b) a depth-5 step
    on (1 x 2) and (2 x 2) grids of gloo ranks sharing the card against
    the one-process step and float64, (c) depth-8 steps on the (1 x 2)
    grid with each rank's kernel calls and peak memory, (d) cli.train with
    parallel.spatial: 2 on the card."""
    from stylegan_torch.parallel import spawn
    shutil.rmtree(SP_TRAIN_OUT, ignore_errors=True)
    os.makedirs(SP_TRAIN_OUT)
    report = {"kernels": spatial_train_kernels(dev)}
    spawn(spatial_train_rank, SP_TRAIN_WORLD, (SP_TRAIN_OUT,),
          backend="gloo", device="cuda:0", timeout=PAR_TIMEOUT,
          join_timeout=PAR_TIMEOUT)
    report["depth8"] = spatial_train_depth8()
    # the CLI's ranks run on the card while this process computes 12(b)'s
    # references (one float32 step on the card, one float64 on the CPU)
    with tempfile.TemporaryDirectory(dir=SP_TRAIN_OUT) as tmp:
        cli = spatial_train_cli_start(tmp)
        try:
            report["vs_one_process"] = spatial_train_vs_one_process(dev)
            report["cli"] = spatial_train_cli_finish(cli)
        finally:
            if cli["proc"].poll() is None:
                cli["proc"].kill()
                cli["proc"].wait()
            cli["log"].close()
    shutil.rmtree(SP_TRAIN_OUT)
    return report


def split_backward(kern, fused, args, cot, n, plain=False):
    """K3 split over n slabs of one plane in one process: the slabs'
    K1-partials merged into the (mean, rstd) the split forward saves (by
    the kernel), then each slab's K3-partial (kernel or plain version),
    the rank-order sum, each slab's K3-apply; returns (dx, dnoise_weight,
    dstyle) of the plane (the shares summed) and the merged sums."""
    x, nw, noise, style = args
    xs, ns, gs = ([t.contiguous() for t in a.chunk(n, dim=1)]
                  for a in (x, noise, cot))
    rows = xs[0].shape[1] * xs[0].shape[2]
    mean, rstd = fused.split_moments(torch.stack([
        kern.epilogue_partial(a, nw, b) for a, b in zip(xs, ns)]), rows)
    saved = torch.stack([mean, rstd], -1).contiguous()
    if plain:
        partial = fused._reference_backward_partial
        apply = lambda *a: fused._reference_backward_apply(
            *a, [True, True, False])
    else:
        partial = kern.epilogue_backward_partial
        apply = lambda *a: kern.epilogue_backward_apply(
            *a, (True, True, False))[:2]
    parts = [partial(g, a, nw, b, saved) for g, a, b in zip(gs, xs, ns)]
    merged = parts[0][0]
    for sums, _ in parts[1:]:
        merged = merged + sums
    grads = [apply(g, a, nw, b, style, saved, merged, n * rows)
             for g, a, b in zip(gs, xs, ns)]
    return (torch.cat([d[0] for d in grads], 1), sum(d[1] for d in grads),
            sum(p[1] for p in parts)), merged


def check_split_grads(got, ref, where, bf16_ref=None):
    """Phase 5(a)'s bars between two (dx, dnoise_weight, dstyle): float32
    F32_TOL * max(1, scale) each; bf16 dx within BF16_ULPS of `bf16_ref`'s
    (or 1 ulp of the float32 plain version, `ref`, when none is given) and
    the float32 gradients within F32_TOL.  Returns the worst f32-bar
    ratio."""
    worst = 0.0
    for name, a, r in zip(("x", "noise_weight", "style"), got, ref):
        a, r = a.float(), r.float()
        if got[0].dtype == torch.bfloat16 and name == "x":
            if bf16_ref is None:
                u = ulps_from(a, r)
                if not u <= 1.0:
                    fail(f"{where} d{name}: {u} ulps from the f32 plain "
                         "version")
            else:
                err, bar = float((a - r).abs().max()), bf16_bound(r)
                if not err <= bar:
                    fail(f"{where} d{name}: {err} from the unsplit kernel "
                         f"(bar {bar})")
            continue
        err, bar = float((a - r).abs().max()), F32_TOL * max(
            1.0, float(r.abs().max()))
        worst = max(worst, err / bar)
        if not err <= bar:
            fail(f"{where} d{name}: max |diff| {err} > {bar}")
    return worst


def spatial_train_kernels(dev):
    """12(a): K3-partial, the rank-order sum and K3-apply at the 9 epilogue
    shapes cut into 2 and 4 slabs (the stages the step splits, res >= 4n),
    batch 2 and 1, float32 and bf16: against the split plain version on
    the same merged statistics and against the unsplit K3 (phase 5(a)'s
    bars), two runs bitwise; K3-apply with dnoise too on every slab
    (check_apply_dnoise); each entry timed on slab 0 of each split stage
    (CUDA graph replay; also with g and x cold in L2) beside its bytes
    bound and the launch floor, printed stage by stage with K3-apply's
    plan and the graph nodes of one captured call (the cluster form must
    take no workspace and one node), and the plain versions at batch 2
    over 2 slabs in float32 (null in the other cases).  Returns the sums over a rank's split backward
    calls of one 1024^2 G backward (16 over 2 ranks, 14 over 4), by case;
    "main" and "bf16" are batch 2 over 2 ranks."""
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    g = torch.Generator(device=dev).manual_seed(13)
    floor = launch_floor_ms()
    keys = ("partial_ms", "partial_cold_ms", "apply_ms", "apply_cold_ms",
            "plain_partial_ms", "plain_apply_ms", "partial_bound_ms",
            "apply_bound_ms", "floor_ms")
    sums = {}
    worst = {"max_abs_err": 0.0, "bar_ratio_vs_plain": 0.0,
             "bar_ratio_vs_unsplit": 0.0, "dnoise_bar_ratio": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        for batch in SP_TRAIN_BATCHES:
            for n in SP_TRAIN_SPLITS:
                s = sums[f"{name}_b{batch}_n{n}"] = {
                    k: None if k.startswith("plain") else 0.0 for k in keys}
                s["stages"] = []
                for res, c in EPILOGUE_SHAPES:
                    if res < 4 * n:
                        continue
                    args = epilogue_inputs(g, dev, dtype, res, c, batch)
                    cot = torch.randn(args[0].shape, generator=g,
                                      device=dev).to(dtype)
                    where = f"split backward {batch}x{res}x{res}x{c}/{n} " \
                            f"{name}"
                    with torch.no_grad():
                        got, merged = split_backward(kern, fused, args, cot,
                                                     n)
                        again, _ = split_backward(kern, fused, args, cot, n)
                        f32 = [t.float() if t.dtype == torch.bfloat16 else t
                               for t in args]
                        ref, ref_sums = split_backward(
                            kern, fused, f32, cot.float(), n, plain=True)
                        unsplit = kernel_grads(kern, args, cot, TRAIN_NEEDS)
                    torch.cuda.synchronize()
                    for a, b in zip(got, again):
                        if not torch.equal(a, b):
                            fail(f"{where}: two runs differ")
                    if got[0].dtype != dtype or \
                            got[0].shape != args[0].shape:
                        fail(f"{where}: dx {got[0].dtype} "
                             f"{tuple(got[0].shape)}")
                    worst["bar_ratio_vs_plain"] = max(
                        worst["bar_ratio_vs_plain"],
                        check_split_grads(got, ref, where + " vs plain"))
                    worst["bar_ratio_vs_unsplit"] = max(
                        worst["bar_ratio_vs_unsplit"],
                        check_split_grads(got, (unsplit[0], unsplit[1],
                                                unsplit[3]),
                                          where + " vs unsplit K3",
                                          bf16_ref=unsplit[0]))
                    worst["dnoise_bar_ratio"] = max(
                        worst["dnoise_bar_ratio"],
                        check_apply_dnoise(kern, fused, args, cot, n, where))
                    if dtype == torch.float32:
                        worst["max_abs_err"] = max(
                            worst["max_abs_err"],
                            max(float((a - r).abs().max())
                                for a, r in zip(got, ref)),
                            float((merged - ref_sums).abs().max()))
                    t = split_backward_times(
                        kern, fused, args, cot, n,
                        plain=(name, batch, n) == ("f32", TRAIN_BATCH, 2))
                    t["floor_ms"] = floor
                    for k, v in t.items():
                        s[k] = (s[k] or 0.0) + 2 * v
                    s["stages"].append({"stage": f"{res}x{res}x{c}",
                                        "rows": res * res // n, **t,
                                        "apply_plan": apply_plan(
                                            kern, args, cot, n, where)})
                    del args, cot, got, again, ref, unsplit
        for k, v in sums.items():
            if k.startswith(name):
                log(json.dumps({"phase12_split_backward": {k: v}}))
    log(json.dumps({"phase12_split_backward": worst}))
    return {"by_case": sums, "main": sums[f"f32_b{TRAIN_BATCH}_n2"],
            "bf16": sums[f"bf16_b{TRAIN_BATCH}_n2"], **worst}


def check_apply_dnoise(kern, fused, args, cot, n, where):
    """K3-apply with every output asked for (dx, its share of
    dnoise_weight, its rows of dnoise) on each of the n slabs, from the
    slabs' merged statistics and sums, twice (bitwise equal), against its
    plain version run in float32 on the same tensors: float32 within
    F32_TOL * max(1, max |ref|); bf16 dx and dnoise within 1 bf16 ulp of
    it (the kernel computes in float32 and rounds once), dnoise_weight
    within the float32 bar.  Returns the worst float32-bar ratio."""
    x, nw, noise, style = args
    xs, ns, gs = ([t.contiguous() for t in a.chunk(n, dim=1)]
                  for a in (x, noise, cot))
    rows = xs[0].shape[1] * xs[0].shape[2]
    worst = 0.0
    with torch.no_grad():
        saved = torch.stack(fused.split_moments(torch.stack([
            kern.epilogue_partial(a, nw, b) for a, b in zip(xs, ns)]),
            rows), -1).contiguous()
        parts = [kern.epilogue_backward_partial(g1, x1, nw, n1, saved)[0]
                 for g1, x1, n1 in zip(gs, xs, ns)]
        sums = parts[0]
        for p in parts[1:]:
            sums = sums + p
        for k, (g1, x1, n1) in enumerate(zip(gs, xs, ns)):
            call = lambda: kern.epilogue_backward_apply(
                g1, x1, nw, n1, style, saved, sums, n * rows,
                (True, True, True))
            got, again = call(), call()
            ref = fused._reference_backward_apply(
                g1.float(), x1.float(), nw, n1.float(), style, saved, sums,
                n * rows, [True, True, True])
            torch.cuda.synchronize()
            at = f"{where} slab {k} K3-apply with dnoise"
            for name, a, b, r in zip(("x", "noise_weight", "noise"), got,
                                     again, ref):
                if not torch.equal(a, b):
                    fail(f"{at}: two calls differ in d{name}")
                a = a.float()
                if x.dtype == torch.bfloat16 and name != "noise_weight":
                    u = ulps_from(a, r)
                    if not u <= 1.0:
                        fail(f"{at} d{name}: {u} ulps from the f32 plain "
                             "version")
                    continue
                err, bar = float((a - r).abs().max()), F32_TOL * max(
                    1.0, float(r.abs().max()))
                worst = max(worst, err / bar)
                if not err <= bar:
                    fail(f"{at} d{name}: max |diff| {err} > {bar}")
    return worst


def graph_nodes(fn):
    """Nodes of a CUDA graph that captures one fn() call (each kernel
    launch and memset is one), by the driver's cuGraphGetNodes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        fn()
    count = ctypes.c_size_t()
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    del graph
    if err != 0:
        fail(f"cuGraphGetNodes: CUresult {err}")
    return count.value


def apply_plan(kern, args, cot, n, where):
    """K3-apply's plan for slab 0 of the plane cut into n (a train-step
    call: no dnoise), as its wrapper takes it, and the nodes of a graph
    capturing one call; fails where the cluster form would take a
    workspace or more than its one kernel (a captured call's ticket
    memset is a second node)."""
    x, nw, noise, style = args
    b, h, w, c = x.shape
    plan = kern.make_bwd_apply_plan(
        kern._library(), int(x.dtype == torch.bfloat16), b, h // n * w, c,
        1, 0).as_dict()
    xs, ns, gs = (a.chunk(n, dim=1)[0].contiguous() for a in (x, noise, cot))
    pair = torch.zeros((b, c, 2), device=x.device)
    pair[..., 1] = 1.0
    nodes = graph_nodes(lambda: kern.epilogue_backward_apply(
        gs, xs, nw, ns, style, pair, pair, n * xs.shape[1] * w,
        (True, True, False)))
    if plan["form"] == 1 and (plan["workspace_bytes"] or nodes != 1):
        fail(f"{where}: K3-apply's cluster form takes a workspace "
             f"({plan['workspace_bytes']} bytes) or {nodes} graph nodes")
    return {"graph_nodes": nodes,
            **{k: plan[k] for k in ("form", "tx", "ty", "chunks", "splits",
                                    "cluster", "unroll", "ring",
                                    "workspace_bytes")}}


def split_backward_times(kern, fused, args, cot, n, plain=False):
    """Device ms of each split backward entry on slab 0 (the others are the
    same size), by graph replay (also with g and x cold in L2),
    the plain versions' where `plain`, and the bytes bounds on the slab's
    rows (train-step calls: dx, dnoise_weight, dstyle)."""
    x, nw, noise, style = args
    xs, ns, gs = (a.chunk(n, dim=1)[0].contiguous() for a in (x, noise, cot))
    rows = xs.shape[1] * xs.shape[2]
    with torch.no_grad():
        saved = torch.stack(fused.split_moments(torch.stack(
            [kern.epilogue_partial(xs, nw, ns)] * n), rows), -1).contiguous()
        sums, _ = kern.epilogue_backward_partial(gs, xs, nw, ns, saved)
        sums = (sums * n).contiguous()
        times = {
            "partial_ms": graph_time_ms(lambda i: kern.epilogue_backward_partial(
                gs, xs, nw, ns, saved)),
            "partial_cold_ms": cold_pairs_time_ms(
                lambda x1, g1: kern.epilogue_backward_partial(
                    g1, x1, nw, ns, saved), xs, gs),
            "apply_ms": graph_time_ms(lambda i: kern.epilogue_backward_apply(
                gs, xs, nw, ns, style, saved, sums, n * rows,
                (True, True, False))),
            "apply_cold_ms": cold_pairs_time_ms(
                lambda x1, g1: kern.epilogue_backward_apply(
                    g1, x1, nw, ns, style, saved, sums, n * rows,
                    (True, True, False)), xs, gs),
        }
        if plain:
            times["plain_partial_ms"] = graph_time_ms(
                lambda i: fused._reference_backward_partial(gs, xs, nw, ns,
                                                            saved))
            times["plain_apply_ms"] = graph_time_ms(
                lambda i: fused._reference_backward_apply(
                    gs, xs, nw, ns, style, saved, sums, n * rows,
                    [True, True, False]))
    times["partial_bound_ms"] = kern.bytes_moved_backward_partial(xs) \
        / HBM_BYTES_PER_S * 1e3
    times["apply_bound_ms"] = kern.bytes_moved_backward_apply(xs) \
        / HBM_BYTES_PER_S * 1e3
    return times


def spatial_step_fn(cfg, gen_cfg, dis_cfg, depth, mesh):
    """The yaml's step over a (data, spatial) grid."""
    from stylegan_torch.train import build_spatial_train_step
    kw = {"r1_gamma": cfg.r1_gamma} if cfg.loss == "logistic" else {}
    return build_spatial_train_step(
        gen_cfg, dis_cfg, depth=depth, mesh=mesh, loss=cfg.loss,
        d_repeats=cfg.d_repeats, use_ema=cfg.use_ema,
        ema_decay=cfg.ema_decay, drift=cfg.drift, **kw)


def spatial_train_counts():
    from stylegan_torch.ops import fused
    return {"forward": counter("launches"),
            "partial": counter("partial_launches"),
            "apply": counter("apply_launches"),
            "backward": counter("backward_launches"),
            "backward_partial": counter("backward_partial_launches"),
            "backward_apply": counter("backward_apply_launches"),
            "plain": fused.plain_calls}


def reset_spatial_train_counts():
    from stylegan_torch.ops import fused
    zero("launches", "partial_launches", "apply_launches", "backward_launches",
         "backward_partial_launches", "backward_apply_launches")
    fused.plain_calls = 0


def spatial_train_rank(rank, device, out_dir):
    """A rank of 12(b) and (c), sharing the card over gloo.  (b): on each
    grid of SP_TRAIN_GRIDS it is in, one depth-5 step on its data shard of
    pinned_inputs(cfg, PAR_BATCH, 80) (the noise maps and mixing latents
    its shard's), its state's digests; rank 0's result to b_{grid}.pt.
    (c): on the (1, 2) grid, a first step and SP_TRAIN_STEPS more at depth
    8, batch 2, with the kernel calls counted from 0 just before them and
    read just after, and the peak memory; all into rank{rank}.json."""
    from stylegan_torch.parallel import create_mesh_2d
    from stylegan_torch.train import create_train_state

    cfg = ffhq_cfg()
    grids = {shape: create_mesh_2d(*shape) for shape in SP_TRAIN_GRIDS}
    alpha = torch.tensor(0.5, device=device)
    reals, z, noises, latents2 = pinned_inputs(cfg, PAR_BATCH, 80)
    report = {"rank": rank}
    for shape, mesh in grids.items():
        if not mesh.is_member:
            continue
        tag = f"{shape[0]}x{shape[1]}"
        b = PAR_BATCH // shape[0]
        lo = mesh.data.rank * b

        def cut(t):
            return t[lo:lo + b].to(device)
        gen_cfg, dis_cfg, gen, dis = train_models(cfg, device)
        state = create_train_state(gen, dis, dict(cfg.model.g_optim),
                                   dict(cfg.model.d_optim),
                                   use_ema=cfg.use_ema)
        step = spatial_step_fn(cfg, gen_cfg, dis_cfg, CHECK_DEPTH, mesh)
        _, m = step(state, cut(reals), cut(z), 0, alpha,
                    noises=[cut(n) for n in noises],
                    mixing=(cut(latents2), MIXING_CUTOFF))
        report[tag] = {"digests": state_digests(state),
                       "losses": [m["d_loss"].item(), m["g_loss"].item()]}
        if rank == 0:
            torch.save(step_result(m, state),
                       os.path.join(out_dir, f"b_{tag}.pt"))
        del state, step, gen, dis
        torch.cuda.empty_cache()

    mesh = grids[(1, 2)]
    if mesh.is_member:
        gen_cfg, dis_cfg, gen, dis = train_models(cfg, device)
        state = create_train_state(gen, dis, dict(cfg.model.g_optim),
                                   dict(cfg.model.d_optim),
                                   use_ema=cfg.use_ema)
        step = spatial_step_fn(cfg, gen_cfg, dis_cfg, TRAIN_DEPTH, mesh)
        batches = [tuple(t.to(device) for t in train_batch(
            gen_cfg, TRAIN_BATCH, 90 + i)) for i in range(SP_TRAIN_STEPS + 1)]
        step(state, *batches[0], 0, alpha)
        torch.cuda.reset_peak_memory_stats(device)
        reset_spatial_train_counts()
        losses = []
        for i in range(SP_TRAIN_STEPS):
            _, m = step(state, *batches[1 + i], 1 + i, alpha)
            losses.append([m["d_loss"].item(), m["g_loss"].item()])
        report["depth8"] = {
            "losses": losses,
            "calls": spatial_train_counts(),
            "peak_GiB": torch.cuda.max_memory_allocated(device) / 2 ** 30,
            "digests": state_digests(state)}
        del state, step, gen, dis, batches
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def spatial_train_ranks():
    ranks = []
    for r in range(SP_TRAIN_WORLD):
        with open(os.path.join(SP_TRAIN_OUT, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def spatial_train_vs_one_process(dev):
    """12(b)'s verdict: on each grid every rank's state digests equal
    (replicas bitwise across each row and column) and its losses rank 0's;
    rank 0's step against the one-process step on the global batch with
    the same pinned draws, on the card (the yardstick) and on the CPU in
    float64 (the truth), within phase 5(c)'s bars (check_vs_float64)."""
    from stylegan_torch.train import create_train_state

    ranks = spatial_train_ranks()
    cfg = ffhq_cfg()
    reals, z, noises, latents2 = pinned_inputs(cfg, PAR_BATCH, 80)
    results = []
    for device, dtype in ((dev, torch.float32),
                          (torch.device("cpu"), torch.float64)):
        gen_cfg, dis_cfg, gen, dis = train_models(cfg, device, dtype)
        state = create_train_state(gen, dis, dict(cfg.model.g_optim),
                                   dict(cfg.model.d_optim),
                                   use_ema=cfg.use_ema)
        step = train_step_fn(cfg, gen_cfg, dis_cfg, CHECK_DEPTH, cfg.loss)
        put = lambda t: t.to(device, dtype)
        _, m = step(state, put(reals), put(z), 0,
                    torch.tensor(0.5, device=device, dtype=dtype),
                    noises=[put(n) for n in noises],
                    mixing=(put(latents2), MIXING_CUTOFF))
        results.append(step_result(m, state))
        del state, step, gen, dis
        torch.cuda.empty_cache()
    report = {"depth": CHECK_DEPTH, "global_batch": PAR_BATCH}
    for shape in SP_TRAIN_GRIDS:
        tag = f"{shape[0]}x{shape[1]}"
        members = [r for r in ranks if tag in r]
        if len(members) != shape[0] * shape[1]:
            fail(f"12(b) {tag}: {len(members)} ranks reported")
        for r in members[1:]:
            if r[tag]["digests"] != members[0][tag]["digests"]:
                bad = [k for k in r[tag]["digests"]
                       if r[tag]["digests"][k] != members[0][tag]["digests"][k]]
                fail(f"12(b) {tag}: rank {r['rank']}'s {bad} differ from "
                     "rank 0's")
            if r[tag]["losses"] != members[0][tag]["losses"]:
                fail(f"12(b) {tag}: rank {r['rank']} reports other losses")
        got = torch.load(os.path.join(SP_TRAIN_OUT, f"b_{tag}.pt"))
        report[tag] = dict(check_vs_float64(cfg, got, results[0], results[1],
                                            f"grid_{tag}", "one_process"),
                           replicas_bitwise=len(members))
    log(json.dumps({"phase12_vs_one_process": report}))
    return report


def spatial_train_depth8():
    """12(c)'s verdict: each (1 x 2) rank's kernel calls per step
    (SP_STEP_CALLS), finite losses equal on both ranks, the replicas'
    digests equal; each rank's peak memory (two ranks share the card)."""
    ranks = [r for r in spatial_train_ranks() if "depth8" in r]
    if len(ranks) != 2:
        fail(f"12(c): {len(ranks)} ranks reported")
    want = {k: v * SP_TRAIN_STEPS for k, v in SP_STEP_CALLS.items()}
    for r in ranks:
        d8 = r["depth8"]
        if d8["calls"] != want:
            fail(f"12(c) rank {r['rank']}: kernel calls {d8['calls']}, want "
                 f"{want}")
        if not all(math.isfinite(v) for pair in d8["losses"] for v in pair):
            fail(f"12(c) rank {r['rank']}: losses {d8['losses']}")
    if ranks[0]["depth8"]["digests"] != ranks[1]["depth8"]["digests"] or \
            ranks[0]["depth8"]["losses"] != ranks[1]["depth8"]["losses"]:
        fail("12(c): the two ranks' states or losses differ")
    report = {"grid": [1, 2], "depth": TRAIN_DEPTH, "batch": TRAIN_BATCH,
              "note": "two ranks sharing one card over gloo: a correctness "
                      "and memory run, not a scaling figure",
              "peak_GiB_by_rank": [r["depth8"]["peak_GiB"] for r in ranks],
              "losses": ranks[0]["depth8"]["losses"],
              "calls_per_step": SP_STEP_CALLS,
              "calls_by_rank": [r["depth8"]["calls"] for r in ranks]}
    log(json.dumps({"phase12_depth8": report}))
    return report


def spatial_train_cli_start(tmp):
    """12(d), started: `python -m stylegan_torch.cli.train --num_devices 2
    --device cuda:0` on the FFHQ yaml with parallel.spatial: 2 over
    SP_CLI_IMAGES seeded 1024^2 PNGs, depths 7 and 8, one epoch each: two
    gloo ranks on the card, each depth on a (1 x 2) grid (its batch of 4
    and 2 leaves the second rank idle).  Returns what
    spatial_train_cli_finish waits for; the caller ends the process."""
    import yaml
    data_dir, out = os.path.join(tmp, "ffhq"), os.path.join(tmp, "run")
    write_pngs(data_dir, SP_CLI_IMAGES, 1024, seed=97)
    with open(CONFIG) as f:
        doc = yaml.safe_load(f)
    doc.update(output_dir=out, num_samples=4, feedback_factor=1)
    doc["dataset"]["img_dir"] = data_dir
    doc["sched"]["epochs"] = [1] * 9
    doc.setdefault("parallel", {})["spatial"] = 2
    path = os.path.join(tmp, "ffhq.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    log_path = os.path.join(tmp, "cli.log")
    log_file = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "stylegan_torch.cli.train", "--config", path,
         "--start_depth", str(TRAINER_START_DEPTH), "--num_devices", "2",
         "--device", "cuda:0"], cwd=REPO, stdout=log_file,
        stderr=subprocess.STDOUT, text=True)
    return {"proc": proc, "log": log_file, "log_path": log_path, "out": out}


def spatial_train_cli_finish(cli):
    """12(d)'s verdict: the command exits 0 within 600 s, finite losses in
    metrics.jsonl, the log shows a (1 x 2) grid at both depths, the five
    checkpoint files of tags 7_1 and 8_1 written once."""
    try:
        rc = cli["proc"].wait(timeout=600)
    except subprocess.TimeoutExpired:
        fail("12(d): the train CLI did not finish in 600 s")
    cli["log"].flush()
    if rc != 0:
        with open(cli["log_path"]) as f:
            fail(f"12(d): the train CLI exited {rc}:\n{f.read()[-6000:]}")
    out = cli["out"]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(out, "log.txt")) as f:
        text = f.read()
    if not rows or not all(math.isfinite(r["d_loss"]) and
                           math.isfinite(r["g_loss"]) for r in rows):
        fail(f"12(d): losses not finite: {rows}")
    if text.count("Spatial grid: 1 data x 2 spatial ranks") != 2:
        fail("12(d): the log does not show a (1 x 2) grid at both depths")
    files = sorted(os.listdir(os.path.join(out, "models")))
    want = sorted(f"GAN_{k}_{d}_1.npz" for d in (
        TRAINER_START_DEPTH, TRAINER_START_DEPTH + 1) for k in (
        "GEN", "DIS", "GEN_OPTIM", "DIS_OPTIM", "GEN_SHADOW"))
    if files != want:
        fail(f"12(d): checkpoint files {files}, want {want}")
    report = {"feedback_rows": len(rows),
              "losses": [(r["d_loss"], r["g_loss"]) for r in rows],
              "checkpoints": len(files)}
    log(json.dumps({"phase12_cli": report}))
    return report

# ------------------------------------------------------------------------
# Phase 13: the evidence tools (stylegan_torch/tools/)

# (batch, resolution, channels) of the epilogue planes the tools' schedules
# give the kernels: the 128^2 progressive schedule's depths (batches 128,
# 128, 128, 64, 32, 16) and the 64^2 conditional run's at batch 32
EVIDENCE_PLANES = [(128, 4, 512), (128, 8, 512), (128, 16, 512),
                   (64, 32, 512), (32, 64, 256), (16, 128, 128),
                   (32, 4, 512), (32, 8, 512), (32, 16, 512), (32, 32, 512)]
EVIDENCE_TIMED_BATCH = 128
# 13(b): the progressive tool at 32^2, the reference batches of its first
# four depths, a few dozen steps a depth, the resume proof over 8 steps
EV_PROG = ["--res", "32", "--steps_per_depth", "24,24,24,32",
           "--batches", "128,128,128,64", "--resume_k", "8", "--pool", "512"]
# 13(c): the conditional tool at 32^2, batch 32
EV_COND = ["--res", "32", "--steps", "24", "--eval_every", "12", "--batch",
           "32", "--pool_per_class", "64"]
EV_EVAL_FORWARDS = 8            # an eval's 256 samples, 32 a forward
EV_COND_EVAL_FORWARDS = 4 * 4   # 4 classes x 128 samples, 32 a forward
EV_GATE_IMAGES = 16             # seeded 1024^2 PNGs, 8 in the folder read
EV_GATE_SAMPLES = 8
EV_GATE_BATCH = 4


def phase_evidence(dev):
    """Phase 13: the evidence tools on the card, each part fatal: (a) the
    epilogue kernels at the planes of the tools' schedules, (b) a
    shortened progressive run and its fresh-process resume, (c) a
    shortened conditional run, (d) measure_latency, (e) the fidelity gate
    on a synthetic official pickle."""
    from stylegan_torch.ops.precision import get_precision, set_precision
    precision = get_precision()   # the tools' trainers allow TF32
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p13_")
    report = {}
    try:
        report["kernels"] = evidence_kernels(dev)
        report["progressive"], verify = evidence_progressive(dev, tmp)
        # the replay runs in its process while (c) and (e) run here; (d)
        # times requests, so it waits for the card to itself
        try:
            report["conditional"] = evidence_conditional(dev, tmp)
            report["gate"] = evidence_gate(dev, tmp)
            report["progressive"]["resume"] = evidence_resume_finish(verify)
        finally:
            if verify["proc"].poll() is None:
                verify["proc"].kill()
                verify["proc"].wait()
        report["latency"] = evidence_latency(dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        set_precision(precision)
    return report


def evidence_kernels(dev):
    """13(a): K1+K2 and K3 at EVIDENCE_PLANES in float32 and bfloat16
    against their plain versions with phases 2 and 5(a)'s bars, two calls
    bitwise equal, each plan printed; the batch-128 planes timed (graph
    replay) against the bytes bound, with the plain versions.  Returns the
    batch-128 sums by dtype and the worst errors."""
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    g = torch.Generator(device=dev).manual_seed(13)
    out = {"max_abs_err": 0.0, "backward_max_abs_err": 0.0,
           "backward_worst_bar_ratio": 0.0, "cases": 0}
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        sums = dict.fromkeys(("ms", "plain_ms", "bound_ms", "bwd_ms",
                              "bwd_plain_ms", "bwd_bound_ms"), 0.0)
        for batch, res, c in EVIDENCE_PLANES:
            args = epilogue_inputs(g, dev, dtype, res, c, batch)
            x, nw, noise, style = args
            where = f"{batch}x{res}x{res}x{c} {name}"
            with torch.no_grad():
                got = fused.fused_epilogue(*args)
                again = fused.fused_epilogue(*args)
                ref = fused._reference_epilogue(*args)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    fail(f"epilogue {where}: two calls differ")
                err = float((got.float() - ref.float()).abs().max())
                tol = F32_TOL if dtype == torch.float32 else bf16_bound(ref)
                if not err <= tol:
                    fail(f"epilogue {where}: max |diff| {err} > {tol}")
                if dtype == torch.bfloat16:
                    ulps = ulps_from(got.float(), fused._reference_epilogue(
                        *(t.float() for t in args)))
                    if not ulps <= 1.0:
                        fail(f"epilogue {where}: {ulps} ulps from the f32 "
                             "plain version")
                else:
                    out["max_abs_err"] = max(out["max_abs_err"], err)
            del got, again, ref
            cot = torch.randn(x.shape, generator=g, device=dev).to(dtype)
            grads = kernel_grads(kern, args, cot)
            grads_again = kernel_grads(kern, args, cot)
            torch.cuda.synchronize()
            for gname, a, b in zip(GRAD_NAMES, grads, grads_again):
                if not torch.equal(a, b):
                    fail(f"epilogue backward {where} d{gname}: two calls "
                         "differ")
            worst = check_grads(fused, args, cot, grads, where)
            out["backward_worst_bar_ratio"] = max(
                out["backward_worst_bar_ratio"], worst)
            if dtype == torch.float32:
                out["backward_max_abs_err"] = max(
                    out["backward_max_abs_err"], max(
                        float((a - r).abs().max()) for a, r in zip(
                            grads, plain_grads(fused, args, cot))))
            line = {"evidence_epilogue": where, "max_abs_err": err,
                    "tol": tol, "backward_worst_bar_ratio": worst,
                    "deterministic": True, "plan": kern.plan_for(x),
                    "backward_plan": kern.bwd_plan_for(x)}
            if batch == EVIDENCE_TIMED_BATCH:
                saved = torch.empty((batch, c, 2), device=dev)
                kern.epilogue_forward(x, nw, noise, style, saved)
                times = {
                    "ms": graph_time_ms(
                        lambda i: fused.fused_epilogue(*args)),
                    "plain_ms": graph_time_ms(
                        lambda i: fused._reference_epilogue(*args)),
                    "bound_ms": kern.bytes_moved(x) / HBM_BYTES_PER_S * 1e3,
                    "bwd_ms": graph_time_ms(lambda i: kern.epilogue_backward(
                        cot, x, nw, noise, style, saved, TRAIN_NEEDS)),
                    "bwd_plain_ms": graph_time_ms(
                        lambda i: fused._reference_epilogue_vjp(
                            x, nw, noise, style, cot)),
                    "bwd_bound_ms": kern.bytes_moved_backward(x)
                    / HBM_BYTES_PER_S * 1e3}
                line.update(times)
                for k, v in times.items():
                    sums[k] += v
                del saved
            log(json.dumps(line))
            out["cases"] += 1
            del args, x, cot, grads, grads_again
        out[f"batch{EVIDENCE_TIMED_BATCH}_{name}"] = sums
    log(json.dumps({"evidence_kernels": out}))
    return out


def expected_evidence_calls(kern, dev, per_depth):
    """Kernel calls and the CUDA launches their plans make, forward and
    backward, for `per_depth`: {depth: [(batch, dtype, forward calls per
    stage, backward calls per stage), ...]}; each call runs the stages 0 to
    depth of a 128^2 model (EPILOGUE_SHAPES' channels), two epilogues a
    stage."""
    want = dict.fromkeys(("forward_calls", "forward_cuda", "backward_calls",
                          "backward_cuda"), 0)
    for depth, entries in per_depth.items():
        for batch, dtype, fwd, bwd in entries:
            for res, c in EPILOGUE_SHAPES[:depth + 1]:
                x = torch.empty((batch, res, res, c), dtype=dtype, device=dev)
                want["forward_calls"] += 2 * fwd
                want["forward_cuda"] += 2 * fwd * kern.plan_for(x)["launches"]
                want["backward_calls"] += 2 * bwd
                want["backward_cuda"] += 2 * bwd * kern.bwd_plan_for(x)[
                    "launches"]
                del x
    return want


def evidence_counts():
    from stylegan_torch.ops import fused
    return {"forward_calls": counter("launches"),
            "forward_cuda": counter("cuda_launches"),
            "backward_calls": counter("backward_launches"),
            "backward_cuda": counter("backward_cuda_launches"),
            "plain_calls": fused.plain_calls}


def check_evidence_counts(kern, dev, per_depth, what):
    counts = evidence_counts()
    want = dict(expected_evidence_calls(kern, dev, per_depth), plain_calls=0)
    if counts != want:
        fail(f"{what}: epilogue calls {counts}, want {want} by the plans")
    return counts


def evidence_progressive(dev, tmp):
    """13(b): the progressive tool at 32^2 in process: every eval's SWD
    finite, the calls and CUDA launches of every step and eval as the plans
    make them, no plain call, the boundary checkpoint written; then its
    --verify_resume started in a fresh process (read by
    evidence_resume_finish)."""
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    from stylegan_torch.tools import train_progressive_run as prog
    out = os.path.join(tmp, "progressive")
    args = EV_PROG + ["--out", out, "--device", "cuda"]
    a = prog.parse_arguments(args)
    steps = [int(s) for s in a.steps_per_depth.split(",")]
    batches = [int(b) for b in a.batches.split(",")]
    reset_counts(kern, fused)
    summary = prog.main(args)
    history = summary_history(out)
    if summary["aborted"] or summary["total_steps"] != sum(steps):
        fail(f"progressive run: {summary}")
    if [(h["step"], h["depth"], h["local_step"], h["alpha"])
            for h in history] != prog.eval_schedule(steps, a.fade_pct,
                                                    a.resume_k):
        fail("progressive run: the evals are not the schedule's")
    if not all(math.isfinite(v) for h in history
               for v in h["swd_x1e3"].values()):
        fail(f"progressive run: an SWD is not finite: {history}")
    evals = {d: sum(h["depth"] == d for h in history)
             for d in range(len(steps))}
    counts = check_evidence_counts(kern, dev, {
        d: [(batches[d], torch.bfloat16, steps[d], steps[d]),
            (32, torch.float32, EV_EVAL_FORWARDS * evals[d], 0)]
        for d in range(len(steps))}, "progressive run")
    for name in ("boundary_ckpt.npz", "boundary_rng.npz",
                 "resume_expected.json"):
        if not os.path.exists(os.path.join(out, name)):
            fail(f"progressive run: no {name}")
    with open(os.path.join(out, "resume_expected.json")) as f:
        expected = json.load(f)
    if len(expected["losses"]) != a.resume_k:
        fail(f"progressive run: {len(expected['losses'])} losses recorded")
    rep = {"steps_per_depth": steps, "batches": batches,
           "total_steps": summary["total_steps"], "evals": len(history),
           "calls": counts,
           "swd_x1e3_avg": [h["swd_x1e3"]["avg"] for h in history],
           "final_depth_swd_avg_first": summary["final_depth_swd_avg_first"],
           "final_depth_swd_avg_last": summary["final_depth_swd_avg_last"]}
    log(json.dumps({"evidence_progressive": rep}))
    log_path = os.path.join(tmp, "verify.log")
    logf = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "stylegan_torch.tools.train_progressive_run",
         *EV_PROG, "--out", out, "--device", "cuda", "--verify_resume"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=logf, text=True)
    return rep, {"proc": proc, "log": logf, "log_path": log_path, "out": out}


def summary_history(out):
    with open(os.path.join(out, "summary.json")) as f:
        return json.load(f)["history"]


def evidence_resume_finish(verify):
    """13(b): the fresh process's replay of the 8 steps after the boundary,
    bit-identical, exit 0."""
    try:
        stdout, _ = verify["proc"].communicate(timeout=600)
    finally:
        verify["log"].close()
    with open(verify["log_path"]) as f:
        err = f.read()
    if verify["proc"].returncode != 0:
        fail(f"--verify_resume exited {verify['proc'].returncode}:\n"
             f"{stdout[-3000:]}\n{err[-3000:]}")
    with open(os.path.join(verify["out"], "resume_check.json")) as f:
        check = json.load(f)
    if check["bit_identical"] is not True or check["max_abs_diff"] != 0.0:
        fail(f"--verify_resume: {check}")
    rep = {k: check[k] for k in ("steps_replayed", "max_abs_diff",
                                 "bit_identical", "deterministic")}
    log(json.dumps({"evidence_resume": rep}))
    return rep


def evidence_conditional(dev, tmp):
    """13(c): the conditional tool at 32^2, batch 32, in process: finite
    per-class SWD, the calls and CUDA launches as the plans make them (G's
    forward for D and for G, its backward, each eval's 16 forwards), no
    plain call."""
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    from stylegan_torch.tools import train_conditional_run as cond
    out = os.path.join(tmp, "conditional")
    args = EV_COND + ["--out", out, "--device", "cuda"]
    a = cond.parse_arguments(args)
    depth = int(math.log2(a.res)) - 2
    reset_counts(kern, fused)
    summary = cond.main(args)
    history = summary_history(out)
    if summary["steps_completed"] != a.steps:
        fail(f"conditional run: {summary}")
    swds = [v for h in history for k, v in h.items() if k.startswith("swd")]
    if len(swds) != 6 * len(history) or not all(map(math.isfinite, swds)):
        fail(f"conditional run: per-class SWD {history}")
    counts = check_evidence_counts(kern, dev, {depth: [
        (a.batch, torch.bfloat16, 2 * a.steps, a.steps),
        (32, torch.float32, EV_COND_EVAL_FORWARDS * len(history), 0)]},
        "conditional run")
    rep = {"steps": a.steps, "evals": len(history), "calls": counts,
           "last": history[-1],
           "conditioning_separates": summary["conditioning_separates"]}
    log(json.dumps({"evidence_conditional": rep}))
    return rep


def evidence_latency(dev):
    """13(d): measure_latency's flagship 1024^2 generator at batch 1, 2, 4
    and 8 (bf16 z, eval mode): per-request ms and img/s, 18 kernel calls a
    request, no plain call."""
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    from stylegan_torch.ops.precision import set_precision
    from stylegan_torch.tools import measure_latency as ml
    set_precision("default")
    reset_counts(kern, fused)
    res = ml.measure(ml.flagship_config(1024), dev, log=log)
    requests = len(ml.BATCHES) * (1 + ml.TRIALS * ml.ITERS)
    want = {"launches": requests * PER_FORWARD, "plain_calls": 0}
    got = {"launches": counter("launches"), "plain_calls": fused.plain_calls}
    if got != want:
        fail(f"measure_latency: epilogue calls {got}, want {want}")
    for b, r in res.items():
        if not (r["latency_ms_raw"] > 0 and math.isfinite(
                r["imgs_per_sec_raw"])):
            fail(f"measure_latency batch {b}: {r}")
    rep = {"by_batch": res, "calls": got}
    log(json.dumps({"evidence_latency": rep}))
    return rep


def evidence_gate(dev, tmp):
    """13(e): the fidelity gate on a synthetic official pickle of the
    seeded FFHQ-1024 generator (noise weights included), a seeded-init
    Inception .npz and 8 seeded 1024^2 PNGs, --skip_golden: pass, FID a
    finite float, PPL skipped, the samples' forwards through the kernel."""
    from stylegan_torch.metrics import inception_v3_init
    from stylegan_torch.models import Generator
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    from stylegan_torch.tools import fidelity_gate as gate_tool
    gen = Generator(gate_tool.gate_config(1024, 8))
    pkl = os.path.join(tmp, "official.pkl")
    official_pickle(pkl, random_state_dict(gen), DEPTH)
    del gen
    inception = os.path.join(tmp, "inception.npz")
    np.savez(inception, **inception_v3_init(0))
    images = os.path.join(tmp, "gate_reals")
    write_pngs(images, EV_GATE_IMAGES, 1024, 13)
    out = os.path.join(tmp, "gate")
    reset_counts(kern, fused)
    code = None
    try:    # the gate exits with its verdict
        gate_tool.main(["--pickle", pkl, "--images",
                        os.path.join(images, "00000"), "--inception",
                        inception, "--out", out, "--num_samples",
                        str(EV_GATE_SAMPLES), "--batch", str(EV_GATE_BATCH),
                        "--skip_golden", "--device", "cuda"])
    except SystemExit as e:
        code = e.code
    with open(os.path.join(out, "gate.json")) as f:
        gate = json.load(f)
    fid = gate["stages"]["fid"].get("fid")
    if code != 0 or gate["pass"] is not True or not isinstance(fid, float) \
            or not math.isfinite(fid) or gate["stages"]["ppl"]["ok"] is not None:
        fail(f"fidelity gate exited {code}: {gate}")
    want = {"launches": EV_GATE_SAMPLES // EV_GATE_BATCH * PER_FORWARD,
            "plain_calls": 0}
    got = {"launches": counter("launches"), "plain_calls": fused.plain_calls}
    if got != want:
        fail(f"fidelity gate: epilogue calls {got}, want {want}")
    rep = {"pass": gate["pass"], "fid": fid, "stages": {
        k: v.get("ok") for k, v in gate["stages"].items()}, "calls": got}
    log(json.dumps({"evidence_gate": rep}))
    return rep


# --------------------------------------------------------------------------
# Phase 14: StyleGAN2 config F (serving)
# --------------------------------------------------------------------------

SG2_CONFIG = os.path.join(REPO, "configs", "torch",
                          "sample_ffhq_1024_stylegan2.yaml")
# the forward against plainref/stylegan2.py in float32 with TF32 off: the
# widest pixel gap over the reference images' largest magnitude (the
# benchmark's image_gap) and the op-level bar of the CPU tests
SG2_IMAGE_GAP = 1e-4
SG2_OP_TOL = 1e-5
F32_FLOP_PER_S = 67e12          # H100 SXM published dense float32 rate
# (input side, cin, cout) of the 8 up-convolutions of a config F 1024^2
# forward
SG2_UP_CONVS = [(4, 512, 512), (8, 512, 512), (16, 512, 512),
                (32, 512, 512), (64, 512, 256), (128, 256, 128),
                (256, 128, 64), (512, 64, 32)]


def sg2_generator(dev, seed=3):
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    from stylegan_torch.models import Generator, generator_config_from_cfg
    cfg = get_default_cfg()
    cfg.merge_from_file(SG2_CONFIG)
    cfg.freeze()
    apply_runtime_knobs(cfg)
    gen_cfg = generator_config_from_cfg(cfg)
    gen = Generator(gen_cfg)
    sd = random_state_dict(gen, seed)
    gen.load_state_dict(sd)
    return gen_cfg, gen.requires_grad_(False).eval().to(dev), sd


def sg2_epilogue_kernel(dev, shapes):
    """(a) The epilogue2 kernel against its plain version at the forward's
    17 planes, two calls bitwise equal; the 17 calls timed by CUDA events
    against their bytes bound."""
    from stylegan_torch.ops.kernels import epilogue2 as k2
    from stylegan_torch.ops.modconv import _reference_epilogue2
    g = torch.Generator(device=dev).manual_seed(14)
    worst, calls, bound = 0.0, [], 0
    for h, c in shapes:
        args = (torch.randn((BATCH, c, h, h), generator=g, device=dev),
                torch.randn((BATCH, 1, h, h), generator=g, device=dev),
                torch.randn((c,), generator=g, device=dev),
                torch.randn((), generator=g, device=dev))
        out = k2.epilogue2_forward(*args)
        if not torch.equal(out, k2.epilogue2_forward(*args)):
            fail(f"epilogue2 not bitwise repeatable at {h}x{c}")
        ref = _reference_epilogue2(*args)
        worst = max(worst, float((out - ref).abs().max() / ref.abs().max()))
        calls.append(args)
        bound += k2.bytes_moved(args[0])
    if worst > SG2_OP_TOL:
        fail(f"epilogue2 kernel vs plain: {worst:.3g} > {SG2_OP_TOL}")
    torch.cuda.synchronize()
    ms = cuda_time_ms(lambda: [k2.epilogue2_forward(*a) for a in calls])
    bound_ms = bound / HBM_BYTES_PER_S * 1e3
    return {"max_rel_err": worst, "calls_17_ms": round(ms, 4),
            "bound_ms": round(bound_ms, 4), "share": round(bound_ms / ms, 4)}


def sg2_epilogue_up_kernel(dev, shapes):
    """(a) The up-layers' kernel against its plain version (the FIR, then
    the epilogue) in float64 at the forward's 8 up-layer planes (y of
    (BATCH, C, 2H+1, 2H+1)), two calls bitwise equal; the 8 calls timed by
    CUDA events against their bytes bound, beside the pair they replace
    (the depthwise FIR and the epilogue2 kernel, the main path before the
    fusion: library_ms) and the plain version in float32."""
    from stylegan_torch.ops.kernels import epilogue2 as k2
    from stylegan_torch.ops.modconv import (_fir, _reference_epilogue2_up,
                                            fir_kernel)
    g = torch.Generator(device=dev).manual_seed(20)
    fir = fir_kernel([1, 3, 3, 1], device=dev)
    worst, calls, bound = 0.0, [], 0
    for side, c in shapes:
        args = (torch.randn((BATCH, c, side + 1, side + 1), generator=g,
                            device=dev), fir,
                torch.randn((BATCH, 1, side, side), generator=g, device=dev),
                torch.randn((c,), generator=g, device=dev),
                torch.randn((), generator=g, device=dev))
        out = k2.epilogue2_up_forward(*args)
        if not torch.equal(out, k2.epilogue2_up_forward(*args)):
            fail(f"epilogue2_up not bitwise repeatable at {side}x{c}")
        ref = _reference_epilogue2_up(*(t.double() for t in args))
        worst = max(worst, float((out.double() - ref).abs().max()
                                 / ref.abs().max()))
        del out, ref
        calls.append(args)
        bound += k2.bytes_moved_up(args[0])
    if worst > SG2_OP_TOL:
        fail(f"epilogue2_up kernel vs plain: {worst:.3g} > {SG2_OP_TOL}")
    torch.cuda.synchronize()
    ms = cuda_time_ms(lambda: [k2.epilogue2_up_forward(*a) for a in calls])
    library_ms = cuda_time_ms(lambda: [
        k2.epilogue2_forward(_fir(a[0], a[1]), *a[2:]) for a in calls])
    plain_ms = cuda_time_ms(lambda: [_reference_epilogue2_up(*a)
                                     for a in calls])
    bound_ms = bound / HBM_BYTES_PER_S * 1e3
    return {"max_rel_err_vs_f64": worst, "calls_8_ms": round(ms, 4),
            "bound_ms": round(bound_ms, 4), "share": round(bound_ms / ms, 4),
            "library_ms": round(library_ms, 4),
            "plain_ms": round(plain_ms, 4)}


def sg2_modconv_up_kernel(dev):
    """(a) The up-convolution kernel against its plain version (the grouped
    transposed convolution) in float64 at the forward's 8 up-convolutions
    (x (BATCH, cin, H, H), per-sample kernels at a demodulated layer's
    scale), two calls bitwise equal; the 8 calls timed by CUDA events
    against their operations' bound at the float32 peak, beside the plain
    version in float32, which is cuDNN's grouped conv_transpose2d, the
    main path before the kernel (library_ms)."""
    from stylegan_torch.ops.kernels import modconv_up as mu
    g = torch.Generator(device=dev).manual_seed(22)
    worst, calls, flops = 0.0, [], 0
    for h, cin, cout in SG2_UP_CONVS:
        x = torch.randn((BATCH, cin, h, h), generator=g, device=dev)
        ww = torch.randn((BATCH, cout, cin, 3, 3), generator=g, device=dev) \
            / (3 * math.sqrt(cin))
        out = mu.modconv_up_forward(x, ww)
        if not torch.equal(out, mu.modconv_up_forward(x, ww)):
            fail(f"modconv_up not bitwise repeatable at {h}x{cin}->{cout}")
        ref = mu._reference_modconv_up(x.double(), ww.double())
        worst = max(worst, float((out.double() - ref).abs().max()
                                 / ref.abs().max()))
        del out, ref
        calls.append((x, ww))
        flops += mu.flops(x, ww)
    if worst > SG2_OP_TOL:
        fail(f"modconv_up kernel vs plain: {worst:.3g} > {SG2_OP_TOL}")
    torch.cuda.synchronize()
    ms = cuda_time_ms(lambda: [mu.modconv_up_forward(*a) for a in calls])
    by_layer = [cuda_time_ms(lambda a=a: mu.modconv_up_forward(*a))
                for a in calls]
    library_ms = cuda_time_ms(lambda: [mu._reference_modconv_up(*a)
                                       for a in calls])
    bound_ms = flops / F32_FLOP_PER_S * 1e3
    return {"max_rel_err_vs_f64": worst, "calls_8_ms": round(ms, 4),
            "by_layer_ms": [round(v, 4) for v in by_layer],
            "gflop": round(flops / 1e9, 3), "bound_ms": round(bound_ms, 4),
            "share": round(bound_ms / ms, 4),
            "library_ms": round(library_ms, 4)}


def sg2_profiled_request(serve, z):
    """(c) Fails if a depthwise convolution kernel (the up-layers' FIR is
    inside their epilogue kernel) or cuDNN's backward-data kernel (the
    up-convolution is the port's) ran in a profiled request, or if the
    up-convolution kernel did not run once an up-layer; returns the
    StyleGAN2 kernels' launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve(z, 99)
    kernels = [e for e in prof.key_averages() if e.device_time_total > 0]
    for banned in ("conv_depthwise2d", "dgrad_engine"):
        found = [e.key for e in kernels if banned in e.key]
        if found:
            fail(f"a StyleGAN2 request ran {banned}: {found}")
    counts = {name: sum(e.count for e in kernels if name in e.key)
              for name in ("modconv_up_kernel", "epilogue2_up_kernel",
                           "epilogue2_kernel")}
    if counts["modconv_up_kernel"] != 8:
        fail(f"modconv_up_kernel ran {counts['modconv_up_kernel']} times in "
             f"a request, want 8")
    return counts


def phase_stylegan2(dev):
    """StyleGAN2 config F at 1024^2, batch 8 (configs/torch/
    sample_ffhq_1024_stylegan2.yaml, seeded random weights): (a) the
    epilogue2 kernel against its plain version and its bytes bound, the
    up-layers' kernel against its plain version, its bytes bound and the
    pair it replaces, the up-convolution kernel against its plain version,
    its operations' bound and cuDNN's grouped transposed convolution; (b)
    make_serving_fn's images against plainref/stylegan2.py on the card,
    the epilogue2 counters (17 calls a forward, 8 launches of the
    up-layers' kernel and 17 of the two kernels, counted where each
    launches), 8 up-convolution launches, and a repeated request bitwise
    equal to the first; (c) no depthwise convolution and no cuDNN
    backward-data kernel in a profiled request, the up-convolution kernel 8
    times; (d) a torch.export artifact bitwise equal to make_serving_fn."""
    sys.path.insert(0, REPO)
    from plainref import stylegan2 as plain
    from stylegan_torch.serving import (export_generator, load_exported,
                                        make_serving_fn)
    from stylegan_torch.utils.profiling import counters
    gen_cfg, gen, sd = sg2_generator(dev)
    arch = {"resolution": 1024, "latent_size": 512, "dlatent_size": 512,
            "mapping_layers": 8, "mapping_fmaps": 512,
            "mapping_lrmul": 0.01, "fmap_base": 16384, "fmap_decay": 1.0,
            "fmap_max": 512, "num_channels": 3,
            "resample_filter": [1, 3, 3, 1]}
    shapes = [(plain.noise_res(i), cout) for i, (_, cout, _) in
              enumerate(plain.conv_channels(arch))]
    out = {"kernel": sg2_epilogue_kernel(dev, shapes),
           "kernel_up": sg2_epilogue_up_kernel(dev, shapes[1::2]),
           "modconv_up": sg2_modconv_up_kernel(dev)}
    log(json.dumps({"phase14_kernel": out["kernel"]}))
    log(json.dumps({"phase14_kernel_up": out["kernel_up"]}))
    log(json.dumps({"phase14_modconv_up": out["modconv_up"]}))

    serve = make_serving_fn(gen_cfg, gen, depth=DEPTH, device=dev)
    z = torch.randn((BATCH, 512), generator=torch.Generator().manual_seed(5))
    names = ("epilogue2.launches", "epilogue2.up_launches",
             "epilogue2.cuda_launches", "modconv.up_launches")
    for name in names:
        counters[name] = 0
    images = serve(z, 7)
    calls = tuple(counters[name] for name in names)
    if calls != (17, 8, 17, 8):
        fail(f"epilogue2 calls, up-layer kernel launches, both kernels' "
             f"launches and up-convolution launches a forward: {calls}")
    if not torch.equal(serve(z, 7), images):
        fail("a repeated StyleGAN2 request gave other bits")
    p = {k: v.to(dev) for k, v in sd.items()}
    with torch.no_grad():
        ref = plain.generator(p, arch, z.to(dev), 7)
    got = images.to(dev)
    gap = float((got - ref).abs().max() / ref.abs().max())
    rms = float(torch.linalg.vector_norm(got - ref)
                / torch.linalg.vector_norm(ref))
    if gap > SG2_IMAGE_GAP:
        fail(f"StyleGAN2 forward vs plainref: image_gap {gap:.3g}")
    out["forward"] = {"image_gap": gap, "image_rms_gap": rms,
                      "epilogue2_calls": calls[0],
                      "epilogue2_up_launches": calls[1],
                      "epilogue2_cuda_launches": calls[2],
                      "modconv_up_launches": calls[3],
                      "parameters": sum(v.numel() for v in sd.values())}
    log(json.dumps({"phase14_forward": out["forward"]}))

    out["profiled_kernels"] = sg2_profiled_request(serve, z)
    log(json.dumps({"phase14_profiled_kernels": out["profiled_kernels"]}))

    blob = export_generator(gen_cfg, gen, depth=DEPTH, batch_size=BATCH)
    exported = load_exported(blob, device=dev)(z, 7)
    if not torch.equal(exported.to(dev), got):
        fail("the exported StyleGAN2 program and make_serving_fn gave other "
             "bits")
    out["export"] = {"bytes": len(blob)}
    log(json.dumps({"phase14_export": out["export"]}))
    return out


SG3_CONFIG = os.path.join(REPO, "configs", "torch",
                          "sample_ffhq_1024_stylegan3t.yaml")
# the forward against plainref/stylegan3.py (image_gap) and the kernel
# against its plain version in float64 (the CPU tests' op-level bar)
SG3_IMAGE_GAP = 1e-4
SG3_OP_TOL = 1e-5
# the reference's `arch`: the benchmark configuration's, which a CPU test
# holds equal to the yaml's and to models/synthesis3.py's constants
SG3_ARCH = os.path.join(REPO, "gpubench", "configs",
                        "stylegan3t-ffhq1024-f32.json")


def sg3_generator(dev, seed=3):
    """StyleGAN3-T at 1024^2 with random_state_dict's draws, but its
    buffers as the generator initialises them (the frequencies, phases,
    transform and magnitude EMAs), the style affines' biases about 1 and
    the input's transform affine at (1, 0, 0, 0) plus 0.2 n; and the
    reference's `arch`."""
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    from stylegan_torch.models import Generator, generator_config_from_cfg
    cfg = get_default_cfg()
    cfg.merge_from_file(SG3_CONFIG)
    cfg.freeze()
    apply_runtime_knobs(cfg)
    gen_cfg = generator_config_from_cfg(cfg)
    gen = Generator(gen_cfg, generator=torch.Generator().manual_seed(seed))
    own = gen.state_dict()
    sd = random_state_dict(gen, seed)
    for k in sd:
        if k.endswith(("freqs", "phases", "transform", "magnitude_ema")):
            sd[k] = own[k].clone()
        elif k.endswith("input.affine.weight"):
            sd[k] = sd[k] * 0.2
        elif k.endswith("affine.bias"):
            sd[k] = own[k] + (0 if "input" in k else sd[k])
    gen.load_state_dict(sd)
    with open(SG3_ARCH) as f:
        arch = json.load(f)["architecture"]
    return gen_cfg, gen.requires_grad_(False).eval().to(dev), sd, arch


def sg3_kernel(dev, specs, arch):
    """(a) The filtered leaky ReLU kernel against its plain version in
    float64 (a sample at a time) at the forward's 14 filtered layers (x the
    convolution's (BATCH, cout, s + 2, s + 2) output), two calls bitwise
    equal; the 14 calls timed by CUDA events against their bound (counts3,
    by call the larger of operations at the float32 peak and bytes at the
    HBM rate) and beside the plain chain in float32."""
    from gpubench import counts3
    from stylegan_torch.ops.kernels import filtered_lrelu as fl
    g = torch.Generator(device=dev).manual_seed(23)
    worst, calls = 0.0, []
    for s in specs:
        args = (torch.randn((BATCH, s.out_channels, s.in_size + 2,
                             s.in_size + 2), generator=g, device=dev),
                torch.as_tensor(s.up_filter, dtype=torch.float32, device=dev),
                torch.as_tensor(s.down_filter, dtype=torch.float32,
                                device=dev),
                torch.randn((s.out_channels,), generator=g, device=dev) * 0.2,
                s.up, s.down, s.pad_lo, s.pad_hi, math.sqrt(2), 0.2, 256.0)
        out = fl.filtered_lrelu_forward(*args)
        if not torch.equal(out, fl.filtered_lrelu_forward(*args)):
            fail(f"filtered_lrelu not bitwise repeatable at {s.out_size}x"
                 f"{s.out_channels}")
        gap = scale = 0.0
        for i in range(BATCH):
            ref = fl._reference_filtered_lrelu(
                args[0][i:i + 1].double(), *(a.double() for a in args[1:4]),
                *args[4:])
            gap = max(gap, float((out[i:i + 1].double() - ref).abs().max()))
            scale = max(scale, float(ref.abs().max()))
            del ref
        worst = max(worst, gap / scale)
        del out
        calls.append(args)
    if worst > SG3_OP_TOL:
        fail(f"filtered_lrelu kernel vs plain: {worst:.3g} > {SG3_OP_TOL}")
    bound = counts3.filtered_lrelu_calls(arch, BATCH)
    if [f for f, _ in bound] != [
            fl.flops(a[0], *a[4:8], a[1].numel(), a[2].numel())
            for a in calls]:
        fail("phase 15's filtered calls are not counts3's")
    torch.cuda.synchronize()
    ms = cuda_time_ms(lambda: [fl.filtered_lrelu_forward(*a) for a in calls])
    by_layer = [cuda_time_ms(lambda a=a: fl.filtered_lrelu_forward(*a))
                for a in calls]
    plain_ms = cuda_time_ms(lambda: [fl._reference_filtered_lrelu(*a)
                                     for a in calls], iters=3, warmup=1)
    bound_ms = sum(max(f / F32_FLOP_PER_S, b / HBM_BYTES_PER_S)
                   for f, b in bound) * 1e3
    return {"max_rel_err_vs_f64": worst, "calls_14_ms": round(ms, 4),
            "by_layer_ms": [round(v, 4) for v in by_layer],
            "gflop": round(sum(f for f, _ in bound) / 1e9, 3),
            "gbytes": round(sum(b for _, b in bound) / 1e9, 3),
            "bound_ms": round(bound_ms, 4), "share": round(bound_ms / ms, 4),
            "plain_ms": round(plain_ms, 4)}


def sg3_profiled_request(serve, z):
    """(d) Fails if a depthwise or transposed convolution kernel ran in a
    profiled request (the filters are inside the filtered kernel), or if
    that kernel did not run once a filtered layer; returns its launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve(z, 99)
    kernels = [e for e in prof.key_averages() if e.device_time_total > 0]
    for banned in ("conv_depthwise2d", "dgrad", "conv_transpose"):
        found = [e.key for e in kernels if banned in e.key.lower()]
        if found:
            fail(f"a StyleGAN3 request ran {banned}: {found}")
    n = sum(e.count for e in kernels if "filtered_lrelu_kernel" in e.key)
    if n != 14:
        fail(f"filtered_lrelu_kernel ran {n} times in a request, want 14")
    return {"filtered_lrelu_kernel": n}


def phase_stylegan3(dev):
    """StyleGAN3-T at 1024^2, batch 8 (configs/torch/
    sample_ffhq_1024_stylegan3t.yaml, seeded random weights): (a) the
    filtered leaky ReLU kernel against its plain version, its bound and the
    plain chain; (b) make_serving_fn's images against plainref/stylegan3.py
    on the card, 15 filtered calls and 14 kernel launches a forward; (c) a
    repeated request bitwise equal to the first, an export bitwise equal to
    make_serving_fn; (d) no depthwise or transposed convolution in a
    profiled request, the filtered kernel 14 times."""
    sys.path.insert(0, REPO)
    from plainref import stylegan3 as plain
    from stylegan_torch.models.synthesis3 import schedule
    from stylegan_torch.serving import (export_generator, load_exported,
                                        make_serving_fn)
    from stylegan_torch.utils.profiling import counters
    gen_cfg, gen, sd, arch = sg3_generator(dev)
    specs = [s for s in schedule(gen_cfg.synthesis)[1] if not s.is_torgb]
    out = {"kernel": sg3_kernel(dev, specs, arch)}
    log(json.dumps({"phase15_kernel": out["kernel"]}))

    serve = make_serving_fn(gen_cfg, gen, depth=DEPTH, device=dev)
    z = torch.randn((BATCH, 512), generator=torch.Generator().manual_seed(5))
    names = ("filtered_lrelu.launches", "filtered_lrelu.cuda_launches")
    for name in names:
        counters[name] = 0
    images = serve(z, 7)
    calls = tuple(counters[name] for name in names)
    if calls != (15, 14):
        fail(f"filtered lrelu calls and kernel launches a forward: {calls}")
    if not torch.equal(serve(z, 7), images):
        fail("a repeated StyleGAN3 request gave other bits")
    p = {k: v.to(dev) for k, v in sd.items()}
    with torch.no_grad():
        ref = torch.cat([plain.generator(p, arch, z[i:i + 1].to(dev))
                         for i in range(BATCH)])
    got = images.to(dev)
    gap = float((got - ref).abs().max() / ref.abs().max())
    rms = float(torch.linalg.vector_norm(got - ref)
                / torch.linalg.vector_norm(ref))
    if gap > SG3_IMAGE_GAP:
        fail(f"StyleGAN3 forward vs plainref: image_gap {gap:.3g}")
    out["forward"] = {"image_gap": gap, "image_rms_gap": rms,
                      "filtered_lrelu_calls": calls[0],
                      "filtered_lrelu_cuda_launches": calls[1],
                      "parameters": sum(t.numel() for t in gen.parameters())}
    log(json.dumps({"phase15_forward": out["forward"]}))

    blob = export_generator(gen_cfg, gen, depth=DEPTH, batch_size=BATCH)
    exported = load_exported(blob, device=dev)(z, 7)
    if not torch.equal(exported.to(dev), got):
        fail("the exported StyleGAN3 program and make_serving_fn gave other "
             "bits")
    out["export"] = {"bytes": len(blob)}
    log(json.dumps({"phase15_export": out["export"]}))

    out["profiled_kernels"] = sg3_profiled_request(serve, z)
    log(json.dumps({"phase15_profiled_kernels": out["profiled_kernels"]}))
    return out


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", type=int, nargs="+", default=None,
                        choices=range(2, 16), metavar="PHASE",
                        help="run only these of the phases 2-15 after the "
                        "build (to try a change; prints no result line)")
    only = parser.parse_args(argv).only
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not os.path.isdir(os.path.join(REPO, "stylegan_torch")):
        fail("the stylegan_torch package is not beside this script")
    from stylegan_torch.ops.kernels import epilogue as kern

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    path, report = kern.build()
    log(f"build: {os.path.basename(path)} in {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  nvcc:", line.strip())
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phases = {
        2: lambda: (phase_kernel(dev), *phase_kernel_batches(dev)),
        3: lambda: phase_slice(dev),
        4: phase_cli,
        5: lambda: (phase_grad_kernel(dev), phase_grad_kernel_b1(dev),
                    phase_train(dev), phase_train_vs_cpu(dev)),
        6: lambda: phase_trainer(dev),
        7: lambda: phase_tools(dev),
        8: lambda: phase_export_project(dev),
        9: lambda: phase_bf16(dev),
        10: lambda: phase_parallel(dev),
        11: lambda: phase_spatial(dev),
        12: lambda: phase_spatial_train(dev),
        13: lambda: phase_evidence(dev),
        14: lambda: phase_stylegan2(dev),
        15: lambda: phase_stylegan3(dev)}
    out = {}
    for n in only or phases:
        t0 = time.perf_counter()
        out[n] = phases[n]()
        log(f"phase {n}: {time.perf_counter() - t0:.1f} s")
    if only:
        return 0

    summary, batches, b1 = out[2]
    launches, cuda_launches, profiled_ms = out[3]
    grad, grad_b1, train, _ = out[5]
    calls = out[6]["epilogue_calls"]
    tools, p8, p9 = out[7], out[8], out[9]
    proj, b9 = p8["project"], p9["train"]
    par_a, par_b = out[10]["one_rank_nccl"], out[10]["two_ranks_gloo"]
    p11 = out[11]
    split, n2 = p11["kernels"], p11["ranks"]["n2"]
    split_calls = {f"n{n}": [r[f"b{BATCH}"]["calls"]
                             for r in p11["ranks"][f"n{n}"]["by_rank"]]
                   for n in SPATIAL_RANKS}
    k3s, d8 = out[12]["kernels"], out[12]["depth8"]
    p13 = out[13]
    p14, p15 = out[14], out[15]
    ev = p13["kernels"]
    ev_calls = {k: p13[k]["calls"] for k in ("progressive", "conditional")}
    ev_b128 = {d: ev[f"batch{EVIDENCE_TIMED_BATCH}_{d}"]
               for d in ("f32", "bf16")}

    kernels = [{
        "name": "epilogue", "route": "cuda",
        "source": "stylegan_torch/csrc/epilogue.cu",
        "replaces": "stylegan_tpu/ops/pallas/epilogue.py:73",
        "replaces_also": ["stylegan_tpu/ops/pallas/epilogue.py:101"],
        "launches": launches, "cuda_launches": cuda_launches,
        "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"], "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "call_ms": summary["call_ms"],
        "cold_ms": summary["cold_ms"], "bf16_ms": summary["bf16_ms"],
        "bf16_cold_ms": summary["bf16_cold_ms"],
        "bf16_bound_ms": summary["bf16_bound_ms"],
        "profiled_forward_ms": profiled_ms,
        "train_launches": train["forward_calls"],
        "trainer_launches": calls["forward"],
        "trainer_cuda_launches": calls["forward_cuda"],
        "tools_launches": tools["launches"],
        "export_launches": p8["export"]["epilogue_calls"],
        "project_launches": proj["forward_calls"],
        "bf16_forward_launches": p9["forward"]["epilogue_calls"],
        "bf16_train_launches_per_step": {
            k: b9[k]["epilogue_calls_per_step"] for k in ("r1_step",
                                                          "off_step")},
        "bf16_in_step_ms": {k: b9[k]["epilogue_kernels_in_step_ms"]
                            for k in ("r1_step", "off_step")},
        "parallel_launches": {
            "one_rank_nccl": par_a["forward_calls"],
            "two_ranks_gloo": [c["forward_calls"]
                               for c in par_b["calls_by_rank"]]},
        "tool_batches_max_abs_err": batches,
        "evidence_launches": {
            **{k: v["forward_calls"] for k, v in ev_calls.items()},
            "latency": p13["latency"]["calls"]["launches"],
            "gate": p13["gate"]["calls"]["launches"]},
        "evidence_max_abs_err": ev["max_abs_err"],
        "evidence_batch128_ms": {d: {k: v[k] for k in ("ms", "plain_ms",
                                                        "bound_ms")}
                                 for d, v in ev_b128.items()},
        "shapes": "the 18 float32 calls of one batch-8 1024^2 forward; ms "
                  "and plain_ms device time (CUDA graph replay, x warm in "
                  "L2), cold_ms the same with x and out cold in L2, call_ms "
                  "eager calls with their host launch overhead, bf16_* the "
                  "same 18 calls in bfloat16, profiled_forward_ms the "
                  "kernels' device time inside one profiled forward; "
                  "launches over the 3 served requests, train_launches "
                  "over the 3 train steps, trainer_launches over phase 6's "
                  "StyleGAN.train run (its steps and feedback grids), "
                  "tools_launches over each in-process CLI run of phase 7, "
                  "export_launches over phase 8(b)'s 3 requests through the "
                  "exported program, project_launches over phase 8(c)'s "
                  "projection (101 batch-1 forwards), "
                  "bf16_forward_launches over phase 9(a)'s 2 bf16 "
                  "forwards, bf16_train_launches_per_step the D and G "
                  "updates' calls of one bf16 perf-config step (remat "
                  "recomputes 16 in G's backward), bf16_in_step_ms the "
                  "kernels' device time inside one profiled bf16 step, "
                  "parallel_launches over phase 10's 3 data-parallel "
                  "steps at depth 8 (one rank over NCCL; each of two "
                  "ranks over gloo), "
                  "tool_batches_max_abs_err the float32 error at the 9 "
                  "shapes by batch (projection's 1, the tool CLIs'); "
                  "evidence_launches over phase 13's shortened "
                  "progressive and conditional runs (steps and evals), "
                  "measure_latency's requests and the gate's samples, "
                  "evidence_batch128_ms the sums over the 3 batch-128 "
                  "planes of the progressive schedule (4^2 to 16^2 x 512; "
                  "one call each, graph replay) by dtype",
    }, {
        "name": "epilogue_backward", "route": "cuda",
        "source": "stylegan_torch/csrc/epilogue.cu",
        "replaces": "stylegan_tpu/ops/pallas/epilogue.py:139",
        "launches": train["backward_calls"],
        "cuda_launches": train["backward_cuda_launches"],
        "max_abs_err": grad["max_abs_err"],
        "worst_bar_ratio": grad["worst_bar_ratio"],
        "ms": grad["ms"], "plain_ms": grad["plain_ms"],
        "bound_ms": grad["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "call_ms": grad["call_ms"],
        "cold_ms": grad["cold_ms"], "bf16_ms": grad["bf16_ms"],
        "bf16_cold_ms": grad["bf16_cold_ms"],
        "bf16_call_ms": grad["bf16_call_ms"],
        "bf16_bound_ms": grad["bf16_bound_ms"],
        "trainer_launches": calls["backward"],
        "trainer_cuda_launches": calls["backward_cuda"],
        "project_launches": proj["backward_calls"],
        "bf16_train_launches": {k: b9[k]["epilogue_calls_per_step"][
            "g_update_backward"] for k in ("r1_step", "off_step")},
        "parallel_launches": {
            "one_rank_nccl": par_a["backward_calls"],
            "two_ranks_gloo": [c["backward_calls"]
                               for c in par_b["calls_by_rank"]]},
        "evidence_launches": {k: v["backward_calls"]
                              for k, v in ev_calls.items()},
        "evidence_max_abs_err": ev["backward_max_abs_err"],
        "evidence_batch128_ms": {d: {k[4:]: v[k] for k in (
            "bwd_ms", "bwd_plain_ms", "bwd_bound_ms")}
            for d, v in ev_b128.items()},
        "shapes": "the 18 float32 calls of one batch-2 1024^2 G backward "
                  "(dx, dnoise_weight, dstyle); ms and plain_ms (the plain "
                  "analytic VJP) device time by CUDA graph replay, cold_ms "
                  "with g and x cold in L2, call_ms eager, bf16_* in "
                  "bfloat16; launches (calls) and cuda_launches over the 3 "
                  "train steps, trainer_launches over phase 6's "
                  "StyleGAN.train run, project_launches over phase 8(c)'s "
                  "100 projection steps (dx and dstyle only), "
                  "bf16_train_launches per bf16 perf-config step of "
                  "phase 9(b), whose in-step times are in the forward's "
                  "bf16_in_step_ms; parallel_launches over phase 10's 3 "
                  "data-parallel steps; evidence_launches over "
                  "phase 13's shortened progressive and conditional runs, "
                  "evidence_batch128_ms as the forward's (train-step "
                  "gradients, no dnoise)",
    }, {
        "name": "epilogue_batch1", "route": "cuda",
        "source": "stylegan_torch/csrc/epilogue.cu",
        "replaces": "stylegan_tpu/ops/pallas/epilogue.py:73",
        "replaces_also": ["stylegan_tpu/ops/pallas/epilogue.py:101"],
        "launches": proj["forward_calls"],
        "cuda_launches": proj["forward_cuda_launches"],
        "max_abs_err": b1["max_abs_err"], "ms": b1["ms"],
        "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "shapes": "the forward kernel at projection's batch 1: the 18 "
                  "float32 calls of one 1024^2 forward, device time by "
                  "CUDA graph replay (phase 2); launches over phase 8(c)'s "
                  "100-step projection",
    }, {
        "name": "epilogue_backward_batch1", "route": "cuda",
        "source": "stylegan_torch/csrc/epilogue.cu",
        "replaces": "stylegan_tpu/ops/pallas/epilogue.py:139",
        "launches": proj["backward_calls"],
        "cuda_launches": proj["backward_cuda_launches"],
        "max_abs_err": grad_b1["max_abs_err"],
        "worst_bar_ratio": grad_b1["worst_bar_ratio"], "ms": grad_b1["ms"],
        "plain_ms": grad_b1["plain_ms"], "bound_ms": grad_b1["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "shapes": "the backward kernels at projection's batch 1, dx and "
                  "dstyle only: the 18 float32 calls of one 1024^2 "
                  "backward, device time by CUDA graph replay (phase "
                  "5(a)); launches over phase 8(c)'s 100 steps",
    }] + [{
        "name": f"epilogue_{entry}", "route": "cuda",
        "source": "stylegan_torch/csrc/epilogue.cu",
        "replaces": "stylegan_tpu/ops/pallas/epilogue.py:" + line,
        "launches": n2["by_rank"][0][f"b{BATCH}"]["calls"][entry],
        "launches_by_world": {k: [c[entry] for c in v]
                              for k, v in split_calls.items()},
        "max_abs_err": split["stats_max_abs_err"] if entry == "partial"
        else split["max_abs_err"],
        "max_abs_err_vs_unsplit": split["max_abs_err_vs_unsplit"],
        "ms": split["main"][f"{entry}_ms"],
        "plain_ms": split["main"][f"plain_{entry}_ms"],
        "bound_ms": split["main"][f"{entry}_bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "floor_ms": split["main"]["floor_ms"],
        **({"cold_ms": split["main"]["partial_cold_ms"]}
           if entry == "partial" else {}),
        "bf16_ms": split["by_case"][f"bf16_b{BATCH}_n2"][f"{entry}_ms"],
        "bf16_bound_ms": split["by_case"][f"bf16_b{BATCH}_n2"][
            f"{entry}_bound_ms"],
        "batch1_ms": split["by_case"]["f32_b1_n2"][f"{entry}_ms"],
        "batch1_bound_ms": split["by_case"]["f32_b1_n2"][f"{entry}_bound_ms"],
        "n4_ms": split["by_case"][f"f32_b{BATCH}_n4"][f"{entry}_ms"],
        "shapes": "one rank's 16 split calls of a batch-8 1024^2 forward "
                  "over 2 ranks (the stages 8^2 to 1024^2, R/2 rows each), "
                  "float32, device time by CUDA graph replay (phase 11(a)); "
                  "floor_ms 16 launches of an empty kernel, cold_ms with x "
                  "cold in L2; bf16_ms, batch1_ms and n4_ms (14 calls over 4 "
                  "ranks) the same sums; max_abs_err "
                  + ("of the merged (mean, rstd*(s0+1)) that K2-apply reads"
                     if entry == "partial" else "of the split output")
                  + " against the split plain version; launches rank 0's "
                  f"over phase 11(c)'s {SPATIAL_REQUESTS} batch-8 requests "
                  "on 2 ranks (launches_by_world: each rank's, 2 and 4 "
                  "ranks)",
    } for entry, line in (("partial", "73"), ("apply", "101"))] + [{
        "name": f"epilogue_backward_{entry}", "route": "cuda",
        "source": "stylegan_torch/csrc/epilogue.cu",
        "replaces": "stylegan_tpu/ops/pallas/epilogue.py:139",
        "launches": d8["calls_by_rank"][0][f"backward_{entry}"],
        "launches_by_rank": [c[f"backward_{entry}"]
                             for c in d8["calls_by_rank"]],
        "max_abs_err": k3s["max_abs_err"],
        "bar_ratio_vs_unsplit": k3s["bar_ratio_vs_unsplit"],
        "dnoise_bar_ratio": k3s["dnoise_bar_ratio"],
        "ms": k3s["main"][f"{entry}_ms"],
        "plain_ms": k3s["main"][f"plain_{entry}_ms"],
        "bound_ms": k3s["main"][f"{entry}_bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "floor_ms": k3s["main"]["floor_ms"],
        "cold_ms": k3s["main"][f"{entry}_cold_ms"],
        "bf16_ms": k3s["bf16"][f"{entry}_ms"],
        "bf16_bound_ms": k3s["bf16"][f"{entry}_bound_ms"],
        "batch1_ms": k3s["by_case"]["f32_b1_n2"][f"{entry}_ms"],
        "batch1_bound_ms": k3s["by_case"]["f32_b1_n2"][f"{entry}_bound_ms"],
        "n4_ms": k3s["by_case"][f"f32_b{TRAIN_BATCH}_n4"][f"{entry}_ms"],
        "shapes": "one rank's 16 split backward calls of a batch-2 1024^2 "
                  "G backward over 2 ranks (the stages 8^2 to 1024^2, R/2 "
                  "rows each; dx, dnoise_weight, dstyle), float32, device "
                  "time by CUDA graph replay (phase 12(a)); floor_ms 16 "
                  "launches of an empty kernel, cold_ms with g and x cold in "
                  "L2; bf16_ms the same in bfloat16, batch1_ms at batch 1, "
                  "n4_ms the 14 calls over 4 ranks; max_abs_err the float32 "
                  "split gradients' (and merged sums') against the split "
                  "plain version (K3-apply's dnoise too, dnoise_bar_ratio); "
                  "launches rank 0's over phase 12(c)'s "
                  f"{SP_TRAIN_STEPS} depth-8 steps on a (1 x 2) grid "
                  "(launches_by_rank: each rank's)",
    } for entry in ("partial", "apply")] + [{
        "name": "modconv_up", "route": "cuda",
        "source": "stylegan_torch/csrc/modconv_up.cu",
        "replaces": None,
        "launches": p14["forward"]["modconv_up_launches"],
        "profiled_launches": p14["profiled_kernels"]["modconv_up_kernel"],
        "max_rel_err_vs_f64": p14["modconv_up"]["max_rel_err_vs_f64"],
        "ms": p14["modconv_up"]["calls_8_ms"],
        "by_layer_ms": p14["modconv_up"]["by_layer_ms"],
        "bound_ms": p14["modconv_up"]["bound_ms"], "bound_by": "operations",
        "plain_ms": p14["modconv_up"]["library_ms"],
        "library_ms": p14["modconv_up"]["library_ms"],
        "shapes": "StyleGAN2-F's 8 up-convolutions of one batch-8 1024^2 "
                  "forward (4^2..512^2 in), float32 on the CUDA cores; ms "
                  "eager device time by CUDA events, bound_ms their "
                  "360.6 GFLOP at 67 TFLOP/s; plain_ms and library_ms the "
                  "plain version, cuDNN's grouped conv_transpose2d, which "
                  "the port ran before; launches over phase 14(b)'s "
                  "forward, profiled_launches in 14(c)'s request",
    }, {
        "name": "filtered_lrelu", "route": "cuda",
        "source": "stylegan_torch/csrc/filtered_lrelu.cu",
        "replaces": None,
        "launches": p15["forward"]["filtered_lrelu_cuda_launches"],
        "profiled_launches": p15["profiled_kernels"]["filtered_lrelu_kernel"],
        "max_rel_err_vs_f64": p15["kernel"]["max_rel_err_vs_f64"],
        "ms": p15["kernel"]["calls_14_ms"],
        "by_layer_ms": p15["kernel"]["by_layer_ms"],
        "bound_ms": p15["kernel"]["bound_ms"],
        "bound_by": "operations or bytes, by call",
        "plain_ms": p15["kernel"]["plain_ms"], "library_ms": None,
        "shapes": "StyleGAN3-T's 14 filtered leaky ReLUs of one batch-8 "
                  "1024^2 forward (36^2..1044^2 out), float32; ms eager "
                  "device time by CUDA events, bound_ms the larger of each "
                  "call's filter taps at 67 TFLOP/s and its bytes at "
                  "3.35 TB/s, summed; plain_ms the upfirdn2d chain in "
                  "PyTorch; launches over phase 15(b)'s forward, "
                  "profiled_launches in 15(d)'s request",
    }]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
