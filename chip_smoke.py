#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stylegan_torch) on one NVIDIA card.

    python3 chip_smoke.py

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
           plain version;
3. slice   build the FFHQ-1024 generator of configs/sample_ffhq_1024.yaml with
           seeded random weights (noise weights included), serve 3 requests of
           batch 8 at 1024^2 through make_serving_fn, check shapes, finiteness
           and 18 kernel calls per forward, and hold the first 2 images of a
           request to the same generator on the CPU (plain path, TF32 off) at
           max |diff| <= 1e-2; profile one more forward (torch.profiler) and
           write its device-time table by kernel to build/chip_smoke/; each
           epilogue kernel must show in it as many launches as the wrapper
           made (26 per forward), each with device time;
4. cli     save the weights as a JAX-package .npz and run
           `python -m stylegan_torch.cli.generate_samples` on them;
5. train   (a) the epilogue's backward kernels against autograd of the plain
           version at the 9 epilogue shapes, batch 2 and 8, float32 and
           bfloat16, two calls bitwise equal, with the plan taken (path,
           cluster, CUDA launches per call), timed at batch 2 in both dtypes
           (graph replay, cold L2, eager; the plain VJP in float32) against
           the bytes bound; (b) FFHQ-1024 training at
           depth 8, batch 2 (sched.batch_sizes[8]), loss logistic with R1,
           alpha 0.5, seeded random weights and seeded numpy reals: a warm-up
           step, 3 timed steps (ms per step, img/s, peak memory, finite
           losses), 36 forward and 18 backward epilogue kernel calls per step
           with the CUDA launches the plans make, no call of the plain
           version, the backward calls whose incoming gradient had to be
           copied to NHWC, a profiled step (device time by op into
           build/chip_smoke/, each epilogue kernel as often as the plans
           launch it), then one relativistic-hinge step; (c) one depth-5
           step of the same model on the card and on the CPU with the draws
           pinned (and on the CPU in float64 as the ground truth): losses,
           gradients and weights within the stated bars.

The last two lines are {"kernels": [...]} with the kernels' measurements and
{"ok": true, "device": {...}}; the card's name and power limit precede them.
Exits non-zero without a result when CUDA is missing or the port is absent.
"""

import json
import math
import os
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
PROFILE_TABLE = os.path.join(REPO, "build", "chip_smoke", "profile.txt")
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
               "bf16_bound_ms": 0.0, "max_abs_err": 0.0,
               # launches of each kernel in one float32 forward, by the plans
               "per_forward": dict.fromkeys(kern.KERNEL_NAMES, 0)}
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
                for name in kern.KERNELS_BY_PATH[plan["path"]]:
                    summary["per_forward"][name] += 2
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
        sd[name] = torch.from_numpy(
            rs.standard_normal(tuple(t.shape), dtype=np.float32) * scale)
    return sd


def phase_slice(dev, per_forward):
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
          for _ in range(REQUESTS + 1)]
    serve(zs[-1], 1000)               # warm-up request, not counted
    torch.cuda.synchronize()

    kern.launches = kern.cuda_launches = 0
    t0 = time.perf_counter()
    outs = []
    for i in range(REQUESTS):
        outs.append(serve(zs[i], i))
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches, cuda_launches = kern.launches, kern.cuda_launches
    for out in outs:
        if tuple(out.shape) != (BATCH, 1024, 1024, 3):
            fail(f"served shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            fail("served images hold non-finite values")
    if launches != 18 * REQUESTS:
        fail(f"epilogue kernel calls {launches}, want {18 * REQUESTS}")
    log(f"served {REQUESTS} requests of batch {BATCH} at 1024^2: "
        f"{elapsed / REQUESTS * 1e3:.2f} ms per forward, "
        f"{REQUESTS * BATCH / elapsed:.2f} img/s, {launches} epilogue calls "
        f"({cuda_launches} CUDA launches), "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the same generator on the CPU, plain path, with the request's noise
    noises = [make_noise(0, i, BATCH, layer_resolution(i), dev)[:2].cpu()
              for i in range(gen_cfg.num_layers)]
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = cpu_gen(torch.from_numpy(zs[0][:2]), depth=DEPTH, alpha=1.0,
                       noises=noises).images
    err = float((outs[0][:2].cpu() - want).abs().max())
    log(f"card vs CPU, 2 images at 1024^2: max |diff| {err:.3e} "
        f"(bar {CPU_TOL}; CPU forward {time.perf_counter() - t0:.1f} s)")
    if not err <= CPU_TOL:
        fail(f"card vs CPU max |diff| {err} > {CPU_TOL}")

    epilogue_ms = profile_forward(serve, zs[0], PROFILE_TABLE, kern,
                                  per_forward)
    return (cpu_gen, launches, cuda_launches, REQUESTS * BATCH / elapsed,
            epilogue_ms)


def profile_forward(serve, z, path, kern, per_forward):
    """Device time of one forward by kernel.  The epilogue's time is read
    by the wrapper's kernel names; it is fresh only if the profiler shows
    each kernel as many times as the plans launch it per forward
    (`per_forward`), all of them the wrapper's CUDA launches, and each with
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    kern.cuda_launches = 0
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        serve(z, 0)
        torch.cuda.synchronize()
    wrapper_launches = kern.cuda_launches
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    by_name = {name: [e for e in kernels if name in e.key]
               for name in kern.KERNEL_NAMES}
    ms = {name: sum(e.self_device_time_total for e in es) / 1e3
          for name, es in by_name.items()}
    count = {name: sum(e.count for e in es) for name, es in by_name.items()}
    epilogue = sum(ms.values())
    log(json.dumps({"profiled_forward_device_ms": busy,
                    "epilogue_kernels_device_ms": epilogue,
                    "epilogue_by_kernel_ms": ms,
                    "epilogue_launches_by_kernel": count,
                    "wrapper_cuda_launches": wrapper_launches}))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    log(f"profile table: {os.path.relpath(path, REPO)}")
    log(table[:6000])
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
TRAIN_PROFILE_TABLE = os.path.join(REPO, "build", "chip_smoke",
                                   "train_profile.txt")
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


def train_models(cfg, dev, dtype=torch.float32):
    """FFHQ-1024 G and D (configs/sample_ffhq_1024.yaml over the defaults)
    with seeded random weights, on `dev`."""
    from stylegan_torch.models import (Discriminator, Generator,
                                       discriminator_config_from_cfg,
                                       generator_config_from_cfg)
    gen_cfg = generator_config_from_cfg(cfg)
    dis_cfg = discriminator_config_from_cfg(cfg)
    gen, dis = Generator(gen_cfg), Discriminator(dis_cfg)
    gen.load_state_dict(random_state_dict(gen, seed=10), strict=True)
    dis.load_state_dict(random_state_dict(dis, seed=11), strict=True)
    return gen_cfg, dis_cfg, gen.to(dev, dtype), dis.to(dev, dtype)


def train_step_fn(cfg, gen_cfg, dis_cfg, depth, loss):
    from stylegan_torch.train import build_train_step
    kw = {"r1_gamma": cfg.r1_gamma} if loss in ("logistic",) else {}
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
    measurements for the report."""
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
               for i in range(TRAIN_STEPS + 3)]
    t0 = time.perf_counter()
    _, m = step(state, *batches[0], 0, alpha)         # warm-up, not counted
    torch.cuda.synchronize()
    log(f"train: warm-up step {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    kern.launches = kern.cuda_launches = kern.backward_launches = 0
    kern.backward_cuda_launches = kern.backward_g_copies = 0
    fused.plain_calls = 0
    losses = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        _, m = step(state, *batches[1 + i], 1 + i, alpha)
        torch.cuda.synchronize()
        losses.append((m["d_loss"].item(), m["g_loss"].item()))
    elapsed = time.perf_counter() - t0
    fwd, bwd, plain = kern.launches, kern.backward_launches, fused.plain_calls
    bwd_cuda, g_copies = kern.backward_cuda_launches, kern.backward_g_copies
    peak = torch.cuda.max_memory_allocated()
    ms_step = elapsed / TRAIN_STEPS * 1e3
    log(json.dumps({"train_ms_per_step": ms_step,
                    "train_img_per_s": TRAIN_STEPS * batch / elapsed,
                    "peak_memory_GiB": peak / 2 ** 30, "losses": losses,
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

    busy, wall, top = profile_train_step(step, state, batches[-2], alpha,
                                         kern, want)

    # one relativistic-hinge step on the same state
    rh = train_step_fn(cfg, gen_cfg, dis_cfg, TRAIN_DEPTH,
                       "relativistic-hinge")
    kern.launches = kern.backward_launches = fused.plain_calls = 0
    _, m = rh(state, *batches[-1], 99, alpha)
    torch.cuda.synchronize()
    rh_losses = (m["d_loss"].item(), m["g_loss"].item())
    log(json.dumps({"relativistic_hinge_losses": rh_losses,
                    "epilogue_forward_calls": kern.launches,
                    "epilogue_backward_calls": kern.backward_launches,
                    "plain_calls": fused.plain_calls}))
    if not all(math.isfinite(v) for v in rh_losses):
        fail(f"relativistic-hinge losses not finite: {rh_losses}")
    if (kern.launches, kern.backward_launches, fused.plain_calls) != \
            (36, 18, 0):
        fail("relativistic-hinge step: wrong epilogue calls")
    del state, step, rh, gen, dis, batches
    torch.cuda.empty_cache()
    return {"ms_per_step": ms_step, "img_per_s": TRAIN_STEPS * batch / elapsed,
            "peak_memory_GiB": peak / 2 ** 30, "losses": losses,
            "forward_calls": fwd, "backward_calls": bwd,
            "backward_cuda_launches": bwd_cuda,
            "backward_g_copies": g_copies, "device_busy_ms": busy,
            "profiled_step_wall_ms": wall,
            "device_busy_share": busy / wall,
            "top_ops": top}


def profile_train_step(step, state, batch, alpha, kern, want):
    """Device time of one train step by op (table in build/chip_smoke/)
    and that step's own wall time, whose ratio is the device's busy share;
    each epilogue kernel must show as often as the plans launch it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, *batch, 7, alpha)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    # by "::name<": PyTorch's multi_tensor_apply_kernel (the optimizers'
    # foreach ops) also contains "apply_kernel"
    count = {name: sum(e.count for e in kernels if f"::{name}<" in e.key)
             for name in want}
    ms = {name: sum(e.self_device_time_total for e in kernels
                    if f"::{name}<" in e.key) / 1e3 for name in want}
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.device_time_total)
    top = [(e.key, e.device_time_total / 1e3, e.count) for e in ops[:12]]
    table = events.table(sort_by="cuda_time_total", row_limit=50)
    os.makedirs(os.path.dirname(TRAIN_PROFILE_TABLE), exist_ok=True)
    with open(TRAIN_PROFILE_TABLE, "w") as f:
        f.write(table)
    log(json.dumps({"profiled_train_step_device_ms": busy,
                    "profiled_train_step_wall_ms": wall,
                    "epilogue_by_kernel_ms": ms,
                    "epilogue_launches_by_kernel": count,
                    "top_aten_ops_device_ms": top}))
    log(f"train profile table: {os.path.relpath(TRAIN_PROFILE_TABLE, REPO)}")
    if count != want:
        fail(f"the profiled train step shows epilogue launches {count}; "
             f"the plans make {want}")
    if not all(ms[name] > 0 for name in want if want[name]):
        fail(f"the profiled train step shows no device time in {ms}")
    return busy, wall, top


def phase_train_vs_cpu(dev):
    """One depth-5 step of the FFHQ-1024 model on the card and on the CPU in
    float32, and on the CPU in float64, with the draws pinned and TF32 off:
    losses, Adam's first moments and every weight of G, D and the shadow
    within the bars above."""
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    from stylegan_torch.models import generator_config_from_cfg
    from stylegan_torch.models.synthesis import layer_resolution
    from stylegan_torch.train import create_train_state

    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.freeze()
    apply_runtime_knobs(cfg)
    batch = cfg.sched.batch_sizes[TRAIN_DEPTH]
    rs = np.random.default_rng(30)
    reals, z = train_batch(generator_config_from_cfg(cfg), batch, 31)
    noises = [torch.from_numpy(rs.standard_normal(
        (batch, layer_resolution(i), layer_resolution(i), 1),
        dtype=np.float32)) for i in range(2 * (CHECK_DEPTH + 1))]
    latents2 = torch.from_numpy(rs.standard_normal(tuple(z.shape),
                                                   dtype=np.float32))
    mixing_cutoff = 5            # mix the layers >= 5 of the 12 in use
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
        t0 = time.perf_counter()
        _, m = step(state, put(reals), put(z), 0,
                    torch.tensor(0.5, device=device, dtype=dtype),
                    noises=[put(n) for n in noises],
                    mixing=(put(latents2), mixing_cutoff))
        losses = (m["d_loss"].item(), m["g_loss"].item())
        log(f"train check on {device.type} {dtype}: losses {losses}, "
            f"{time.perf_counter() - t0:.1f} s")
        results.append((losses, {
            k: {n: t.detach().cpu().double() for n, t in getattr(state, k)
                .state_dict().items()}
            for k in ("generator", "discriminator", "g_shadow")},
            moments(state)))
        del state, step, gen, dis
        torch.cuda.empty_cache()
    (lc, wc, mc), (lh, _, mh), (_, w64, m64) = results
    worst = {}
    for a, b, name in zip(lc, lh, ("d_loss", "g_loss")):
        rel = abs(a - b) / max(1.0, abs(b))
        worst[name] = rel
        if not rel <= CHECK_LOSS_RTOL:
            fail(f"card vs CPU {name}: {a} vs {b}")
    grad = {"bar_ratio": 0.0, "card_rel": 0.0, "cpu_rel": 0.0}
    noise = {}      # per tensor: the float32 gradient's error bar
    for name, truth in m64.items():
        scale = float(truth.abs().max())
        err_card = float((mc[name] - truth).abs().max())
        err_cpu = float((mh[name] - truth).abs().max())
        bar = noise[name] = CHECK_GRAD_FACTOR * err_cpu + 1e-5 * scale
        if bar > 0:     # else no gradient flows there: both exactly 0
            grad["bar_ratio"] = max(grad["bar_ratio"], err_card / bar)
        if scale > 0:
            grad["card_rel"] = max(grad["card_rel"], err_card / scale)
            grad["cpu_rel"] = max(grad["cpu_rel"], err_cpu / scale)
        if not err_card <= bar:
            fail(f"card gradient (Adam first moment) {name}: {err_card} "
                 f"from float64, the CPU's float32 {err_cpu}")
    lr = cfg.model.g_optim.learning_rate
    weights = {"max_abs_diff": 0.0, "beyond_1e-4": 0, "elements": 0}
    for k, label in (("generator", "G"), ("discriminator", "D")):
        for name, truth in w64[k].items():
            d = (wc[k][name] - truth).abs()
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
                fail(f"card vs float64 {k} {name}: max |diff| "
                     f"{float(d.max())}, {int((beyond & sure).sum())} "
                     "elements beyond 1e-4 whose gradient is not 0 up to "
                     "float32 rounding")
    shadow = max(float((wc["g_shadow"][n] - t).abs().max())
                 for n, t in w64["g_shadow"].items())
    if not shadow <= 2 * lr * (1 - cfg.ema_decay) + 1e-5:
        fail(f"card vs float64 shadow: max |diff| {shadow}")
    report = {"loss_rel_diff": worst, "grads_vs_float64": grad,
              "weights_vs_float64": weights, "shadow_max_abs_diff": shadow,
              "depth": CHECK_DEPTH}
    log(json.dumps({"train_card_vs_cpu": report}))
    return report


def moments(state):
    """Adam's first moments of G and D by parameter name (b1 = 0: the last
    step's gradients, clipped for G)."""
    out = {}
    for label, module, opt in (("G", state.generator, state.g_optimizer),
                               ("D", state.discriminator, state.d_optimizer)):
        for name, p in module.named_parameters():
            out[f"{label} {name}"] = opt.state[p]["exp_avg"].detach().cpu()
    return out


def phase_cli(cpu_gen):
    from PIL import Image
    from stylegan_torch.convert import save_generator_file
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "gen.npz")
        save_generator_file(cpu_gen, npz)
        out_dir = os.path.join(tmp, "samples")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "stylegan_torch.cli.generate_samples",
             "--config", CONFIG, "--generator_file", npz, "--num_samples",
             "2", "--output_dir", out_dir, "--seed", "0"],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            fail(f"generate_samples exited {r.returncode}:\n{r.stdout}\n"
                 f"{r.stderr}")
        for i in (1, 2):
            img = np.asarray(Image.open(os.path.join(out_dir, f"{i}.png")))
            if img.shape != (1024, 1024, 3):
                fail(f"sample {i}.png has shape {img.shape}")
        log(f"cli: 2 samples at 1024^2 in {time.perf_counter() - t0:.1f} s")


def main():
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

    summary = phase_kernel(dev)
    grad = phase_grad_kernel(dev)
    cpu_gen, launches, cuda_launches, img_s, profiled_ms = phase_slice(
        dev, summary["per_forward"])
    phase_cli(cpu_gen)
    del cpu_gen
    train = phase_train(dev)
    check = phase_train_vs_cpu(dev)

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
        "shapes": "the 18 float32 calls of one batch-8 1024^2 forward; ms "
                  "and plain_ms device time (CUDA graph replay, x warm in "
                  "L2), cold_ms the same with x and out cold in L2, call_ms "
                  "eager calls with their host launch overhead, bf16_* the "
                  "same 18 calls in bfloat16, profiled_forward_ms the "
                  "kernels' device time inside one profiled forward; "
                  "launches over the 3 served requests, train_launches "
                  "over the 3 train steps",
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
        "shapes": "the 18 float32 calls of one batch-2 1024^2 G backward "
                  "(dx, dnoise_weight, dstyle); ms and plain_ms (the plain "
                  "analytic VJP) device time by CUDA graph replay, cold_ms "
                  "with g and x cold in L2, call_ms eager, bf16_* in "
                  "bfloat16; launches (calls) and cuda_launches over the 3 "
                  "train steps",
    }]
    log(json.dumps({"serve_img_per_s": img_s, "batch": BATCH,
                    "resolution": 1024, "dtype": "float32"}))
    log(json.dumps({"train": {k: v for k, v in train.items()
                              if k != "top_ops"},
                    "card_vs_cpu": check}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
