#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stylegan_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build   compile the epilogue kernel (csrc/epilogue.cu) with nvcc for sm_90a;
2. kernel  at each of the 9 epilogue shapes of a 1024^2 forward, batch 8, in
           float32 and bfloat16: run the kernel and the plain PyTorch version
           (ops/fused.py::_reference_epilogue) on the same CUDA tensors, hold
           max |diff| to its tolerance, time both with CUDA events (device
           time from CUDA-graph replays, and eager calls); hold it too at
           ragged shapes that take its scalar (unvectorised) path; check the
           autograd.Function's gradients against autograd of the plain version;
3. slice   build the FFHQ-1024 generator of configs/sample_ffhq_1024.yaml with
           seeded random weights (noise weights included), serve 3 requests of
           batch 8 at 1024^2 through make_serving_fn, check shapes, finiteness
           and 18 kernel calls per forward, and hold the first 2 images of a
           request to the same generator on the CPU (plain path, TF32 off) at
           max |diff| <= 1e-2; profile one more forward (torch.profiler) and
           write its device-time table by kernel to build/chip_smoke/;
4. cli     save the weights as a JAX-package .npz and run
           `python -m stylegan_torch.cli.generate_samples` on them.

The last two lines are {"kernels": [...]} with the kernel's measurements and
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
    """Device time of one fn() call: `calls` calls captured in a CUDA graph,
    replayed, median replay time over `calls`.  Leaves out the host's launch
    overhead, which cuda_time_ms of an eager call includes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_time_ms(graph.replay, iters=replays) / calls
    del graph
    return ms


def bf16_bound(ref):
    # bfloat16 keeps 8 significant bits: one ulp at magnitude m is
    # 2**(floor(log2 m) - 7)
    m = float(ref.abs().max())
    return BF16_ULPS * 2.0 ** (math.floor(math.log2(m)) - 7)


def phase_kernel(dev):
    """Kernel vs plain version at every epilogue shape; returns the summary
    over the main path's 18 float32 calls."""
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    g = torch.Generator(device=dev).manual_seed(0)
    summary = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for res, c in EPILOGUE_SHAPES:
            shape = (BATCH, res, res, c)
            x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(dtype)
            nw = 0.5 * torch.randn(c, generator=g, device=dev)
            noise = torch.randn((BATCH, res, res, 1), generator=g,
                                device=dev).to(dtype)
            style = 0.5 * torch.randn((BATCH, 2 * c), generator=g,
                                      device=dev)
            args = (x, nw, noise, style)
            with torch.no_grad():
                got = fused.fused_epilogue(*args)
                ref = fused._reference_epilogue(*args)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != x.shape:
                    fail(f"kernel output {got.dtype} {tuple(got.shape)}")
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

                def kernel():
                    fused.fused_epilogue(*args)

                def plain():
                    fused._reference_epilogue(*args)
                ms, plain_ms = graph_time_ms(kernel), graph_time_ms(plain)
                call_ms = cuda_time_ms(kernel)
                plain_call_ms = cuda_time_ms(plain)
            nbytes = kern.bytes_moved(x)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            name = "f32" if dtype == torch.float32 else "bf16"
            log(json.dumps({"epilogue": f"{BATCH}x{res}x{res}x{c}",
                            "dtype": name, "max_abs_err": err, "tol": tol,
                            "ms": ms, "plain_ms": plain_ms,
                            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
                            "bytes": nbytes, "bound_ms": bound_ms,
                            "GB_per_s": nbytes / ms / 1e6}))
            if not err <= tol:
                fail(f"epilogue {shape} {name}: max |diff| {err} > {tol}")
            if dtype == torch.float32:   # the main path: two calls per stage
                summary["ms"] += 2 * ms
                summary["call_ms"] += 2 * call_ms
                summary["plain_ms"] += 2 * plain_ms
                summary["bound_ms"] += 2 * bound_ms
                summary["max_abs_err"] = max(summary["max_abs_err"], err)
            del x, noise, got, ref, args, kernel, plain
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
        ref = fused._reference_epilogue(*args)
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
          for _ in range(REQUESTS + 1)]
    serve(zs[-1], 1000)               # warm-up request, not counted
    torch.cuda.synchronize()

    kern.launches = 0
    t0 = time.perf_counter()
    outs = []
    for i in range(REQUESTS):
        outs.append(serve(zs[i], i))
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = kern.launches
    for out in outs:
        if tuple(out.shape) != (BATCH, 1024, 1024, 3):
            fail(f"served shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            fail("served images hold non-finite values")
    if launches != 18 * REQUESTS:
        fail(f"epilogue kernel calls {launches}, want {18 * REQUESTS}")
    log(f"served {REQUESTS} requests of batch {BATCH} at 1024^2: "
        f"{elapsed / REQUESTS * 1e3:.2f} ms per forward, "
        f"{REQUESTS * BATCH / elapsed:.2f} img/s, {launches} epilogue calls, "
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

    profile_forward(serve, zs[0], PROFILE_TABLE)
    return cpu_gen, launches, REQUESTS * BATCH / elapsed


def profile_forward(serve, z, path):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        serve(z, 0)
        torch.cuda.synchronize()
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    epilogue = sum(e.self_device_time_total for e in kernels
                   if any(k in e.key for k in ("stats_kernel",
                                               "finalize_kernel",
                                               "apply_kernel"))) / 1e3
    log(json.dumps({"profiled_forward_device_ms": busy,
                    "epilogue_kernels_device_ms": epilogue}))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    log(f"profile table: {os.path.relpath(path, REPO)}")
    log(table[:6000])


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
    cpu_gen, launches, img_s = phase_slice(dev)
    phase_cli(cpu_gen)

    kernels = [{
        "name": "epilogue", "route": "cuda",
        "source": "stylegan_torch/csrc/epilogue.cu",
        "replaces": "stylegan_tpu/ops/pallas/epilogue.py:73",
        "replaces_also": ["stylegan_tpu/ops/pallas/epilogue.py:101"],
        "launches": launches, "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"], "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "call_ms": summary["call_ms"],
        "shapes": "the 18 float32 calls of one batch-8 1024^2 forward; ms "
                  "and plain_ms device time (CUDA graph replay), call_ms "
                  "eager calls with their host launch overhead",
    }]
    log(json.dumps({"serve_img_per_s": img_s, "batch": BATCH,
                    "resolution": 1024, "dtype": "float32"}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
