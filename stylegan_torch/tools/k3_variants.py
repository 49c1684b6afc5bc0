"""Time variants of the epilogue's backward kernels (K3) on one CUDA card.

    python -m stylegan_torch.tools.k3_variants [NAME ...]

Each variant is the kernel library built from a copy of ``csrc/`` with a few
constants of ``epilogue.cu`` or ``epilogue_plan.h`` replaced (`VARIANTS`;
the kept sources are "kept"), under ``build/k3_variants/``; all are built at
once, one nvcc each.  Then, in the order given (default: every variant, and
"kept" again at the end to show the drift), each is held to the plain
version at the 9 epilogue shapes of a 1024^2 G backward at batch 2, in
float32 and bfloat16 (chip_smoke.py's bars), and timed: device time per call
by CUDA-graph replay as chip_smoke.py's phase 5(a) (which includes a memset
of the captured call's ticket counters), and each kernel's device time per
call from torch.profiler over eager calls.  Prints one JSON line per
(variant, dtype, shape), then one per variant with the 18 calls' sums, and
the card's name and power limit.  The plans and kernels of the package are
not changed: a variant exists only in its build directory.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

import torch

from stylegan_torch.ops.kernels import epilogue as kern

REPO = kern._PKG.parent
VARIANTS_DIR = REPO / "build" / "k3_variants"
PLAN = "epilogue_plan.h"
CU = "epilogue.cu"
# name -> [(file, old, new)]: each `old` must occur exactly once
VARIANTS = {
    "kept": [],
    "sums_unroll_2": [(CU, "kBwdSumsUnroll = 4", "kBwdSumsUnroll = 2")],
    "sums_unroll_8": [(CU, "kBwdSumsUnroll = 4", "kBwdSumsUnroll = 8")],
    "bf16_sums_unroll_2": [(CU, "kBwdSumsUnrollBf16 = 1",
                            "kBwdSumsUnrollBf16 = 2")],
    "dx_unroll_4": [(CU, "kBwdDxUnroll = 2", "kBwdDxUnroll = 4")],
    "bf16_dx_unroll_1": [(CU, "kBwdDxUnrollBf16 = 2",
                          "kBwdDxUnrollBf16 = 1")],
    "two_pass_only": [(PLAN, "if (fit_one_pass(p.vec, elem, 2,",
                       "if (false && fit_one_pass(p.vec, elem, 2,")],
}
for n in (128, 384, 512, 1024):
    VARIANTS[f"target_{n}"] = [(PLAN, "kTargetBwdBlocks = 256",
                                f"kTargetBwdBlocks = {n}")]
BATCH = 2


def build_all(names):
    """Build every named variant at once; returns {name: library path}."""
    procs, out = {}, {}
    for name in names:
        d = VARIANTS_DIR / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for src in kern.SOURCES:
            text = src.read_text()
            for fname, old, new in VARIANTS[name]:
                if fname == src.name:
                    if text.count(old) != 1:
                        raise SystemExit(f"{name}: {old!r} is not in "
                                         f"{src.name} exactly once")
                    text = text.replace(old, new)
            (d / src.name).write_text(text)
        out[name] = str(d / "libepilogue.so")
        procs[name] = subprocess.Popen(
            [kern._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
             out[name], str(d / CU)], stderr=subprocess.PIPE, text=True)
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed:\n{err}")
    return out


def use_library(path):
    kern._lib = kern.bind(ctypes.CDLL(path))
    for cache in (kern._plans, kern._workspaces, kern._bwd_plans,
                  kern._bwd_workspaces):
        cache.clear()


def kernel_ms(fn, calls=20):
    """Device time per call of each backward kernel, by torch.profiler over
    `calls` eager calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in kern.BWD_KERNEL_NAMES:
            if f"::{name}<" in e.key:
                ms[name] = ms.get(name, 0.0) + \
                    e.self_device_time_total / 1e3 / calls
    return ms


def time_variant(name, smoke, fused, dev):
    total = {"f32_ms": 0.0, "bf16_ms": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(3)
        for res, c in smoke.EPILOGUE_SHAPES:
            args = smoke.epilogue_inputs(g, dev, dtype, res, c, BATCH)
            x, nw, noise, style = args
            cot = torch.randn(x.shape, generator=g, device=dev).to(dtype)
            where = f"{name} {BATCH}x{res}x{res}x{c} {dtype}"
            smoke.check_grads(fused, args, cot,
                              smoke.kernel_grads(kern, args, cot), where)
            saved = torch.empty((BATCH, c, 2), device=dev)
            kern.epilogue_forward(x, nw, noise, style, saved)

            def call(i=0):
                return kern.epilogue_backward(cot, x, nw, noise, style,
                                              saved, smoke.TRAIN_NEEDS)
            ms = smoke.graph_time_ms(call)
            plan = kern.bwd_plan_for(x)
            key = "f32_ms" if dtype == torch.float32 else "bf16_ms"
            total[key] += 2 * ms
            print(json.dumps({
                "variant": name, "shape": f"{BATCH}x{res}x{res}x{c}",
                "dtype": str(dtype), "ms": ms,
                "kernel_ms": kernel_ms(call), "path": plan["path"],
                "cluster": plan["cluster"], "chunk_c": plan["chunk_c"],
                "splits": plan["splits"]}), flush=True)
            del args, x, cot, saved, call
    print(json.dumps({"variant": name, "calls_18": total}), flush=True)


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from stylegan_torch.ops import fused
    names = argv or list(VARIANTS) + ["kept"]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    libs = build_all(list(dict.fromkeys(names)))
    dev = torch.device("cuda")
    for name in names:
        use_library(libs[name])
        time_variant(name, smoke, fused, dev)
    print(smoke.card_line())


if __name__ == "__main__":
    main(sys.argv[1:])
