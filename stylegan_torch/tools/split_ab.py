"""Compare builds of the split-plane partial reductions (K1-partial,
K3-partial) stage by stage, in turns, on one CUDA card.

    python -m stylegan_torch.tools.split_ab [--baseline DIR] [NAME ...]

Each library is the kernel library built from a copy of ``csrc/`` (under
``build/split_ab/``, one nvcc each, all at once): "kept" is this tree's
sources; a name of `VARIANTS` is this tree's with a constant replaced; and
with ``--baseline DIR``, "baseline" is built from ``DIR/epilogue.cu`` and
``DIR/epilogue_plan.h``, an earlier tree's, e.g.

    git show <commit>:stylegan_torch/csrc/epilogue.cu > DIR/epilogue.cu

A library whose entries take the split plans of that time
(``sgt_epilogue_split_plan``, ``sgt_epilogue_bwd_split_plan``) is called
through them; one with ``sgt_epilogue_partial_plan`` through its own.  For
each entry (K1-partial at batch 1 and 8, K3-partial at batch 2 and 1),
dtype (float32, bfloat16) and slab count (2, 4), at every stage of a 1024^2
forward that is split (side >= 4n; the slab has R/n rows): each library's
call is timed by CUDA-graph replay (chip_smoke.py's graph_time_ms; one
output and workspace reused, so no allocation or memset is timed) in the
order given and then reversed (A B B A), and its output held to the first
library's (float32 max |diff| <= 1e-4 * max(1, max |ref|): only the order
of the sums differs).  Prints one JSON line per stage (each library's mean
time, the bytes bound and the launch floor), one per case with the sums
over a rank's calls of one forward or G backward (two per split stage), and
the card's name and power limit.  The package's own plans and kernels are
not changed: a variant exists only in its build directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from stylegan_torch.ops.kernels import epilogue as kern

REPO = kern._PKG.parent
OUT = REPO / "build" / "split_ab"
PLAN = "epilogue_plan.h"
CU = "epilogue.cu"
# name -> [(file, old, new)]: each `old` must occur exactly once
VARIANTS = {
    "kept": [],
    "k1_bf16_unroll_4": [(PLAN, "kPartialClusterUnrollBf16 = 1",
                          "kPartialClusterUnrollBf16 = 4")],
    "stream_rows_16": [(PLAN, "kStreamRowsPerThread = 32",
                        "kStreamRowsPerThread = 16")],
    "stream_rows_64": [(PLAN, "kStreamRowsPerThread = 32",
                        "kStreamRowsPerThread = 64")],
    "block_bytes_64k": [(PLAN, "kClusterBlockBytes = 128 << 10",
                         "kClusterBlockBytes = 64 << 10")],
    "block_bytes_256k": [(PLAN, "kClusterBlockBytes = 128 << 10",
                          "kClusterBlockBytes = 256 << 10")],
    "cluster_rounds_16": [(PLAN, "kMaxClusterRounds = 8",
                           "kMaxClusterRounds = 16")],
    "merge_loads_2048": [(PLAN, "kMaxMergeLoads = 4096",
                          "kMaxMergeLoads = 2048")],
}
for _n in (1, 4, 16):
    VARIANTS[f"cluster_{_n}"] = [(PLAN, "kMaxPartialCluster = 8",
                                  f"kMaxPartialCluster = {_n}")]
for _name, _const, _old, _news in (
        ("k1_stream", "kStreamBlocks", 1024, (512, 2048)),
        ("k1_bf16_stream", "kStreamBlocksBf16", 256, (512,)),
        ("k3_stream", "kBwdStreamBlocks", 256, (512,))):
    for _n in _news:
        VARIANTS[f"{_name}_{_n}"] = [(PLAN, f"{_const} = {_old}",
                                      f"{_const} = {_n}")]
BATCHES = {"partial": (1, 8), "backward_partial": (2, 1)}
SLABS = (2, 4)


def build_all(names, baseline):
    """Build every named library at once; returns {name: library path}."""
    procs, out = {}, {}
    for name in names:
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for src in kern.SOURCES:
            if name == "baseline":
                text = (baseline / src.name).read_text()
            else:
                text = src.read_text()
            for fname, old, new in VARIANTS.get(name, ()):
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


class Library:
    """One build's two partial entries, each call on preallocated outputs
    and a workspace of its plan (tickets zeroed once: the kernels leave
    them at zero)."""

    def __init__(self, path):
        self.lib = lib = ctypes.CDLL(path)
        self.own = hasattr(lib, "sgt_epilogue_partial_plan")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in ("sgt_epilogue_partial_plan",
                     "sgt_epilogue_bwd_partial_plan",
                     "sgt_epilogue_split_plan"):
            if hasattr(lib, name):
                getattr(lib, name).argtypes = [i, i, ll, i, i, p]
        lib.sgt_epilogue_bwd_split_plan.argtypes = [i, i, ll, i, i, i, p]
        lib.sgt_epilogue_partial.argtypes = [p, p, p, p, p, ll, i, i, ll, i,
                                             p, p]
        lib.sgt_epilogue_backward_partial.argtypes = [
            p, p, p, p, p, p, p, p, ll, i, i, ll, i, p, p]

    def plan(self, entry, bf16, b, rows, c):
        if self.own:
            plan = kern.PartialPlan()
            fn = (self.lib.sgt_epilogue_partial_plan if entry == "partial"
                  else self.lib.sgt_epilogue_bwd_partial_plan)
            err = fn(bf16, b, rows, c, 1, ctypes.addressof(plan))
        elif entry == "partial":
            plan = kern.Plan()
            err = self.lib.sgt_epilogue_split_plan(bf16, b, rows, c, 1,
                                                   ctypes.addressof(plan))
        else:
            plan = kern.BwdPlan()
            err = self.lib.sgt_epilogue_bwd_split_plan(
                bf16, b, rows, c, 1, 0, ctypes.addressof(plan))
        if err != 0:
            raise SystemExit(f"no {entry} plan for {b} {rows} {c}")
        return plan

    def call(self, entry, g, x, nw, noise, saved):
        """fn(i) launching the entry on these tensors, and its outputs."""
        b, h, w, c = x.shape
        bf16 = int(x.dtype == torch.bfloat16)
        plan = self.plan(entry, bf16, b, h * w, c)
        ws = torch.zeros(max(plan.workspace_bytes, 16), dtype=torch.uint8,
                         device=x.device)
        out = torch.empty((b, c, 2), device=x.device)
        dstyle = torch.empty((b, 2 * c), device=x.device)
        addr = ctypes.addressof(plan)

        def fn(i=0):
            stream = torch.cuda.current_stream().cuda_stream
            if entry == "partial":
                err = self.lib.sgt_epilogue_partial(
                    x.data_ptr(), noise.data_ptr(), nw.data_ptr(),
                    out.data_ptr(), ws.data_ptr(), ws.numel(), bf16, b,
                    h * w, c, addr, stream)
            else:
                err = self.lib.sgt_epilogue_backward_partial(
                    g.data_ptr(), x.data_ptr(), noise.data_ptr(),
                    nw.data_ptr(), saved.data_ptr(), out.data_ptr(),
                    dstyle.data_ptr(), ws.data_ptr(), ws.numel(), bf16, b,
                    h * w, c, addr, stream)
            if err != 0:
                raise SystemExit(f"{entry} launch failed: cudaError {err}")
        fn.plan = plan  # the plan outlives the calls that point at it
        return fn, (out, dstyle) if entry != "partial" else (out,)

    def summary(self, plan):
        """The plan's geometry, as one line of the report shows it."""
        names = ("tx", "ty", "chunks", "splits") + (
            ("cluster", "groups", "unroll") if self.own else ())
        return {n: getattr(plan, n) for n in names}


def stage_inputs(smoke, fused, g, dev, dtype, res, c, batch, n):
    """Slab 0 of a (batch, res, res, c) plane cut into n: (g, x, nw,
    noise, saved), saved the slab's own (mean, rstd)."""
    x, nw, noise, _ = smoke.epilogue_inputs(g, dev, dtype, res, c, batch)
    cot = torch.randn(x.shape, generator=g, device=dev).to(dtype)
    xs, ns, gs = (t.chunk(n, dim=1)[0].contiguous() for t in (x, noise, cot))
    rows = xs.shape[1] * xs.shape[2]
    saved = torch.stack(fused.split_moments(
        fused._reference_partial(xs, nw, ns)[None], rows), -1).contiguous()
    return gs, xs, nw, ns, saved


def main(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", default=None)
    parser.add_argument("names", nargs="*")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from stylegan_torch.ops import fused
    names = (["baseline"] if args.baseline else []) + (args.names or ["kept"])
    unknown = set(names) - set(VARIANTS) - {"baseline"}
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    order = list(dict.fromkeys(names))
    libs = {k: Library(v) for k, v in build_all(
        order, Path(args.baseline) if args.baseline else None).items()}
    dev = torch.device("cuda")
    floor = smoke.launch_floor_ms()
    print(json.dumps({"launch_floor_ms": floor}), flush=True)
    for entry, batches in BATCHES.items():
        bound_of = (kern.bytes_moved_partial if entry == "partial"
                    else kern.bytes_moved_backward_partial)
        for dtype in (torch.float32, torch.bfloat16):
            dname = "f32" if dtype == torch.float32 else "bf16"
            for batch in batches:
                for n in SLABS:
                    g = torch.Generator(device=dev).manual_seed(12)
                    case = f"{entry}_{dname}_b{batch}_n{n}"
                    sums = dict.fromkeys([*order, "bound", "floor"], 0.0)
                    for res, c in smoke.EPILOGUE_SHAPES:
                        if res < 4 * n:
                            continue
                        ins = stage_inputs(smoke, fused, g, dev, dtype, res,
                                           c, batch, n)
                        calls = {k: lib.call(entry, *ins)
                                 for k, lib in libs.items()}
                        ref = None
                        for k, (fn, outs) in calls.items():
                            fn()
                            torch.cuda.synchronize()
                            if ref is None:
                                ref = [o.clone() for o in outs]
                                continue
                            for o, r in zip(outs, ref):
                                err = float((o - r).abs().max())
                                bar = 1e-4 * max(1.0, float(r.abs().max()))
                                if not err <= bar:
                                    raise SystemExit(
                                        f"{case} {res}: {k} differs from "
                                        f"{order[0]} by {err} (bar {bar})")
                        ms = dict.fromkeys(order, 0.0)
                        for k in order + order[::-1]:
                            ms[k] += smoke.graph_time_ms(calls[k][0]) / 2
                        bound = bound_of(ins[1]) / smoke.HBM_BYTES_PER_S * 1e3
                        line = {"case": case, "stage": f"{res}x{res}x{c}",
                                "rows": ins[1].shape[1] * ins[1].shape[2],
                                "ms": ms, "bound_ms": bound,
                                "floor_ms": floor,
                                "plans": {k: libs[k].summary(calls[k][0].plan)
                                          for k in order}}
                        print(json.dumps(line), flush=True)
                        for k in order:
                            sums[k] += 2 * ms[k]
                        sums["bound"] += 2 * bound
                        sums["floor"] += 2 * floor
                        del ins, calls, ref
                    print(json.dumps({"case": case, "sums_ms": sums}),
                          flush=True)
    print(smoke.card_line(), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
