"""Compare builds of the split-plane epilogue entries K1-partial, K3-partial
and K3-apply stage by stage, in turns, on one CUDA card.

    python -m stylegan_torch.tools.split_ab [--baseline DIR] [NAME ...]
        [--entries ENTRY ...]

Each library is the kernel library built from a copy of ``csrc/`` (under
``build/split_ab/``, one nvcc each, all at once): "kept" is this tree's
sources; a name of `VARIANTS` is this tree's with a constant replaced; and
with ``--baseline DIR``, "baseline" is built from ``DIR/epilogue.cu`` and
``DIR/epilogue_plan.h``, an earlier tree's, e.g.

    git show <commit>:stylegan_torch/csrc/epilogue.cu > DIR/epilogue.cu

A library is called through the plans it exports: K1-partial and
K3-partial through ``sgt_epilogue_partial_plan`` and
``sgt_epilogue_bwd_partial_plan`` where it has them, else through the
split plans of that time (``sgt_epilogue_split_plan``,
``sgt_epilogue_bwd_split_plan``); K3-apply through
``sgt_epilogue_bwd_apply_plan`` where it has it, else through
``sgt_epilogue_bwd_split_plan`` (the kernels before K3-apply had a plan
of its own).  For each entry (`--entries`, all three by default:
K1-partial at batch 1 and 8, K3-partial and K3-apply at batch 2 and 1),
dtype (float32, bfloat16) and slab count (2, 4), at every stage of a
1024^2 forward that is split (side >= 4n; the slab has R/n rows): each
library's call is timed by CUDA-graph replay (chip_smoke.py's
graph_time_ms; one output and workspace reused, so no allocation or
memset is timed) in the order given and then reversed (A B B A), and its
output held to the first library's (float32 max |diff| <= 1e-4 * max(1,
max |ref|): only the order of the sums differs; K3-apply's dx, whose
arithmetic every build shares, bitwise; a library that differs is
reported at the end, and the run then exits with an error).  K3-apply is a train-step call
(dx and dnoise_weight); it is also timed after the same library's
K3-partial with g and x cold in L2 (`pair_cold_ms`: the pair's time on
rotating copies, as the step runs them).  Prints one JSON line per stage
(each library's mean time and plan, the bytes bound and the launch floor,
each library's ratio to the first), one per case with the sums over a
rank's calls of one forward or G backward (two per split stage), and the
card's name and power limit.  The package's own plans and kernels are
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
# K3-apply's plan constants (make_bwd_apply_plan)
for _name, _const, _old, _news in (
        ("apply_cluster", "kMaxApplyCluster", 8, (2, 4, 16)),
        ("apply_cluster_bytes", "kApplyClusterBytes", "7 << 20",
         ("4 << 20", "16 << 20")),
        ("apply_block_bytes", "kApplyBlockBytes", "64 << 10",
         ("32 << 10", "128 << 10")),
        ("apply_split_rows", "kApplyMinSplitRows", 16, (32,)),
        ("apply_cluster_steps", "kApplyClusterSteps", 2, (1, 4)),
        ("apply_cluster_unroll", "kApplyClusterUnroll", 4, (2, 8)),
        ("apply_cluster_unroll_bf16", "kApplyClusterUnrollBf16", 2, (4,)),
        ("apply_stream_unroll", "kApplyStreamUnroll", 2, (4, 8)),
        ("apply_stream_unroll_bf16", "kApplyStreamUnrollBf16", 2, (4,)),
        ("apply_waves", "kApplyWaves", 1, (2,)),
        ("apply_stream_rows", "kApplyStreamRows", 4, (8, 16)),
        ("apply_reverse", "kApplyReverse", 1, (0,)),
        ("apply_ring", "kApplyRingStages", 0, (2, 3, 4)),
        ("apply_ring_bf16", "kApplyRingStagesBf16", 3, (0, 2, 4)),
        ("apply_ring_unroll", "kApplyRingUnroll", 8, (2, 4)),
        ("apply_stream_ahead", "kApplyStreamAhead", 1, (0,)),
        ("apply_whole_row_bytes", "kApplyWholeRowBytes", 256, (128,)),
        ("apply_whole_row_bytes_f32", "kApplyWholeRowBytesF32", 128,
         (256,))):
    for _n in _news:
        VARIANTS[f"{_name}_{str(_n).split()[0]}"] = [
            (PLAN, f"{_const} = {_old};", f"{_const} = {_n};")]
ENTRIES = ("partial", "backward_partial", "backward_apply")
BATCHES = {"partial": (1, 8), "backward_partial": (2, 1),
           "backward_apply": (2, 1)}
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
    """One build's split entries, each call on preallocated outputs and a
    workspace of its plan (tickets zeroed once: the kernels leave them at
    zero)."""

    def __init__(self, path):
        self.lib = lib = ctypes.CDLL(path)
        self.own = hasattr(lib, "sgt_epilogue_partial_plan")
        self.own_apply = hasattr(lib, "sgt_epilogue_bwd_apply_plan")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in ("sgt_epilogue_partial_plan",
                     "sgt_epilogue_bwd_partial_plan",
                     "sgt_epilogue_split_plan"):
            if hasattr(lib, name):
                getattr(lib, name).argtypes = [i, i, ll, i, i, p]
        if hasattr(lib, "sgt_epilogue_bwd_split_plan"):
            lib.sgt_epilogue_bwd_split_plan.argtypes = [i, i, ll, i, i, i, p]
        if self.own_apply:
            lib.sgt_epilogue_bwd_apply_plan.argtypes = [i, i, ll, i, i, i, ll,
                                                        p]
            lib.sgt_epilogue_bwd_apply_wave.argtypes = [i, i, i, p]
        lib.sgt_epilogue_partial.argtypes = [p, p, p, p, p, ll, i, i, ll, i,
                                             p, p]
        lib.sgt_epilogue_backward_partial.argtypes = [
            p, p, p, p, p, p, p, p, ll, i, i, ll, i, p, p]
        lib.sgt_epilogue_backward_apply.argtypes = [
            p, p, p, p, p, p, p, ll, p, p, p, p, ll, i, i, ll, i, p, p]

    def plan(self, entry, bf16, b, rows, c):
        if entry == "backward_apply":
            if self.own_apply:
                wave = ctypes.c_longlong()
                err = self.lib.sgt_epilogue_bwd_apply_wave(
                    bf16, c, 1, ctypes.addressof(wave))
                if err != 0:
                    raise SystemExit(f"occupancy query failed: {err}")
                plan = kern.ApplyPlan()
                err = self.lib.sgt_epilogue_bwd_apply_plan(
                    bf16, b, rows, c, 1, 0, wave.value,
                    ctypes.addressof(plan))
            else:
                plan = kern.BwdPlan()
                err = self.lib.sgt_epilogue_bwd_split_plan(
                    bf16, b, rows, c, 1, 0, ctypes.addressof(plan))
        elif self.own:
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

    def call(self, entry, ins):
        """fn(i) launching the entry on the stage's tensors `ins`, and its
        outputs."""
        g, x, nw, noise = ins["g"], ins["x"], ins["nw"], ins["noise"]
        b, h, w, c = x.shape
        bf16 = int(x.dtype == torch.bfloat16)
        plan = self.plan(entry, bf16, b, h * w, c)
        ws = torch.zeros(max(plan.workspace_bytes, 16), dtype=torch.uint8,
                         device=x.device)
        addr = ctypes.addressof(plan)
        if entry == "backward_apply":
            outs = (torch.empty_like(x), torch.empty_like(nw))
        else:
            outs = (torch.empty((b, c, 2), device=x.device),
                    torch.empty((b, 2 * c), device=x.device))

        def fn(i=0):
            stream = torch.cuda.current_stream().cuda_stream
            if entry == "partial":
                err = self.lib.sgt_epilogue_partial(
                    x.data_ptr(), noise.data_ptr(), nw.data_ptr(),
                    outs[0].data_ptr(), ws.data_ptr(), ws.numel(), bf16, b,
                    h * w, c, addr, stream)
            elif entry == "backward_partial":
                err = self.lib.sgt_epilogue_backward_partial(
                    g.data_ptr(), x.data_ptr(), noise.data_ptr(),
                    nw.data_ptr(), ins["saved"].data_ptr(),
                    outs[0].data_ptr(), outs[1].data_ptr(), ws.data_ptr(),
                    ws.numel(), bf16, b, h * w, c, addr, stream)
            else:
                err = self.lib.sgt_epilogue_backward_apply(
                    g.data_ptr(), x.data_ptr(), noise.data_ptr(),
                    nw.data_ptr(), ins["style"].data_ptr(),
                    ins["saved"].data_ptr(), ins["sums"].data_ptr(),
                    ins["plane_rows"], outs[0].data_ptr(),
                    outs[1].data_ptr(), None, ws.data_ptr(), ws.numel(),
                    bf16, b, h * w, c, addr, stream)
            if err != 0:
                raise SystemExit(f"{entry} launch failed: cudaError {err}")
        fn.plan = plan  # the plan outlives the calls that point at it
        fn.ws = ws
        return fn, outs[:1] if entry == "partial" else outs

    def pair_cold_ms(self, smoke, ins):
        """K3-partial, then K3-apply, of this library on rotating copies of
        g and x, cold in L2: device ms of one pair."""
        n = max(2, -(-smoke.COLD_BYTES // (3 * ins["x"].numel()
                                          * ins["x"].element_size())))
        pairs = []
        for _ in range(n):
            own = dict(ins, g=ins["g"].clone(), x=ins["x"].clone())
            pairs.append((self.call("backward_partial", own)[0],
                          self.call("backward_apply", own)[0]))

        def fn(i):
            for f in pairs[i % n]:
                f()
        ms = smoke.graph_time_ms(fn, calls=n, replays=5)
        del pairs
        return ms

    def summary(self, entry, plan):
        """The plan's geometry, as one line of the report shows it."""
        if isinstance(plan, kern.ApplyPlan):
            names = ("form", "tx", "ty", "chunks", "splits", "cluster",
                     "unroll", "ring", "workspace_bytes")
        elif isinstance(plan, kern.PartialPlan):
            names = ("tx", "ty", "chunks", "splits", "cluster", "groups",
                     "unroll")
        else:
            names = ("tx", "ty", "chunks", "splits")
        return {n: getattr(plan, n) for n in names}


def stage_inputs(smoke, fused, g, dev, dtype, res, c, batch, n):
    """Slab 0 of a (batch, res, res, c) plane cut into n, as a dict: g, x,
    nw, noise, style; saved the slab's own (mean, rstd); sums n times the
    slab's (sum g, sum g * (y - mean)), over plane_rows = n slabs' rows."""
    x, nw, noise, style = smoke.epilogue_inputs(g, dev, dtype, res, c, batch)
    cot = torch.randn(x.shape, generator=g, device=dev).to(dtype)
    xs, ns, gs = (t.chunk(n, dim=1)[0].contiguous() for t in (x, noise, cot))
    rows = xs.shape[1] * xs.shape[2]
    saved = torch.stack(fused.split_moments(
        fused._reference_partial(xs, nw, ns)[None], rows), -1).contiguous()
    sums = (fused._reference_backward_partial(gs, xs, nw, ns, saved)[0]
            * n).contiguous()
    return {"g": gs, "x": xs, "nw": nw, "noise": ns, "style": style,
            "saved": saved, "sums": sums, "plane_rows": n * rows}


def check_outputs(entry, case, res, name, first, outs, ref):
    """The faults of one library's outputs against the first's, as
    strings."""
    faults = []
    for k, (o, r) in enumerate(zip(outs, ref)):
        if entry == "backward_apply" and k == 0:
            if not torch.equal(o, r):
                faults.append(f"{case} {res}: {name}'s dx differs from "
                              f"{first}'s")
            continue
        err = float((o.float() - r.float()).abs().max())
        bar = 1e-4 * max(1.0, float(r.float().abs().max()))
        if not err <= bar:
            faults.append(f"{case} {res}: {name} differs from {first} by "
                          f"{err} (bar {bar})")
    return faults


def main(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", default=None)
    parser.add_argument("--entries", nargs="+", choices=ENTRIES,
                        default=list(ENTRIES))
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
    faults = []
    for entry in args.entries:
        bound_of = {"partial": kern.bytes_moved_partial,
                    "backward_partial": kern.bytes_moved_backward_partial,
                    "backward_apply": kern.bytes_moved_backward_apply}[entry]
        for dtype in (torch.float32, torch.bfloat16):
            dname = "f32" if dtype == torch.float32 else "bf16"
            for batch in BATCHES[entry]:
                for n in SLABS:
                    g = torch.Generator(device=dev).manual_seed(12)
                    case = f"{entry}_{dname}_b{batch}_n{n}"
                    sums = dict.fromkeys([*order, "bound", "floor"], 0.0)
                    if entry == "backward_apply":
                        sums["pair_cold"] = dict.fromkeys(order, 0.0)
                    for res, c in smoke.EPILOGUE_SHAPES:
                        if res < 4 * n:
                            continue
                        ins = stage_inputs(smoke, fused, g, dev, dtype, res,
                                           c, batch, n)
                        calls = {k: lib.call(entry, ins)
                                 for k, lib in libs.items()}
                        ref = None
                        for k, (fn, outs) in calls.items():
                            fn()
                            torch.cuda.synchronize()
                            if ref is None:
                                ref = [o.clone() for o in outs]
                                continue
                            faults += check_outputs(entry, case, res, k,
                                                    order[0], outs, ref)
                        ms = dict.fromkeys(order, 0.0)
                        for k in order + order[::-1]:
                            ms[k] += smoke.graph_time_ms(calls[k][0]) / 2
                        bound = bound_of(ins["x"]) / smoke.HBM_BYTES_PER_S \
                            * 1e3
                        line = {"case": case, "stage": f"{res}x{res}x{c}",
                                "rows": ins["x"].shape[1] * ins["x"].shape[2],
                                "ms": ms, "bound_ms": bound,
                                "floor_ms": floor,
                                "ratio": {k: ms[k] / ms[order[0]]
                                          for k in order[1:]},
                                "plans": {k: libs[k].summary(
                                    entry, calls[k][0].plan) for k in order}}
                        if entry == "backward_apply":
                            pair = dict.fromkeys(order, 0.0)
                            for k in order + order[::-1]:
                                pair[k] += libs[k].pair_cold_ms(smoke,
                                                                ins) / 2
                            line["pair_cold_ms"] = pair
                            for k in order:
                                sums["pair_cold"][k] += 2 * pair[k]
                        print(json.dumps(line), flush=True)
                        for k in order:
                            sums[k] += 2 * ms[k]
                        sums["bound"] += 2 * bound
                        sums["floor"] += 2 * floor
                        del ins, calls, ref
                    sums["ratio"] = {k: sums[k] / sums[order[0]]
                                     for k in order[1:]}
                    print(json.dumps({"case": case, "sums_ms": sums}),
                          flush=True)
    print(smoke.card_line(), flush=True)
    if faults:
        print(json.dumps({"faults": faults}), flush=True)
        raise SystemExit(f"{len(faults)} outputs differ from {order[0]}'s")


if __name__ == "__main__":
    main(sys.argv[1:])
