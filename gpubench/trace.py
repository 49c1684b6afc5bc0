"""The traced stretches: ``torch.profiler`` over a few units of a run's
window, and the reduction of their traces to what the per-layer readers
take.

A stretch is marked by a ``gpubench.stretch`` range on the host, and
begins and ends on a device with nothing queued.  Device time is the union
of the intervals of kernels, copies and sets that ran within it (so
overlapping work counts once).  A kernel belongs to the host op that
launched it and to that op's ancestors: its launch (matched by the
trace's correlation id) lies inside them on the launching thread.  A
convolution's time is that of kernels under an ``aten::convolution*`` op;
the epilogue's that of kernels under a ``stylegan_torch::epilogue*`` op,
whose calls (outermost only) and input shapes give the bytes bound.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path

import torch

from . import counts

STRETCH = "gpubench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CONV = "aten::convolution"
EPILOGUE = "stylegan_torch::epilogue"
ITEMSIZE = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8}
TOP = 10


class Tracer:
    """Two stretches of `count` units each, from unit `start` of a window.
    The first records the device alone (kernels, copies, sets and their
    launches), which slows the host little: the busy and idle shares, the
    launches and the device's top operations are read there.  The second
    records the host's ops with their input shapes as well, which slows the
    host: only the device time of convolutions and of the epilogue, the
    epilogue's bytes and the idle gaps' host ops are read there."""

    def __init__(self, start: int, count: int, path: Path):
        self.stretches = {"device": (start, start + count),
                          "ops": (start + count, start + 2 * count)}
        self.path = path
        self.units = dict.fromkeys(self.stretches, 0)
        self.host_s = dict.fromkeys(self.stretches, 0.0)
        self._prof = self._range = self._kind = None
        self._done = {}
        self._t = 0.0

    def before(self, i: int):
        for kind, (a, _) in self.stretches.items():
            if i == a:
                self._begin(kind)

    def _begin(self, kind):
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA] if cuda else []
        if kind == "ops" or not cuda:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self._prof = torch.profiler.profile(activities=acts,
                                            record_shapes=kind == "ops")
        self._kind = kind
        self._t = time.perf_counter()
        self._prof.start()
        self._range = torch.profiler.record_function(STRETCH)
        self._range.__enter__()

    def after(self, i: int):
        if self._kind is None:
            return
        a, b = self.stretches[self._kind]
        if a <= i < b:
            self.units[self._kind] += 1
        if i + 1 == b:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._range.__exit__(None, None, None)
            self._prof.stop()
            if self._kind == "device":
                # written at once: a later profiler session in the process
                # leaves this one's device events without durations
                self._done["device"] = self._write("device", self._prof)
            else:
                self._done["ops"] = self._prof
            self.host_s[self._kind] = time.perf_counter() - self._t
            self._prof = self._kind = None

    def _write(self, kind, prof) -> Path:
        path = self.path.with_suffix(f".{kind}.json")
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        return path

    def close(self):
        """Writes the second stretch's trace (after the window: writing
        takes seconds); returns the two stretches' reduction, or None when
        the window ended before both did."""
        if set(self._done) != set(self.stretches):
            return None
        out = reduce_device(_events(self._done.pop("device")))
        out.update(reduce(_events(self._write("ops", self._done.pop("ops")))))
        out["units"] = self.units["device"]
        out["ops_range"] = self.stretches["ops"]
        # the window's units that ran under the profiler
        out["traced"] = (self.stretches["device"][0],
                         self.stretches["ops"][1])
        out["traced_host_s"] = sum(self.host_s.values())
        return out


def _events(path: Path):
    return json.loads(path.read_text())["traceEvents"]


def reduce_device(events) -> dict:
    """From a device-only trace: the stretch's wall (its first launch or
    device op to the end of its last, the closing synchronize included),
    the union of its device ops, its kernels and its top device ops."""
    device, bounds = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS or cat in LAUNCH_CATS:
            bounds += [e["ts"], e["ts"] + e.get("dur", 0)]
        if cat in DEVICE_CATS:
            device.append((e["ts"], e["ts"] + e.get("dur", 0), e, cat))
    if not device:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": 0,
                "device_ops": []}
    busy, _ = _union([(a, b) for a, b, _, _ in device])
    by_name = defaultdict(float)
    for a, b, e, _ in device:
        by_name[e["name"][:160]] += b - a
    return {"window_s": (max(bounds) - min(bounds)) / 1e6,
            "busy_s": busy / 1e6,
            "kernels": sum(c == "kernel" for *_, c in device),
            "device_ops": _top(by_name)}


def _top(d):
    return [[k, v / 1e6] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def _union(intervals):
    total, end = 0.0, None
    spans = []
    for a, b in sorted(intervals):
        if end is None or a > end:
            spans.append([a, b])
            end = b
        elif b > end:
            spans[-1][1] = end = b
    for a, b in spans:
        total += b - a
    return total, spans


def _annotate(ops, points):
    """For each point (tid, ts, key): the chain flags of the innermost op
    on its thread that holds it: (under a conv, under an epilogue op, the
    innermost op's name).  Ops gain 'outer_epilogue' (an epilogue op with
    no epilogue op above it)."""
    by_tid = defaultdict(list)
    for o in ops:
        by_tid[o["tid"]].append((o["ts"], 0, -o["end"], id(o), o))
    for tid, ts, key in points:
        by_tid[tid].append((ts, 1, 0, key, None))
    found = {}
    for items in by_tid.values():
        items.sort(key=lambda t: t[:4])
        stack = []   # (end, conv, epilogue, name)
        for ts, kind, _, key, o in items:
            while stack and stack[-1][0] <= ts:
                stack.pop()
            conv, epi = stack[-1][1:3] if stack else (False, False)
            if kind == 0:
                name = o["name"]
                is_epi = name.startswith(EPILOGUE)
                o["outer_epilogue"] = is_epi and not epi
                stack.append((o["end"], conv or name.startswith(CONV),
                              epi or is_epi, name))
            else:
                found[key] = (conv, epi, stack[-1][3] if stack else "")
    return found


def reduce(events) -> dict:
    """From a trace of host ops and the device: the device time of
    kernels under convolution ops and under epilogue ops, the epilogue
    calls' bytes bound, and the idle gaps by the host op at their middle,
    within the ``gpubench.stretch`` range."""
    stretch = next(e for e in events if e.get("name") == STRETCH
                   and e.get("ph") == "X" and e.get("cat") in HOST_CATS)
    t0, t1 = stretch["ts"], stretch["ts"] + stretch["dur"]
    ops, device, launches = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in HOST_CATS:
            ops.append({"tid": e["tid"], "ts": e["ts"],
                        "end": e["ts"] + e.get("dur", 0), "name": e["name"],
                        "args": e.get("args", {})})
        elif cat in DEVICE_CATS:
            a, b = max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1)
            if b > a:
                device.append((a, b, e, cat))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e
    points = []
    for i, (_, _, e, _) in enumerate(device):
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            points.append((launch["tid"], launch["ts"], i))
    chain = _annotate(ops, points)

    _, spans = _union([(a, b) for a, b, _, _ in device])
    conv_us = epi_us = 0.0
    for i, (a, b, e, cat) in enumerate(device):
        if cat != "kernel":
            continue
        conv, epi, _ = chain.get(i, (False, False, ""))
        conv_us += (b - a) if conv else 0.0
        epi_us += (b - a) if epi else 0.0

    epi_bytes = 0
    for o in ops:
        if not (o.get("outer_epilogue") and t0 <= o["ts"] < t1):
            continue
        dims = o["args"].get("Input Dims") or [[]]
        types = o["args"].get("Input type") or [""]
        n = counts.epilogue_bytes(o["name"], dims[0],
                                  ITEMSIZE.get(types[0], 0))
        if n is None or not ITEMSIZE.get(types[0]):
            epi_bytes = None
            break
        epi_bytes += n

    # idle gaps, labelled by the innermost host op on the stretch's thread
    # at each gap's middle
    gaps, edge = [], t0
    for a, b in spans + [[t1, t1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    labels = _annotate([o for o in ops if o["tid"] == stretch["tid"]],
                       [(stretch["tid"], (a + b) / 2, j)
                        for j, (a, b) in enumerate(gaps)])
    idle_by = defaultdict(float)
    for j, (a, b) in enumerate(gaps):
        idle_by[labels.get(j, (0, 0, ""))[2] or "(none)"] += b - a

    return {"conv_s": conv_us / 1e6, "epilogue_s": epi_us / 1e6,
            "epilogue_bytes": epi_bytes, "idle_gaps": _top(idle_by)}
