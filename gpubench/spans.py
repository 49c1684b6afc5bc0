"""The join of the program's spans with a traced stretch's device trace:
every device op and every idle gap put down to a span.

The spans are the program's recorder's tuples ``(name, parent, root, tid,
t0_ns, t1_ns)`` on ``time.time_ns()``; the trace is ``torch.profiler``'s
Chrome trace, whose events lie at ``baseTimeNanoseconds + ts * 1000`` on
the same clock.  A unit is a root span (one with no parent) that no root
span of another thread holds.  The stretch is the trace's first launch or
device op to the end of its last, and its busy time the union of its
device ops' intervals, as ``trace.py`` reads them.

* A device op counts to the innermost span on its launching thread that
  holds its launch (matched by correlation id), failing that to the
  innermost span on a unit's thread that holds it: that thread blocks
  inside ``*.backward`` while autograd's thread launches.  A trace that
  records the device alone names threads by CUPTI's ids, not the
  system's, so there only the second rule applies.  Where ops overlap,
  the time two of them share counts once, to the one that started first.
* An idle gap is split at the boundaries of the units' thread's spans;
  each piece counts to the innermost span that holds it.
* What no span holds counts as outside the program.

``join`` returns per unit: for each span name its calls, wall, self
(wall less its children's), device and idle ms, by innermost span
(``spans``); the same device and idle ms for each name summed over every
op and gap that lies inside a span of that name on the units' thread
(``phases``); and the device and idle ms outside the program.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class _Innermost:
    """The innermost of one thread's (properly nested) spans that holds a
    time, by a bisection over their starts and a walk up the parents."""

    def __init__(self, spans, idx):
        self.spans = spans
        self.order = sorted(idx, key=lambda i: (spans[i][4], -spans[i][5]))
        self.starts = [spans[i][4] for i in self.order]

    def __call__(self, t):
        k = bisect.bisect_right(self.starts, t) - 1
        i = self.order[k] if k >= 0 else None
        while i is not None:
            s = self.spans[i]
            if s is None:           # a parent still open
                return None
            if s[5] >= t:
                return i
            i = s[1]
        return None


def _chain(spans, i):
    """The names of span `i` and its ancestors, each once."""
    names = set()
    while i is not None and spans[i] is not None:
        names.add(spans[i][0])
        i = spans[i][1]
    return names


def join(doc: dict, spans) -> dict:
    """The span table of a device trace `doc` (the exported Chrome JSON)
    and the spans recorded over it, per unit (module docstring)."""
    base = doc.get("baseTimeNanoseconds", 0)
    device, launches, bounds = [], {}, []
    for e in doc["traceEvents"]:
        if e.get("ph") != "X":
            continue
        cat, a = e.get("cat"), e["ts"]
        b = a + e.get("dur", 0)
        if cat in DEVICE_CATS or cat in LAUNCH_CATS:
            bounds += [a, b]
        if cat in DEVICE_CATS:
            device.append((a, b, e.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["tid"], a)
    # the spans on the trace's time base (microseconds), at their indexes;
    # None where a span was still open
    sp = [None if s is None else
          (s[0], s[1], s[2], s[3], (s[4] - base) / 1e3, (s[5] - base) / 1e3)
          for s in spans]
    done = [i for i, s in enumerate(sp) if s is not None]
    by_tid = defaultdict(list)
    for i in done:
        by_tid[sp[i][3]].append(i)
    inner = {tid: _Innermost(sp, idx) for tid, idx in by_tid.items()}
    # a unit: a root span that no root span of another thread holds (a
    # root that autograd's thread opens lies inside the unit it serves)
    roots = [i for i in done if sp[i][1] is None]
    units = [i for i in roots
             if not any(sp[j][3] != sp[i][3] and sp[j][4] <= sp[i][4]
                        and sp[i][5] <= sp[j][5] for j in roots)]
    main_tids = {sp[i][3] for i in units}

    def on_main(t):
        found = [f(t) for tid, f in inner.items() if tid in main_tids]
        found = [i for i in found if i is not None]
        return max(found, key=lambda i: sp[i][4]) if found else None

    dev_by, idle_by = defaultdict(float), defaultdict(float)
    dev_phase, idle_phase = defaultdict(float), defaultdict(float)

    def put(share, innermost, main, by, phase):
        by[sp[innermost][0] if innermost is not None else None] += share
        for name in _chain(sp, main):
            phase[name] += share

    covered = None
    busy = []
    for a, b, corr in sorted(device):
        start = a if covered is None else max(a, covered)
        if covered is None or a > covered:
            busy.append([a, b])
        elif b > busy[-1][1]:
            busy[-1][1] = b
        covered = b if covered is None else max(covered, b)
        share = max(0.0, b - start)
        launch = launches.get(corr)
        main = innermost = None
        if launch is not None:
            tid, t = launch
            main = on_main(t)
            innermost = inner[tid](t) if tid in inner else None
            if innermost is None:
                innermost = main
        put(share, innermost, main, dev_by, dev_phase)

    edges = sorted({t for i in done if sp[i][3] in main_tids
                    for t in sp[i][4:6]})
    if bounds:
        lo, hi, edge = min(bounds), max(bounds), min(bounds)
        for a, b in busy + [[hi, hi]]:
            if a > edge:
                cuts = edges[bisect.bisect_right(edges, edge):
                             bisect.bisect_left(edges, a)]
                for g0, g1 in zip([edge] + cuts, cuts + [a]):
                    i = on_main((g0 + g1) / 2)
                    put(g1 - g0, i, i, idle_by, idle_phase)
            edge = max(edge, b)

    n = max(len(units), 1)
    wall, child = defaultdict(float), defaultdict(float)
    calls = defaultdict(int)
    for i in done:
        name, parent, _, _, a, b = sp[i]
        wall[name] += b - a
        calls[name] += 1
        if parent is not None and sp[parent] is not None:
            child[sp[parent][0]] += b - a
    table = {name: {"calls": calls[name] / n,
                    "wall_ms": wall[name] / 1e3 / n,
                    "self_ms": (wall[name] - child[name]) / 1e3 / n,
                    "device_ms": dev_by[name] / 1e3 / n,
                    "idle_ms": idle_by[name] / 1e3 / n}
             for name in sorted(calls)}
    phases = {name: {"device_ms": dev_phase[name] / 1e3 / n,
                     "idle_ms": idle_phase[name] / 1e3 / n}
              for name in sorted(set(dev_phase) | set(idle_phase))}
    return {"units": len(units), "spans": table, "phases": phases,
            "outside": {"device_ms": dev_by[None] / 1e3 / n,
                        "idle_ms": idle_by[None] / 1e3 / n}}
