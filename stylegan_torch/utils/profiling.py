"""Observability hooks (the port's copy of
``stylegan_tpu/utils/profiling.py``, with spans and counters of its own).

* ``span(name)`` — a named interval of the program on the host's realtime
  clock (``time.time_ns()``), kept in memory while a recorder is
  installed; a shared no-op context otherwise.
* ``recording()`` — installs a recorder and yields it; its ``spans`` are
  plain tuples ``(name, parent, root, tid, t0_ns, t1_ns)``.
* ``trace(logdir)`` — context manager around ``torch.profiler`` that writes
  a Chrome/Perfetto trace JSON (CPU ops, and the card's kernels when CUDA is
  available) into `logdir`, with the spans recorded meanwhile.
* ``counters`` — the program's event counts (``epilogue.launches``, ...;
  ``serve.host_copies``, the served requests handed to the host through
  page-locked memory, and ``serve.host_allocs``, those whose page-locked
  block the caching host allocator had to create), one
  ``collections.Counter``.
* ``MetricsWriter`` — JSONL metrics stream (one dict per line) that tools can
  tail; doubles as the trainer's machine-readable log.

The spans, by the layer they bound: ``train.step`` (root), ``train.input``
(the reals' copy and z), ``train.d``, ``train.reg``, ``train.g_forward``,
``train.g`` and ``train.ema``, with ``.backward`` and ``.optim`` children in
the D, R1 and G phases; ``g.forward`` (root when called alone),
``g.mapping``, ``g.synthesis`` and ``g.noise``; ``serve.request`` (root),
``serve.input`` (z's copy) and ``serve.output`` (the images' hand-off to
the host).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import Counter
from typing import Optional

import torch

counters: Counter = Counter()


class Recorder:
    """The spans opened while it is installed, in the order they opened:
    ``(name, parent index or None, root index, thread id, t0_ns, t1_ns)``,
    None in the slot of a span still open.  A root span (no open parent on
    its thread) starts a unit; its children carry its index as `root`."""

    def __init__(self):
        self.spans: list = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _thread(self):
        """This thread's stack of open spans and its id, the id read once
        (a system call, which costs about 0.1 ms on some hosts)."""
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.tid = [], threading.get_native_id()
        return local.stack, local.tid


class _Span:
    __slots__ = ("rec", "name", "stack", "tid", "slot", "t0")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        stack, self.tid = rec._thread()
        self.stack = stack
        with rec._lock:
            i = len(rec.spans)
            rec.spans.append(None)
        parent, root = stack[-1] if stack else (None, i)
        self.slot = (i, parent, root)
        stack.append((i, root))
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        i, parent, root = self.slot
        self.stack.pop()
        self.rec.spans[i] = (self.name, parent, root, self.tid, self.t0, t1)
        return False


_NOOP = contextlib.nullcontext()
_recorder: Optional[Recorder] = None


def span(name: str):
    """A context that records `name` over its body while a recorder is
    installed, and not while ``torch.export`` or ``torch.compile`` traces
    (their graphs hold nothing of it)."""
    rec = _recorder
    if rec is None or torch.compiler.is_compiling():
        return _NOOP
    return _Span(rec, name)


@contextlib.contextmanager
def recording():
    """Installs a recorder for the body (the one it replaces comes back
    after) and yields it; nothing is written."""
    global _recorder
    saved, rec = _recorder, Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = saved


def _add_spans(path: str, spans):
    """Writes the finished spans into the Chrome trace at `path` as
    complete events of category ``program_span``, on its own time base."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": s[0], "pid": pid,
         "tid": s[3], "ts": (s[4] - base) / 1e3, "dur": (s[5] - s[4]) / 1e3,
         "args": {"index": i, "parent": s[1], "root": s[2]}}
        for i, s in enumerate(spans) if s is not None)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """torch.profiler trace if a logdir is given, else a no-op.  On exit the
    trace is written as ``trace-<pid>-<ns>.json`` in `logdir` (created), a
    Chrome trace that Perfetto and chrome://tracing open, also when the
    body raises, as JAX's stop_trace in a finally; the program's spans of
    the body are in it, category ``program_span``.  The context's value is
    the profile (``with trace(d) as prof``: its ``key_averages()``), None
    without a logdir."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    with recording() as rec:
        prof.start()
        try:
            yield prof
        finally:
            prof.stop()
            path = os.path.join(logdir,
                                f"trace-{os.getpid()}-{time.time_ns()}.json")
            prof.export_chrome_trace(path)
            _add_spans(path, rec.spans)


class MetricsWriter:
    """Append-only JSONL metrics file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def write(self, **metrics):
        metrics.setdefault("time", time.time())
        self._f.write(json.dumps(metrics) + "\n")

    def close(self):
        self._f.close()
