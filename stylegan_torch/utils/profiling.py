"""Observability hooks (the port's copy of
``stylegan_tpu/utils/profiling.py``).

* ``trace(logdir)`` — context manager around ``torch.profiler`` that writes
  a Chrome/Perfetto trace JSON (CPU ops, and the card's kernels when CUDA is
  available) into `logdir`.
* ``StepTimer`` — cheap host-side step timing with EMA smoothing and img/s.
* ``MetricsWriter`` — JSONL metrics stream (one dict per line) that tools can
  tail; doubles as the trainer's machine-readable log.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """torch.profiler trace if a logdir is given, else a no-op.  On exit the
    trace is written as ``trace-<pid>-<ns>.json`` in `logdir` (created), a
    Chrome trace that Perfetto and chrome://tracing open, also when the
    body raises, as JAX's stop_trace in a finally.  The context's value is
    the profile (``with trace(d) as prof``: its ``key_averages()``), None
    without a logdir."""
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class StepTimer:
    def __init__(self, smoothing: float = 0.9):
        self.smoothing = smoothing
        self._last = None
        self.ema_step_time = None

    def tick(self) -> Optional[float]:
        """Call once per step; returns smoothed step time (seconds) or None."""
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            if self.ema_step_time is None:
                self.ema_step_time = dt
            else:
                self.ema_step_time = (self.smoothing * self.ema_step_time
                                      + (1 - self.smoothing) * dt)
        self._last = now
        return self.ema_step_time

    def images_per_sec(self, batch_size: int) -> Optional[float]:
        if not self.ema_step_time:
            return None
        return batch_size / self.ema_step_time


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
