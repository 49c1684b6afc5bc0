"""The per-layer and end-to-end quantities the readers in ``metrics/``
return, from a finished Run (drive.py) and its traced stretch (trace.py).
Each returns None where the run holds nothing to read.
"""

from __future__ import annotations

import statistics


def setup_s(run):
    return run.setup_s


def img_per_s(run):
    return run.images / run.window_s if run.window_s > 0 else None


def p95_ms(run):
    lat = run.latencies_s
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3


def device_idle(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(run):
    """Model FLOPs of the window's units over its wall time, as a share of
    the dense peak of the precision the convolutions compute in; in a
    traced run, of the units the profiler did not slow."""
    units, wall = run.unit_flops, run.window_s
    if run.trace:
        a, b = run.trace["traced"]
        units, wall = units[:a] + units[b:], wall - run.trace["traced_host_s"]
    if not run.peaks or wall <= 0 or not units:
        return None
    return 100.0 * sum(f[0] for f in units) / wall / run.peaks[run.precision]


def conv_roofline(run):
    """The traced units' convolution FLOPs over the device time of the
    kernels under convolution ops, as a share of the peak."""
    t = run.trace
    if not t or not run.peaks or t["conv_s"] <= 0:
        return None
    a, b = t["ops_range"]
    flops = sum(f[1] for f in run.unit_flops[a:b])
    return 100.0 * flops / t["conv_s"] / run.peaks[run.precision]


def epilogue_roofline(run):
    """The epilogue calls' bytes bound at the card's HBM bandwidth over
    the device time of the kernels under the epilogue ops."""
    t = run.trace
    if not t or not run.peaks or t["epilogue_s"] <= 0 \
            or not t["epilogue_bytes"]:
        return None
    return 100.0 * t["epilogue_bytes"] / run.peaks["hbm"] / t["epilogue_s"]


def launches(run):
    t = run.trace
    if not t or not t["units"]:
        return None
    return t["kernels"] / t["units"]
