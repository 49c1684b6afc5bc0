"""The 95th percentile of every window request's latency, call to images in host memory."""

from gpubench import layer


def read(run):
    return layer.p95_ms(run) if run.entry == "serve" else None
