"""Seconds from the process's start to the first timed unit: imports, the kernel library (built once per checkout), weights, inputs, the warm-up."""

from gpubench import layer


def read(run):
    return layer.setup_s(run)
