"""CUDA kernels in the traced stretch per unit (request or update)."""

from gpubench import layer


def read(run):
    return layer.launches(run) if run.entry == "train" else None
