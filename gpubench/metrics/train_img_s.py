"""Images of every update in the window (batch x updates) over its wall time, which ends in a device synchronize."""

from gpubench import layer


def read(run):
    return layer.img_per_s(run) if run.entry == "train" else None
