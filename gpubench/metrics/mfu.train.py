"""Model FLOPs of the window's units over its wall time, against the card's dense peak in the configuration's precision."""

from gpubench import layer


def read(run):
    return layer.mfu(run) if run.entry == "train" else None
