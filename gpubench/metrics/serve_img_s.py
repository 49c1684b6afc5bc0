"""Images of every request completed in the window over its wall time."""

from gpubench import layer


def read(run):
    return layer.img_per_s(run) if run.entry == "serve" else None
