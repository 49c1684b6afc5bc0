"""Share of the traced stretch in which no kernel, copy or set ran on the device."""

from gpubench import layer


def read(run):
    return layer.device_idle(run) if run.entry == "serve" else None
