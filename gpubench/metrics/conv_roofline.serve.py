"""Convolution FLOPs of the traced units (blur included) over the device time of kernels under convolution ops, against the peak."""

from gpubench import layer


def read(run):
    return layer.conv_roofline(run) if run.entry == "serve" else None
