"""The epilogue calls' bytes bound at the HBM bandwidth over the device time of kernels under the epilogue ops."""

from gpubench import layer


def read(run):
    return layer.epilogue_roofline(run) if run.entry == "train" else None
