"""The epilogue calls' bytes bound at the HBM bandwidth over the device time of kernels under the epilogue ops; a training cell in bf16 activations only, whose host-bound runs spread more than float32's and take a bound of their own."""

from gpubench import layer


def read(run):
    return layer.epilogue_roofline(run) if run.entry == "train" \
        and run.precision == "bfloat16" else None
