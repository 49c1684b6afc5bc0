"""CUDA kernels in the traced stretch per unit (request or update); a training cell in bf16 activations only, whose host-bound runs spread more than float32's and take a bound of their own."""

from gpubench import layer


def read(run):
    return layer.launches(run) if run.entry == "train" \
        and run.precision == "bfloat16" else None
