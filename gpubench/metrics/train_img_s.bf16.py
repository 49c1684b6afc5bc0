"""Images of every update in the window (batch x updates) over its wall time, which ends in a device synchronize; a training cell in bf16 activations only, whose host-bound runs spread more than float32's and take a bound of their own."""

from gpubench import layer


def read(run):
    return layer.img_per_s(run) if run.entry == "train" \
        and run.precision == "bfloat16" else None
