"""Model FLOPs of the window's units over its wall time, against the card's dense peak in the configuration's precision; a training cell in bf16 activations only, whose host-bound runs spread more than float32's and take a bound of their own."""

from gpubench import layer


def read(run):
    return layer.mfu(run) if run.entry == "train" \
        and run.precision == "bfloat16" else None
