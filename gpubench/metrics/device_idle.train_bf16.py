"""Share of the traced stretch in which no kernel, copy or set ran on the device; a training cell in bf16 activations only, whose host-bound runs spread more than float32's and take a bound of their own."""

from gpubench import layer


def read(run):
    return layer.device_idle(run) if run.entry == "train" \
        and run.precision == "bfloat16" else None
