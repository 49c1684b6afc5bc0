"""StyleGAN3's filtered leaky ReLU kernel: the device stretch's units' bound, the sum over the forward's filtered calls of max(FLOPs at the float32 peak, bytes at the HBM rate) (counts3.py), over the summed device time of the program's ``filtered_lrelu_kernel*`` kernels in that stretch's trace (the serve3 kind's run.span_trace); None where no such kernel ran."""

import json

from gpubench import counts3

KERNEL = "filtered_lrelu_kernel"


def read(run):
    t, path = run.trace, getattr(run, "span_trace", None)
    if not t or not run.peaks or path is None or not path.is_file():
        return None
    us = sum(e.get("dur", 0) for e in json.loads(path.read_text())
             ["traceEvents"] if e.get("ph") == "X"
             and e.get("cat") == "kernel" and KERNEL in e.get("name", ""))
    if us <= 0:
        return None
    arch = run.config["architecture"]
    a, units = t["traced"][0], t["units"]
    images = sum(f[1] for f in run.unit_flops[a:a + units]) \
        / counts3.serve_image(arch)[1]
    batch = round(images / units)
    bound = sum(max(f / run.peaks[run.precision], b / run.peaks["hbm"])
                for f, b in counts3.filtered_lrelu_calls(arch, batch))
    return 100.0 * units * bound / (us / 1e6)
