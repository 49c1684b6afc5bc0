"""StyleGAN2's up-convolution kernel: the up-convolutions' FLOPs of the device stretch's units (counts2.py's transposed 3x3s, 2 * (H/2)^2 * 9 * Cin * Cout an image) over the summed device time of the program's ``modconv_up_kernel*`` kernels in that stretch's trace (the serve2 kind's run.span_trace), against the peak; None where no such kernel ran."""

import json
import math

from gpubench import counts2

KERNEL = "modconv_up_kernel"


def up_flops(arch) -> int:
    """The up-convolutions' FLOPs of one image at full resolution."""
    return sum(2 * 2 ** (2 * r - 2) * 9 * counts2._nf(arch, r - 2)
               * counts2._nf(arch, r - 1)
               for r in range(3, int(math.log2(arch["resolution"])) + 1))


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
    a = t["traced"][0]
    images = sum(f[1] for f in run.unit_flops[a:a + t["units"]]) \
        / counts2.serve_image(arch)[1]
    return 100.0 * images * up_flops(arch) / (us / 1e6) \
        / run.peaks[run.precision]
