"""The yardstick's frozen counts for StyleGAN3-T's generator: model FLOPs,
convolution FLOPs, and each filtered leaky ReLU call's FLOPs and bytes (the
peaks are ``counts.PEAKS``).

FLOPs count the published network's work at the schedule of
``reference/nets3.py`` (the same as the program's own counts,
``ops/kernels/filtered_lrelu.py::flops`` and ``bytes_moved``, when the
benchmark was defined, which a CPU test holds these to): a modulated
convolution with padding k - 1 on an s^2 input 2 * cin * cout * k^2 *
(s + k - 1)^2 an image; dense layers 2 * in * out (the mapping, each
layer's style affine, the input's transform affine); the input's
channels x channels mapping 2 * size^2 * C^2.  `conv` is the modulated
convolutions alone.  Element-wise work (the Fourier features, modulation,
demodulation) is not counted, nor the filtered leaky ReLU's taps, which
`filtered_lrelu_calls` counts apart: the separable passes' taps, 2
operations each, the up filter's polyphase taps (taps / up a sample) down
the columns of its input and along the rows of the oversampled plane, the
down filter's along those rows and down the output's columns.  StyleGAN3-T
at 1024^2: 570.45 GFLOP of convolutions an image, 571.13 in all; the 14
filtered calls 44.63 GFLOP and 2.084 GB an image.

Bytes: a filtered call must read its input plane and write its output
plane once, and read the bias.
"""

from __future__ import annotations

from gpubench.reference import nets3


def g_forward(arch) -> tuple[int, int]:
    """(all, conv) FLOPs of one image through G."""
    (c, size, _, _), layers = nets3.schedule(arch)
    w = arch["dlatent_size"]
    dense, fin = 0, arch["latent_size"]
    for _ in range(arch["mapping_layers"]):
        dense += 2 * fin * w
        fin = w
    dense += 2 * w * 4 + 2 * size * size * c * c
    conv = 0
    for lay in layers:
        k = lay["k"]
        conv += 2 * lay["cin"] * lay["cout"] * k * k * (
            lay["in_size"] + k - 1) ** 2
        dense += 2 * w * lay["cin"]
    return conv + dense, conv


def serve_image(arch) -> tuple[int, int]:
    """(all, conv) FLOPs of one served image."""
    return g_forward(arch)


def filtered_lrelu_calls(arch, batch: int) -> list:
    """(FLOPs, bytes) of each filtered leaky ReLU call (the layers with
    filters) of one forward at `batch`."""
    _, layers = nets3.schedule(arch)
    out = []
    for lay in layers:
        if lay["fu"] is None:
            continue
        up, down = lay["up"], lay["down"]
        ku, kd = lay["fu"].numel(), lay["fd"].numel()
        lo, hi = lay["padding"]
        n = lay["in_size"] + lay["k"] - 1
        t = n * up + lo + hi - ku + 1
        o = lay["out_size"]
        c = lay["cout"]
        flops = 2 * batch * c * (t * n * (ku // up) + t * t * (ku // up)
                                 + t * o * kd + o * o * kd)
        out.append((flops, 4 * (batch * c * (n * n + o * o) + c)))
    return out
