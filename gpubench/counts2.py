"""The yardstick's frozen counts for StyleGAN2's skip generator: model
FLOPs, convolution FLOPs and the layer epilogue's bytes bound (the peaks
are ``counts.PEAKS``).

FLOPs count the TF original's work (the same as the program's
``utils/flops.py::stylegan2_forward_flops`` when the benchmark was
defined, which a CPU test holds these to): a modulated 3x3 conv
2 * H * W * 9 * Cin * Cout per image, toRGB the same at 1x1; the
up-convolution as the transposed 3x3, 2 * (H/2)^2 * 9 * Cin * Cout, and its
FIR as upfirdn_2d applies it, a depthwise 4x4 filter, 2 * H^2 * 16 * Cout;
the skip output's upsample the 4 taps of the 4x4 filter that meet a
sample, 2 * H^2 * 4 * C; dense layers 2 * in * out (the mapping, each
layer's style affine).  `conv` is the part under a convolution: all but
the dense layers.  Element-wise work (modulation, demodulation, the
epilogue) is not counted.  Config F at 1024^2: 150.67 GFLOP an image,
150.66 under a convolution, 148.52 of that the 3x3 convolutions, the
transposed ones and the toRGBs.

Bytes: each epilogue call must read its plane once and write its output
once, and read one noise value a pixel, the bias and the strength.
"""

from __future__ import annotations

import math


def _nf(arch, stage):
    return min(int(arch["fmap_base"] / 2.0 ** (stage * arch["fmap_decay"])),
               arch["fmap_max"])


def g_forward(arch) -> tuple[int, int]:
    """(all, conv) FLOPs of one image through G at full resolution."""
    rlog2 = int(math.log2(arch["resolution"]))
    w, rgb = arch["dlatent_size"], arch["num_channels"]
    taps = len(arch["resample_filter"])
    dense = 0
    fin = arch["latent_size"]
    for i in range(arch["mapping_layers"]):
        fout = w if i == arch["mapping_layers"] - 1 else arch["mapping_fmaps"]
        dense += 2 * fin * fout
        fin = fout
    c1 = _nf(arch, 1)
    conv = 2 * 16 * 9 * c1 * c1 + 2 * 16 * c1 * rgb
    dense += 2 * w * (c1 + c1)
    for r in range(3, rlog2 + 1):
        h = 2 ** r
        cin, cout = _nf(arch, r - 2), _nf(arch, r - 1)
        conv += 2 * (h // 2) ** 2 * 9 * cin * cout
        conv += 2 * h * h * taps ** 2 * cout
        conv += 2 * h * h * 9 * cout * cout
        conv += 2 * h * h * cout * rgb
        conv += 2 * h * h * (taps // 2) ** 2 * rgb
        dense += 2 * w * (cin + cout + cout)
    return conv + dense, conv


def serve_image(arch) -> tuple[int, int]:
    """(all, conv) FLOPs of one served image."""
    return g_forward(arch)


def epilogue2_bytes(b: int, h: int, w: int, c: int, itemsize: int) -> int:
    """Bytes one epilogue call on a (B, C, H, W) plane of `itemsize`-byte
    elements must move."""
    n = b * h * w
    return itemsize * (2 * n * c + n) + 4 * (c + 1)


def epilogue2_shapes(arch):
    """(H, C) of each epilogue call of one forward, in order."""
    out = [(4, _nf(arch, 1))]
    for r in range(3, int(math.log2(arch["resolution"])) + 1):
        out += [(2 ** r, _nf(arch, r - 1))] * 2
    return out


def epilogue2_forward_bytes(arch, batch: int, itemsize: int) -> int:
    """The bytes bound of every epilogue call of one forward at `batch`."""
    return sum(epilogue2_bytes(batch, h, h, c, itemsize)
               for h, c in epilogue2_shapes(arch))
