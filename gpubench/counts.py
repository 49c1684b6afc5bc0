"""The yardstick's frozen counts: model FLOPs, convolution FLOPs, the
epilogue kernels' bytes bounds and the card's published peaks.

FLOPs follow StyleGAN's semantic conventions (the same as the program's
``utils/flops.py`` at the time the benchmark was defined, which a CPU test
holds these to): a conv is 2 * H_out * W_out * k * k * Cin * Cout per
image; the fused 2x upscale counts the transposed 4x4 form (4 taps per
output pixel) and the fused downscale the strided 4x4 form (16 taps per
output pixel) from a resolution of 128 on, the resample and a 3x3 conv (9
taps at the larger side) below; the blur is a depthwise 3x3; a dense layer
2 * in * out.  The backward is twice the forward.  A training image costs
3 G forwards and 15 D forwards with R1 in the loss, 9 without (lazy R1 at
interval N amortises (R1 + (N - 1) plain) / N).  `conv` parts count only
the work under a convolution: the mapping network, the styles and D's
dense head are left out.

Bytes: each epilogue call must read its plane and noise once and write its
output once, plus its per-channel parameters and per-(b, c) statistics.
"""

from __future__ import annotations

import math

FUSE_THRESHOLD = 128

# NVIDIA H100 Tensor Core GPU datasheet, SXM5 part: dense rates (half the
# "with sparsity" ones) in FLOP/s and HBM3 bandwidth in bytes/s, at the
# part's 700 W limit.
PEAKS = (
    ("h100 80gb hbm3", {"float32": 67e12, "tf32": 495e12,
                        "bfloat16": 989e12, "hbm": 3.35e12}),
    ("h100 sxm", {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
                  "hbm": 3.35e12}),
)


def peaks(device_name: str):
    """The peaks of the card called `device_name`, or None for a card the
    table does not hold (its rooflines and mfu are then not reported)."""
    name = device_name.lower()
    for tag, p in PEAKS:
        if tag in name:
            return p
    return None


def _nf(arch, stage):
    return min(int(arch["fmap_base"] / 2.0 ** (stage * arch["fmap_decay"])),
               arch["fmap_max"])


def g_forward(arch) -> tuple[int, int]:
    """(all, conv) FLOPs of one image through G at full depth."""
    rlog2 = int(math.log2(arch["resolution"]))
    w = arch["dlatent_size"]
    dense = 0
    fin = arch["latent_size"]
    for i in range(arch["mapping_layers"]):
        fout = (w if i == arch["mapping_layers"] - 1
                else arch["mapping_fmaps"])
        dense += 2 * fin * fout
        fin = fout
    c1 = _nf(arch, 1)
    conv = 2 * 16 * 9 * c1 * c1
    dense += 2 * (2 * w * 2 * c1)
    for r in range(3, rlog2 + 1):
        h = 2 ** r
        cin, cout = _nf(arch, r - 2), _nf(arch, r - 1)
        taps = 4 if h >= FUSE_THRESHOLD else 9
        conv += 2 * h * h * taps * cin * cout
        conv += 2 * h * h * cout * 9
        conv += 2 * h * h * 9 * cout * cout
        dense += 2 * (2 * w * 2 * cout)
    conv += (2 * arch["resolution"] ** 2 * _nf(arch, rlog2 - 1)
             * arch["num_channels"])
    return conv + dense, conv


def d_forward(arch) -> tuple[int, int]:
    """(all, conv) FLOPs of one image through D at full depth."""
    rlog2 = int(math.log2(arch["resolution"]))
    conv = (2 * arch["resolution"] ** 2 * arch["num_channels"]
            * _nf(arch, rlog2 - 1))
    for r in range(rlog2, 2, -1):
        h = 2 ** r
        cin, cout = _nf(arch, r - 1), _nf(arch, r - 2)
        conv += 2 * h * h * 9 * cin * cin
        conv += 2 * h * h * cin * 9
        taps = 16 if h >= FUSE_THRESHOLD else 9 * 4
        conv += 2 * (h // 2) * (h // 2) * taps * cin * cout
    c2 = _nf(arch, 2)
    conv += 2 * 16 * 9 * (c2 + arch["mbstd_num_features"]) * c2
    dense = 2 * (c2 * 16) * c2 + 2 * c2
    return conv + dense, conv


def serve_image(arch) -> tuple[int, int]:
    """(all, conv) FLOPs of one served image."""
    return g_forward(arch)


def train_image(arch, with_r1: bool) -> tuple[int, int]:
    """(all, conv) FLOPs of one image of a logistic train step."""
    g, d = g_forward(arch), d_forward(arch)
    mult = 15 if with_r1 else 9
    return tuple(3 * gi + mult * di for gi, di in zip(g, d))


# bytes each epilogue op must move, by the op's name, from its first
# input's (B, H, W, C) shape and element size
def _fwd(b, n, c, es):
    return es * n * (2 * c + 1) + 4 * (c + 2 * b * c)


def _bwd(b, n, c, es):
    return es * (3 * n * c + n) + 4 * (2 * c + 4 * b * c + 2 * b * c)


EPILOGUE_BYTES = {
    "stylegan_torch::epilogue": _fwd,
    # the forward that also writes the (B, C, 2) float32 (mean, rstd)
    "stylegan_torch::epilogue_train":
        lambda b, n, c, es: _fwd(b, n, c, es) + 8 * b * c,
    "stylegan_torch::epilogue_backward": _bwd,
    "stylegan_torch::epilogue_partial":
        lambda b, n, c, es: es * n * (c + 1) + 4 * (c + 2 * b * c),
    "stylegan_torch::epilogue_apply":
        lambda b, n, c, es: _fwd(b, n, c, es) + 8 * b * c,
    "stylegan_torch::epilogue_backward_partial":
        lambda b, n, c, es: es * (2 * n * c + n) + 4 * (c + 6 * b * c),
    "stylegan_torch::epilogue_backward_apply":
        lambda b, n, c, es: es * (3 * n * c + n) + 4 * (2 * c + 6 * b * c),
}


def epilogue_bytes(op: str, shape, itemsize: int):
    """Bytes an epilogue op on a (B, H, W, C) plane must move, or None for
    an op the table does not hold."""
    f = EPILOGUE_BYTES.get(op)
    if f is None or len(shape) != 4:
        return None
    b, h, w, c = shape
    return f(b, b * h * w, c, itemsize)
