"""Analytic model-FLOP accounting for MFU reporting (the port's copy of
``stylegan_tpu/utils/flops.py``: the same counts, and NVIDIA's peaks in
place of the TPU table).

Counts the *semantic* work of the reference architecture (StyleGAN.pytorch
models/Blocks.py + CustomLayers.py), independent of how the convolutions
run, so `mfu` is model-FLOP utilization.

Conventions (the same as the JAX package's, so the two count alike):

* conv: FLOPs = 2 * H_out * W_out * kh * kw * Cin * Cout per image.
* fused up/down-scale convs count the transposed/strided form (the expanded
  4x4 kernel = 4 taps per output pixel upscaling, 16 per output pixel
  downscaling) when the stage resolution >= 128 — the threshold at which
  the port (``ops/linear.py::conv2d_apply``) and the reference
  (CustomLayers.py:124-178) take the fused kernel — and the unfused
  resample+3x3 form (9 taps at the larger resolution) below it.  FFHQ-1024
  G forward = 64.5 GFLOP/img.
* blur: depthwise 3x3 = 2 * H * W * C * 9.
* dense: 2 * in * out; per-layer style mods are dense dlatent -> 2C.
* backward = 2x forward (grad wrt inputs + grad wrt weights), the standard
  MFU convention (e.g. PaLM appendix B).

Train-step multipliers (per image of batch, d_repeats=1; see
train/steps.py for the step structure):

  D phase: G fwd (shared with the G phase)                   1 F_G
           D fwd on reals+fakes                              2 F_D
           D bwd                                             4 F_D
  G phase: D fwd on fakes (updated D params)                 1 F_D
           (+1 F_D more for relativistic losses: the gen
            loss re-scores reals too, Losses.py:106-119)
           D bwd to the fake images                          2 F_D
           G bwd                                             2 F_G

  logistic gamma=0:            3 F_G +  9 F_D
  logistic + in-loss R1:       3 F_G + 15 F_D   (R1's grad-of-grad: inner
                               input-grad 2 F_D + differentiating through
                               that composite ~4 F_D; the D(real) forward is
                               shared with the main loss's)
  relativistic-hinge:          3 F_G + 10 F_D

Lazy R1 at interval N amortizes: (r1_step + (N-1) * plain_step) / N.
"""

from __future__ import annotations

import math
from typing import Optional


def _nf(stage: int, fmap_base: int = 8192, fmap_decay: float = 1.0,
        fmap_max: int = 512) -> int:
    return min(int(fmap_base / (2.0 ** (stage * fmap_decay))), fmap_max)


_FUSE_THRESHOLD = 128  # resolution threshold, ops/linear.py::conv2d_apply /
#                        reference CustomLayers.py:124-178


def generator_forward_flops(resolution: int, *, latent_size: int = 512,
                            dlatent_size: int = 512, mapping_layers: int = 8,
                            mapping_fmaps: int = 512, num_channels: int = 3,
                            fmap_base: int = 8192, fmap_decay: float = 1.0,
                            fmap_max: int = 512) -> int:
    """Per-image forward FLOPs of the full generator (mapping + synthesis +
    to_rgb) at full depth.  Default args = the reference FFHQ configuration;
    1024 -> 64.5 GFLOP."""
    def nf(s):
        return _nf(s, fmap_base, fmap_decay, fmap_max)
    rlog2 = int(math.log2(resolution))
    f = 0
    # mapping network
    for i in range(mapping_layers):
        fin = latent_size if i == 0 else mapping_fmaps
        fout = dlatent_size if i == mapping_layers - 1 else mapping_fmaps
        f += 2 * fin * fout
    # input block: conv3x3 at 4x4 + 2 style denses
    c1 = nf(1)
    f += 2 * 16 * 9 * c1 * c1 + 2 * (2 * dlatent_size * 2 * c1)
    # growth blocks: upscale-conv, blur, conv3x3, 2 style denses
    for r in range(3, rlog2 + 1):
        h = 2 ** r
        cin, cout = nf(r - 2), nf(r - 1)
        up_taps = 4 if h >= _FUSE_THRESHOLD else 9
        f += 2 * h * h * up_taps * cin * cout
        f += 2 * h * h * cout * 9              # blur
        f += 2 * h * h * 9 * cout * cout       # conv1
        f += 2 * (2 * dlatent_size * 2 * cout)
    f += 2 * resolution * resolution * nf(rlog2 - 1) * num_channels  # to_rgb
    return f


def discriminator_forward_flops(resolution: int, *, num_channels: int = 3,
                                fmap_base: int = 8192, fmap_decay: float = 1.0,
                                fmap_max: int = 512,
                                mbstd_num_features: int = 1) -> int:
    """Per-image forward FLOPs of the discriminator at full depth."""
    def nf(s):
        return _nf(s, fmap_base, fmap_decay, fmap_max)
    rlog2 = int(math.log2(resolution))
    f = 2 * resolution * resolution * num_channels * nf(rlog2 - 1)  # from_rgb
    for r in range(rlog2, 2, -1):
        h = 2 ** r
        cin, cout = nf(r - 1), nf(r - 2)
        f += 2 * h * h * 9 * cin * cin          # conv0
        f += 2 * h * h * cin * 9                # blur
        down_taps = 16 if h >= _FUSE_THRESHOLD else 9 * 4
        f += 2 * (h // 2) * (h // 2) * down_taps * cin * cout  # conv1_down
    c2 = nf(2)
    f += 2 * 16 * 9 * (c2 + mbstd_num_features) * c2   # top conv
    f += 2 * (c2 * 16) * c2 + 2 * c2 * 1               # top denses
    return f


def train_step_flops(resolution: int, *, loss: str = "logistic",
                     with_r1: bool = True, **arch) -> int:
    """Per-image FLOPs of the fused train step (d_repeats=1).  See the
    module docstring for the multiplier derivation."""
    fg = generator_forward_flops(resolution, **{
        k: v for k, v in arch.items() if k != "mbstd_num_features"})
    fd = discriminator_forward_flops(resolution, **{
        k: v for k, v in arch.items()
        if k in ("num_channels", "fmap_base", "fmap_decay", "fmap_max",
                 "mbstd_num_features")})
    if loss == "logistic":
        d_mult = 15 if with_r1 else 9
    elif loss in ("relativistic-hinge", "relativistic-average-hinge"):
        d_mult = 10
    else:  # standard-gan / hinge: gen loss scores fakes only
        d_mult = 9
    return 3 * fg + d_mult * fd


def lazy_r1_amortized_flops(resolution: int, interval: int, **arch) -> float:
    """Amortized per-image FLOPs of lazy R1 at the given interval."""
    r1 = train_step_flops(resolution, loss="logistic", with_r1=True, **arch)
    plain = train_step_flops(resolution, loss="logistic", with_r1=False,
                             **arch)
    return (r1 + (interval - 1) * plain) / interval


# Dense peak TFLOP/s by card and precision, from NVIDIA's H100 Tensor Core
# GPU datasheet: the tensor-core figures are half of its "with sparsity"
# ones.  float32 is the CUDA cores' rate, the one the port's default policy
# (TF32 off, ops/precision.py) runs at; tf32 and bfloat16 the tensor cores'.
# Matched against torch.cuda.get_device_name ("NVIDIA H100 80GB HBM3" is
# the SXM5 part); another H100 (NVL) has other peaks and is not matched.
_SXM = {"float32": 67.0, "tf32": 494.7, "bfloat16": 989.4}
PEAK_TFLOPS = (
    ("h100 80gb hbm3", _SXM), ("h100 sxm", _SXM),
    ("h100 pcie", {"float32": 51.0, "tf32": 378.0, "bfloat16": 756.0}),
)
PRECISIONS = ("float32", "tf32", "bfloat16")


def peak_tflops_for(name: str, precision: str = "float32") -> Optional[float]:
    """The dense peak of the card called `name` at `precision`, or None for
    a card the table does not hold."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}: one of "
                         f"{PRECISIONS}")
    name = name.lower()
    for tag, peaks in PEAK_TFLOPS:
        if tag in name:
            return peaks[precision]
    return None


def device_peak_tflops(device=None,
                       precision: str = "float32") -> Optional[float]:
    """Dense peak TFLOP/s of a CUDA device (None = the current one) at
    `precision` ('float32', 'tf32' or 'bfloat16'); None when there is no
    card or its name is not in the table (mfu is then omitted).  A run's
    MFU reads against its config's ``precision.activations``: 'bfloat16'
    (the tensor cores) for bf16 activations, else 'float32' (the CUDA
    cores, as the float32 path runs with TF32 off)."""
    import torch
    if not torch.cuda.is_available():
        return None
    return peak_tflops_for(torch.cuda.get_device_name(device), precision)


def mfu_fields(imgs_per_sec: float, flops_per_img: float,
               peak_tflops: Optional[float]) -> dict:
    """The JSON fields a throughput report attaches to each metric."""
    tps = imgs_per_sec * flops_per_img / 1e12
    out = {"gflops_per_img": round(flops_per_img / 1e9, 2),
           "tflops_per_sec": round(tps, 2)}
    if peak_tflops:
        out["mfu"] = round(tps / peak_tflops, 4)
    return out
