"""Equalized-learning-rate linear and convolution ops (the port's counterpart
of ``stylegan_tpu/ops/linear.py``).

Parameters are stored at unit-ish scale and multiplied by a constant ``w_mul``
at apply time (reference: models/CustomLayers.py:79-180).  Weights keep the
reference's torch layouts: dense (out, in), conv OIHW.  Activations are NHWC
at the public functions and channels-last NCHW inside the convolutions.

The convolutions are PyTorch's (cuDNN on the card), as the JAX package left
them to XLA.  Only the unpacked upscale and same-size branches of the JAX
``conv2d_apply`` are here; the downscale branches arrive with the
discriminator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .primitives import blur2d, to_nchw, to_nhwc, upscale2d


def equalized_scales(gain: float, fan_in: int, lrmul: float,
                     use_wscale: bool) -> tuple[float, float]:
    """Return (init_std, w_mul) per the reference rule (CustomLayers.py:84-91)."""
    he_std = gain * fan_in ** (-0.5)
    if use_wscale:
        return 1.0 / lrmul, he_std * lrmul
    return he_std / lrmul, lrmul


def linear_apply(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 gain: float = math.sqrt(2), use_wscale: bool = False,
                 lrmul: float = 1.0) -> torch.Tensor:
    """Equalized dense layer; weight (out, in)."""
    _, w_mul = equalized_scales(gain, weight.shape[1], lrmul, use_wscale)
    if bias is not None:
        bias = (bias * lrmul).to(x.dtype)
    return F.linear(x, (weight * w_mul).to(x.dtype), bias)


def conv2d_apply(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 gain: float = math.sqrt(2), use_wscale: bool = False,
                 lrmul: float = 1.0, upscale: bool = False,
                 blur_kernel: Optional[torch.Tensor] = None,
                 fused_resample_threshold: int = 128) -> torch.Tensor:
    """Equalized conv of NHWC x with weight (O, I, k, k), SAME padding.

    Dispatch mirrors CustomLayers.py:137-180: with `upscale`, an output
    resolution >= threshold takes the fused transposed conv on the 4-tap
    summed kernel, a smaller one nearest-upsamples and then convolves.
    `blur_kernel` (the G path) sits between the conv and the bias add.
    """
    _, in_ch, kh, kw = weight.shape
    _, w_mul = equalized_scales(gain, in_ch * kh * kw, lrmul, use_wscale)
    w = (weight * w_mul).to(x.dtype)
    if bias is not None:
        bias = (bias * lrmul).to(x.dtype)

    if upscale and min(x.shape[1], x.shape[2]) * 2 >= fused_resample_threshold:
        y = _fused_upscale_conv(x, w)
    else:
        if upscale:
            x = upscale2d(x)
        y = to_nhwc(F.conv2d(to_nchw(x), w, padding=(kh - 1) // 2))
    if blur_kernel is not None:
        y = blur2d(y, blur_kernel)
    if bias is not None:
        y = y + bias
    return y


def _fused_upscale_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Transposed conv, stride 2, padding 1, with the 4-tap-summed 4x4 kernel
    (reference CustomLayers.py:146-151).  conv_transpose2d takes the kernel
    un-flipped, laid out (in, out, kh, kw)."""
    wp = F.pad(w, (1, 1, 1, 1))
    w4 = (wp[:, :, 1:, 1:] + wp[:, :, :-1, 1:]
          + wp[:, :, 1:, :-1] + wp[:, :, :-1, :-1])
    y = F.conv_transpose2d(to_nchw(x), w4.transpose(0, 1), stride=2, padding=1)
    return to_nhwc(y)


def _randn(shape, std, generator):
    return torch.randn(shape, generator=generator) * std


class EqualizedLinear(nn.Module):
    """Dense layer with runtime weight scaling; `weight` (out, in)."""

    def __init__(self, in_dim: int, out_dim: int, gain: float = math.sqrt(2),
                 use_wscale: bool = False, lrmul: float = 1.0,
                 bias: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init_std, _ = equalized_scales(gain, in_dim, lrmul, use_wscale)
        self.gain, self.use_wscale, self.lrmul = gain, use_wscale, lrmul
        self.weight = nn.Parameter(_randn((out_dim, in_dim), init_std,
                                          generator))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_apply(x, self.weight, self.bias, gain=self.gain,
                            use_wscale=self.use_wscale, lrmul=self.lrmul)


class EqualizedConv2d(nn.Module):
    """Square conv with runtime weight scaling; `weight` OIHW, NHWC in/out."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 gain: float = math.sqrt(2), use_wscale: bool = False,
                 lrmul: float = 1.0, bias: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init_std, _ = equalized_scales(gain, in_ch * kernel_size ** 2, lrmul,
                                       use_wscale)
        self.gain, self.use_wscale, self.lrmul = gain, use_wscale, lrmul
        self.weight = nn.Parameter(_randn(
            (out_ch, in_ch, kernel_size, kernel_size), init_std, generator))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor, upscale: bool = False,
                blur_kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
        return conv2d_apply(x, self.weight, self.bias, gain=self.gain,
                            use_wscale=self.use_wscale, lrmul=self.lrmul,
                            upscale=upscale, blur_kernel=blur_kernel)
