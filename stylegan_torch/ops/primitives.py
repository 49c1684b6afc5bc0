"""Core StyleGAN generator ops as plain PyTorch functions (the port's
counterpart of ``stylegan_tpu/ops/primitives.py``).

Public layouts are the JAX package's: feature maps are NHWC (B, H, W, C),
noise maps (B, H, W, 1), styles (B, 2C) as [scale | bias].  An NHWC tensor
that is contiguous has the same storage as an NCHW tensor in
``torch.channels_last`` memory format, so `to_nchw` / `to_nhwc` are views and
the convolutions read and write channels-last storage without copies.

Numerical contracts (held against the JAX package in tests/test_torch_ops.py):
  pixel_norm         reference CustomLayers.py:17-23
  upscale2d          reference CustomLayers.py:26-45
  blur2d             reference CustomLayers.py:251-276
  leaky_relu(0.2)    reference GAN.py:67-68
  instance_norm      torch.nn.InstanceNorm2d(affine=False, eps=1e-5)
  truncation         reference CustomLayers.py:308-323
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC view -> NCHW view (channels_last storage when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(y: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC; a view when y is already channels_last."""
    return y.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def _f32_stats(x: torch.Tensor) -> torch.Tensor:
    # statistics accumulate in float32 when activations are bfloat16
    return x.float() if x.dtype == torch.bfloat16 else x


def pixel_norm(x: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """x * rsqrt(mean(x^2, channel) + eps) over the last (channel) axis."""
    ms = torch.mean(torch.square(_f32_stats(x)), dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + epsilon).to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    # where(x >= 0) rather than F.leaky_relu: same gradient at 0 as the JAX op
    return torch.where(x >= 0, x, x * negative_slope)


def upscale2d(x: torch.Tensor, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """Nearest-neighbour upsample of NHWC, optional gain."""
    assert x.ndim == 4
    if gain != 1.0:
        x = x * gain
    if factor == 1:
        return x
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
    return x.reshape(b, h * factor, w * factor, c)


def make_blur_kernel(taps, normalize: bool = True) -> torch.Tensor:
    """Outer-product separable blur kernel, shape (k, k), float32."""
    k = torch.as_tensor(taps, dtype=torch.float32)
    k = k[:, None] * k[None, :]
    if normalize:
        k = k / torch.sum(k)
    return k


def blur2d(x: torch.Tensor, kernel2d: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Depthwise blur of NHWC with a (k, k) kernel, SAME padding."""
    c = x.shape[-1]
    k = kernel2d.shape[0]
    kern = kernel2d.to(x.dtype)[None, None].expand(c, 1, k, k)
    y = F.conv2d(to_nchw(x), kern, stride=stride, padding=(k - 1) // 2,
                 groups=c)
    return to_nhwc(y)


def instance_norm(x: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """Per-sample per-channel spatial normalization of NHWC, no affine,
    biased variance, two-pass float32 statistics."""
    xf = _f32_stats(x)
    mean = torch.mean(xf, dim=(1, 2), keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=(1, 2), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)


def truncate_dlatents(dlatents: torch.Tensor, avg_latent: torch.Tensor,
                      psi, cutoff: int) -> torch.Tensor:
    """Truncation trick: lerp(avg, w, psi) on layers < cutoff.

    dlatents: (B, num_layers, D); avg_latent: (D,)."""
    num_layers = dlatents.shape[1]
    interp = (avg_latent + (dlatents - avg_latent) * psi).to(dlatents.dtype)
    layer_idx = torch.arange(num_layers, device=dlatents.device)[None, :, None]
    return torch.where(layer_idx < cutoff, interp, dlatents)


def update_moving_average(avg: torch.Tensor, new: torch.Tensor,
                          beta: float) -> torch.Tensor:
    """avg <- beta * avg + (1 - beta) * new (reference CustomLayers.py:316-317)."""
    return beta * avg + (1.0 - beta) * new


def style_modulate(x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """AdaIN affine modulation x * (scale + 1) + bias; style (B, 2C) laid out
    as [scales | biases] (reference CustomLayers.py:210-216)."""
    c = x.shape[-1]
    s = style.reshape(style.shape[0], 2, c)
    scale = s[:, 0][:, None, None, :]
    bias = s[:, 1][:, None, None, :]
    return x * (scale + 1.0) + bias


def add_noise(x: torch.Tensor, noise_weight: torch.Tensor,
              noise: torch.Tensor) -> torch.Tensor:
    """x + weight[c] * noise, noise shaped (B, H, W, 1) (CustomLayers.py:191-200)."""
    return x + noise_weight.to(x.dtype) * noise.to(x.dtype)
