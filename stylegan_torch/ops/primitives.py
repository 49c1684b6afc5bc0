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
  downscale2d        reference CustomLayers.py:48-76
  blur2d             reference CustomLayers.py:251-276
  leaky_relu(0.2)    reference GAN.py:67-68
  instance_norm      torch.nn.InstanceNorm2d(affine=False, eps=1e-5)
  minibatch_stddev   reference CustomLayers.py:288-305
  truncation         reference CustomLayers.py:308-323
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import halo
from ..parallel.distributed import all_gather
from ..parallel.mesh import Mesh


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


def avg_pool2d(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average pool of NHWC with window == stride == factor."""
    return to_nhwc(F.avg_pool2d(to_nchw(x), factor))


def downscale2d(x: torch.Tensor, factor: int = 2,
                gain: float = 1.0) -> torch.Tensor:
    """gain * factor x factor average pooling of NHWC (the reference's
    [sqrt(g)/2]^2 blur with stride 2 is exactly that for factor 2)."""
    assert x.ndim == 4
    out = avg_pool2d(x, factor) if factor > 1 else x
    return out if gain == 1.0 else out * gain


def make_blur_kernel(taps, normalize: bool = True) -> torch.Tensor:
    """Outer-product separable blur kernel, shape (k, k), float32."""
    k = torch.as_tensor(taps, dtype=torch.float32)
    k = k[:, None] * k[None, :]
    if normalize:
        k = k / torch.sum(k)
    return k


def _depthwise(x: torch.Tensor, kernel2d: torch.Tensor,
               padding=None) -> torch.Tensor:
    # the grouped convolution itself, padding (rows, columns); SAME for an
    # odd kernel by default
    c, k = x.shape[-1], kernel2d.shape[0]
    if padding is None:
        padding = (k // 2, k // 2)
    kern = kernel2d.to(x.dtype)[None, None].expand(c, 1, k, k)
    return to_nhwc(F.conv2d(to_nchw(x), kern, padding=padding, groups=c))


class _Blur(torch.autograd.Function):
    """The blur as a linear map with a constant kernel, padding (rows,
    columns): its gradient is the blur with the flipped kernel and padding
    k - 1 - p, itself a _Blur, so every order of derivative (R1's double
    backward through D) is one depthwise convolution.  Autograd of the
    grouped conv instead runs its double backward one channel at a time.
    SAME padding is (p, p) for p = (k - 1) / 2, its own adjoint's; a slab
    that holds its halo rows pads its columns only, (0, p)."""

    @staticmethod
    def forward(ctx, x, kernel2d, padding):
        ctx.save_for_backward(kernel2d)
        ctx.padding = padding
        return _depthwise(x, kernel2d, padding)

    @staticmethod
    def backward(ctx, g):
        (kernel2d,) = ctx.saved_tensors
        k = kernel2d.shape[0]
        return _Blur.apply(g, kernel2d.flip(0, 1),
                           tuple(k - 1 - p for p in ctx.padding)), None, None


def blur2d(x: torch.Tensor, kernel2d: torch.Tensor,
           spatial=None) -> torch.Tensor:
    """Depthwise blur of NHWC with a constant (k, k) kernel, k odd, SAME
    padding, stride 1 (the only blur the networks run).  With `spatial` (a
    parallel.halo.SpatialContext) x is this rank's slab of rows: it takes
    its neighbours' rows first."""
    if not kernel2d.shape[0] % 2:
        raise ValueError(f"blur2d needs an odd kernel, got {kernel2d.shape[0]}")
    p = kernel2d.shape[0] // 2
    if spatial is not None:
        return _Blur.apply(halo.exchange_halo(x, spatial, p),
                           kernel2d.detach(), (0, p))
    return _Blur.apply(x, kernel2d.detach(), (p, p))


def moments(y: torch.Tensor) -> torch.Tensor:
    """(B, C, 2): the per-(b, c) mean of NHWC y over its rows and columns
    and the sum of squared deviations from it (M2), two passes."""
    mean = torch.mean(y, dim=(1, 2), keepdim=True)
    m2 = torch.sum(torch.square(y - mean), dim=(1, 2))
    return torch.stack([mean[:, 0, 0], m2], dim=-1)


def merge_moments(parts: torch.Tensor, rows: int):
    """(mean, M2, count) of a plane from its n slabs' (mean, M2), `parts`
    (n, B, C, 2), each over `rows` rows: Chan's pairwise formula in rank
    order, so every rank that merges the same parts gets the same bits.
    Never sums and sums of squares, which cancel over large planes."""
    mean, m2 = parts[0, ..., 0], parts[0, ..., 1]
    count = rows
    for k in range(1, parts.shape[0]):
        f = rows / (count + rows)
        d = parts[k, ..., 0] - mean
        mean = mean + d * f
        m2 = m2 + parts[k, ..., 1] + d * d * (count * f)
        count += rows
    return mean, m2, count


def instance_norm(x: torch.Tensor, epsilon: float = 1e-5,
                  spatial=None) -> torch.Tensor:
    """Per-sample per-channel spatial normalization of NHWC, no affine,
    biased variance, two-pass float32 statistics.  With `spatial` x is this
    rank's slab of rows; the slabs' statistics are gathered and merged."""
    xf = _f32_stats(x)
    if spatial is not None:
        mean, m2, count = merge_moments(
            halo.all_gather(moments(xf), spatial), x.shape[1] * x.shape[2])
        rstd = torch.rsqrt(m2 / count + epsilon)
        return ((xf - mean[:, None, None]) * rstd[:, None, None]).to(x.dtype)
    mean = torch.mean(xf, dim=(1, 2), keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=(1, 2), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)


def _stddev_feature(y: torch.Tensor, group_size: int, f: int) -> torch.Tensor:
    """The (B, H, W, f) stddev feature map of one batch (float32 in and out).

    Reference grouping (CustomLayers.py:294-305): reshape (g, B//g, ...), so
    group s holds the batch indices {s, s + B//g, ...}: strided groups."""
    b, h, w, c = y.shape
    g = min(group_size, b)
    if b % g:
        raise ValueError(f"batch {b} not divisible by stddev group {g}")
    y = y.reshape(g, b // g, h, w, f, c // f)
    y = y - y.mean(dim=0, keepdim=True)
    y = torch.sqrt(y.square().mean(dim=0) + 1e-8)    # (b//g, H, W, f, c//f)
    y = y.mean(dim=(1, 2, 4))                         # (b//g, f)
    return y[None, :, None, None, :].expand(g, b // g, h, w, f) \
        .reshape(b, h, w, f)


def minibatch_stddev(x: torch.Tensor, group_size: int = 4,
                     num_new_features: int = 1, *, axis_name=None,
                     chunks: int = 1) -> torch.Tensor:
    """Append per-group stddev statistics as extra channels (NHWC).

    The reference formula (CustomLayers.py:294-305): groups of
    min(group_size, B), strided over the batch, the biased stddev per
    (feature, pixel) with eps 1e-8 inside the sqrt, averaged over the
    feature's channels and H, W, broadcast back, one channel per new
    feature.  Statistics are float32 whatever x's dtype.

    `chunks` restricts grouping to that many equal contiguous batch chunks,
    each grouped alone (the fused real/fake scoring runs one batch-2B pass
    with chunks=2; a one-process run of the data-parallel step's
    shard-local statistic uses chunks = the group's size).  `axis_name` (a
    parallel.Mesh) takes the statistic over the group's global batch
    instead: x, the small 4x4 head input, is all-gathered, grouped as one
    process groups the global batch, and this rank's rows are kept."""
    if axis_name is not None and not isinstance(axis_name, Mesh):
        raise TypeError("axis_name is the data-parallel group's "
                        f"parallel.Mesh, got {axis_name!r}")
    if axis_name is not None and chunks > 1:
        raise ValueError("axis_name (global scope) and chunks (local scope) "
                         "are exclusive")
    b = x.shape[0]
    if b % chunks:
        raise ValueError(f"batch {b} not divisible into {chunks} chunks")
    y = _f32_stats(x)
    if axis_name is not None:
        full = _stddev_feature(all_gather(y, axis_name), group_size,
                               num_new_features)
        feat = full[axis_name.rank * b:(axis_name.rank + 1) * b]
    else:
        feat = torch.cat([_stddev_feature(t, group_size, num_new_features)
                          for t in y.chunk(chunks)])
    return torch.cat([x, feat.to(x.dtype)], dim=-1)


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
