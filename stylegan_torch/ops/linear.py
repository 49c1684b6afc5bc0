"""Equalized-learning-rate linear and convolution ops (the port's counterpart
of ``stylegan_tpu/ops/linear.py``).

Parameters are stored at unit-ish scale and multiplied by a constant ``w_mul``
at apply time (reference: models/CustomLayers.py:79-180).  Weights keep the
reference's torch layouts: dense (out, in), conv OIHW.  Activations are NHWC
at the public functions and channels-last NCHW inside the convolutions.

The convolutions are PyTorch's (cuDNN on the card), as the JAX package left
them to XLA.  The JAX ``conv2d_apply``'s unpacked branches are all here:
upscale, downscale and same-size; its space-to-depth packed and blur-folding
branches compute the same math in TPU layouts and have no counterpart.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.halo import exchange_halo
from .primitives import blur2d, downscale2d, to_nchw, to_nhwc, upscale2d


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
    """Equalized dense layer; weight (out, in).  On bfloat16 x it computes
    as the JAX package's does: the product with the float32 weight in
    float32, rounded to bf16, then the bias rounded to bf16 added."""
    _, w_mul = equalized_scales(gain, weight.shape[1], lrmul, use_wscale)
    if x.dtype == torch.bfloat16:
        y = F.linear(x.float(), weight * w_mul).to(x.dtype)
        return y if bias is None else y + (bias * lrmul).to(y.dtype)
    if bias is not None:
        bias = (bias * lrmul).to(x.dtype)
    return F.linear(x, (weight * w_mul).to(x.dtype), bias)


def conv2d_apply(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 gain: float = math.sqrt(2), use_wscale: bool = False,
                 lrmul: float = 1.0, upscale: bool = False,
                 downscale: bool = False,
                 blur_kernel: Optional[torch.Tensor] = None,
                 pre_blur_kernel: Optional[torch.Tensor] = None,
                 fused_resample_threshold: int = 128,
                 spatial=None) -> torch.Tensor:
    """Equalized conv of NHWC x with weight (O, I, k, k), SAME padding.

    Dispatch mirrors CustomLayers.py:137-180: with `upscale`, an output
    resolution >= threshold takes the fused transposed conv on the 4-tap
    summed kernel, a smaller one nearest-upsamples and then convolves.  With
    `downscale`, an input resolution >= threshold takes the fused stride-2
    conv on the 4-tap averaged kernel, a smaller one convolves and then
    average-pools 2x2.  `blur_kernel` (the G path) sits between the conv and
    the bias add, as does the small downscale's pooling; `pre_blur_kernel`
    (the D path) blurs the input of a downscale.

    With `spatial` (a parallel.halo.SpatialContext) x is this rank's slab of
    rows of a square plane and the output the rank's slab of the output
    plane: each op that reads neighbouring rows (the 3x3 conv, the sub-pixel
    upscale, the blur, the fused stride-2 downscale) takes one row from each
    neighbour first; the small downscale's 2x2 pool is row-aligned.  The
    upscale is always the sub-pixel form (the transposed conv has no slab
    form).  Every slab op differentiates to any order (the halo exchange's
    transpose, `conv`).
    """
    _, in_ch, kh, kw = weight.shape
    _, w_mul = equalized_scales(gain, in_ch * kh * kw, lrmul, use_wscale)
    w = (weight * w_mul).to(x.dtype)
    if bias is not None:
        bias = (bias * lrmul).to(x.dtype)
    if upscale and downscale:
        raise ValueError("conv2d_apply: upscale and downscale are exclusive")

    if spatial is not None:
        if downscale and pre_blur_kernel is not None:
            x = blur2d(x, pre_blur_kernel, spatial)
        # a slab's width is its plane's side
        if upscale and x.shape[2] * 2 >= fused_resample_threshold:
            y = _subpixel_upscale_conv(x, w, spatial)
        elif downscale and x.shape[2] >= fused_resample_threshold:
            y = _fused_downscale_conv(x, w, spatial)
        else:
            y = _slab_conv(upscale2d(x) if upscale else x, w, spatial)
            if downscale:
                y = downscale2d(y)
        if blur_kernel is not None:
            y = blur2d(y, blur_kernel, spatial)
        return y if bias is None else y + bias

    if downscale and pre_blur_kernel is not None:
        x = blur2d(x, pre_blur_kernel)
    if upscale and min(x.shape[1], x.shape[2]) * 2 >= fused_resample_threshold:
        y = _fused_upscale_conv(x, w)
    elif downscale and min(x.shape[1], x.shape[2]) >= fused_resample_threshold:
        y = _fused_downscale_conv(x, w)
    else:
        if upscale:
            x = upscale2d(x)
        y = to_nhwc(conv(to_nchw(x), w, 1, (kh - 1) // 2))
        if downscale:
            y = downscale2d(y)
    if blur_kernel is not None:
        y = blur2d(y, blur_kernel)
    if bias is not None:
        y = y + bias
    return y


def _fused_upscale_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The transposed conv, stride 2, padding 1, with the 4-tap-summed 4x4
    kernel (reference CustomLayers.py:146-151).  Where no gradient is
    recorded (serving, the generation CLIs, an exported program, the D
    update's fakes) it runs as the sub-pixel convolution, whose every run
    gives the same bits on the card; under autograd as cuDNN's transposed
    conv, whose backward is the cheaper of the two on the H100 (the
    depth-8 float32 train step took 8% longer with the sub-pixel form
    throughout: PERF.md)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _transposed_upscale_conv(x, w)
    return _subpixel_upscale_conv(x, w)


def _summed_taps(w: torch.Tensor) -> torch.Tensor:
    """(O, I, 3, 3) -> the 4-tap-summed (O, I, 4, 4) kernel."""
    wp = F.pad(w, (1, 1, 1, 1))
    return (wp[:, :, 1:, 1:] + wp[:, :, :-1, 1:]
            + wp[:, :, 1:, :-1] + wp[:, :, :-1, :-1])


def _transposed_upscale_conv(x: torch.Tensor, w: torch.Tensor
                             ) -> torch.Tensor:
    """conv_transpose2d takes the kernel un-flipped, laid out (in, out, kh,
    kw).  cuDNN runs it as a backward-data convolution, whose default
    algorithms on the card sum in no fixed order."""
    y = conv(to_nchw(x), _summed_taps(w).transpose(0, 1), 2, 1,
             transpose=True)
    return to_nhwc(y)


def _subpixel_upscale_conv(x: torch.Tensor, w: torch.Tensor,
                           spatial=None) -> torch.Tensor:
    """The same sums as a sub-pixel convolution.  Output pixel (2m + a,
    2n + b) reads a 2x2 window of the input padded by 1, at offset (a, b):
    along each axis, phase 0 takes the 4x4 kernel's taps (3, 1) and phase 1
    its taps (2, 0), every other tap of the flipped kernel.  The four phase
    kernels are stacked as 4*O output channels of one stride-1 conv with
    padding 1, whose (H+1, W+1) output holds each phase's (H, W) window at
    its offset; the phases are then interleaved into (2H, 2W).  FLOPs
    (H+1)(W+1)/HW of the transposed conv's; cuDNN's forward algorithms give
    the same bits on every run.  Its gradients are convolutions (`conv`).
    On a slab of rows (`spatial`) the neighbours' rows stand in for the
    padding rows, and the output is the slab's rows of the (2H, 2W) plane."""
    b, h, wd, _ = x.shape
    o = w.shape[0]
    # slices, not index lists: an index list is copied to the card each call
    wf = _summed_taps(w).flip(2, 3)
    phases = torch.cat([wf[:, :, a::2, c::2] for a in (0, 1) for c in (0, 1)])
    if spatial is None:
        y = conv(to_nchw(x), phases, 1, 1)
    else:
        y = conv(to_nchw(exchange_halo(x, spatial)), phases, 1, (0, 1))
    y = to_nhwc(y).reshape(b, h + 1, wd + 1, 2, 2, o)
    rows = [torch.stack([y[:, a:a + h, c:c + wd, a, c] for c in (0, 1)], 3)
            for a in (0, 1)]
    return torch.stack(rows, 2).reshape(b, 2 * h, 2 * wd, o)


def _slab_conv(x: torch.Tensor, w: torch.Tensor, spatial) -> torch.Tensor:
    """Stride-1 SAME conv of this rank's slab of rows: the neighbours'
    rows in place of the padding rows, padding along the width only."""
    p = (w.shape[-1] - 1) // 2
    if p:
        x = exchange_halo(x, spatial, p)
    return to_nhwc(conv(to_nchw(x), w, 1, (0, p)))


def _fused_downscale_conv(x: torch.Tensor, w: torch.Tensor,
                          spatial=None) -> torch.Tensor:
    """Stride-2 conv, padding 1, with the 4-tap-averaged 4x4 kernel
    (reference CustomLayers.py:158-163).  Both sides cross-correlate, so the
    kernel is not flipped.  On a slab of rows (`spatial`, an even number of
    rows from an even offset) output row m reads input rows 2m - 1 .. 2m +
    2: one row of each neighbour in place of the padding rows."""
    wp = F.pad(w, (1, 1, 1, 1))
    w4 = (wp[:, :, 1:, 1:] + wp[:, :, :-1, 1:]
          + wp[:, :, 1:, :-1] + wp[:, :, :-1, :-1]) * 0.25
    if spatial is None:
        return to_nhwc(conv(to_nchw(x), w4, 2, 1))
    return to_nhwc(conv(to_nchw(exchange_halo(x, spatial)), w4, 2, (0, 1)))


# --------------------------------------------------------------------------
# Convolutions whose gradients of every order are convolutions
# --------------------------------------------------------------------------
# R1 differentiates D's scores w.r.t. the images and then the penalty w.r.t.
# D's weights: a double backward through every convolution.  Autograd's
# double backward of a convolution computes the weight's gradient as a
# convolution whose kernel is the size of the image, which cuDNN runs slowly
# (most of a 1024^2 train step on the H100, PERF.md).  Here the gradient
# w.r.t. the input is the adjoint convolution and the gradient w.r.t. the
# weight is cuDNN's backward-filter (aten.convolution_backward), both again
# differentiable through these same functions.  Same math as F.conv2d /
# F.conv_transpose2d (groups 1, dilation 1, no bias).  The padding is an int
# or a (rows, columns) pair (a slab of rows that holds its halo rows pads
# its columns only).

def conv(x: torch.Tensor, w: torch.Tensor, stride: int, padding,
         transpose: bool = False) -> torch.Tensor:
    """F.conv2d(x, w, stride, padding), or with `transpose`
    F.conv_transpose2d(x, w, stride, padding), of NCHW x."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv.apply(x, w, (stride, padding, transpose, 0))
    return _conv(x, w, (stride, padding, transpose, 0))


def _conv(x, w, op):
    stride, padding, transpose, output_padding = op
    if transpose:
        return F.conv_transpose2d(x, w, None, stride, padding, output_padding)
    return F.conv2d(x, w, None, stride, padding)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _adjoint(op, x_shape, y_shape, w_shape):
    """The op mapping y's gradient back to x's: conv <-> transposed conv,
    with the output padding that restores x's size (per axis)."""
    stride, padding, transpose, _ = op
    if transpose:
        return stride, padding, False, 0
    extra = tuple(x_shape[d] - ((y_shape[d] - 1) * stride - 2 * p
                                + w_shape[d])
                  for d, p in zip((-2, -1), _pair(padding)))
    return stride, padding, True, extra


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, op):
        ctx.save_for_backward(x, w)
        ctx.op = op
        return _conv(x, w, op)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _Conv.apply(gy, w, _adjoint(ctx.op, x.shape, gy.shape,
                                             w.shape))
        if ctx.needs_input_grad[1]:
            gw = _ConvWeightGrad.apply(gy, x, w, ctx.op)
        return gx, gw, None


class _ConvWeightGrad(torch.autograd.Function):
    """d loss / d w of y = op(x, w), given gy = d loss / d y: cuDNN's
    backward-filter.  It is bilinear in (gy, x): its gradients are op(x, ggw)
    w.r.t. gy and the adjoint op(gy, ggw) w.r.t. x."""

    @staticmethod
    def forward(ctx, gy, x, w, op):
        ctx.save_for_backward(gy, x)
        ctx.op, ctx.w_shape = op, w.shape
        stride, padding, transpose, output_padding = op
        return torch.ops.aten.convolution_backward(
            gy, x, w, None, (stride, stride), _pair(padding), (1, 1),
            transpose, _pair(output_padding), 1, (False, True, False))[1]

    @staticmethod
    def backward(ctx, ggw):
        gy, x = ctx.saved_tensors
        d_gy = d_x = None
        if ctx.needs_input_grad[0]:
            d_gy = _Conv.apply(x, ggw, ctx.op)
        if ctx.needs_input_grad[1]:
            d_x = _Conv.apply(gy, ggw, _adjoint(ctx.op, x.shape, gy.shape,
                                                ctx.w_shape))
        return d_gy, d_x, None, None


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
                blur_kernel: Optional[torch.Tensor] = None,
                downscale: bool = False,
                pre_blur_kernel: Optional[torch.Tensor] = None,
                spatial=None) -> torch.Tensor:
        return conv2d_apply(x, self.weight, self.bias, gain=self.gain,
                            use_wscale=self.use_wscale, lrmul=self.lrmul,
                            upscale=upscale, downscale=downscale,
                            blur_kernel=blur_kernel,
                            pre_blur_kernel=pre_blur_kernel, spatial=spatial)
