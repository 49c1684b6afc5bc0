"""Fused layer-epilogue dispatch (the port's counterpart of
``stylegan_tpu/ops/fused.py``).

The synthesis epilogue (noise-add -> leaky-relu -> instance-norm -> AdaIN) is
element-wise work plus a per-channel reduction, bound by memory traffic.
On the card it always runs as the hand-written CUDA kernels, forward and
backward (``ops/kernels/epilogue.py``); a CPU tensor takes the plain versions
here, `_reference_epilogue` and its analytic VJP `_reference_epilogue_vjp`,
which are also the ground truth the kernels are held to.  The JAX package's
opt-in switch was a TPU trade-off and has no counterpart here.

A call that needs no gradient goes, on either device, through the
``stylegan_torch::epilogue`` op, whose CPU implementation this module
registers (`_reference_epilogue`): a program that ``torch.export`` traces
anywhere holds the op's node, and launches the kernel once moved to the
card.

On a slab of rows of a plane split over ranks (the spatial serving path,
``parallel/spatial.py``) no rank sees the whole plane, so the epilogue runs
split, forward only: K1-partial (``stylegan_torch::epilogue_partial``)
gives this rank's per-(b, c) (mean, M2), the ranks gather those and each
merges them in rank order with Chan's formula (`split_stats`: every rank
gets the same bits), and K2-apply (``stylegan_torch::epilogue_apply``)
normalises and modulates this rank's rows.  The ops launch the kernels on
the card; their CPU implementations, registered here, are the plain
versions `_reference_partial` and `_reference_apply`.
"""

from __future__ import annotations

import torch

from ..parallel import halo
from .kernels.epilogue import (epilogue_apply_op, epilogue_op,
                               epilogue_partial_op, kernel_epilogue,
                               needs_grad)
from .primitives import (_f32_stats, add_noise, instance_norm, leaky_relu,
                         merge_moments, moments, style_modulate)

EPS = 1e-5

# Calls of the plain versions (forward and VJP).  On the card's main path
# this stays 0: a count there means a plain version ran where a kernel should.
plain_calls = 0


def _reference_epilogue(x, noise_weight, noise, style):
    global plain_calls
    plain_calls += 1
    x = add_noise(x, noise_weight, noise)
    x = leaky_relu(x)
    x = instance_norm(x)
    return style_modulate(x, style)


def _reference_epilogue_vjp(x, noise_weight, noise, style, g):
    """The epilogue's VJP, written out (the formula the backward kernels
    compute), in float32 (or the inputs' dtype where it is wider).  With
    u = x + nw * n, y = lrelu(u), yh = (y - mean) * r and
    r = rsqrt(var + 1e-5) over H, W:

        ds1[b, c] = sum_hw g           ds0[b, c] = sum_hw g * yh
        dy = (s0 + 1) * r * (g - mean_hw(g) - yh * mean_hw(g * yh))
        du = dy where u >= 0, else 0.2 * dy   (slope 1 at 0, as leaky_relu)
        dx = du    dnw[c] = sum_bhw du * n    dn[b, h, w] = sum_c du * nw[c]

    Returns (dx, dnoise_weight, dnoise, dstyle) in the inputs' dtypes."""
    global plain_calls
    plain_calls += 1
    dims = (1, 2)
    wide = torch.promote_types(x.dtype, torch.float32)
    xf, nf, gf = x.to(wide), noise.to(wide), g.to(wide)
    nw = noise_weight.to(wide)
    u = xf + nw * nf
    neg = u < 0
    y = torch.where(neg, u * 0.2, u)
    mean = y.mean(dims, keepdim=True)
    r = torch.rsqrt((y - mean).square().mean(dims, keepdim=True) + 1e-5)
    yh = (y - mean) * r
    c = x.shape[-1]
    s0 = style.to(wide)[:, :c][:, None, None, :]
    gyh = gf * yh
    dy = (s0 + 1.0) * r * (gf - gf.mean(dims, keepdim=True)
                           - yh * gyh.mean(dims, keepdim=True))
    du = torch.where(neg, dy * 0.2, dy)
    dnw = (du * nf).sum((0, 1, 2))
    dn = (du * nw).sum(-1, keepdim=True)
    dstyle = torch.cat([gyh.sum(dims), gf.sum(dims)], dim=1)
    return (du.to(x.dtype), dnw.to(noise_weight.dtype), dn.to(noise.dtype),
            dstyle.to(style.dtype))


def _reference_partial(x, noise_weight, noise):
    """K1-partial's plain version: the (B, C, 2) (mean, M2) of
    y = lrelu(x + nw * noise) over x's rows, in float32 (or x's dtype
    where it is wider), two passes."""
    global plain_calls
    plain_calls += 1
    return moments(_f32_stats(leaky_relu(add_noise(x, noise_weight, noise))))


def split_stats(parts, rows: int, style):
    """The (B, C, 2) (mean, rstd * (s0 + 1)) K2-apply reads, from the
    ranks' K1-partials `parts` (n, B, C, 2), each over `rows` rows, merged
    in rank order."""
    mean, m2, count = merge_moments(parts, rows)
    rstd = torch.rsqrt(m2 / count + EPS)
    s0 = style[:, :mean.shape[-1]].to(rstd.dtype)
    return torch.stack([mean, rstd * (s0 + 1.0)], dim=-1)


def _reference_apply(x, noise_weight, noise, style, stats):
    """K2-apply's plain version: (y - mean) * scale + s1 over x's rows in
    float32 (or wider), rounded once to x's dtype."""
    global plain_calls
    plain_calls += 1
    y = _f32_stats(leaky_relu(add_noise(x, noise_weight, noise)))
    mean, scale = stats[..., 0], stats[..., 1]
    s1 = style[:, x.shape[-1]:].to(scale.dtype)
    out = (y - mean[:, None, None]) * scale[:, None, None] \
        + s1[:, None, None]
    return out.to(x.dtype)


epilogue_op.register_kernel("cpu")(_reference_epilogue)
epilogue_partial_op.register_kernel("cpu")(_reference_partial)
epilogue_apply_op.register_kernel("cpu")(_reference_apply)


class _PlainEpilogue(torch.autograd.Function):
    """The CPU epilogue: the composition forward, its analytic VJP backward.
    The VJP is torch ops, so a create_graph backward differentiates again."""

    @staticmethod
    def forward(ctx, x, noise_weight, noise, style):
        ctx.save_for_backward(x, noise_weight, noise, style)
        return _reference_epilogue(x, noise_weight, noise, style)

    @staticmethod
    def backward(ctx, g):
        grads = _reference_epilogue_vjp(*ctx.saved_tensors, g)
        return tuple(d if need else None
                     for d, need in zip(grads, ctx.needs_input_grad))


def fused_epilogue(x: torch.Tensor, noise_weight: torch.Tensor,
                   noise: torch.Tensor, style: torch.Tensor,
                   spatial=None) -> torch.Tensor:
    """noise-add -> lrelu(0.2) -> instance-norm(eps 1e-5) -> AdaIN.

    x: (B, H, W, C); noise: (B, H, W, 1); noise_weight: (C,); style: (B, 2C).
    A CUDA x launches the kernels, which take x and noise in one dtype
    (float32 or bfloat16) and noise_weight and style in float32, and raise
    on anything else; a bfloat16 style (the bf16 path's style dense) is
    widened first, as the JAX package's Pallas wrapper widens it, and its
    gradient comes back in float32 through the cast.  A CPU x runs the
    plain versions in the inputs' dtypes, as the JAX package's unfused
    composition does.  Without a gradient to record, both go through the
    ``stylegan_torch::epilogue`` op.

    With `spatial` (a parallel.halo.SpatialContext) x and noise are this
    rank's slab of rows of the plane: the split form of the module
    docstring, forward only.
    """
    if spatial is not None:
        return _split_epilogue(x, noise_weight, noise, style, spatial)
    if x.device.type == "cuda":
        return kernel_epilogue(x, noise_weight, noise,
                               style.to(torch.float32))
    if x.device.type != "cpu":
        raise ValueError(f"no epilogue for device {x.device}")
    if needs_grad(x, noise_weight, noise, style):
        return _PlainEpilogue.apply(x, noise_weight, noise, style)
    return epilogue_op(x, noise_weight, noise, style)


def _split_epilogue(x, noise_weight, noise, style, spatial):
    if needs_grad(x, noise_weight, noise, style):
        raise ValueError("the split epilogue (a slab of rows) is a forward "
                         "only: call it without a gradient to record")
    if x.device.type == "cuda":
        style = style.to(torch.float32)
    partial = epilogue_partial_op(x, noise_weight, noise)
    stats = split_stats(halo.all_gather(partial, spatial),
                        x.shape[1] * x.shape[2], style)
    return epilogue_apply_op(x, noise_weight, noise, style, stats)
