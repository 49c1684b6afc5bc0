"""StyleGAN2's modulated convolution, its resampling and its layer epilogue
(NVlabs/stylegan2 ``training/networks_stylegan2.py::modulated_conv2d_layer``
and ``dnnlib/tflib/ops/upfirdn_2d.py``), on contiguous NCHW tensors; and
StyleGAN3's per-sample kernels (`modulate_weight3`), whose convolution is
`modulated_conv2d` with padding k - 1.

* The style of a layer: s = A w / sqrt(dlatent) + b_A + 1 (`modulation`).
* The weight: w' = W s[ci] / sqrt(ci k^2); demodulated, w'' = w' d with
  d = rsqrt(sum over (ci, kh, kw) of w'^2 + 1e-8) per sample and output
  channel (`demodulation`, which sums s^2 against the kernel's squares
  per input channel: the same sum, taken as one small product).
* The convolution with w'' runs in the fused form (`modulate_weight`,
  `modulated_conv2d`): the per-sample kernels as one grouped convolution
  (groups = batch), as the TF original and stylegan2-ada-pytorch run
  inference.  It beat the scaled form, conv(x * s) with the shared kernel
  and `* d` after it, on the card (PERF.md).
* The up-convolution: a stride-2 transposed convolution of the spatially
  flipped kernel (the TF original's flip, so that converted kernels load
  as they are), (2H+1) wide (`modulated_conv2d` with `up`, through the
  ``stylegan_torch::modconv_up`` op), then the 4x4 FIR at gain 4 with one
  pixel of padding a side: 2H wide (`_fir`, a depthwise convolution).  The
  skip output's upsample is the FIR alone at up 2, padding (2, 1), as a
  depthwise transposed convolution (`skip_upsample`).
* The layer epilogue: sqrt(2) * lrelu(x + strength * noise + b, 0.2).  A
  same-size layer's (`layer_epilogue`) goes through the
  ``stylegan_torch::epilogue2`` op; an up-layer's (`layer_epilogue_up`)
  takes the up-convolution's (2H+1)^2 output and applies the FIR first,
  through the ``stylegan_torch::epilogue2_up`` op, so that the FIR's
  (2H)^2 plane is never written.  Each op is a CUDA kernel on the card
  (``ops/kernels/epilogue2.py``) and its plain version on the CPU
  (`_reference_epilogue2`, after `_fir` for the up-layers), which this
  module registers.

On the card the up-convolution is the port's own kernel
(``ops/kernels/modconv_up.py``: the four sub-pixel phases, the whole batch
in one launch, each output summed in one fixed order); its CPU
implementation, which that module registers, is the plain version, the
grouped transposed convolution (``_reference_modconv_up`` there).  The
other convolutions are cuDNN's: the same-size layers' and toRGBs' grouped
convolutions and the skip upsample's depthwise transposed convolution.  ``epilogue2.launches`` in
``utils.profiling.counters`` counts every layer epilogue's calls, on either
device; ``ops/kernels/epilogue2.py`` counts its kernels' launches and
``ops/kernels/modconv_up.py`` the up-convolution's
(``modconv.up_launches``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.profiling import counters
from .kernels.epilogue import needs_grad
from .kernels.epilogue2 import (check_inputs, check_inputs_up, epilogue2_op,
                                epilogue2_up_op)
from .kernels import modconv_up as _up
from .linear import equalized_scales

SQRT2 = math.sqrt(2.0)


def fir_kernel(taps, device=None) -> torch.Tensor:
    """The 2-D filter of 1-D `taps`, normalised to sum 1."""
    k = torch.as_tensor(taps, dtype=torch.float32, device=device)
    k = k[:, None] * k[None, :]
    return k / k.sum()


def modulation(affine, w: torch.Tensor) -> torch.Tensor:
    """s = affine(w) + 1, (B, cin); `affine` an EqualizedLinear of gain 1."""
    return affine(w) + 1.0


def weight_scale(weight: torch.Tensor) -> float:
    """The equalized learning rate's 1 / sqrt(cin k^2) of a kernel."""
    _, cin, kh, kw = weight.shape
    return equalized_scales(1.0, cin * kh * kw, 1.0, True)[1]


def demodulation(weight: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """d = rsqrt(sum_ci s[b, ci]^2 * sum_k W[o, ci, k]^2 / (ci k^2) + 1e-8),
    (B, cout)."""
    sq = weight.square().sum((2, 3)) * weight_scale(weight) ** 2
    return torch.rsqrt(s.square() @ sq.t() + 1e-8)


def _fir(x: torch.Tensor, fir: torch.Tensor) -> torch.Tensor:
    """The (2H+1) up-convolution's output through the FIR at gain 4,
    padding 1 a side: (2H)."""
    c = x.shape[1]
    k = (fir * 4).flip(0, 1)[None, None].expand(c, 1, *fir.shape)
    return F.conv2d(x, k, padding=1, groups=c)


def modulate_weight(weight: torch.Tensor, s: torch.Tensor,
                    d: Optional[torch.Tensor]) -> torch.Tensor:
    """The per-sample kernels (B, cout, cin, k, k): `weight`
    (cout, cin, k, k) scaled by 1 / sqrt(cin k^2), the styles `s` (B, cin)
    and the demodulation factors `d` (B, cout) or None."""
    ww = (weight * weight_scale(weight))[None] * s[:, None, :, None, None]
    return ww if d is None else ww * d[:, :, None, None, None]


def modulate_weight3(weight: torch.Tensor, s: torch.Tensor,
                     input_gain: torch.Tensor, *,
                     demodulate: bool = True) -> torch.Tensor:
    """StyleGAN3's per-sample kernels (B, cout, cin, k, k)
    (NVlabs/stylegan3 ``networks_stylegan3.py::modulated_conv2d``): where
    the layer demodulates, `weight` (cout, cin, k, k) pre-normalised,
    w * rsqrt(mean over (ci, kh, kw) of w^2) per output channel, and the
    styles `s` (B, cin) over the whole tensor, s * rsqrt(mean of s^2), then
    w' = w s[ci] demodulated by d = rsqrt(sum over (ci, kh, kw) of w'^2 +
    1e-8) (as `demodulation` takes the sum, without the equalized scale);
    toRGB's, without demodulation, w s (its caller scales s); both times
    `input_gain`, the layer's rsqrt(magnitude_ema) (0-d)."""
    if demodulate:
        weight = weight * weight.square().mean((1, 2, 3),
                                               keepdim=True).rsqrt()
        s = s * s.square().mean().rsqrt()
    ww = weight[None] * s[:, None, :, None, None]
    if demodulate:
        d = torch.rsqrt(s.square() @ weight.square().sum((2, 3)).t() + 1e-8)
        ww = ww * d[:, :, None, None, None]
    return ww * input_gain


def modulated_conv2d(x: torch.Tensor, ww: torch.Tensor, *,
                     up: bool = False,
                     padding: Optional[int] = None) -> torch.Tensor:
    """The modulated convolution in its fused form: x (B, cin, H, W) with
    the per-sample kernels `ww` (`modulate_weight`) as one grouped
    convolution (groups = B), SAME padding (`padding`, k // 2, unless given:
    StyleGAN3's k - 1 gives (B, cout, H + 2, W + 2) at k = 3); with `up`
    the transposed up-convolution, (B, cout, 2H+1, 2W+1), whose FIR
    `layer_epilogue_up` applies: through the ``stylegan_torch::modconv_up``
    op where no gradient is recorded (the port's kernel on the card; x and
    `ww` contiguous float32 3x3), else on the CPU the plain version,
    differentiable, and on the card an error (the kernel has no backward).
    Returns contiguous NCHW."""
    if up:
        if needs_grad(x, ww):
            if x.device.type == "cuda":
                raise RuntimeError("StyleGAN2's up-convolution kernel has no "
                                   "backward: the port serves StyleGAN2 and "
                                   "does not train it")
            _up.check_inputs(x, ww)
            return _up._reference_modconv_up(x, ww)
        return _up.modconv_up_op(x, ww)
    b, cin, h, w = x.shape
    cout, k = ww.shape[1], ww.shape[-1]
    x = x.contiguous().reshape(1, b * cin, h, w)
    y = F.conv2d(x, ww.reshape(b * cout, cin, k, k),
                 padding=k // 2 if padding is None else padding, groups=b)
    return y.reshape(b, cout, *y.shape[2:])


def skip_upsample(y: torch.Tensor, fir: torch.Tensor) -> torch.Tensor:
    """upfirdn(y, fir * 4, up 2, padding (2, 1)): the skip output at twice
    the size, as a depthwise transposed convolution."""
    c = y.shape[1]
    k = (fir * 4)[None, None].expand(c, 1, *fir.shape)
    return F.conv_transpose2d(y, k, stride=2, padding=1, groups=c)


def _reference_epilogue2(x, noise, bias, strength):
    """The epilogue's plain version."""
    x = x + noise * strength + bias[None, :, None, None]
    return F.leaky_relu(x, 0.2) * SQRT2


def _reference_epilogue2_up(y, fir, noise, bias, strength):
    """The up-layer epilogue's plain version: the FIR, then the epilogue."""
    return _reference_epilogue2(_fir(y, fir), noise, bias, strength)


@epilogue2_up_op.register_kernel("cpu")
def _(y, fir, noise, bias, strength):
    check_inputs_up(y, fir, noise, bias, strength)
    return _reference_epilogue2_up(y, fir, noise, bias, strength)


epilogue2_op.register_kernel("cpu")(_reference_epilogue2)


def _dispatch(op, plain, check, *args):
    """Through `op` without a gradient to record (the kernel on the card);
    on the CPU under autograd `plain`, differentiable; on the card under
    autograd raise (the kernels have no backward)."""
    counters["epilogue2.launches"] += 1
    if needs_grad(*args):
        if args[0].device.type == "cuda":
            raise RuntimeError("StyleGAN2's epilogue kernel has no backward: "
                               "the port serves StyleGAN2 and does not train "
                               "it")
        check(*args)
        return plain(*args)
    return op(*args)


def layer_epilogue(x: torch.Tensor, noise: torch.Tensor, bias: torch.Tensor,
                   strength: torch.Tensor) -> torch.Tensor:
    """sqrt(2) * lrelu(x + strength * noise + bias, 0.2) of x (B, C, H, W),
    noise (B, 1, H, W), bias (C,), strength 0-d (`_dispatch`)."""
    return _dispatch(epilogue2_op, _reference_epilogue2, check_inputs, x,
                     noise, bias, strength)


def layer_epilogue_up(y: torch.Tensor, fir: torch.Tensor, noise: torch.Tensor,
                      bias: torch.Tensor, strength: torch.Tensor
                      ) -> torch.Tensor:
    """sqrt(2) * lrelu(FIR(y) + strength * noise + bias, 0.2) of an
    up-convolution's y (B, C, 2H+1, 2H+1), fir (4, 4) (`fir_kernel`),
    noise (B, 1, 2H, 2H), bias (C,), strength 0-d: (B, C, 2H, 2H)
    (`_dispatch`)."""
    return _dispatch(epilogue2_up_op, _reference_epilogue2_up,
                     check_inputs_up, y, fir, noise, bias, strength)
