"""CUDA kernel: StyleGAN3's filtered leaky ReLU (``csrc/filtered_lrelu.cu``).

    out = upfirdn(clamp(gain * lrelu(upfirdn(x + b, fu, up, padding),
                                     slope), +-clamp), fd, down)

after each modulated convolution of StyleGAN3's synthesis network
(NVlabs/stylegan3 ``torch_utils/ops/filtered_lrelu.py``, whose reference
``_filtered_lrelu_ref`` is the plain version here, `_reference_filtered_lrelu`).
upfirdn is upfirdn2d with a separable 1-D filter: zeros inserted (`up`),
padded by `padding` (pad_lo, pad_hi) on each axis (negative crops), a true
convolution with the filter on each axis at gain `up` (up^2 in all), then
every `down`-th sample kept.

The kernel computes the whole chain for up 2 or 4, down 2, 6 * up taps in fu
and 12 in fd, in one pass whose oversampled plane lives only in shared
memory (the source's header has the design).  It is built with
``epilogue.build`` into a library of its own
(``build/stylegan_torch/libfiltered_lrelu-<sources hash>.so``) at first
use and called through ``ctypes`` on PyTorch's current stream.

It reaches PyTorch as the ``torch.library`` op
``stylegan_torch::filtered_lrelu`` (x, fu, fd, bias, up, down, pad_lo,
pad_hi, gain, slope, clamp) -> out, with a fake for ``torch.export``.  Its
CUDA implementation is `filtered_lrelu_forward`; its CPU implementation is
the plain version.  All tensors contiguous float32 on one device: x
(B, C, H, W) NCHW, fu and fd 1-D, bias (C,).  The op has no backward:
StyleGAN3 runs on the serving path only.

`filtered_lrelu` is what the synthesis calls: it counts every call in
``utils.profiling.counters["filtered_lrelu.launches"]``, on either device,
computes a layer without filters (StyleGAN3's toRGB: up = down = 1) in
plain PyTorch, and sends the others through the op, or under autograd
through the plain version on the CPU (and refuses on the card).
``counters["filtered_lrelu.cuda_launches"]`` counts the kernel's launches,
where it launches: none on the CPU.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...utils.profiling import counters
from .epilogue import _PKG, _on_device, _stream, build, needs_grad

SOURCES = (_PKG / "csrc" / "filtered_lrelu.cu",)
# what the kernel takes: the up factors, the down factor, the taps a phase
UPS, DOWN, PHASE_TAPS = (2, 4), 2, 6

_lib = None


def _library():
    global _lib
    if _lib is None:
        path, _ = build(SOURCES, "filtered_lrelu")
        lib = ctypes.CDLL(path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # x fu fd bias out, B C H W Ho Wo, up lo, gain slope clamp, stream
        lib.sgt_filtered_lrelu.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           i, i, f, f, f, p]
        lib.sgt_filtered_lrelu.restype = ctypes.c_int
        _lib = lib
    return _lib


def output_size(n: int, up: int, down: int, pad_lo: int, pad_hi: int,
                up_taps: int, down_taps: int) -> int:
    """The output's side along an axis of `n` input samples."""
    return (n * up + pad_lo + pad_hi - (up_taps - 1) - (down_taps - 1)
            + down - 1) // down


def check_inputs(x, fu, fd, bias, up, down, pad_lo, pad_hi):
    """Raise unless the tensors and factors are what the kernel takes (the
    fake runs this too, on whatever device the trace's is); returns the
    output's (Ho, Wo)."""
    if x.ndim != 4 or x.dtype != torch.float32:
        raise ValueError(f"x must be 4-D float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if up not in UPS or down != DOWN:
        raise ValueError(f"the kernel takes up in {UPS} and down {DOWN}, got "
                         f"up {up}, down {down}")
    c = x.shape[1]
    for name, t, shape in (("x", x, tuple(x.shape)),
                           ("fu", fu, (PHASE_TAPS * up,)),
                           ("fd", fd, (PHASE_TAPS * down,)),
                           ("bias", bias, (c,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != x.device:
            raise ValueError(f"{name} must be {shape} float32 on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ho, wo = (output_size(n, up, down, pad_lo, pad_hi, fu.numel(),
                          fd.numel()) for n in x.shape[2:])
    if min(x.shape) < 1 or min(ho, wo) < 1:
        raise ValueError(f"empty filtered lrelu: x {tuple(x.shape)}, "
                         f"padding ({pad_lo}, {pad_hi}) gives {ho} x {wo}")
    return ho, wo


def filtered_lrelu_forward(x, fu, fd, bias, up: int, down: int, pad_lo: int,
                           pad_hi: int, gain: float, slope: float,
                           clamp: float) -> torch.Tensor:
    """Launch the kernel on x's device."""
    ho, wo = check_inputs(x, fu, fd, bias, up, down, pad_lo, pad_hi)
    if x.device.type != "cuda":
        raise ValueError(f"the filtered_lrelu kernel needs a CUDA tensor, got "
                         f"{x.device}")
    out = x.new_empty((*x.shape[:2], ho, wo))
    _on_device(x.device, _launch, x, fu, fd, bias, out, up, pad_lo, gain,
               slope, clamp)
    return out


def _launch(x, fu, fd, bias, out, up, pad_lo, gain, slope, clamp):
    b, c, h, w = x.shape
    err = _library().sgt_filtered_lrelu(
        x.data_ptr(), fu.data_ptr(), fd.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, c, h, w, out.shape[2], out.shape[3], up, pad_lo,
        gain, slope, clamp, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"filtered_lrelu kernel launch failed: cudaError "
                           f"{err}")
    counters["filtered_lrelu.cuda_launches"] += 1


@torch.library.custom_op("stylegan_torch::filtered_lrelu", mutates_args=(),
                         device_types="cuda")
def filtered_lrelu_op(x: torch.Tensor, fu: torch.Tensor, fd: torch.Tensor,
                      bias: torch.Tensor, up: int, down: int, pad_lo: int,
                      pad_hi: int, gain: float, slope: float,
                      clamp: float) -> torch.Tensor:
    return filtered_lrelu_forward(x, fu, fd, bias, up, down, pad_lo, pad_hi,
                                  gain, slope, clamp)


@filtered_lrelu_op.register_fake
def _(x, fu, fd, bias, up, down, pad_lo, pad_hi, gain, slope, clamp):
    ho, wo = check_inputs(x, fu, fd, bias, up, down, pad_lo, pad_hi)
    return x.new_empty((*x.shape[:2], ho, wo))


def upfirdn(x: torch.Tensor, f: torch.Tensor, up: int = 1, down: int = 1,
            pad_lo: int = 0, pad_hi: int = 0,
            gain: float = 1.0) -> torch.Tensor:
    """upfirdn2d's plain version on NCHW x with the 1-D filter `f` applied
    on both axes: zeros inserted, padded (negative crops), the true
    convolution at gain sqrt(`gain`) an axis, then every `down`-th
    sample."""
    b, c, h, w = x.shape
    if up > 1:
        x = F.pad(x.reshape(b, c, h, 1, w, 1), [0, up - 1, 0, 0, 0, up - 1])
        x = x.reshape(b, c, h * up, w * up)
    x = F.pad(x, [max(pad_lo, 0), max(pad_hi, 0)] * 2)
    x = x[:, :, max(-pad_lo, 0):x.shape[2] - max(-pad_hi, 0),
          max(-pad_lo, 0):x.shape[3] - max(-pad_hi, 0)]
    k = (f * gain ** 0.5).flip(0).to(x.dtype)
    x = F.conv2d(x, k[None, None, None, :].expand(c, 1, 1, -1), groups=c)
    x = F.conv2d(x, k[None, None, :, None].expand(c, 1, -1, 1), groups=c)
    return x[:, :, ::down, ::down]


def _activation(x, gain, slope, clamp):
    return (F.leaky_relu(x, slope) * gain).clamp(-clamp, clamp)


def _reference_filtered_lrelu(x, fu, fd, bias, up, down, pad_lo, pad_hi, gain,
                              slope, clamp):
    """The plain version (the published ``_filtered_lrelu_ref``): the bias,
    upfirdn up at gain up^2, the activation, upfirdn down."""
    x = x + bias[None, :, None, None]
    x = upfirdn(x, fu, up=up, pad_lo=pad_lo, pad_hi=pad_hi, gain=up ** 2)
    return upfirdn(_activation(x, gain, slope, clamp), fd, down=down)


@filtered_lrelu_op.register_kernel("cpu")
def _(x, fu, fd, bias, up, down, pad_lo, pad_hi, gain, slope, clamp):
    check_inputs(x, fu, fd, bias, up, down, pad_lo, pad_hi)
    return _reference_filtered_lrelu(x, fu, fd, bias, up, down, pad_lo,
                                     pad_hi, gain, slope, clamp)


def filtered_lrelu(x: torch.Tensor, fu: torch.Tensor | None,
                   fd: torch.Tensor | None, bias: torch.Tensor, *, up: int,
                   down: int, padding: tuple[int, int], gain: float,
                   slope: float, clamp: float) -> torch.Tensor:
    """A layer's bias, filtered leaky ReLU and clamp on x (B, C, H, W).
    Without filters (fu and fd None, up = down = 1, no padding: toRGB's)
    in plain PyTorch;
    otherwise through the op where no gradient is recorded (the kernel on
    the card), on the CPU under autograd the plain version, on the card
    under autograd an error (the kernel has no backward)."""
    counters["filtered_lrelu.launches"] += 1
    lo, hi = padding
    if fu is None and fd is None and (up, down, lo, hi) == (1, 1, 0, 0):
        return _activation(x + bias[None, :, None, None], gain, slope, clamp)
    args = (x, fu, fd, bias, up, down, lo, hi, float(gain), float(slope),
            float(clamp))
    if needs_grad(x, bias):
        if x.device.type == "cuda":
            raise RuntimeError("StyleGAN3's filtered lrelu kernel has no "
                               "backward: the port serves StyleGAN3 and does "
                               "not train it")
        check_inputs(*args[:8])
        return _reference_filtered_lrelu(*args)
    return filtered_lrelu_op(*args)


def flops(x: torch.Tensor, up: int, down: int, pad_lo: int, pad_hi: int,
          up_taps: int, down_taps: int) -> int:
    """The filter taps of a call, counted as the separable passes of the
    plain chain take them, 2 operations each: the up filter's polyphase
    taps (up_taps / up a sample) down the columns of x and then along the
    rows of the oversampled plane, the down filter's taps along its rows
    and then down the output's columns."""
    b, c, h, w = x.shape
    th, tw = (n * up + pad_lo + pad_hi - up_taps + 1 for n in (h, w))
    ho, wo = (output_size(n, up, down, pad_lo, pad_hi, up_taps, down_taps)
              for n in (h, w))
    p = up_taps // up
    return 2 * b * c * (th * w * p + th * tw * p + th * wo * down_taps
                        + ho * wo * down_taps)


def bytes_moved(x: torch.Tensor, ho: int, wo: int) -> int:
    """The bytes a call must move: x read and out written once, the bias."""
    b, c, h, w = x.shape
    return 4 * (b * c * (h * w + ho * wo) + c)
