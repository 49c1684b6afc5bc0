"""CUDA kernel: StyleGAN2's modulated up-convolution
(``csrc/modconv_up.cu``).

    y[s] = conv_transpose2d(x[s], flip(ww[s]) transposed, stride 2)

x (B, Ci, H, W) with the per-sample kernels ww (B, Co, Ci, 3, 3)
(``ops/modconv.py::modulate_weight``) gives y (B, Co, 2H+1, 2W+1), whose
4x4 FIR the up-layers' epilogue applies.  The kernel computes the four
sub-pixel phases of the stride-2 transposed convolution for the whole batch
in one launch, float32 on the CUDA cores, each output summed in one fixed
order (the source's header has the design).  It is built into StyleGAN2's
kernel library (``ops/kernels/epilogue2.py``'s sources, one ``nvcc`` run);
this module declares its C interface and calls it through ``ctypes`` on
PyTorch's current stream.

It reaches PyTorch as the ``torch.library`` op ``stylegan_torch::modconv_up``
(x, ww) -> y, with a fake for ``torch.export``.  Its CUDA implementation is
`modconv_up_forward`; its CPU implementation is the plain version,
`_reference_modconv_up`, the grouped ``conv_transpose2d`` (cuDNN's on the
card, where ``ops/modconv.py`` and the tests call it directly).  All tensors are contiguous NCHW float32 on one device;
the op has no backward (StyleGAN2 runs on the serving path only).  Its name
is neither under ``aten::convolution`` nor under ``stylegan_torch::epilogue``.

``counters["modconv.up_launches"]`` (``utils.profiling``) counts the
kernel's launches, where it launches: none on the CPU.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...utils.profiling import counters
from .epilogue import _on_device, _stream
from . import epilogue2

_lib = None


def _library():
    """StyleGAN2's kernel library with the up-convolution's signature."""
    global _lib
    if _lib is None:
        lib = epilogue2._library()
        p, i = ctypes.c_void_p, ctypes.c_int
        # x ww y, B Ci Co H W, stream
        lib.sgt_modconv_up.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.sgt_modconv_up.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_inputs(x, ww):
    """Raise unless x (B, Ci, H, W) and ww (B, Co, Ci, 3, 3) are what the
    kernel takes (the fake runs this too, on whatever device the trace's
    is)."""
    for name, t, ndim in (("x", x, 4), ("ww", ww, 5)):
        if t.ndim != ndim or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {ndim}-D float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, ci, h, w = x.shape
    if ww.shape[0] != b or ww.shape[2] != ci or ww.shape[3:] != (3, 3) \
            or ww.device != x.device:
        raise ValueError(f"ww must be ({b}, Co, {ci}, 3, 3) on {x.device} "
                         f"for x {tuple(x.shape)}, got {tuple(ww.shape)} on "
                         f"{ww.device}")
    if min(b, ci, h, w, ww.shape[1]) < 1:
        raise ValueError(f"empty up-convolution: x {tuple(x.shape)}, ww "
                         f"{tuple(ww.shape)}")


def _output(x, ww):
    b, _, h, w = x.shape
    return x.new_empty((b, ww.shape[1], 2 * h + 1, 2 * w + 1))


def modconv_up_forward(x, ww) -> torch.Tensor:
    """Launch the kernel on x's device."""
    check_inputs(x, ww)
    if x.device.type != "cuda":
        raise ValueError(f"the modconv_up kernel needs a CUDA tensor, got "
                         f"{x.device}")
    y = _output(x, ww)
    _on_device(x.device, _launch, x, ww, y)
    return y


def _launch(x, ww, y):
    b, ci, h, w = x.shape
    err = _library().sgt_modconv_up(
        x.data_ptr(), ww.data_ptr(), y.data_ptr(), b, ci, ww.shape[1], h, w,
        _stream(x.device))
    if err != 0:
        raise RuntimeError(f"modconv_up kernel launch failed: cudaError {err}")
    counters["modconv.up_launches"] += 1


@torch.library.custom_op("stylegan_torch::modconv_up", mutates_args=(),
                         device_types="cuda")
def modconv_up_op(x: torch.Tensor, ww: torch.Tensor) -> torch.Tensor:
    return modconv_up_forward(x, ww)


@modconv_up_op.register_fake
def _(x, ww):
    check_inputs(x, ww)
    return _output(x, ww)


def _reference_modconv_up(x: torch.Tensor, ww: torch.Tensor) -> torch.Tensor:
    """The plain version: the flipped per-sample kernels as one grouped
    transposed convolution (groups = B), stride 2."""
    b, cin, h, w = x.shape
    cout, k = ww.shape[1], ww.shape[-1]
    wt = ww.flip(3, 4).transpose(1, 2).reshape(b * cin, cout, k, k)
    y = F.conv_transpose2d(x.reshape(1, b * cin, h, w), wt, stride=2,
                           groups=b)
    return y.reshape(b, cout, 2 * h + 1, 2 * w + 1)


@modconv_up_op.register_kernel("cpu")
def _(x, ww):
    check_inputs(x, ww)
    return _reference_modconv_up(x, ww)


def flops(x, ww) -> int:
    """The operations of a call: 2 * H * W * 9 * Ci * Co a sample, each
    input pixel meeting each tap once."""
    b, ci, h, w = x.shape
    return 2 * b * h * w * 9 * ci * ww.shape[1]
