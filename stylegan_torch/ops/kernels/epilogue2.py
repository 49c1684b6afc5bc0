"""CUDA kernel: StyleGAN2's layer epilogue (``csrc/epilogue2.cu``).

    out = sqrt(2) * leaky_relu(x + strength * noise + bias[c], 0.2)

after each modulated convolution.  The source is compiled with ``nvcc``
for ``sm_90a`` into a library of its own
(``build/stylegan_torch/libepilogue2-<sources hash>.so``, by
``epilogue.build``) at first use and called through ``ctypes`` on
PyTorch's current stream, one launch a call.

It reaches PyTorch as the ``torch.library`` op ``stylegan_torch::epilogue2``
(x, noise, bias, strength) -> out: x (B, C, H, W) and noise (B, 1, H, W)
contiguous NCHW, bias (C,) and strength a 0-d tensor, all float32 on x's
device.  Its CUDA implementation is `epilogue2_forward`; its CPU
implementation, registered by ``ops/modconv.py``, is the plain version.
The op has no backward: StyleGAN2 runs on the serving path only.

Counts in ``utils.profiling.counters``: ``epilogue2.launches``, the op's
calls on either device, and ``epilogue2.cuda_launches``, the kernel's
launches (one a call on the card).
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.profiling import counters
from .epilogue import _PKG, _on_device, _stream, build

SOURCES = (_PKG / "csrc" / "epilogue2.cu",)

_lib = None


def _library():
    global _lib
    if _lib is None:
        path, _ = build(SOURCES, "epilogue2")
        lib = ctypes.CDLL(path)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # x noise bias strength out, B HW C, stream
        lib.sgt_epilogue2.argtypes = [p, p, p, p, p, i, ll, i, p]
        lib.sgt_epilogue2.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_inputs(x, noise, bias, strength):
    """Raise unless the tensors are what the kernel takes (the fake runs
    this too, on whatever device the trace's is)."""
    if x.ndim != 4 or x.dtype != torch.float32:
        raise ValueError(f"x must be 4-D float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    b, c, h, w = x.shape
    checks = [("x", x, (b, c, h, w)), ("noise", noise, (b, 1, h, w)),
              ("bias", bias, (c,)), ("strength", strength, ())]
    for name, t, shape in checks:
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != x.device:
            raise ValueError(f"{name} must be {shape} float32 on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def epilogue2_forward(x, noise, bias, strength) -> torch.Tensor:
    """Launch the kernel on x's device."""
    check_inputs(x, noise, bias, strength)
    if x.device.type != "cuda":
        raise ValueError(f"the epilogue2 kernel needs a CUDA tensor, got "
                         f"{x.device}")
    out = torch.empty_like(x)
    _on_device(x.device, _launch, x, noise, bias, strength, out)
    return out


def _launch(x, noise, bias, strength, out):
    b, c, h, w = x.shape
    err = _library().sgt_epilogue2(
        x.data_ptr(), noise.data_ptr(), bias.data_ptr(), strength.data_ptr(),
        out.data_ptr(), b, h * w, c, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"epilogue2 kernel launch failed: cudaError {err}")
    counters["epilogue2.cuda_launches"] += 1


@torch.library.custom_op("stylegan_torch::epilogue2", mutates_args=(),
                         device_types="cuda")
def epilogue2_op(x: torch.Tensor, noise: torch.Tensor, bias: torch.Tensor,
                 strength: torch.Tensor) -> torch.Tensor:
    return epilogue2_forward(x, noise, bias, strength)


@epilogue2_op.register_fake
def _(x, noise, bias, strength):
    check_inputs(x, noise, bias, strength)
    return torch.empty_like(x)


def bytes_moved(x: torch.Tensor) -> int:
    """The bytes a call on x must move: x read and out written once, one
    noise value a pixel, the bias and the strength."""
    b, c, h, w = x.shape
    es = x.element_size()
    return es * (2 * b * c * h * w + b * h * w) + 4 * (c + 1)
