"""CUDA kernels: StyleGAN2's layer epilogue (``csrc/epilogue2.cu``).

    out = sqrt(2) * leaky_relu(x + strength * noise + bias[c], 0.2)

after each modulated convolution; after an up-convolution x is the 4x4
FIR of its (2H+1)^2 output, applied inside the kernel.  The source is
compiled with ``nvcc`` for ``sm_90a`` into a library of its own
(``build/stylegan_torch/libepilogue2-<sources hash>.so``, by
``epilogue.build``) at first use and called through ``ctypes`` on
PyTorch's current stream, one launch a call.  The library holds StyleGAN2's
up-convolution too (``csrc/modconv_up.cu``, bound by
``ops/kernels/modconv_up.py``).

It reaches PyTorch as two ``torch.library`` ops, each with a fake that
checks the inputs and gives the output's shape, for ``torch.export``:

* ``stylegan_torch::epilogue2`` (x, noise, bias, strength) -> out, the
  same-size layers': x (B, C, H, W) and noise (B, 1, H, W);
* ``stylegan_torch::epilogue2_up`` (y, fir, noise, bias, strength) -> out,
  the up-layers': y (B, C, 2H+1, 2H+1), the transposed convolution's
  output, fir (4, 4) the FIR normalised to sum 1 (applied at gain 4,
  flipped, with one pixel of zero padding a side, as
  ``ops/modconv.py::_fir``), noise (B, 1, 2H, 2H), out (B, C, 2H, 2H).

All tensors contiguous NCHW float32 on one device, bias (C,), strength
0-d.  The CUDA implementations are `epilogue2_forward` and
`epilogue2_up_forward`; the CPU implementations, registered by
``ops/modconv.py``, are the plain versions.  The ops have no backward:
StyleGAN2 runs on the serving path only.  The names start with
``stylegan_torch::epilogue``, under which ``gpubench/trace.py`` finds the
epilogue's kernels.

Counts in ``utils.profiling.counters``, taken where each kernel launches:
``epilogue2.up_launches``, the up-layer kernel's launches, and
``epilogue2.cuda_launches``, both kernels' (one a call on the card);
``ops/modconv.py`` counts the layer epilogues' calls on either device.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.profiling import counters
from .epilogue import _PKG, _on_device, _stream, build

SOURCES = (_PKG / "csrc" / "epilogue2.cu", _PKG / "csrc" / "modconv_up.cu")

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
        # y fir noise bias strength out, B C S (y's side), stream
        lib.sgt_epilogue2_up.argtypes = [p, p, p, p, p, p, i, i, i, p]
        lib.sgt_epilogue2_up.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_inputs(x, noise, bias, strength):
    """Raise unless the tensors are what the same-size kernel takes (the
    fake runs this too, on whatever device the trace's is)."""
    if x.ndim != 4 or x.dtype != torch.float32:
        raise ValueError(f"x must be 4-D float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    b, c, h, w = x.shape
    _check(x, [("x", x, (b, c, h, w)), ("noise", noise, (b, 1, h, w)),
               ("bias", bias, (c,)), ("strength", strength, ())])


def check_inputs_up(y, fir, noise, bias, strength):
    """Raise unless the tensors are what the up-layer kernel takes: y
    (B, C, 2H+1, 2H+1), a square plane as every up-layer's is, the rest as
    the same-size kernel's for the (B, C, 2H, 2H) output, and fir (4, 4)."""
    if y.ndim != 4 or y.dtype != torch.float32:
        raise ValueError(f"y must be 4-D float32, got {tuple(y.shape)} "
                         f"{y.dtype}")
    b, c, h, w = y.shape
    if h != w or h % 2 != 1 or h < 3:
        raise ValueError(f"y must be an up-convolution's square (2H+1)^2 "
                         f"plane, got {h} x {w}")
    _check(y, [("y", y, (b, c, h, w)), ("fir", fir, (4, 4)),
               ("noise", noise, (b, 1, h - 1, w - 1)), ("bias", bias, (c,)),
               ("strength", strength, ())])


def _check(x, checks):
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


def epilogue2_up_forward(y, fir, noise, bias, strength) -> torch.Tensor:
    """Launch the up-layer kernel on y's device."""
    check_inputs_up(y, fir, noise, bias, strength)
    if y.device.type != "cuda":
        raise ValueError(f"the epilogue2_up kernel needs a CUDA tensor, got "
                         f"{y.device}")
    out = _up_output(y)
    _on_device(y.device, _launch_up, y, fir, noise, bias, strength, out)
    return out


def _up_output(y):
    b, c, h, w = y.shape
    return y.new_empty((b, c, h - 1, w - 1))


def _launch(x, noise, bias, strength, out):
    b, c, h, w = x.shape
    err = _library().sgt_epilogue2(
        x.data_ptr(), noise.data_ptr(), bias.data_ptr(), strength.data_ptr(),
        out.data_ptr(), b, h * w, c, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"epilogue2 kernel launch failed: cudaError {err}")
    counters["epilogue2.cuda_launches"] += 1


def _launch_up(y, fir, noise, bias, strength, out):
    b, c, side, _ = y.shape
    err = _library().sgt_epilogue2_up(
        y.data_ptr(), fir.data_ptr(), noise.data_ptr(), bias.data_ptr(),
        strength.data_ptr(), out.data_ptr(), b, c, side, _stream(y.device))
    if err != 0:
        raise RuntimeError(f"epilogue2_up kernel launch failed: cudaError "
                           f"{err}")
    counters["epilogue2.up_launches"] += 1
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


@torch.library.custom_op("stylegan_torch::epilogue2_up", mutates_args=(),
                         device_types="cuda")
def epilogue2_up_op(y: torch.Tensor, fir: torch.Tensor, noise: torch.Tensor,
                    bias: torch.Tensor, strength: torch.Tensor) -> torch.Tensor:
    return epilogue2_up_forward(y, fir, noise, bias, strength)


@epilogue2_up_op.register_fake
def _(y, fir, noise, bias, strength):
    check_inputs_up(y, fir, noise, bias, strength)
    return _up_output(y)


def bytes_moved(x: torch.Tensor) -> int:
    """The bytes a call on x must move: x read and out written once, one
    noise value a pixel, the bias and the strength."""
    b, c, h, w = x.shape
    es = x.element_size()
    return es * (2 * b * c * h * w + b * h * w) + 4 * (c + 1)


def bytes_moved_up(y: torch.Tensor) -> int:
    """The bytes an up-layer call on y (B, C, 2H+1, 2H+1) must move: y
    read and the (2H, 2H) out written once, one noise value an output
    pixel, the bias, the strength and the 16 taps."""
    b, c, h, w = y.shape
    n = b * (h - 1) * (w - 1)
    return y.element_size() * (b * c * h * w + n * c + n) + 4 * (c + 17)
