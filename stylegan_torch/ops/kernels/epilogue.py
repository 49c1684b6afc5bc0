"""CUDA kernel: fused synthesis-layer epilogue (the port's counterpart of
``stylegan_tpu/ops/pallas/epilogue.py``).

    y   = leaky_relu(x + noise_weight[c] * noise, 0.2)
    out = (y - mean_hw(y)) * rsqrt(var_hw(y) + 1e-5) * (s0 + 1) + s1

The kernel is ``stylegan_torch/csrc/epilogue.cu`` (see its header for the
design and what bounds it).  It is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface at first use, cached under
``build/stylegan_torch/`` by a hash of the source, and called through
``ctypes`` on PyTorch's current stream.  The launch geometry is decided in
the source alone; the wrapper asks it for the size of the workspace.

`kernel_epilogue` is the ``torch.autograd.Function`` around the launch (the
counterpart of the JAX ``pallas_epilogue`` custom VJP): its backward
differentiates the plain version, as the JAX backward does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from ..fused import _reference_epilogue

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "epilogue.cu"
BUILD_DIR = _PKG.parent / "build" / "stylegan_torch"

# Calls of epilogue_forward that launched the kernel (one per call, whatever
# number of CUDA launches the call makes).
launches = 0

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           f"{SOURCE.name}")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> tuple[str, str]:
    """Compile the kernel library if this source has not been built yet.

    Returns (path of the shared library, nvcc's report: registers, shared
    memory and spills per kernel; empty when the library was cached)."""
    src = SOURCE.read_bytes()
    so = BUILD_DIR / f"libepilogue-{hashlib.sha256(src).hexdigest()[:16]}.so"
    if so.exists():
        return str(so), ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(SOURCE)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees a partial file
    return str(so), r.stderr


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # is_bf16 B R C x out
        lib.sgt_epilogue_splits.argtypes = [i, i, ll, i, p, p]
        lib.sgt_epilogue_splits.restype = ctypes.c_int
        lib.sgt_epilogue_forward.argtypes = [
            p, p, p, p, p, p, p,  # x noise nw style out partials stats
            i, i, ll, i, i,       # is_bf16 B R C splits
            p]                    # stream
        lib.sgt_epilogue_forward.restype = ctypes.c_int
        _lib = lib
    return _lib


def epilogue_forward(x: torch.Tensor, noise_weight: torch.Tensor,
                     noise: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  x: (B, H, W, C) contiguous NHWC (channels-last
    storage), float32 or bfloat16, on a CUDA device; noise (B, H, W, 1) of
    x's dtype; noise_weight (C,) and style (B, 2C) float32.  Raises on
    anything else, never copies."""
    global launches
    if x.ndim != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be 4-D float32/bfloat16 NHWC, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, h, w, c = x.shape
    for name, t, shape, dtype in (
            ("noise", noise, (b, h, w, 1), x.dtype),
            ("noise_weight", noise_weight, (c,), torch.float32),
            ("style", style, (b, 2 * c), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (channels_last NCHW)")
    if x.device.type != "cuda":
        raise ValueError(f"epilogue kernel needs a CUDA tensor, got {x.device}")
    rows, is_bf16 = h * w, int(x.dtype == torch.bfloat16)
    lib = _library()
    out = torch.empty_like(x)
    splits = lib.sgt_epilogue_splits(is_bf16, b, rows, c, x.data_ptr(),
                                     out.data_ptr())
    partials = torch.empty((b, splits, c, 2), dtype=torch.float32,
                           device=x.device)
    stats = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sgt_epilogue_forward(
            x.data_ptr(), noise.data_ptr(), noise_weight.data_ptr(),
            style.data_ptr(), out.data_ptr(), partials.data_ptr(),
            stats.data_ptr(), is_bf16, b, rows, c, splits, stream)
    if err != 0:
        raise RuntimeError(f"epilogue kernel launch failed: cudaError {err}")
    launches += 1
    return out


def bytes_moved(x: torch.Tensor) -> int:
    """Bytes the epilogue must move: x and noise read once, out written once,
    plus noise_weight and style (float32)."""
    b, h, w, c = x.shape
    return (x.element_size() * b * h * w * (2 * c + 1)
            + 4 * (c + 2 * b * c))


class _KernelEpilogue(torch.autograd.Function):
    """Forward: the kernel.  Backward: autograd of the plain version, which is
    exactly what the CPU path computes (as the JAX custom VJP's _bwd)."""

    @staticmethod
    def forward(ctx, x, noise_weight, noise, style):
        ctx.save_for_backward(x, noise_weight, noise, style)
        return epilogue_forward(x, noise_weight, noise, style)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y = _reference_epilogue(*inputs)
            grads = iter(torch.autograd.grad(y, wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def kernel_epilogue(x, noise_weight, noise, style):
    """Differentiable kernel epilogue; same arguments as epilogue_forward."""
    return _KernelEpilogue.apply(x, noise_weight, noise, style)
