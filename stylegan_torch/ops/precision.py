"""Process-wide float32 matmul/conv precision policy (the port's counterpart
of ``stylegan_tpu/ops/precision.py``).

The JAX package defaults to ``Precision.HIGHEST`` so float32 convolutions run
in full float32: the converted-weights fidelity target (<=1e-2 pixel delta at
1024^2) needs it.  On the card, cuDNN runs float32 convolutions in TF32 by
default, which keeps about three decimal digits, so "highest" turns TF32 off
for both cuDNN and cuBLAS; "default" allows it (the perf setting, which bf16
activations take for whatever still runs in float32).

No bf16 GEMM runs: a dense layer on bf16 activations multiplies in float32
and rounds the product, as the JAX package's does (``ops/linear.py``), so
cuBLAS's bf16 split-K reduction (PyTorch's
``allow_bf16_reduced_precision_reduction``) never applies.  cuDNN's bf16
convolutions accumulate in float32.
"""

from __future__ import annotations

import torch

_PRECISION = "highest"


def set_precision(p: str):
    """p: 'highest' (full float32, TF32 off) or 'default' (TF32 allowed)."""
    global _PRECISION
    p = p.lower()
    if p not in ("highest", "default"):
        raise ValueError(f"unknown precision {p!r}: 'highest' or 'default'")
    allow_tf32 = p == "default"
    torch.backends.cudnn.allow_tf32 = allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    _PRECISION = p


def get_precision() -> str:
    return _PRECISION
