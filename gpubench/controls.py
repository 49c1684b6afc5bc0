"""The control of each configuration: the reference computed one
precision below the one the configuration states, the step that would
tempt a later change.  A float32 configuration with TF32 off: TF32 (every
cuDNN convolution and cuBLAS product).  bf16 activations: fp8 (e4m3)
activations and activation gradients: every activation an op produces
rounded to fp8 with a per-tensor scale (its largest magnitude at 448), as
the bf16 program rounds each to bf16, and the gradient flowing back
through each rounded the same way, to any order.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def _round(t):
    s = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t)

    @staticmethod
    def backward(ctx, g):
        return _Fp8.apply(g)


def fp8(t):
    return _Fp8.apply(t)


def _ident(t):
    return t


def lower(name):
    """(activation rounding, TF32 on) of a control: None, 'tf32', 'fp8'."""
    if name is None:
        return _ident, False
    if name == "tf32":
        return _ident, True
    if name == "fp8":
        return fp8, False
    raise ValueError(f"unknown control {name!r}")


def for_config(config: dict) -> str:
    act = config["overlay"]["precision"]["activations"]
    return {"float32": "tf32", "bfloat16": "fp8"}[act]
