"""Fused layer-epilogue dispatch (the port's counterpart of
``stylegan_tpu/ops/fused.py``).

The synthesis epilogue (noise-add -> leaky-relu -> instance-norm -> AdaIN) is
element-wise work plus a per-channel reduction, bound by memory traffic.
On the card it always runs as the hand-written CUDA kernel
(``ops/kernels/epilogue.py``); a CPU tensor takes the plain composition,
which is also the ground truth the kernel is held to.  The JAX package's
opt-in switch was a TPU trade-off and has no counterpart here.
"""

from __future__ import annotations

import torch

from .primitives import add_noise, instance_norm, leaky_relu, style_modulate


def _reference_epilogue(x, noise_weight, noise, style):
    x = add_noise(x, noise_weight, noise)
    x = leaky_relu(x)
    x = instance_norm(x)
    return style_modulate(x, style)


def fused_epilogue(x: torch.Tensor, noise_weight: torch.Tensor,
                   noise: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """noise-add -> lrelu(0.2) -> instance-norm(eps 1e-5) -> AdaIN.

    x: (B, H, W, C); noise: (B, H, W, 1); noise_weight: (C,); style: (B, 2C).
    A CUDA x launches the kernel, which takes x and noise in one dtype
    (float32 or bfloat16) and noise_weight and style in float32, and raises
    on anything else; a CPU x runs the plain version.
    """
    if x.device.type == "cuda":
        from .kernels.epilogue import kernel_epilogue
        return kernel_epilogue(x, noise_weight, noise, style)
    if x.device.type == "cpu":
        return _reference_epilogue(x, noise_weight, noise, style)
    raise ValueError(f"no epilogue for device {x.device}")
