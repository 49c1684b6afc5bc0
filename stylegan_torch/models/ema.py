"""Exponential moving average of generator parameters (the port's
counterpart of ``stylegan_tpu/models/ema.py``; reference
models/__init__.py:13-40).

shadow <- beta * shadow + (1 - beta) * param over the *parameters only*: the
truncation ``avg_latent`` buffer is a statistic, not a parameter, and stays
as it is, as the reference's ``named_parameters()`` loop leaves it.  The
update is in place (one fused ``lerp_`` over the parameter list), where the
JAX package builds a new tree.
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def ema_update(shadow: nn.Module, model: nn.Module, beta: float) -> None:
    """Moves `shadow`'s parameters toward `model`'s, in place: shadow +=
    (1 - beta) * (param - shadow), which is beta * shadow + (1 - beta) *
    param.  beta = 0 copies the parameters."""
    s_params = list(shadow.parameters())
    m_params = list(model.parameters())
    if len(s_params) != len(m_params):
        raise ValueError("shadow and model have different parameters")
    torch._foreach_lerp_(s_params, m_params, 1.0 - beta)
