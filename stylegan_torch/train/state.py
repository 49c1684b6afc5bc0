"""Training state and optimizers (the port's counterpart of
``stylegan_tpu/train/state.py``).

Optimizers mirror the reference (GAN.py:529-533, 649-652):
  * D: Adam(lr, betas, eps) on the discriminator's parameters.
  * G: the gradients' global norm clipped at 10, then Adam: the reference's
    clip_grad_norm_ before step, which the JAX package chains in optax.
    torch's clip scales by max / (norm + 1e-6) where optax's scales by
    max / norm: a relative difference below 1e-7 once the norm passes 10.

Adam with b1 = 0 is the same update in both: m = g, v = b2 v + (1 - b2) g^2,
and the step lr * m / (sqrt(v / (1 - b2^t)) + eps).  torch's Adam keeps a
step count per parameter where optax keeps one; the train step gives every
parameter a gradient (zero where none flows, as JAX's dense trees do), so
the counts stay equal.

A TrainState holds the modules and optimizers themselves; the steps update
them in place (the JAX state is an immutable tree that each step replaces).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn


class ClippedAdam(torch.optim.Adam):
    """Adam whose step first clips the gradients' global norm (the G
    optimizer)."""

    def __init__(self, params, clip_norm: float = 10.0, **adam_args):
        super().__init__(params, **adam_args)
        self.clip_norm = clip_norm

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for group in self.param_groups for p in group["params"]
                  if p.grad is not None]
        torch.nn.utils.clip_grad_norm_(params, self.clip_norm)
        return super().step(closure)


def make_d_optimizer(params, learning_rate=0.003, beta_1=0.0, beta_2=0.99,
                     eps=1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=(beta_1, beta_2),
                            eps=eps)


def make_g_optimizer(params, learning_rate=0.003, beta_1=0.0, beta_2=0.99,
                     eps=1e-8, clip_norm=10.0) -> ClippedAdam:
    return ClippedAdam(params, clip_norm=clip_norm, lr=learning_rate,
                       betas=(beta_1, beta_2), eps=eps)


def lazy_reg_adam_correction(opt_args: dict, interval: int) -> dict:
    """StyleGAN2's lazy-regularization correction of the D optimizer's
    hyperparameters: with the penalty applied as a separate update every
    `interval` minibatches, lr *= c and betas **= c, c = interval /
    (interval + 1).  Returns a corrected copy of the make_d_optimizer
    keyword arguments (defaults filled from its signature)."""
    c = interval / (interval + 1)
    out = dict(opt_args)
    out["learning_rate"] = float(out.get("learning_rate", 0.003)) * c
    out["beta_1"] = float(out.get("beta_1", 0.0)) ** c
    out["beta_2"] = float(out.get("beta_2", 0.99)) ** c
    return out


@dataclass
class TrainState:
    """Everything a step updates: G, D, G's EMA shadow (None without EMA)
    and the two optimizers."""
    generator: nn.Module
    discriminator: nn.Module
    g_optimizer: torch.optim.Optimizer
    d_optimizer: torch.optim.Optimizer
    g_shadow: Optional[nn.Module]


def create_train_state(generator: nn.Module, discriminator: nn.Module,
                       g_opt_args: Optional[dict] = None,
                       d_opt_args: Optional[dict] = None,
                       use_ema: bool = True) -> TrainState:
    """A TrainState over the modules; the shadow is a deep copy of the
    generator, its parameters frozen (only the EMA moves them)."""
    shadow = None
    if use_ema:
        shadow = copy.deepcopy(generator).requires_grad_(False)
    return TrainState(
        generator=generator, discriminator=discriminator,
        g_optimizer=make_g_optimizer(generator.parameters(),
                                     **(g_opt_args or {})),
        d_optimizer=make_d_optimizer(discriminator.parameters(),
                                     **(d_opt_args or {})),
        g_shadow=shadow)
