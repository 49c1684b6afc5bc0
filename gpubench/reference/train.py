"""One StyleGAN training update in plain PyTorch, float32: the
progressive fade of the reals, the D update with the logistic loss and
R1, the G update with the non-saturating logistic loss, G's gradient
clipped at global norm 10, Adam on both, and the EMA of G's parameters
(reference GAN.py:557-659, Losses.py:192-229, models/__init__.py:13-40).

Every parameter gets a gradient on each update, zero where none flows (a
from_rgb or to_rgb the depth does not use), so that Adam counts the same
steps for every parameter.  There is no W average to follow: a
configuration with truncation off (psi <= 0, as the published ones) keeps
none, and the reference refuses one with truncation on.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import draws, nets


def fade_reals(reals, total_depth: int, depth: int, alpha):
    """Reals (B, C, R, R) at the depth's resolution, blended by alpha with
    the 2x nearest upsample of the half resolution."""
    factor = 2 ** (total_depth - depth - 1)
    ds = F.avg_pool2d(reals, factor) if factor > 1 else reals
    if depth == 0:
        return ds
    prior = F.interpolate(F.avg_pool2d(reals, factor * 2), scale_factor=2,
                          mode="nearest")
    return alpha * ds + (1 - alpha) * prior


class Adam:
    """torch.optim.Adam's update, written out; `clip` scales the
    gradients to a global norm of at most that first."""

    def __init__(self, params: dict, lr, betas, eps, clip=None):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.clip = clip
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Applies one update; returns the gradients as the update took
        them (after clipping)."""
        if self.clip is not None:
            total = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads.values()]))
            scale = torch.clamp(self.clip / (total + 1e-6), max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
        return grads


def _grads(loss, params: dict) -> dict:
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), got)}


class Trainer:
    """G, D, G's shadow and the two Adams of one training run, from one
    dict of named float32 tensors (G's names and D's, as nets lays them
    out)."""

    def __init__(self, arch, opt, weights: dict, q=nets._ident):
        if arch["truncation_psi"] > 0:
            raise NotImplementedError("the W average of truncation")
        self.arch, self.opt, self.q = arch, opt, q
        g_names, d_names = nets.g_shapes(arch), nets.d_shapes(arch)
        self.g = {k: weights["g." + k].clone().float().requires_grad_()
                  for k in g_names}
        self.d = {k: weights["d." + k].clone().float().requires_grad_()
                  for k in d_names}
        self.shadow = {k: v.detach().clone() for k, v in self.g.items()}
        go, do = opt["g_optim"], opt["d_optim"]
        self.g_adam = Adam(self.g, go["learning_rate"],
                           (go["beta_1"], go["beta_2"]), go["eps"], clip=10.0)
        self.d_adam = Adam(self.d, do["learning_rate"],
                           (do["beta_1"], do["beta_2"]), do["eps"])

    def _g(self, z, depth, alpha, seed, dtype):
        return nets.generator(self.g, self.arch, z, depth, alpha, seed,
                              train=True, dtype=dtype, q=self.q)

    def _d(self, images, depth, alpha):
        return nets.discriminator(self.d, self.arch, images, depth, alpha,
                                  self.q)

    def step(self, reals, z, seed: int, depth: int, alpha, r1_gamma: float,
             dtype):
        """One update on reals (B, C, R, R) at the full resolution and z
        (B, latent); `seed` the step seed.  Returns (d_loss, g_loss, the
        gradients Adam took for G, for D)."""
        total = nets.log2res(self.arch) - 1
        reals = fade_reals(reals, total, depth, alpha)
        with torch.no_grad():
            fakes = self._g(z, depth, alpha, draws.stream(seed, 0), dtype)
        d_loss = (F.softplus(self._d(fakes, depth, alpha)).mean()
                  + F.softplus(-self._d(reals, depth, alpha)).mean())
        if r1_gamma:
            x = reals.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(self._d(x, depth, alpha).sum(), x,
                                        create_graph=True)
            d_loss = d_loss + gx.square().sum() * (r1_gamma * 0.5)
        d_grads = self.d_adam.step(_grads(d_loss, self.d))

        fakes = self._g(z, depth, alpha, draws.stream(seed, 1), dtype)
        g_loss = F.softplus(-self._d(fakes, depth, alpha)).mean()
        g_grads = self.g_adam.step(_grads(g_loss, self.g))
        beta = self.opt["ema_decay"]
        with torch.no_grad():
            for k, v in self.shadow.items():
                v.lerp_(self.g[k], 1.0 - beta)
        return d_loss.item(), g_loss.item(), g_grads, d_grads
