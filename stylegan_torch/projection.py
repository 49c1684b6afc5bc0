"""W-space projection: invert a target image into the generator's W space
(the port's counterpart of ``stylegan_tpu/projection.py``).

Beyond-reference feature (huangzh13/StyleGAN.pytorch ships no projector; the
algorithm follows the official StyleGAN projector's shape — W(+)
optimization from the mapping average with a ramped lr schedule and an
annealed latent perturbation).  The image loss is a multi-scale
Laplacian-pyramid MSE (``metrics/swd.py``'s pyramid), which needs no
downloaded weights; pixel MSE is its finest level.

The randomness is pinned, not matched to JAX's: the mapping draws of
`w_statistics`, the per-layer noise maps (batch 1, drawn once and kept for
the whole run) and each step's W perturbation come from explicit
``torch.Generator``s seeded from the run's seed, or are handed in
(``z=``, ``noises=``, ``perturbation=``), as the tests hand in JAX's.

The update is ``torch.optim.Adam`` (betas (0.9, 0.999), eps 1e-8, its
single-tensor implementation, ``foreach=False``) on the W leaf, its lr set
from `_lr_schedule` before each step: lr * m_hat / (sqrt(v_hat) + eps),
which is optax's ``scale_by_adam`` (eps_root 0) followed by
``dlatents - lr * updates``.  The generator is frozen, so the backward
asks the epilogue's kernels for dx and dstyle only.  No step reads a value
back from the device: the losses stay there until the end (the callback
reads one every 50 steps, as JAX's).

Usage: ``python -m stylegan_torch.cli.project --generator_file ... --target
img.png`` writes the projected image and a ``w.npy`` for
``python -m stylegan_torch.cli.generate_samples --input w.npy``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from .metrics.swd import laplacian_pyramid
from .models.synthesis import layer_resolution, make_noise, stream_seed


@dataclass(frozen=True)
class ProjectorConfig:
    num_steps: int = 1000
    w_plus: bool = True            # per-layer W+ (False: one shared W)
    initial_lr: float = 0.1
    lr_rampup: float = 0.05        # fraction of steps
    lr_rampdown: float = 0.25
    initial_noise_factor: float = 0.05   # latent perturbation, annealed
    noise_ramp: float = 0.75
    pyramid_levels: int = 4
    avg_samples: int = 4096        # mapping draws for w_avg / w_std


class ProjectionState(NamedTuple):
    dlatents: torch.Tensor          # (num_layers|1, D) leaf being optimized
    optimizer: torch.optim.Adam     # over [dlatents]
    rng: torch.Generator            # per-step perturbation draws


def _device(generator) -> torch.device:
    return next(generator.parameters()).device


def w_statistics(gen_cfg, generator, rng: Optional[torch.Generator] = None,
                 n_samples: int = 4096, *, z=None):
    """Mean W and scalar std of the mapping output over random latents
    (the official projector's w_avg / w_std initialization), on the
    generator's device.  z: (n_samples, effective latent) handed in, or
    drawn on the host from `rng`."""
    device = _device(generator)
    dtype = next(generator.parameters()).dtype
    if z is None:
        z = torch.randn((n_samples, gen_cfg.effective_latent_size),
                        generator=rng)
    z = torch.as_tensor(z).to(device, dtype)
    with torch.no_grad():
        w = generator.g_mapping(z[:, :gen_cfg.mapping.latent_size])
        if w.ndim == 3:                # broadcast form (B, num_layers, D)
            w = w[:, 0]
        w_avg = w.mean(dim=0)
        w_std = torch.sqrt(torch.sum(torch.mean(torch.square(w - w_avg),
                                                dim=0)))
    return w_avg, w_std


def pyramid_loss(a: torch.Tensor, b: torch.Tensor, levels: int
                 ) -> torch.Tensor:
    """Multi-scale MSE over Laplacian detail levels (finest first) plus the
    low-res residual; coarser levels weighted up so global structure leads."""
    wide = torch.promote_types(a.dtype, torch.float32)
    pa = laplacian_pyramid(a.to(wide), levels)
    pb = laplacian_pyramid(b.to(wide), levels)
    loss = 0.0
    for lvl, (xa, xb) in enumerate(zip(pa, pb)):
        loss = loss + (2.0 ** lvl) * torch.mean(torch.square(xa - xb))
    return loss


def _lr_schedule(t, cfg: ProjectorConfig) -> float:
    """Official projector schedule: cosine rampdown + linear-ish rampup."""
    frac = t / cfg.num_steps
    rampdown = min(1.0, (1.0 - frac) / cfg.lr_rampdown)
    rampdown = 0.5 - 0.5 * math.cos(rampdown * math.pi)
    rampup = min(1.0, frac / cfg.lr_rampup)
    return cfg.initial_lr * rampdown * rampup


def _pinned_noises(seed: int, gen_cfg, device, dtype=torch.float32):
    """One (1, res, res, 1) noise map per synthesis layer, each from its own
    generator (seeded from (seed, layer)), on `device`."""
    base = stream_seed(seed, 1)
    return [make_noise(base, layer, 1, layer_resolution(layer), device, dtype)
            for layer in range(gen_cfg.num_layers)]


def init_projection(seed: int, gen_cfg, generator, cfg: ProjectorConfig, *,
                    z=None, noises=None):
    """Returns (state, w_std, noises): dlatents start at w_avg; per-layer
    synthesis noise is drawn once (or handed in) and pinned for the whole
    optimization.  Draws: the mapping's z on the host from (seed, 0), the
    noise maps from (seed, 1, layer), the perturbations from (seed, 2) on
    the generator's device."""
    device = _device(generator)
    dtype = next(generator.parameters()).dtype
    w_avg, w_std = w_statistics(
        gen_cfg, generator, torch.Generator().manual_seed(
            stream_seed(seed, 0)), cfg.avg_samples, z=z)
    rows = gen_cfg.num_layers if cfg.w_plus else 1
    dlatents = w_avg[None].repeat(rows, 1).requires_grad_(True)
    if noises is None:
        noises = _pinned_noises(seed, gen_cfg, device, dtype)
    noises = [torch.as_tensor(n).to(device, dtype) for n in noises]
    optimizer = torch.optim.Adam([dlatents], lr=0.0, betas=(0.9, 0.999),
                                 eps=1e-8, foreach=False)
    rng = torch.Generator(device=device).manual_seed(stream_seed(seed, 2))
    return ProjectionState(dlatents, optimizer, rng), w_std, noises


def _synthesize(gen_cfg, generator, dlatents, noises, w_plus: bool):
    num_layers = gen_cfg.num_layers
    wall = (dlatents[None] if w_plus else dlatents[None, 0:1]).expand(
        1, num_layers, dlatents.shape[-1])
    return generator.g_synthesis(wall, depth=gen_cfg.synthesis.depth - 1,
                                 alpha=1.0, noises=noises)


def build_projection_step(gen_cfg, generator, cfg: ProjectorConfig, noises):
    """One projection update: perturb W (annealed), synthesize, score
    against the target, Adam-update the dlatents.  Freezes the generator's
    weights (requires_grad_(False)): the gradient is W's alone.

    step(state, target, t, w_std, perturbation=None) -> (state, loss):
    target (H, W, C) on the generator's device; t the step index (an int);
    perturbation (dlatents' shape) handed in, or drawn from state.rng.
    The state's dlatents and Adam moments are updated in place; the loss
    stays on the device."""
    generator.requires_grad_(False)

    def step(state: ProjectionState, target: torch.Tensor, t, w_std,
             perturbation: Optional[torch.Tensor] = None):
        dlatents = state.dlatents
        frac = t / cfg.num_steps
        noise_scale = (w_std * cfg.initial_noise_factor
                       * max(0.0, 1.0 - frac / cfg.noise_ramp) ** 2)
        if perturbation is None:
            perturbation = torch.randn(dlatents.shape, generator=state.rng,
                                       device=dlatents.device,
                                       dtype=dlatents.dtype)
        pert = dlatents + noise_scale * perturbation
        img = _synthesize(gen_cfg, generator, pert, noises, cfg.w_plus)
        loss = pyramid_loss(img, target[None], cfg.pyramid_levels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in state.optimizer.param_groups:
            group["lr"] = _lr_schedule(t, cfg)
        state.optimizer.step()
        return state, loss.detach()

    return step


def project(seed: int, gen_cfg, generator, target,
            cfg: Optional[ProjectorConfig] = None, callback=None):
    """Full projection run on the generator's device.  target: (H, W, C)
    in [-1, 1] (array or tensor).

    Returns (dlatents (num_layers, D), final image (H, W, C), losses) as
    numpy arrays and a list of floats."""
    cfg = cfg or ProjectorConfig()
    state, w_std, noises = init_projection(seed, gen_cfg, generator, cfg)
    step = build_projection_step(gen_cfg, generator, cfg, noises)
    dl = state.dlatents
    target = torch.as_tensor(target).to(dl.device, dl.dtype)
    losses = []
    for t in range(cfg.num_steps):
        state, loss = step(state, target, t, w_std)
        if callback is not None and (t % 50 == 0 or t == cfg.num_steps - 1):
            callback(t, float(loss))
        losses.append(loss)
    with torch.no_grad():
        img = _synthesize(gen_cfg, generator, dl, noises, cfg.w_plus)
        wall = (dl if cfg.w_plus else dl[0:1]).expand(gen_cfg.num_layers,
                                                      dl.shape[-1])
        return (wall.detach().cpu().numpy(), img[0].cpu().numpy(),
                torch.stack(losses).tolist())
