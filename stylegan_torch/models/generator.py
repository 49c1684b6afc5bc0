"""Style-based generator (reference Generator, GAN.py:211-297; the port's
counterpart of ``stylegan_tpu/models/generator.py``).

Composes mapping + truncation + synthesis.  Training-mode semantics reproduce
the reference, including its idiosyncrasies:

* W moving average updated from the *first batch element only*
  (GAN.py:278: truncation.update(dlatents_in[0, 0])).
* Style-mixing regularization: with prob `style_mixing_prob` draw a cutoff
  uniformly in [1, 2*(depth+1)] and splice a second mapping pass's W above it
  (GAN.py:281-289).
* The truncation lerp is applied in the *training* branch (GAN.py:291-293).

As in the JAX package, train mode returns the updated W average and leaves
the ``truncation.avg_latent`` buffer as it was: the caller stores it.  All
randomness derives from the explicit `seed`; the mixing draws can also be
pinned with `mixing=(latents2, cutoff)`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import truncate_dlatents, update_moving_average
from ..parallel.distributed import broadcast_
from .configs import GeneratorConfig
from .mapping import GMapping
from .synthesis import GSynthesis, stream_seed


class GeneratorOutput(NamedTuple):
    images: torch.Tensor
    avg_latent: Optional[torch.Tensor]  # updated W moving average (train mode)


class Truncation(nn.Module):
    def __init__(self, dlatent_size: int):
        super().__init__()
        self.register_buffer("avg_latent", torch.zeros(dlatent_size))


def embed_labels(weight: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.embedding(labels, weight)


def draw_mixing(seed: int, shape, depth: int, mixing_prob: float, device,
                dtype=torch.float32):
    """The style-mixing draws of one train-mode call: second latents of
    `shape` and the cutoff, which is 2*(depth+1) (nothing mixes) when the
    coin says no."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 1))
    latents2 = torch.randn(shape, generator=g, device=device, dtype=dtype)
    cur_layers = 2 * (depth + 1)
    h = torch.Generator().manual_seed(stream_seed(seed, 2))
    cutoff = int(torch.randint(1, cur_layers + 1, (), generator=h))
    do_mix = float(torch.rand((), generator=h)) < mixing_prob
    return latents2, (cutoff if do_mix else cur_layers)


def mix_styles(dlatents: torch.Tensor, dlatents2: torch.Tensor,
               cutoff: int) -> torch.Tensor:
    """Style-mixing splice (reference GAN.py:284-289): dlatents2 for the
    layers >= cutoff."""
    layer_idx = torch.arange(dlatents.shape[1], device=dlatents.device)
    return torch.where(layer_idx[None, :, None] < cutoff, dlatents, dlatents2)


class Generator(nn.Module):
    """State-dict keys ``g_mapping.*``, ``g_synthesis.*``,
    ``truncation.avg_latent`` and ``class_embedding.weight``."""

    def __init__(self, cfg: GeneratorConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.g_mapping = GMapping(cfg.mapping, generator=generator)
        self.g_synthesis = GSynthesis(cfg.synthesis, generator=generator)
        if cfg.use_truncation:
            self.truncation = Truncation(cfg.dlatent_size)
        if cfg.conditional:
            if cfg.n_classes <= 0:
                raise ValueError("Conditional generation requires n_classes > 0")
            self.class_embedding = nn.Embedding(cfg.n_classes, cfg.latent_size)
            with torch.no_grad():  # nn.Embedding's N(0, 1), from `generator`
                self.class_embedding.weight.copy_(torch.randn(
                    cfg.n_classes, cfg.latent_size, generator=generator))

    def forward(self, latents: torch.Tensor, depth: int, alpha=1.0,
                seed: Optional[int] = None, train: bool = False,
                labels: Optional[torch.Tensor] = None, noises=None,
                mixing=None, spatial=None, avg_from=None) -> GeneratorOutput:
        """latents: (B, latent_size) -> images (B, H, W, C); with `spatial`
        (a parallel.halo.SpatialContext) this rank's rows of them
        (GSynthesis.forward).  `avg_from` (a parallel.Mesh whose rank 0
        holds the global batch's first sample, where `latents` is a shard of
        it): train mode's W average is updated from that sample's W on every
        rank, as the forward on the global batch updates it."""
        cfg = self.cfg
        if cfg.conditional:
            if labels is None:
                raise ValueError("Conditional generation requires labels")
            emb = embed_labels(self.class_embedding.weight, labels)
            latents = torch.cat([latents, emb.to(latents.dtype)], dim=1)

        dlatents = self.g_mapping(latents)

        new_avg = self.truncation.avg_latent if cfg.use_truncation else None
        if train:
            if cfg.use_truncation:
                w0 = dlatents[0, 0].detach()
                if avg_from is not None:
                    w0 = w0.clone()
                    broadcast_([w0], avg_from)
                new_avg = update_moving_average(new_avg, w0,
                                                cfg.dlatent_avg_beta)
            if cfg.style_mixing_prob is not None and cfg.style_mixing_prob > 0:
                if mixing is None:
                    if seed is None:
                        raise ValueError("train mode needs a seed or mixing=")
                    mixing = draw_mixing(seed, latents.shape, depth,
                                         cfg.style_mixing_prob,
                                         latents.device, latents.dtype)
                latents2, cutoff = mixing
                dlatents = mix_styles(dlatents, self.g_mapping(latents2),
                                      cutoff)
            if cfg.use_truncation:
                dlatents = truncate_dlatents(dlatents, new_avg.detach(),
                                             cfg.truncation_psi,
                                             cfg.truncation_cutoff)

        images = self.g_synthesis(dlatents, depth=depth, alpha=alpha,
                                  seed=seed, noises=noises, spatial=spatial)
        return GeneratorOutput(images=images, avg_latent=new_avg)
