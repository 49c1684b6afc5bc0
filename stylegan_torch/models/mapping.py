"""Z -> W mapping network (reference GMapping, GAN.py:37-100; the port's
counterpart of ``stylegan_tpu/models/mapping.py``).

A stack of equalized-LR dense layers with lrmul=0.01 and leaky-relu, with
optional PixelNorm on the input latents and broadcast of W over the synthesis
layers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops import EqualizedLinear, leaky_relu, pixel_norm
from .configs import MappingConfig

_GAIN = math.sqrt(2)


class GMapping(nn.Module):
    """State-dict keys ``map.dense{i}.{weight,bias}``."""

    def __init__(self, cfg: MappingConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.map = nn.ModuleDict({
            f"dense{i}": EqualizedLinear(
                fin, fout, gain=_GAIN, use_wscale=cfg.use_wscale,
                lrmul=cfg.mapping_lrmul, generator=generator)
            for i, (fin, fout) in enumerate(cfg.layer_dims())})

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        """latents: (B, latent_size) -> W: (B, dlatent) or (B, broadcast, dlatent)."""
        cfg = self.cfg
        x = pixel_norm(latents) if cfg.normalize_latents else latents
        act = leaky_relu if cfg.mapping_nonlinearity == "lrelu" else torch.relu
        for layer in self.map.values():
            x = act(layer(x))
        if cfg.dlatent_broadcast is not None:
            x = x[:, None, :].expand(x.shape[0], cfg.dlatent_broadcast,
                                     x.shape[-1])
        return x
