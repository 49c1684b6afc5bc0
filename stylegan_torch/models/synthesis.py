"""Synthesis network (reference GSynthesis, GAN.py:103-208 + Blocks.py; the
port's counterpart of ``stylegan_tpu/models/synthesis.py``, unpacked path).

Module names follow the reference state_dict keys, so a converted JAX or
reference checkpoint loads with ``load_state_dict(strict=True)``.  Feature
maps travel as contiguous NHWC tensors (channels-last storage), which is the
layout the epilogue kernel reads.

Per-layer noise is drawn from a ``torch.Generator`` seeded from
(seed, layer index), so skipping a branch never shifts another layer's draw,
or comes from a pinned list of maps (``noises=``, the reference's
NoiseLayer.noise analysis hook, CustomLayers.py:195-198); a pinned map of
batch 1 is shared by every image of the batch, as JAX broadcasts it.

With ``cfg.remat`` each growth block is recomputed in the backward pass
(``torch.utils.checkpoint``): its two epilogue kernels then launch once more
per block in a G update's backward.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import (EqualizedConv2d, EqualizedLinear, add_noise, instance_norm,
                   leaky_relu, make_blur_kernel, pixel_norm, style_modulate,
                   upscale2d)
from ..ops.fused import fused_epilogue
from ..parallel import halo
from .configs import SynthesisConfig

_GAIN = math.sqrt(2)


def stream_seed(seed: int, *stream: int) -> int:
    """A torch seed for one named random stream of a request seed."""
    state = np.random.SeedSequence([seed % 2 ** 64, *stream]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


def make_noise(seed: int, layer_idx: int, batch: int, res: int,
               device, dtype=torch.float32) -> torch.Tensor:
    """Layer `layer_idx`'s (batch, res, res, 1) noise map for `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 0, layer_idx))
    return torch.randn((batch, res, res, 1), generator=g, device=device,
                       dtype=dtype)


def layer_resolution(layer_idx: int) -> int:
    """Resolution of synthesis layer `layer_idx` (two layers per stage)."""
    return 2 ** (layer_idx // 2 + 2)


# --------------------------------------------------------------------------
# Layer epilogue
# --------------------------------------------------------------------------

class NoiseLayer(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels))


class StyleMod(nn.Module):
    def __init__(self, dlatent_size: int, channels: int, use_wscale: bool, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin = EqualizedLinear(dlatent_size, channels * 2, gain=1.0,
                                   use_wscale=use_wscale, generator=generator)


class LayerEpilogue(nn.Module):
    """Post-conv chain (reference LayerEpilogue, CustomLayers.py:219-248).
    State-dict keys ``top_epi.noise.weight`` and ``style_mod.lin.*``."""

    def __init__(self, cfg: SynthesisConfig, channels: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.top_epi = nn.ModuleDict()
        if cfg.use_noise:
            self.top_epi["noise"] = NoiseLayer(channels)
        if cfg.use_styles:
            self.style_mod = StyleMod(cfg.dlatent_size, channels,
                                      cfg.use_wscale, generator=generator)

    def forward(self, x: torch.Tensor, dlatent: Optional[torch.Tensor],
                noise: Optional[torch.Tensor], spatial=None) -> torch.Tensor:
        cfg = self.cfg
        style = self.style_mod.lin(dlatent) if cfg.use_styles else None
        if (cfg.use_noise and not cfg.use_pixel_norm and cfg.use_instance_norm
                and cfg.use_styles and cfg.nonlinearity == "lrelu"):
            # the kernel hardcodes lrelu(0.2)
            return fused_epilogue(x, self.top_epi["noise"].weight, noise,
                                  style, spatial)
        if cfg.use_noise:
            x = add_noise(x, self.top_epi["noise"].weight, noise)
        x = leaky_relu(x) if cfg.nonlinearity == "lrelu" else torch.relu(x)
        if cfg.use_pixel_norm:
            x = pixel_norm(x)
        if cfg.use_instance_norm:
            x = instance_norm(x, spatial=spatial)
        if cfg.use_styles:
            x = style_modulate(x, style)
        return x


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

class InputBlock(nn.Module):
    """4x4 stage (reference InputBlock, Blocks.py:17-60)."""

    def __init__(self, cfg: SynthesisConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        nf = cfg.nf(1)
        if cfg.const_input_layer:
            self.const = nn.Parameter(torch.ones(1, nf, 4, 4))
            self.bias = nn.Parameter(torch.ones(nf))
        else:
            self.dense = EqualizedLinear(cfg.dlatent_size, nf * 16,
                                         gain=_GAIN / 4,
                                         use_wscale=cfg.use_wscale,
                                         generator=generator)
        self.epi1 = LayerEpilogue(cfg, nf, generator=generator)
        self.conv = EqualizedConv2d(nf, nf, 3, gain=_GAIN,
                                    use_wscale=cfg.use_wscale,
                                    generator=generator)
        self.epi2 = LayerEpilogue(cfg, nf, generator=generator)

    def forward(self, dlatents: torch.Tensor, n0, n1) -> torch.Tensor:
        batch = dlatents.shape[0]
        nf = self.cfg.nf(1)
        if self.cfg.const_input_layer:
            # cast, then add: the JAX package's order in bfloat16
            x = (self.const.permute(0, 2, 3, 1).to(dlatents.dtype)
                 + self.bias.to(dlatents.dtype))
            x = x.expand(batch, 4, 4, nf).contiguous()
        else:
            x = self.dense(dlatents[:, 0])
            # the reference reshapes NCHW (B, nf, 4, 4)
            x = x.reshape(batch, nf, 4, 4).permute(0, 2, 3, 1).contiguous()
        x = self.epi1(x, dlatents[:, 0], n0)
        x = self.conv(x)
        return self.epi2(x, dlatents[:, 1], n1)


class GSynthesisBlock(nn.Module):
    """One growth stage (reference GSynthesisBlock, Blocks.py:63-88)."""

    def __init__(self, cfg: SynthesisConfig, in_ch: int, out_ch: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(gain=_GAIN, use_wscale=cfg.use_wscale, generator=generator)
        self.conv0_up = EqualizedConv2d(in_ch, out_ch, 3, **kw)
        self.epi1 = LayerEpilogue(cfg, out_ch, generator=generator)
        self.conv1 = EqualizedConv2d(out_ch, out_ch, 3, **kw)
        self.epi2 = LayerEpilogue(cfg, out_ch, generator=generator)

    def forward(self, x: torch.Tensor, dlatents: torch.Tensor, n0, n1,
                blur_kernel: Optional[torch.Tensor],
                spatial=None) -> torch.Tensor:
        x = self.conv0_up(x, upscale=True, blur_kernel=blur_kernel,
                          spatial=spatial)
        x = self.epi1(x, dlatents[:, 0], n0, spatial)
        x = self.conv1(x, spatial=spatial)
        return self.epi2(x, dlatents[:, 1], n1, spatial)


# --------------------------------------------------------------------------
# Full synthesis network
# --------------------------------------------------------------------------

class GSynthesis(nn.Module):
    """State-dict keys ``init_block.*``, ``blocks.{i}.*``, ``to_rgb.{i}.*``."""

    def __init__(self, cfg: SynthesisConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.init_block = InputBlock(cfg, generator=generator)
        rgb = dict(gain=1.0, use_wscale=cfg.use_wscale, generator=generator)
        to_rgb = [EqualizedConv2d(cfg.nf(1), cfg.num_channels, 1, **rgb)]
        blocks = []
        for res in range(3, cfg.resolution_log2 + 1):
            blocks.append(GSynthesisBlock(cfg, cfg.nf(res - 2),
                                          cfg.nf(res - 1), generator=generator))
            to_rgb.append(EqualizedConv2d(cfg.nf(res - 1), cfg.num_channels,
                                          1, **rgb))
        self.blocks = nn.ModuleList(blocks)
        self.to_rgb = nn.ModuleList(to_rgb)
        # static configuration, not a weight: kept out of the state_dict
        self.register_buffer(
            "blur_kernel", make_blur_kernel(cfg.blur_filter)
            if cfg.blur_filter else None, persistent=False)

    def forward(self, dlatents: torch.Tensor, depth: int = 0, alpha=0.0,
                seed: Optional[int] = None,
                noises: Optional[Sequence[torch.Tensor]] = None,
                spatial=None) -> torch.Tensor:
        """dlatents: (B, num_layers, D) -> images (B, H, W, C) in [-1, 1]-ish.

        A Python `alpha` equal to 1.0 (fade complete) skips the residual
        branch; a tensor alpha always blends (reference GAN.py:175-208).

        `spatial` (a parallel.halo.SpatialContext of n ranks) splits each
        image by height: a stage of side res >= 4n runs on this rank's slab
        of res/n rows (differentiable, once through the epilogue; not
        recomputed under cfg.remat), and the images returned are the rank's
        rows (B, H/n, W, C).  Shorter stages run whole on every rank, and
        the rank cuts its slab from the input of the first stage that
        splits: 8x8 for n = 2 (the 4x4 stage whole), 16x16 for n = 4 (4x4
        and 8x8 whole).  Noise: each rank draws the full map of a split
        layer and takes its rows, so the draws are the unsplit forward's;
        a pinned map of a split layer may be the full map or the rank's
        rows."""
        cfg = self.cfg
        assert depth < cfg.depth, "Requested output depth cannot be produced"
        batch = dlatents.shape[0]

        def noise(layer_idx):
            if not cfg.use_noise:
                return None
            res = layer_resolution(layer_idx)
            if noises is not None:
                n = noises[layer_idx]
                if n.shape[0] == 1 and batch > 1:
                    # a map pinned for every image (the video's frames):
                    # the kernel takes (B, H, W, 1), contiguous
                    n = n.expand(batch, *n.shape[1:]).contiguous()
            elif seed is None:
                raise ValueError("synthesis needs a seed when use_noise=True")
            else:
                n = make_noise(seed, layer_idx, batch, res, dlatents.device,
                               dlatents.dtype)
            if halo.splits(res, spatial) and n.shape[1] == res:
                n = halo.take_rows(n, spatial)
            return n

        def enter(i, x):
            # the slab of block i's input, where block i is the first to
            # split
            if halo.splits(2 ** (i + 3), spatial) and \
                    x.shape[1] == 2 ** (i + 2):
                return halo.take_rows(x, spatial)
            return x

        def block(i, x):
            layer0 = 2 * (i + 1)
            res = 2 ** (i + 3)
            args = (enter(i, x), dlatents[:, layer0:layer0 + 2],
                    noise(layer0), noise(layer0 + 1), self.blur_kernel)
            if halo.splits(res, spatial):
                return self.blocks[i](*args, spatial=spatial)
            if cfg.remat and torch.is_grad_enabled():
                # the noise maps are drawn here and handed in, so the
                # recompute sees the same ones; the block's two epilogues
                # run again in the backward
                return checkpoint(self.blocks[i], *args, use_reentrant=False)
            return self.blocks[i](*args)

        x = self.init_block(dlatents[:, 0:2], noise(0), noise(1))
        if halo.splits(4, spatial):
            x = halo.take_rows(x, spatial)

        if cfg.structure == "fixed":
            for i in range(len(self.blocks)):
                x = block(i, x)
            return self.to_rgb[-1](x)
        if cfg.structure != "linear":
            raise KeyError(f"Unknown structure: {cfg.structure}")

        if depth == 0:
            return self.to_rgb[0](x)
        if not torch.is_tensor(alpha) and float(alpha) == 1.0:
            for i in range(depth):
                x = block(i, x)
            return self.to_rgb[depth](x)

        for i in range(depth - 1):
            x = block(i, x)
        x = enter(depth - 1, x)
        # to_rgb before the nearest upsample: a 1x1 conv commutes with it
        residual = upscale2d(self.to_rgb[depth - 1](x))
        straight = self.to_rgb[depth](block(depth - 1, x))
        return (alpha * straight + (1.0 - alpha) * residual).to(straight.dtype)
