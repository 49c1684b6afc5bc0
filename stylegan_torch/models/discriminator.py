"""Discriminator (reference Discriminator, GAN.py:300-444 + Blocks.py:91-146;
the port's counterpart of ``stylegan_tpu/models/discriminator.py``, unpacked
path).

Mirrored progressive architecture: per-stage from_rgb 1x1 convs, conv ->
blur -> downscale-conv blocks, and a final minibatch-stddev + conv + dense
head.  Module names follow the reference state_dict keys (``blocks.{i}.
{conv0,conv1_down}``, ``from_rgb.{i}``, ``final_block.{conv,dense0,dense1}``,
``embeddings.{i}.weight``), so a converted JAX or reference checkpoint loads
with ``load_state_dict(strict=True)``.  Feature maps travel as contiguous
NHWC tensors, as in the generator.

The head flattens the 4x4 map in channel-major (NCHW) order, so the dense
weights stay interchangeable with the reference's (View(-1), Blocks.py:127).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import (EqualizedConv2d, EqualizedLinear, avg_pool2d, leaky_relu,
                   make_blur_kernel, minibatch_stddev)
from ..ops.primitives import to_nchw
from .configs import DiscriminatorConfig

_GAIN = math.sqrt(2)


def _act(cfg: DiscriminatorConfig):
    return leaky_relu if cfg.nonlinearity == "lrelu" else torch.relu


class DiscriminatorBlock(nn.Module):
    """conv0 -> act -> blur -> conv1_down -> act (Blocks.py:137-146)."""

    def __init__(self, cfg: DiscriminatorConfig, in_ch: int, out_ch: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(gain=_GAIN, use_wscale=cfg.use_wscale, generator=generator)
        self.act = _act(cfg)
        self.conv0 = EqualizedConv2d(in_ch, in_ch, 3, **kw)
        self.conv1_down = EqualizedConv2d(in_ch, out_ch, 3, **kw)

    def forward(self, x: torch.Tensor,
                blur_kernel: torch.Tensor) -> torch.Tensor:
        x = self.act(self.conv0(x))
        return self.act(self.conv1_down(x, downscale=True,
                                        pre_blur_kernel=blur_kernel))


class DiscriminatorTop(nn.Module):
    """Final block (reference DiscriminatorTop, Blocks.py:91-134)."""

    def __init__(self, cfg: DiscriminatorConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        in_ch = cfg.nf(2)
        self.conv = EqualizedConv2d(in_ch + cfg.mbstd_num_features, in_ch, 3,
                                    gain=_GAIN, use_wscale=cfg.use_wscale,
                                    generator=generator)
        self.dense0 = EqualizedLinear(in_ch * 16, in_ch, gain=_GAIN,
                                      use_wscale=cfg.use_wscale,
                                      generator=generator)
        self.dense1 = EqualizedLinear(in_ch, 1, gain=1.0,
                                      use_wscale=cfg.use_wscale,
                                      generator=generator)

    def forward(self, x: torch.Tensor, mbstd_chunks: int = 1,
                mbstd_axis=None) -> torch.Tensor:
        cfg, act = self.cfg, _act(self.cfg)
        if cfg.mbstd_group_size > 1:
            x = minibatch_stddev(x, cfg.mbstd_group_size,
                                 cfg.mbstd_num_features, chunks=mbstd_chunks,
                                 axis_name=mbstd_axis)
        x = act(self.conv(x))
        # channel-major flatten for the reference's dense weight layout
        x = to_nchw(x).reshape(x.shape[0], -1)
        return self.dense1(act(self.dense0(x)))


class Discriminator(nn.Module):
    """images (B, H, W, C) at resolution 2^(depth+2) -> scores (B, 1)."""

    def __init__(self, cfg: DiscriminatorConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        rlog2 = cfg.resolution_log2
        rgb = dict(gain=_GAIN, use_wscale=cfg.use_wscale, generator=generator)
        blocks, from_rgb, embeddings = [], [], []
        for res in range(rlog2, 2, -1):
            blocks.append(DiscriminatorBlock(cfg, cfg.nf(res - 1),
                                             cfg.nf(res - 2),
                                             generator=generator))
            from_rgb.append(EqualizedConv2d(cfg.input_channels,
                                            cfg.nf(res - 1), 1, **rgb))
            if cfg.conditional:
                embeddings.append(self._embedding(2 ** res, generator))
        from_rgb.append(EqualizedConv2d(cfg.input_channels, cfg.nf(2), 1,
                                        **rgb))
        self.blocks = nn.ModuleList(blocks)
        self.from_rgb = nn.ModuleList(from_rgb)
        self.final_block = DiscriminatorTop(cfg, generator=generator)
        if cfg.conditional:
            if cfg.n_classes <= 0:
                raise ValueError("A conditional discriminator needs "
                                 "n_classes > 0")
            embeddings.append(self._embedding(4, generator))
            self.embeddings = nn.ModuleList(embeddings)
        # the reference D always blurs, [1, 2, 1] by default (Blocks.py:143,
        # CustomLayers.py:254-255); static configuration, not a weight
        self.register_buffer(
            "blur_kernel", make_blur_kernel(cfg.blur_filter or (1, 2, 1)),
            persistent=False)

    def _embedding(self, res: int, generator) -> nn.Embedding:
        cfg = self.cfg
        emb = nn.Embedding(cfg.n_classes, cfg.num_channels * res * res)
        with torch.no_grad():  # nn.Embedding's N(0, 1), from `generator`
            emb.weight.copy_(torch.randn(emb.weight.shape,
                                         generator=generator))
        return emb

    def _label_planes(self, idx: int, images: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
        """The label embedding as image planes, channel-concatenated
        (reference GAN.py:402-437; its view is NCHW, channel-major)."""
        b, h, w, _ = images.shape
        emb = F.embedding(labels, self.embeddings[idx].weight)
        emb = emb.reshape(b, -1, h, w).permute(0, 2, 3, 1)
        return torch.cat([images, emb.to(images.dtype)], dim=-1)

    def _block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Block i, recomputed in the backward pass when cfg.remat."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(self.blocks[i], x, self.blur_kernel,
                              use_reentrant=False)
        return self.blocks[i](x, self.blur_kernel)

    def forward(self, images: torch.Tensor, depth: int, alpha=1.0,
                labels: Optional[torch.Tensor] = None,
                mbstd_chunks: int = 1, mbstd_axis=None) -> torch.Tensor:
        cfg = self.cfg
        assert depth < cfg.depth, "Requested output depth cannot be produced"
        if cfg.conditional and labels is None:
            raise ValueError("A conditional discriminator needs labels")

        if cfg.structure == "fixed":
            if cfg.conditional:
                images = self._label_planes(0, images, labels)
            x = self.from_rgb[0](images)
            for i in range(len(self.blocks)):
                x = self._block(i, x)
            return self.final_block(x, mbstd_chunks, mbstd_axis)
        if cfg.structure != "linear":
            raise KeyError(f"Unknown structure: {cfg.structure}")

        if depth > 0:
            top = cfg.depth - depth - 1      # the block at this resolution
            if cfg.conditional:
                images = self._label_planes(top, images, labels)
            residual = self.from_rgb[top + 1](avg_pool2d(images, 2))
            straight = self._block(top, self.from_rgb[top](images))
            # blend in the activation dtype (alpha may be a float32 tensor)
            x = (alpha * straight + (1.0 - alpha) * residual).to(
                straight.dtype)
            for i in range(top + 1, len(self.blocks)):
                x = self._block(i, x)
        else:
            if cfg.conditional:
                images = self._label_planes(-1, images, labels)
            x = self.from_rgb[-1](images)
        return self.final_block(x, mbstd_chunks, mbstd_axis)
