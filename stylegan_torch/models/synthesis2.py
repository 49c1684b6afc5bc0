"""StyleGAN2's synthesis network, config F's skip generator (Karras et al.,
arXiv:1912.04958; NVlabs/stylegan2 ``G_synthesis_stylegan2`` with
``architecture='skip'``), for serving.

* A learned 4x4 constant, then per resolution a 3x3 modulated
  up-convolution (not at 4x4) and a 3x3 modulated convolution, each
  followed by the layer epilogue sqrt(2) * lrelu(x + strength * noise + b,
  0.2) (``ops/modconv.py``): 2 log2(res) - 3 layers (17 at 1024^2), of
  which log2(res) - 2 (8) are up-layers, whose epilogue applies the
  up-convolution's FIR too (`layer_epilogue_up`).
* 2 log2(res) - 2 W inputs (18): layer i takes W[i]; the toRGB at
  resolution 2^k takes W[2k - 3], the index of the next block's first
  layer.
* Skip outputs: y = upsample(y) + toRGB_r(x), toRGB a 1x1 modulated
  convolution without demodulation and a bias; no tanh, no fade.
* Noise: one scalar strength a layer; layer i's (B, 1, R, R) map, R =
  2 ** ((i + 5) // 2), drawn from the request seed (``make_noise``, stream
  (seed, 0, i)) or pinned (``noises=``, maps (B or 1, R, R, 1) as
  ``make_noise`` returns them).

State-dict keys: ``const``; ``layers.{i}.weight`` (cout, cin, 3, 3),
``.bias``, ``.noise_strength`` (0-d), ``.affine.weight`` (cin, dlatent),
``.affine.bias``; ``to_rgb.{j}.weight`` (C, cin, 1, 1), ``.bias``,
``.affine.*``.  Kernels are stored as the TF original's, transposed to
OIHW and not flipped; the up-convolution flips them as TF does.

The modulated convolutions run in the fused form on NCHW planes (module
docstring of ``ops/modconv.py``): on the card the 3x3 same-size layers'
and the toRGBs' grouped convolutions, and the skip upsample's depthwise
transposed convolution, are cuDNN's; the up-convolution is the port's own
kernel (``stylegan_torch::modconv_up``, ``csrc/modconv_up.cu``).  All
styles, demodulation factors and per-sample kernels are computed first,
under the span ``g.modulate``.
Eval only: the whole resolution (`depth` the last), no
progressive growing, no spatial split, no gradient on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import EqualizedLinear
from ..ops.modconv import (demodulation, fir_kernel, layer_epilogue,
                           layer_epilogue_up, modulate_weight,
                           modulated_conv2d, modulation, skip_upsample)
from ..utils.profiling import span
from .configs import SynthesisConfig
from .synthesis import make_noise

def noise_resolution(layer_idx: int) -> int:
    """Resolution of StyleGAN2 layer `layer_idx` (one at 4x4, then two a
    stage)."""
    return 2 ** ((layer_idx + 5) // 2)


class ModulatedLayer(nn.Module):
    """A modulated convolution's parameters: the kernel, its style affine
    (bias drawn at 0; the style's +1 is in the graph) and, for a 3x3 layer,
    the epilogue's bias and noise strength."""

    def __init__(self, dlatent: int, cin: int, cout: int, k: int, *,
                 epilogue: bool,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn((cout, cin, k, k),
                                               generator=generator))
        self.bias = nn.Parameter(torch.zeros(cout))
        if epilogue:
            self.noise_strength = nn.Parameter(torch.zeros(()))
        self.affine = EqualizedLinear(dlatent, cin, gain=1.0,
                                      use_wscale=True, generator=generator)


class GSynthesis2(nn.Module):
    """State-dict keys ``const``, ``layers.{i}.*``, ``to_rgb.{j}.*``."""

    def __init__(self, cfg: SynthesisConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        w = cfg.dlatent_size
        self.const = nn.Parameter(torch.randn((1, cfg.nf(1), 4, 4),
                                              generator=generator))
        layers = [ModulatedLayer(w, cfg.nf(1), cfg.nf(1), 3, epilogue=True,
                                 generator=generator)]
        rgb = [cfg.nf(1)]
        for r in range(3, cfg.resolution_log2 + 1):
            cin, cout = cfg.nf(r - 2), cfg.nf(r - 1)
            for c in (cin, cout):
                layers.append(ModulatedLayer(w, c, cout, 3, epilogue=True,
                                             generator=generator))
            rgb.append(cout)
        self.layers = nn.ModuleList(layers)
        self.to_rgb = nn.ModuleList(
            ModulatedLayer(w, c, cfg.num_channels, 1, epilogue=False,
                           generator=generator) for c in rgb)
        self.register_buffer("fir", fir_kernel(cfg.blur_filter),
                             persistent=False)

    def forward(self, dlatents: torch.Tensor, depth: Optional[int] = None,
                alpha=1.0, seed: Optional[int] = None,
                noises: Optional[Sequence[torch.Tensor]] = None,
                spatial=None) -> torch.Tensor:
        """dlatents (B, num_layers, D) -> images (B, H, W, C).  `depth`
        must be the last (None for it); `alpha` is not read."""
        cfg = self.cfg
        if spatial is not None:
            raise ValueError("architecture 'stylegan2' has no spatial path")
        if depth is not None and depth != cfg.depth - 1:
            raise ValueError(f"architecture 'stylegan2' generates at the "
                             f"full resolution only (depth {cfg.depth - 1}), "
                             f"got depth {depth}")
        if torch.is_grad_enabled() and dlatents.device.type == "cuda":
            raise RuntimeError("architecture 'stylegan2' is served, not "
                               "trained: call it without a gradient")
        b = dlatents.shape[0]
        with span("g.modulate"):
            styles = [modulation(m.affine, dlatents[:, i])
                      for i, m in enumerate(self.layers)]
            kernels = [modulate_weight(m.weight, s, demodulation(m.weight, s))
                       for m, s in zip(self.layers, styles)]
            rgb_kernels = [modulate_weight(
                m.weight, modulation(m.affine, dlatents[:, 2 * j + 1]), None)
                for j, m in enumerate(self.to_rgb)]

        def noise(i):
            if noises is not None:
                n = noises[i]
            elif seed is None:
                raise ValueError("synthesis needs a seed or noises=")
            else:
                with span("g.noise"):
                    n = make_noise(seed, i, b, noise_resolution(i),
                                   dlatents.device, dlatents.dtype)
            # (B or 1, R, R, 1) -> (B, 1, R, R), the same storage
            return n.expand(b, *n.shape[1:]).contiguous().permute(0, 3, 1, 2)

        def layer(i, x):
            m = self.layers[i]
            if i % 2 == 1:
                y = modulated_conv2d(x, kernels[i], up=True)
                return layer_epilogue_up(y, self.fir, noise(i), m.bias,
                                         m.noise_strength)
            y = modulated_conv2d(x, kernels[i])
            return layer_epilogue(y, noise(i), m.bias, m.noise_strength)

        def to_rgb(j, x):
            t = modulated_conv2d(x, rgb_kernels[j])
            return t + self.to_rgb[j].bias[None, :, None, None]

        x = self.const.to(dlatents.dtype).expand(b, -1, -1, -1).contiguous()
        x = layer(0, x)
        y = to_rgb(0, x)
        for r in range(3, cfg.resolution_log2 + 1):
            x = layer(2 * r - 4, layer(2 * r - 5, x))
            y = skip_upsample(y, self.fir) + to_rgb(r - 2, x)
        return y.permute(0, 2, 3, 1)
