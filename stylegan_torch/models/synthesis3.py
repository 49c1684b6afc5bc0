"""StyleGAN3-T's synthesis network (Karras et al., "Alias-Free Generative
Adversarial Networks", arXiv:2106.12423; NVlabs/stylegan3
``training/networks_stylegan3.py``, ``SynthesisNetwork`` with
``SynthesisInput`` and ``SynthesisLayer``, as ``train.py --cfg=stylegan3-t``
builds it), for serving.

* The schedule (`schedule`), computed once: with e_i = min(i / (NUM_LAYERS
  - NUM_CRITICAL), 1) for i = 0..NUM_LAYERS, the cutoff f_c = FIRST_CUTOFF
  * (res/2 / FIRST_CUTOFF)^e, the stopband f_t = FIRST_STOPBAND *
  (res/2 * LAST_STOPBAND_REL / FIRST_STOPBAND)^e, the sampling rate s =
  2^ceil(log2(min(2 f_t, res))), the half-width f_h = max(f_t, s/2) - f_c,
  the size s + 2 MARGIN_SIZE (res for the last two), the channels
  rint(min(channel_base / 2 / f_c, channel_max)) (the image's for the
  last).  Layer i reads layer max(i - 1, 0)'s output.
* The input (`SynthesisInput`): Fourier features of the first layer's
  channels at its size, their frequencies drawn in a disc of radius f_c[0]
  and their phases, rotated and translated by t = affine(W[0]) (t / |t[:2]|),
  the frequencies above the band damped, sin(2 pi (grid f + phase)) on a
  grid of half-width size / (2 s[0]), then a channels x channels mapping
  (weight / sqrt(channels)).
* Each layer (`SynthesisLayer`): styles = affine(W[i + 1]) (bias
  initialised at 1; toRGB's scaled by 1 / sqrt(cin k^2)), the modulated
  convolution with StyleGAN3's pre-normalisation and input gain
  (``ops/modconv.py::modulate_weight3``) and padding k - 1, then the
  filtered leaky ReLU (``ops/kernels/filtered_lrelu.py``): the bias,
  upsampling by up = rint(tmp / s_in) with a Kaiser low-pass filter of
  FILTER_SIZE * up taps, lrelu(., 0.2) * sqrt(2) clamped at CONV_CLAMP,
  downsampling by down = rint(tmp / s_out) with FILTER_SIZE * down taps,
  where tmp = max(s_in, s_out) * LRELU_UPSAMPLING.  toRGB (the last)
  takes a 1x1 kernel, no demodulation and no filters, slope and gain 1.
* The output: times OUTPUT_SCALE, (B, H, W, C) as the other architectures
  return it.

The filters are scipy.signal.firwin's Kaiser-windowed low-pass designs
(`lowpass_filter`), written with numpy so that serving needs no scipy.

Departures from the published network:

* State-dict keys are ``input.{weight, affine.*, transform, freqs,
  phases}`` and ``layers.{i}.{weight, bias, magnitude_ema, affine.*}``
  (the published ``L{i}_{size}_{channels}``); the up and down filters are
  computed from the configuration and kept out of the state dict.
* Eval only: the whole resolution (`depth` the last), no magnitude EMA
  update, no truncation or mixing (the generator's), no spatial split, no
  gradient on the card; float32 throughout (the published pickle runs its
  top four rates in float16).
* The per-sample kernels of all layers are computed first, under the span
  ``g.modulate``; the input under ``g.input``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import EqualizedLinear
from ..ops.kernels.filtered_lrelu import filtered_lrelu
from ..ops.modconv import modulate_weight3, modulated_conv2d
from ..utils.profiling import span
from .configs import Synthesis3Config

SQRT2 = math.sqrt(2.0)

# The rest of StyleGAN3-T's arguments of SynthesisNetwork and
# SynthesisLayer, fixed: the filtered leaky ReLU kernel takes
# FILTER_SIZE-tap phases and LRELU_UPSAMPLING's down factor only.
CONV_KERNEL = 3
NUM_LAYERS = Synthesis3Config.num_ws - 2    # excluding the input and toRGB
NUM_CRITICAL = 2            # critically sampled layers at the end
MARGIN_SIZE = 10            # samples outside the image on each side
FIRST_CUTOFF = 2.0
FIRST_STOPBAND = 2 ** 2.1
LAST_STOPBAND_REL = 2 ** 0.3
FILTER_SIZE = 6             # taps relative to the lower rate
LRELU_UPSAMPLING = 2        # the nonlinearity's rate, relative
OUTPUT_SCALE = 0.25
CONV_CLAMP = 256.0


def lowpass_filter(numtaps: int, cutoff: float, width: float,
                   fs: float) -> Optional[np.ndarray]:
    """scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs): a low-pass
    of DC gain 1 under a Kaiser window whose beta gives the attenuation
    that the transition `width` allows; None for one tap."""
    if numtaps == 1:
        return None
    nyq = fs / 2
    atten = 2.285 * (numtaps - 1) * math.pi * (width / nyq) + 7.95
    if atten > 50:
        beta = 0.1102 * (atten - 8.7)
    elif atten > 21:
        beta = 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    else:
        beta = 0.0
    m = np.arange(numtaps) - (numtaps - 1) / 2
    h = (cutoff / nyq) * np.sinc((cutoff / nyq) * m) * np.kaiser(numtaps, beta)
    return h / h.sum()


class LayerSpec(NamedTuple):
    in_channels: int
    out_channels: int
    in_size: int
    out_size: int
    kernel: int
    is_torgb: bool
    up: int
    down: int
    up_filter: Optional[np.ndarray]
    down_filter: Optional[np.ndarray]
    pad_lo: int
    pad_hi: int


class InputSpec(NamedTuple):
    channels: int
    size: int
    sampling_rate: float
    bandwidth: float


def schedule(cfg: Synthesis3Config):
    """(InputSpec, [LayerSpec] of the NUM_LAYERS + 1 layers)."""
    res = cfg.resolution
    n = NUM_LAYERS
    last_cutoff = res / 2
    last_stopband = last_cutoff * LAST_STOPBAND_REL
    e = np.minimum(np.arange(n + 1) / (n - NUM_CRITICAL), 1)
    cutoffs = FIRST_CUTOFF * (last_cutoff / FIRST_CUTOFF) ** e
    stopbands = FIRST_STOPBAND * (last_stopband / FIRST_STOPBAND) ** e
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, res))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + MARGIN_SIZE * 2
    sizes[-2:] = res
    channels = np.rint(np.minimum((cfg.channel_base / 2) / cutoffs,
                                  cfg.channel_max))
    channels[-1] = cfg.num_channels
    layers = []
    for i in range(n + 1):
        p = max(i - 1, 0)
        torgb = i == n
        k = 1 if torgb else CONV_KERNEL
        tmp = max(rates[p], rates[i]) * (1 if torgb else LRELU_UPSAMPLING)
        up, down = int(np.rint(tmp / rates[p])), int(np.rint(tmp / rates[i]))
        up_taps = FILTER_SIZE * up if up > 1 and not torgb else 1
        down_taps = FILTER_SIZE * down if down > 1 and not torgb else 1
        fu = lowpass_filter(up_taps, cutoffs[p], half_widths[p] * 2, tmp)
        fd = lowpass_filter(down_taps, cutoffs[i], half_widths[i] * 2, tmp)
        in_size, out_size = int(sizes[p]), int(sizes[i])
        pad_total = ((out_size - 1) * down + 1 - (in_size + k - 1) * up
                     + up_taps + down_taps - 2)
        pad_lo = (pad_total + up) // 2
        layers.append(LayerSpec(int(channels[p]), int(channels[i]), in_size,
                                out_size, k, torgb, up, down, fu, fd, pad_lo,
                                pad_total - pad_lo))
    return (InputSpec(int(channels[0]), int(sizes[0]), float(rates[0]),
                      float(cutoffs[0])), layers)


class SynthesisInput(nn.Module):
    """The Fourier features; parameters ``weight`` (C, C) and ``affine.*``
    (4 outputs: rotation cos and sin, translation x and y; drawn at the
    published (1, 0, 0, 0)), buffers ``transform`` (3, 3, the user's
    inverse transform, the identity), ``freqs`` (C, 2) and ``phases``
    (C,), and the sampling grid outside the state dict."""

    def __init__(self, dlatent: int, spec: InputSpec, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        c = spec.channels
        freqs = torch.randn((c, 2), generator=generator)
        radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
        freqs = freqs / (radii * radii.square().exp().pow(0.25))
        self.weight = nn.Parameter(torch.randn((c, c), generator=generator))
        self.affine = EqualizedLinear(dlatent, 4, gain=1.0, use_wscale=True)
        with torch.no_grad():   # the published init: t = (1, 0, 0, 0)
            self.affine.weight.zero_()
            self.affine.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))
        self.register_buffer("transform", torch.eye(3))
        self.register_buffer("freqs", freqs * spec.bandwidth)
        self.register_buffer("phases",
                             torch.rand((c,), generator=generator) - 0.5)
        # the sampling grid, (1, size, size, 2) of half-width size / (2 s)
        theta = torch.tensor([[[0.5 * spec.size / spec.sampling_rate, 0, 0],
                               [0, 0.5 * spec.size / spec.sampling_rate, 0]]])
        self.register_buffer("grid", F.affine_grid(
            theta, [1, 1, spec.size, spec.size], align_corners=False),
            persistent=False)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        """W (B, dlatent) -> features (B, C, size, size)."""
        spec, b = self.spec, w.shape[0]
        t = self.affine(w)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        one, zero = torch.ones_like(t[:, 0]), torch.zeros_like(t[:, 0])
        m_r = torch.stack([t[:, 0], -t[:, 1], zero, t[:, 1], t[:, 0], zero,
                           zero, zero, one], dim=1).reshape(b, 3, 3)
        m_t = torch.stack([one, zero, -t[:, 2], zero, one, -t[:, 3], zero,
                           zero, one], dim=1).reshape(b, 3, 3)
        transforms = m_r @ m_t @ self.transform[None]
        phases = self.phases[None] + (self.freqs[None]
                                      @ transforms[:, :2, 2:]).squeeze(2)
        freqs = self.freqs[None] @ transforms[:, :2, :2]
        amplitudes = (1 - (freqs.norm(dim=2) - spec.bandwidth)
                      / (spec.sampling_rate / 2 - spec.bandwidth)).clamp(0, 1)
        x = (self.grid.unsqueeze(3) @ freqs.permute(0, 2, 1)[:, None, None]
             ).squeeze(3)                                  # (B, H, W, C)
        x = torch.sin((x + phases[:, None, None]) * (2 * math.pi))
        x = x * amplitudes[:, None, None]
        x = x @ (self.weight / math.sqrt(spec.channels)).t()
        return x.permute(0, 3, 1, 2).contiguous()


class SynthesisLayer(nn.Module):
    """A layer's parameters (``weight`` (cout, cin, k, k), ``bias``,
    ``affine.*`` with its bias drawn at 1) and buffer ``magnitude_ema``
    (0-d, 1); its filters as buffers outside the state dict."""

    def __init__(self, dlatent: int, spec: LayerSpec, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        cin, cout, k = spec.in_channels, spec.out_channels, spec.kernel
        self.weight = nn.Parameter(torch.randn((cout, cin, k, k),
                                               generator=generator))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.affine = EqualizedLinear(dlatent, cin, gain=1.0, use_wscale=True,
                                      generator=generator)
        with torch.no_grad():
            self.affine.bias.fill_(1.0)
        self.register_buffer("magnitude_ema", torch.ones(()))
        for name, f in (("up_filter", spec.up_filter),
                        ("down_filter", spec.down_filter)):
            self.register_buffer(name, None if f is None else torch.as_tensor(
                f, dtype=torch.float32), persistent=False)

    def kernels(self, w: torch.Tensor) -> torch.Tensor:
        """The per-sample kernels for W (B, dlatent)."""
        s = self.affine(w)
        if self.spec.is_torgb:
            s = s * (1 / math.sqrt(self.spec.in_channels
                                   * self.spec.kernel ** 2))
        return modulate_weight3(self.weight, s, self.magnitude_ema.rsqrt(),
                                demodulate=not self.spec.is_torgb)

    def forward(self, x: torch.Tensor, ww: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        x = modulated_conv2d(x, ww, padding=spec.kernel - 1)
        return filtered_lrelu(
            x, self.up_filter, self.down_filter, self.bias, up=spec.up,
            down=spec.down, padding=(spec.pad_lo, spec.pad_hi),
            gain=1.0 if spec.is_torgb else SQRT2,
            slope=1.0 if spec.is_torgb else 0.2, clamp=CONV_CLAMP)


class GSynthesis3(nn.Module):
    """State-dict keys ``input.*``, ``layers.{i}.*``."""

    def __init__(self, cfg: Synthesis3Config, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        inp, specs = schedule(cfg)
        self.input = SynthesisInput(cfg.dlatent_size, inp, generator=generator)
        self.layers = nn.ModuleList(
            SynthesisLayer(cfg.dlatent_size, s, generator=generator)
            for s in specs)

    def forward(self, dlatents: torch.Tensor, depth: Optional[int] = None,
                alpha=1.0, seed: Optional[int] = None,
                noises: Optional[Sequence[torch.Tensor]] = None,
                spatial=None) -> torch.Tensor:
        """dlatents (B, num_ws, D) -> images (B, H, W, C).  `depth` must be
        the last (None for it); `alpha`, `seed` and `noises` are not read
        (StyleGAN3 has no noise)."""
        cfg = self.cfg
        if spatial is not None:
            raise ValueError("architecture 'stylegan3' has no spatial path")
        if depth is not None and depth != cfg.depth - 1:
            raise ValueError(f"architecture 'stylegan3' generates at the "
                             f"full resolution only (depth {cfg.depth - 1}), "
                             f"got depth {depth}")
        if torch.is_grad_enabled() and dlatents.device.type == "cuda":
            raise RuntimeError("architecture 'stylegan3' is served, not "
                               "trained: call it without a gradient")
        with span("g.modulate"):
            kernels = [m.kernels(dlatents[:, i + 1])
                       for i, m in enumerate(self.layers)]
        with span("g.input"):
            x = self.input(dlatents[:, 0])
        for m, ww in zip(self.layers, kernels):
            x = m(x, ww)
        return (x * OUTPUT_SCALE).permute(0, 2, 3, 1)
