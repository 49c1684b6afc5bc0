"""StyleGAN3-T's generator in plain PyTorch, float32, NCHW (Karras et al.,
"Alias-Free Generative Adversarial Networks", arXiv:2106.12423; NVlabs/
stylegan3 ``training/networks_stylegan3.py``, ``Generator`` with
``MappingNetwork`` and ``SynthesisNetwork`` as ``train.py --cfg=stylegan3-t``
builds it, and ``torch_utils/ops/filtered_lrelu.py::_filtered_lrelu_ref``
over ``upfirdn2d.py::_upfirdn2d_ref`` and ``bias_act.py``'s reference).

Everything is a function of a dict of named tensors, keyed as the
program's state dict (``g_mapping.map.dense0.weight``,
``g_synthesis.input.freqs``, ``g_synthesis.layers.3.affine.bias``,
``g_synthesis.layers.14.magnitude_ema``, ...); `shapes` gives every name and
shape in a fixed order.  `arch` is a dict of ``resolution``,
``latent_size``, ``dlatent_size``, ``mapping_layers``, ``mapping_lrmul``,
``num_channels`` and the synthesis's ``channel_base``, ``channel_max``,
``conv_kernel``, ``num_layers``, ``num_critical``, ``margin_size``,
``first_cutoff``, ``first_stopband``, ``last_stopband_rel``,
``filter_size``, ``lrelu_upsampling``, ``output_scale``, ``conv_clamp``.

The equations, as the published code computes them:

* mapping: z * rsqrt(mean(z^2) + 1e-8), then per layer
  sqrt(2) * lrelu(lrmul * x W / sqrt(fan_in) + lrmul * b, 0.2); W
  broadcast to num_layers + 2 inputs;
* the schedule (`schedule`): e_i = min(i / (num_layers - num_critical), 1),
  cutoff f_c = first_cutoff * (res/2 / first_cutoff)^e, stopband f_t =
  first_stopband * (res/2 last_stopband_rel / first_stopband)^e, rate s =
  2^ceil(log2(min(2 f_t, res))), half-width max(f_t, s/2) - f_c, size s +
  2 margin (res for the last two), channels rint(min(channel_base / 2 /
  f_c, channel_max)), the image's for the last;
* filters: scipy.signal.firwin(taps, f_c, width=2 f_h, fs=tmp rate), the
  Kaiser window's beta from the attenuation 2.285 (N - 1) pi (width /
  (fs/2)) + 7.95 (`lowpass`);
* the input: t = A W[0] / sqrt(dlatent) + b_A, t / |t[:2]|; the
  frequencies and phases moved by the rotation (t0, t1) and translation
  (t2, t3), composed with ``transform``; amplitudes clamp(1 - (|f| -
  f_c) / (s/2 - f_c), 0, 1); sin(2 pi (grid f + phase)) * amplitude on
  ``affine_grid``'s grid of half-width size / (2 s); times weight /
  sqrt(C);
* a layer: styles s = A w / sqrt(dlatent) + b_A (toRGB's times
  1 / sqrt(cin k^2)); where it demodulates, w * rsqrt(mean w^2) per output
  channel and s * rsqrt(mean s^2) over the whole batch, then w s and
  rsqrt(sum w'^2 + 1e-8); times rsqrt(magnitude_ema); the grouped
  convolution with padding k - 1; then the filtered leaky ReLU: x + b,
  upfirdn2d up with fu at gain up^2 and the layer's padding, lrelu
  (slope 0.2, gain sqrt(2); 1 and 1 for toRGB) clamped at conv_clamp,
  upfirdn2d down with fd;
* the output: times output_scale.

Departures from the published code:

* State-dict names are the program's: ``g_synthesis.input.*`` and
  ``g_synthesis.layers.{i}.*`` for the published ``synthesis.input.*`` and
  ``synthesis.L{i}_{size}_{channels}.*``; dense weights (out, in) as
  published.  The up and down filters are designed here from `arch`, not
  read from the dict.
* Eval semantics only: truncation off, no EMA updates; float32 throughout
  (the published pickle runs its four highest rates in float16).

The functions set TF32 off for cuDNN and cuBLAS while they run
(`generator` and `full_float32`), and import nothing of the program under
test.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)


# ------------------------------------------------------------- the layout --

def num_ws(arch) -> int:
    return arch["num_layers"] + 2


def lowpass(numtaps: int, cutoff: float, width: float, fs: float):
    """scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs), float32,
    or None for one tap."""
    if numtaps == 1:
        return None
    nyq = 0.5 * fs
    atten = 2.285 * (numtaps - 1) * np.pi * (width / nyq) + 7.95
    if atten > 50:
        beta = 0.1102 * (atten - 8.7)
    elif atten > 21:
        beta = 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    else:
        beta = 0.0
    m = np.arange(0, numtaps) - 0.5 * (numtaps - 1)
    c = cutoff / nyq
    h = c * np.sinc(c * m) * np.kaiser(numtaps, beta)
    return torch.as_tensor(h / np.sum(h), dtype=torch.float32)


def schedule(arch):
    """(input's (channels, size, rate, bandwidth), each layer's dict)."""
    res, n = arch["resolution"], arch["num_layers"]
    last_cutoff = res / 2
    last_stopband = last_cutoff * arch["last_stopband_rel"]
    e = np.minimum(np.arange(n + 1) / (n - arch["num_critical"]), 1)
    cutoffs = arch["first_cutoff"] * (last_cutoff / arch["first_cutoff"]) ** e
    stopbands = arch["first_stopband"] * (
        last_stopband / arch["first_stopband"]) ** e
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, res))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + arch["margin_size"] * 2
    sizes[-2:] = res
    channels = np.rint(np.minimum((arch["channel_base"] / 2) / cutoffs,
                                  arch["channel_max"]))
    channels[-1] = arch["num_channels"]
    layers = []
    for i in range(n + 1):
        prev = max(i - 1, 0)
        torgb = i == n
        k = 1 if torgb else arch["conv_kernel"]
        tmp = max(rates[prev], rates[i]) * (1 if torgb
                                            else arch["lrelu_upsampling"])
        up = int(np.rint(tmp / rates[prev]))
        down = int(np.rint(tmp / rates[i]))
        up_taps = arch["filter_size"] * up if up > 1 and not torgb else 1
        down_taps = arch["filter_size"] * down if down > 1 and not torgb \
            else 1
        in_size, out_size = int(sizes[prev]), int(sizes[i])
        pad_total = (out_size - 1) * down + 1
        pad_total -= (in_size + k - 1) * up
        pad_total += up_taps + down_taps - 2
        pad_lo = (pad_total + up) // 2
        layers.append({
            "cin": int(channels[prev]), "cout": int(channels[i]),
            "in_size": in_size, "out_size": out_size, "k": k,
            "torgb": torgb, "up": up, "down": down,
            "fu": lowpass(up_taps, cutoffs[prev], half_widths[prev] * 2, tmp),
            "fd": lowpass(down_taps, cutoffs[i], half_widths[i] * 2, tmp),
            "padding": (pad_lo, pad_total - pad_lo)})
    return ((int(channels[0]), int(sizes[0]), float(rates[0]),
             float(cutoffs[0])), layers)


def shapes(arch) -> dict:
    s = {}
    fin = arch["latent_size"]
    for i in range(arch["mapping_layers"]):
        s[f"g_mapping.map.dense{i}.weight"] = (arch["dlatent_size"], fin)
        s[f"g_mapping.map.dense{i}.bias"] = (arch["dlatent_size"],)
        fin = arch["dlatent_size"]
    w = arch["dlatent_size"]
    (c, _, _, _), layers = schedule(arch)
    p = "g_synthesis.input"
    s.update({f"{p}.weight": (c, c), f"{p}.transform": (3, 3),
              f"{p}.freqs": (c, 2), f"{p}.phases": (c,),
              f"{p}.affine.weight": (4, w), f"{p}.affine.bias": (4,)})
    for i, lay in enumerate(layers):
        p = f"g_synthesis.layers.{i}"
        s[f"{p}.weight"] = (lay["cout"], lay["cin"], lay["k"], lay["k"])
        s[f"{p}.bias"] = (lay["cout"],)
        s[f"{p}.magnitude_ema"] = ()
        s[f"{p}.affine.weight"] = (lay["cin"], w)
        s[f"{p}.affine.bias"] = (lay["cin"],)
    return s


@contextmanager
def full_float32():
    """TF32 off for cuDNN and cuBLAS over the body, restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ------------------------------------------------------------- the ops --

def dense(x, weight, bias, lrmul: float = 1.0):
    """FullyConnectedLayer, linear: x (W lrmul / sqrt(fan_in))^T + b lrmul."""
    return torch.addmm((bias * lrmul)[None], x,
                       (weight * (lrmul / np.sqrt(weight.shape[1]))).t())


def upfirdn2d(x, f, up: int = 1, down: int = 1, padding=(0, 0),
              gain: float = 1.0):
    """_upfirdn2d_ref on NCHW x with the separable 1-D filter f (None: the
    identity), alike on both axes: zeros inserted, padded or cropped, the
    true convolution, every `down`-th sample."""
    if f is None:
        f = torch.ones([1, 1], dtype=torch.float32, device=x.device)
    b, c, h, w = x.shape
    x = x.reshape([b, c, h, 1, w, 1])
    x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
    x = x.reshape([b, c, h * up, w * up])
    p0, p1 = padding
    x = F.pad(x, [max(p0, 0), max(p1, 0), max(p0, 0), max(p1, 0)])
    x = x[:, :, max(-p0, 0):x.shape[2] - max(-p1, 0),
          max(-p0, 0):x.shape[3] - max(-p1, 0)]
    f = (f * (gain ** (f.ndim / 2))).to(x.dtype)
    f = f.flip(list(range(f.ndim)))
    f = f[None, None].repeat([c, 1] + [1] * f.ndim)
    if f.ndim == 4:
        x = F.conv2d(x, f, groups=c)
    else:
        x = F.conv2d(x, f.unsqueeze(2), groups=c)
        x = F.conv2d(x, f.unsqueeze(3), groups=c)
    return x[:, :, ::down, ::down]


def bias_act(x, b=None, slope: float = 1.0, gain: float = 1.0,
             clamp=None):
    """bias_act's reference: + b, lrelu (slope 1: linear), * gain, clamp."""
    if b is not None:
        x = x + b.reshape([1, -1] + [1] * (x.ndim - 2))
    if slope != 1:
        x = F.leaky_relu(x, slope)
    if gain != 1:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x


def filtered_lrelu(x, fu, fd, b, up, down, padding, gain, slope, clamp):
    """_filtered_lrelu_ref: bias, upsample, lrelu and clamp, downsample."""
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up ** 2)
    x = bias_act(x, slope=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down)


def modulated_conv2d(x, w, s, demodulate=True, padding=0, input_gain=None):
    """The published modulated_conv2d, fused: per-sample kernels as one
    grouped convolution."""
    b = x.shape[0]
    cout, cin, kh, kw = w.shape
    if demodulate:
        w = w * w.square().mean([1, 2, 3], keepdim=True).rsqrt()
        s = s * s.square().mean().rsqrt()
    w = w.unsqueeze(0) * s.unsqueeze(1).unsqueeze(3).unsqueeze(4)
    if demodulate:
        d = (w.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt()
        w = w * d.unsqueeze(2).unsqueeze(3).unsqueeze(4)
    if input_gain is not None:
        input_gain = input_gain.expand(b, cin)
        w = w * input_gain.unsqueeze(1).unsqueeze(3).unsqueeze(4)
    x = x.reshape(1, -1, *x.shape[2:])
    w = w.reshape(-1, cin, kh, kw)
    x = F.conv2d(x, w, padding=padding, groups=b)
    return x.reshape(b, -1, *x.shape[2:])


# -------------------------------------------------------- the networks --

def mapping(p, arch, z):
    """(B, latent) -> W (B, num_ws, dlatent)."""
    x = z * (z.square().mean(1, keepdim=True) + 1e-8).rsqrt()
    lrmul = arch["mapping_lrmul"]
    for i in range(arch["mapping_layers"]):
        weight = p[f"g_mapping.map.dense{i}.weight"]
        x = x.matmul((weight * (lrmul / np.sqrt(weight.shape[1]))).t())
        x = bias_act(x, p[f"g_mapping.map.dense{i}.bias"] * lrmul,
                     slope=0.2, gain=SQRT2)
    return x.unsqueeze(1).repeat([1, num_ws(arch), 1])


def synthesis_input(p, arch, w, spec):
    """The Fourier features (B, C, size, size) of W[0]."""
    channels, size, rate, bandwidth = spec
    q = "g_synthesis.input"
    transforms = p[f"{q}.transform"].unsqueeze(0)
    freqs = p[f"{q}.freqs"].unsqueeze(0)
    phases = p[f"{q}.phases"].unsqueeze(0)
    t = dense(w, p[f"{q}.affine.weight"], p[f"{q}.affine.bias"])
    t = t / t[:, :2].norm(dim=1, keepdim=True)
    m_r = torch.eye(3, device=w.device).unsqueeze(0).repeat([w.shape[0], 1, 1])
    m_r[:, 0, 0] = t[:, 0]
    m_r[:, 0, 1] = -t[:, 1]
    m_r[:, 1, 0] = t[:, 1]
    m_r[:, 1, 1] = t[:, 0]
    m_t = torch.eye(3, device=w.device).unsqueeze(0).repeat([w.shape[0], 1, 1])
    m_t[:, 0, 2] = -t[:, 2]
    m_t[:, 1, 2] = -t[:, 3]
    transforms = m_r @ m_t @ transforms
    phases = phases + (freqs @ transforms[:, :2, 2:]).squeeze(2)
    freqs = freqs @ transforms[:, :2, :2]
    amplitudes = (1 - (freqs.norm(dim=2) - bandwidth)
                  / (rate / 2 - bandwidth)).clamp(0, 1)
    theta = torch.eye(2, 3, device=w.device)
    theta[0, 0] = 0.5 * size / rate
    theta[1, 1] = 0.5 * size / rate
    grids = F.affine_grid(theta.unsqueeze(0), [1, 1, size, size],
                          align_corners=False)
    x = (grids.unsqueeze(3) @ freqs.permute(0, 2, 1).unsqueeze(1)
         .unsqueeze(2)).squeeze(3)
    x = x + phases.unsqueeze(1).unsqueeze(2)
    x = torch.sin(x * (np.pi * 2))
    x = x * amplitudes.unsqueeze(1).unsqueeze(2)
    weight = p[f"{q}.weight"] / np.sqrt(channels)
    x = x @ weight.t()
    return x.permute(0, 3, 1, 2)


def synthesis_layer(p, arch, i, lay, x, w):
    q = f"g_synthesis.layers.{i}"
    input_gain = p[f"{q}.magnitude_ema"].rsqrt()
    styles = dense(w, p[f"{q}.affine.weight"], p[f"{q}.affine.bias"])
    if lay["torgb"]:
        styles = styles * (1 / np.sqrt(lay["cin"] * lay["k"] ** 2))
    x = modulated_conv2d(x, p[f"{q}.weight"], styles,
                         demodulate=not lay["torgb"], padding=lay["k"] - 1,
                         input_gain=input_gain)
    dev = x.device
    fu = None if lay["fu"] is None else lay["fu"].to(dev)
    fd = None if lay["fd"] is None else lay["fd"].to(dev)
    return filtered_lrelu(x, fu, fd, p[f"{q}.bias"], lay["up"], lay["down"],
                          lay["padding"], 1 if lay["torgb"] else SQRT2,
                          1 if lay["torgb"] else 0.2, arch["conv_clamp"])


def synthesis(p, arch, ws):
    """ws (B, num_ws, dlatent) -> images NCHW."""
    spec, layers = schedule(arch)
    ws = ws.unbind(dim=1)
    x = synthesis_input(p, arch, ws[0], spec)
    for i, (lay, w) in enumerate(zip(layers, ws[1:])):
        x = synthesis_layer(p, arch, i, lay, x, w)
    return x * arch["output_scale"]


def generator(p, arch, z, seed: int = 0):
    """Eval-mode images (B, H, W, C) of latents z; `seed` (a request's) is
    not read: StyleGAN3 draws no noise."""
    with full_float32():
        return synthesis(p, arch, mapping(p, arch, z)).permute(0, 2, 3, 1)
