"""StyleGAN2 config F's generator in plain PyTorch, float32, NCHW: the
benchmark's copy of the repository's ``plainref/stylegan2.py`` (Karras et
al., arXiv:1912.04958; NVlabs/stylegan2 ``G_mapping`` and
``G_synthesis_stylegan2`` at ``architecture='skip'``), which a CPU test
holds equal to it on seeded weights.  Its docstring gives the equations and
each departure from the TF original.

The functions take a dict of named tensors keyed as the program's state
dict (`shapes`) and an ``architecture`` group of a configuration file.
Unlike ``plainref``, `generator` leaves the precision to its caller, which
runs it with TF32 off (``drive.precise``) or, for the control, on.  It
imports nothing of the program.
"""

from __future__ import annotations

import math
import numpy as np
import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)


# ------------------------------------------------------------- the layout --

def nf(arch, stage: int) -> int:
    return min(int(arch["fmap_base"] / 2.0 ** (stage * arch["fmap_decay"])),
               arch["fmap_max"])


def log2res(arch) -> int:
    return int(math.log2(arch["resolution"]))


def num_convs(arch) -> int:
    """Modulated 3x3 convolutions (and noise inputs): 17 at 1024^2."""
    return 2 * log2res(arch) - 3


def num_ws(arch) -> int:
    """W inputs: 18 at 1024^2."""
    return 2 * log2res(arch) - 2


def noise_res(i: int) -> int:
    return 2 ** ((i + 5) // 2)


def conv_channels(arch):
    """(cin, cout, up) of each modulated convolution in order."""
    c = nf(arch, 1)
    out = [(c, c, False)]
    for r in range(3, log2res(arch) + 1):
        cin, cout = nf(arch, r - 2), nf(arch, r - 1)
        out += [(cin, cout, True), (cout, cout, False)]
    return out


def rgb_channels(arch):
    """Input channels of each toRGB, from 4^2 up."""
    return [nf(arch, 1)] + [nf(arch, r - 1)
                            for r in range(3, log2res(arch) + 1)]


def shapes(arch) -> dict:
    s = {}
    fin = arch["latent_size"]
    for i in range(arch["mapping_layers"]):
        fout = (arch["dlatent_size"] if i == arch["mapping_layers"] - 1
                else arch["mapping_fmaps"])
        s[f"g_mapping.map.dense{i}.weight"] = (fout, fin)
        s[f"g_mapping.map.dense{i}.bias"] = (fout,)
        fin = fout
    w = arch["dlatent_size"]
    s["g_synthesis.const"] = (1, nf(arch, 1), 4, 4)
    for i, (cin, cout, _) in enumerate(conv_channels(arch)):
        p = f"g_synthesis.layers.{i}"
        s[f"{p}.weight"] = (cout, cin, 3, 3)
        s[f"{p}.bias"] = (cout,)
        s[f"{p}.noise_strength"] = ()
        s[f"{p}.affine.weight"] = (cin, w)
        s[f"{p}.affine.bias"] = (cin,)
    for j, cin in enumerate(rgb_channels(arch)):
        p = f"g_synthesis.to_rgb.{j}"
        s[f"{p}.weight"] = (arch["num_channels"], cin, 1, 1)
        s[f"{p}.bias"] = (arch["num_channels"],)
        s[f"{p}.affine.weight"] = (cin, w)
        s[f"{p}.affine.bias"] = (cin,)
    return s


# ------------------------------------------------------------ the draws --

def stream(seed: int, *path: int) -> int:
    """A torch seed for one named stream of `seed`: SeedSequence([seed mod
    2**64, *path])'s first 64-bit word, shifted right once."""
    state = np.random.SeedSequence([seed % 2 ** 64, *path]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


def draw_noises(seed: int, arch, batch: int, device) -> list:
    """The (B, 1, R, R) noise maps of every layer for request `seed`."""
    out = []
    for i in range(num_convs(arch)):
        g = torch.Generator(device=device).manual_seed(stream(seed, 0, i))
        r = noise_res(i)
        out.append(torch.randn((batch, r, r, 1), generator=g, device=device)
                   .permute(0, 3, 1, 2))
    return out


# ------------------------------------------------------------- the ops --

def dense(x, weight, bias, lrmul: float = 1.0):
    """TF's dense_layer (gain 1) with its bias: x W lrmul / sqrt(fan_in) +
    b lrmul."""
    return F.linear(x, weight * (lrmul / math.sqrt(weight.shape[1])),
                    bias * lrmul)


def fir(taps, device=None) -> torch.Tensor:
    """The 2-D filter of 1-D `taps`, normalised to sum 1 (_setup_kernel)."""
    k = torch.tensor(taps, dtype=torch.float32, device=device)
    k = k[:, None] * k[None, :]
    return k / k.sum()


def upfirdn(x, f, up: int, pad0: int, pad1: int):
    """TF's upfirdn_2d_ref on NCHW x, alike on both axes: zeros inserted
    after each sample (`up`), padded by (pad0, pad1), then the true
    convolution with `f` (a correlation with f flipped), channel by
    channel."""
    b, c, h, w = x.shape
    if up > 1:
        x = x.reshape(b, c, h, 1, w, 1)
        x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
        x = x.reshape(b, c, h * up, w * up)
    x = F.pad(x, [pad0, pad1, pad0, pad1])
    k = f.flip(0, 1)[None, None].expand(c, 1, *f.shape)
    return F.conv2d(x, k, groups=c)


def style(p, name, w):
    """s = A w / sqrt(dlatent) + b_A + 1, (B, cin)."""
    return dense(w, p[f"{name}.affine.weight"], p[f"{name}.affine.bias"]) + 1


def modulated_conv(p, name, x, w, *, demodulate=True, up=False, f=None):
    """TF's modulated_conv2d_layer in its fused form on NCHW x."""
    weight = p[f"{name}.weight"]
    o, i, k, _ = weight.shape
    s = style(p, name, w)
    ww = weight[None] / math.sqrt(i * k * k) * s[:, None, :, None, None]
    if demodulate:
        d = torch.rsqrt(ww.square().sum(dim=(2, 3, 4)) + 1e-8)
        ww = ww * d[:, :, None, None, None]
    b, _, h, wd = x.shape
    x = x.reshape(1, b * i, h, wd)
    if up:
        # upsample_conv_2d: conv2d_transpose of the flipped kernel, stride
        # 2, VALID, (2H+1) wide; then the FIR, gain 4, padding 1 a side
        wt = ww.flip(3, 4).transpose(1, 2).reshape(b * i, o, k, k)
        x = F.conv_transpose2d(x, wt, stride=2, groups=b)
        x = x.reshape(b, o, 2 * h + 1, 2 * wd + 1)
        return upfirdn(x, f * 4, 1, 1, 1)
    x = F.conv2d(x, ww.reshape(b * o, i, k, k), padding=k // 2, groups=b)
    return x.reshape(b, o, h, wd)


def layer(p, idx, x, w, noise, f):
    """Modulated conv i, its noise and sqrt(2) * lrelu(. + b, 0.2)."""
    name = f"g_synthesis.layers.{idx}"
    x = modulated_conv(p, name, x, w, up=idx % 2 == 1, f=f)
    x = x + noise * p[f"{name}.noise_strength"]
    return SQRT2 * F.leaky_relu(x + p[f"{name}.bias"].view(1, -1, 1, 1), 0.2)


def to_rgb(p, j, x, w):
    name = f"g_synthesis.to_rgb.{j}"
    t = modulated_conv(p, name, x, w, demodulate=False)
    return t + p[f"{name}.bias"].view(1, -1, 1, 1)


def skip_upsample(y, f):
    """upsample_2d: up 2 with the FIR at gain 4, padding (2, 1)."""
    return upfirdn(y, f * 4, 2, 2, 1)


# -------------------------------------------------------- the networks --

def mapping(p, arch, z):
    """(B, latent) -> W (B, dlatent)."""
    x = z * torch.rsqrt(z.square().mean(dim=1, keepdim=True) + 1e-8)
    for i in range(arch["mapping_layers"]):
        x = SQRT2 * F.leaky_relu(dense(
            x, p[f"g_mapping.map.dense{i}.weight"],
            p[f"g_mapping.map.dense{i}.bias"], arch["mapping_lrmul"]), 0.2)
    return x


def synthesis(p, arch, ws, noises):
    """ws (B, num_ws, dlatent), noises (B, 1, R, R) each -> images NCHW."""
    f = fir(arch["resample_filter"], ws.device)
    b = ws.shape[0]
    x = p["g_synthesis.const"].expand(b, -1, -1, -1)
    x = layer(p, 0, x, ws[:, 0], noises[0], f)
    y = to_rgb(p, 0, x, ws[:, 1])
    for r in range(3, log2res(arch) + 1):
        for idx in (2 * r - 5, 2 * r - 4):
            x = layer(p, idx, x, ws[:, idx], noises[idx], f)
        y = skip_upsample(y, f) + to_rgb(p, r - 2, x, ws[:, 2 * r - 3])
    return y


def generator(p, arch, z, seed: int, noises=None):
    """Eval-mode images (B, H, W, C) of latents z for request `seed`."""
    if noises is None:
        noises = draw_noises(seed, arch, z.shape[0], z.device)
    w = mapping(p, arch, z)
    ws = w[:, None].expand(-1, num_ws(arch), -1)
    return synthesis(p, arch, ws, noises).permute(0, 2, 3, 1)
