"""StyleGAN's generator and discriminator in plain PyTorch, float32, NCHW
(Karras et al., arXiv:1812.04948, as StyleGAN.pytorch's GAN.py, Blocks.py
and CustomLayers.py write them).

The networks are functions of a dict of named tensors.  The names are the
state-dict keys of the program under test (``g_mapping.map.dense0.weight``,
``g_synthesis.blocks.3.conv0_up.weight``, ``blocks.0.conv1_down.bias``,
...), so both sides load one dict.  `g_shapes` and `d_shapes` give every
name and shape in a fixed order.

`arch` is a configuration file's ``architecture`` group.  ``q`` is applied
to every activation an op produces (and to a layer's inputs); the identity
computes in float32, and the control passes a rounding to a lower
precision.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import draws

SQRT2 = math.sqrt(2.0)


def nf(arch, stage: int) -> int:
    return min(int(arch["fmap_base"] / 2.0 ** (stage * arch["fmap_decay"])),
               arch["fmap_max"])


def log2res(arch) -> int:
    return int(math.log2(arch["resolution"]))


def num_layers(arch) -> int:
    return 2 * (log2res(arch) - 1)


def _ident(t):
    return t


# --------------------------------------------------------------- layouts --

def g_shapes(arch) -> dict:
    s = {}
    fin = arch["latent_size"]
    for i in range(arch["mapping_layers"]):
        fout = (arch["dlatent_size"] if i == arch["mapping_layers"] - 1
                else arch["mapping_fmaps"])
        s[f"g_mapping.map.dense{i}.weight"] = (fout, fin)
        s[f"g_mapping.map.dense{i}.bias"] = (fout,)
        fin = fout
    w = arch["dlatent_size"]

    def epi(prefix, c):
        s[f"{prefix}.top_epi.noise.weight"] = (c,)
        s[f"{prefix}.style_mod.lin.weight"] = (2 * c, w)
        s[f"{prefix}.style_mod.lin.bias"] = (2 * c,)

    def conv(prefix, cin, cout, k):
        s[f"{prefix}.weight"] = (cout, cin, k, k)
        s[f"{prefix}.bias"] = (cout,)

    c = nf(arch, 1)
    p = "g_synthesis.init_block"
    s[f"{p}.const"] = (1, c, 4, 4)
    s[f"{p}.bias"] = (c,)
    epi(f"{p}.epi1", c)
    conv(f"{p}.conv", c, c, 3)
    epi(f"{p}.epi2", c)
    for i, r in enumerate(range(3, log2res(arch) + 1)):
        cin, cout = nf(arch, r - 2), nf(arch, r - 1)
        p = f"g_synthesis.blocks.{i}"
        conv(f"{p}.conv0_up", cin, cout, 3)
        epi(f"{p}.epi1", cout)
        conv(f"{p}.conv1", cout, cout, 3)
        epi(f"{p}.epi2", cout)
    rgb = [nf(arch, 1)] + [nf(arch, r - 1)
                           for r in range(3, log2res(arch) + 1)]
    for i, cin in enumerate(rgb):
        conv(f"g_synthesis.to_rgb.{i}", cin, arch["num_channels"], 1)
    return s


def d_shapes(arch) -> dict:
    s = {}
    nc = arch["num_channels"]
    for i, r in enumerate(range(log2res(arch), 2, -1)):
        cin, cout = nf(arch, r - 1), nf(arch, r - 2)
        s[f"blocks.{i}.conv0.weight"] = (cin, cin, 3, 3)
        s[f"blocks.{i}.conv0.bias"] = (cin,)
        s[f"blocks.{i}.conv1_down.weight"] = (cout, cin, 3, 3)
        s[f"blocks.{i}.conv1_down.bias"] = (cout,)
    outs = [nf(arch, r - 1) for r in range(log2res(arch), 2, -1)]
    for i, cout in enumerate(outs + [nf(arch, 2)]):
        s[f"from_rgb.{i}.weight"] = (cout, nc, 1, 1)
        s[f"from_rgb.{i}.bias"] = (cout,)
    c = nf(arch, 2)
    s["final_block.conv.weight"] = (c, c + arch["mbstd_num_features"], 3, 3)
    s["final_block.conv.bias"] = (c,)
    s["final_block.dense0.weight"] = (c, c * 16)
    s["final_block.dense0.bias"] = (c,)
    s["final_block.dense1.weight"] = (1, c)
    s["final_block.dense1.bias"] = (1,)
    return s


# ---------------------------------------------------------------- layers --

def dense(p, name, x, gain, lrmul=1.0, q=_ident):
    w = p[f"{name}.weight"]
    return q(F.linear(q(x), w * (gain / math.sqrt(w.shape[1]) * lrmul),
                      p[f"{name}.bias"] * lrmul))


def _scaled(w, gain):
    return w * (gain / math.sqrt(w[0].numel()))


def conv(p, name, x, gain, q=_ident):
    w = p[f"{name}.weight"]
    return q(F.conv2d(q(x), _scaled(w, gain), padding=w.shape[-1] // 2))


def bias(p, name, x, q=_ident):
    return q(x + p[f"{name}.bias"].view(1, -1, 1, 1))


def blur(x, taps, q=_ident):
    k = torch.tensor(taps, dtype=x.dtype, device=x.device)
    k = k[:, None] * k[None, :]
    k = (k / k.sum()).expand(x.shape[1], 1, *k.shape)
    return q(F.conv2d(q(x), k, padding=k.shape[-1] // 2, groups=x.shape[1]))


def lrelu(x, q=_ident):
    return q(F.leaky_relu(x, 0.2))


def up_conv(p, name, x, q=_ident):
    """2x upscale and 3x3 conv: from an output side of 128 on, the
    transposed conv with the 4-tap summed kernel; below, nearest-neighbour
    upsampling and the conv."""
    w = _scaled(p[f"{name}.weight"], SQRT2)
    if x.shape[-1] * 2 >= 128:
        w = F.pad(w.transpose(0, 1), (1, 1, 1, 1))
        w = w[:, :, 1:, 1:] + w[:, :, :-1, 1:] + w[:, :, 1:, :-1] \
            + w[:, :, :-1, :-1]
        return q(F.conv_transpose2d(q(x), w, stride=2, padding=1))
    return q(F.conv2d(q(F.interpolate(x, scale_factor=2, mode="nearest")), w,
                      padding=1))


def down_conv(p, name, x, q=_ident):
    """3x3 conv and 2x downscale: from an input side of 128 on, the
    stride-2 conv with the 4-tap averaged kernel; below, the conv and 2x2
    average pooling."""
    w = _scaled(p[f"{name}.weight"], SQRT2)
    if x.shape[-1] >= 128:
        w = F.pad(w, (1, 1, 1, 1))
        w = (w[:, :, 1:, 1:] + w[:, :, :-1, 1:] + w[:, :, 1:, :-1]
             + w[:, :, :-1, :-1]) * 0.25
        return q(F.conv2d(q(x), w, stride=2, padding=1))
    return q(F.avg_pool2d(q(F.conv2d(q(x), w, padding=1)), 2))


def epilogue(p, name, x, w, noise, q=_ident):
    """Noise, leaky ReLU, instance norm, AdaIN."""
    x = q(x + p[f"{name}.top_epi.noise.weight"].view(1, -1, 1, 1) * noise)
    x = lrelu(x, q)
    mean = x.mean((2, 3), keepdim=True)
    var = (x - mean).square().mean((2, 3), keepdim=True)
    x = q((x - mean) * torch.rsqrt(var + 1e-5))
    s = dense(p, f"{name}.style_mod.lin", w, 1.0, q=q)
    c = x.shape[1]
    return q(x * (s[:, :c, None, None] + 1.0) + s[:, c:, None, None])


# ------------------------------------------------------------- generator --

def mapping(p, arch, z, q=_ident):
    x = q(z * torch.rsqrt(z.square().mean(1, keepdim=True) + 1e-8))
    for i in range(arch["mapping_layers"]):
        x = lrelu(dense(p, f"g_mapping.map.dense{i}", x, SQRT2,
                        arch["mapping_lrmul"], q), q)
    return x[:, None].expand(-1, num_layers(arch), -1)


def synthesis(p, arch, w, depth, alpha, noises, q=_ident):
    """w (B, layers, D) -> images (B, C, H, W) at 4 * 2**depth."""
    taps = arch["blur_filter"]
    pre = "g_synthesis.init_block"
    b = w.shape[0]
    x = q(p[f"{pre}.const"] + p[f"{pre}.bias"].view(1, -1, 1, 1)).expand(
        b, -1, -1, -1)
    x = epilogue(p, f"{pre}.epi1", x, w[:, 0], noises[0], q)
    x = bias(p, f"{pre}.conv", conv(p, f"{pre}.conv", x, SQRT2, q), q)
    x = epilogue(p, f"{pre}.epi2", x, w[:, 1], noises[1], q)

    def block(i, x):
        pre = f"g_synthesis.blocks.{i}"
        x = up_conv(p, f"{pre}.conv0_up", x, q)
        if taps:
            x = blur(x, taps, q)
        x = epilogue(p, f"{pre}.epi1", bias(p, f"{pre}.conv0_up", x, q),
                     w[:, 2 * i + 2], noises[2 * i + 2], q)
        x = bias(p, f"{pre}.conv1", conv(p, f"{pre}.conv1", x, SQRT2, q), q)
        return epilogue(p, f"{pre}.epi2", x, w[:, 2 * i + 3],
                        noises[2 * i + 3], q)

    def rgb(i, x):
        return bias(p, f"g_synthesis.to_rgb.{i}",
                    conv(p, f"g_synthesis.to_rgb.{i}", x, 1.0, q), q)

    if depth == 0:
        return rgb(0, x)
    if alpha == 1.0:
        for i in range(depth):
            x = block(i, x)
        return rgb(depth, x)
    for i in range(depth - 1):
        x = block(i, x)
    residual = F.interpolate(rgb(depth - 1, x), scale_factor=2,
                             mode="nearest")
    return q(alpha * rgb(depth, block(depth - 1, x))
             + (1 - alpha) * residual)


def generator(p, arch, z, depth, alpha, seed, *, train=False, dtype=None,
              q=_ident):
    """Images (B, C, H, W) of latents z from request or step seed `seed`:
    noise maps drawn in `dtype` (the configuration's activations), and in
    train mode the style-mixing draws.  Truncation is off in the
    configurations this serves."""
    if arch["truncation_psi"] > 0:
        raise NotImplementedError("truncation is off in every configuration "
                                  "the reference serves")
    dtype = dtype or torch.float32
    w = mapping(p, arch, z, q)
    if train and arch["style_mixing_prob"]:
        z2, cutoff = draws.mixing(seed, z.shape[0], z.shape[1], depth,
                                  arch["style_mixing_prob"], z.device, dtype)
        layer = torch.arange(w.shape[1], device=z.device)[None, :, None]
        w = torch.where(layer < cutoff, w, mapping(p, arch, z2, q))
    noises = [draws.noise(seed, i, z.shape[0], z.device, dtype)
              for i in range(2 * (depth + 1))]
    return synthesis(p, arch, w, depth, alpha, noises, q)


# --------------------------------------------------------- discriminator --

def minibatch_stddev(x, group, features):
    b, c, h, w = x.shape
    g = min(group, b)
    y = x.reshape(g, b // g, features, c // features, h, w)
    y = torch.sqrt((y - y.mean(0)).square().mean(0) + 1e-8)
    y = y.mean((2, 3, 4))                               # (B/g, features)
    y = y.repeat(g, 1)[:, :, None, None].expand(-1, -1, h, w)
    return torch.cat([x, y], 1)


def discriminator(p, arch, images, depth, alpha, q=_ident):
    """Scores (B, 1) of images (B, C, H, W) at 4 * 2**depth."""
    taps = arch["blur_filter"] or (1, 2, 1)
    last = log2res(arch) - 2           # the index of the 4x4 from_rgb

    def rgb(i, x):
        return bias(p, f"from_rgb.{i}",
                    conv(p, f"from_rgb.{i}", x, SQRT2, q), q)

    def block(i, x):
        x = lrelu(bias(p, f"blocks.{i}.conv0",
                       conv(p, f"blocks.{i}.conv0", x, SQRT2, q), q), q)
        x = down_conv(p, f"blocks.{i}.conv1_down", blur(x, taps, q), q)
        return lrelu(bias(p, f"blocks.{i}.conv1_down", x, q), q)

    if depth > 0:
        top = last - depth
        residual = rgb(top + 1, q(F.avg_pool2d(images, 2)))
        straight = block(top, rgb(top, images))
        x = q(alpha * straight + (1 - alpha) * residual)
        for i in range(top + 1, last):
            x = block(i, x)
    else:
        x = rgb(last, images)
    x = q(minibatch_stddev(x, arch["mbstd_group_size"],
                           arch["mbstd_num_features"]))
    x = lrelu(bias(p, "final_block.conv",
                   conv(p, "final_block.conv", x, SQRT2, q), q), q)
    x = lrelu(dense(p, "final_block.dense0", x.reshape(x.shape[0], -1),
                    SQRT2, q=q), q)
    return dense(p, "final_block.dense1", x, 1.0, q=q)
