"""The weights of a run, made from its seed on the device in one draw.

Every parameter of G and D (named as ``reference.nets`` lays them out,
which are the program's state-dict keys) is a slice of one normal draw,
scaled as the configuration's ``assumed`` list states: weight matrices and
kernels by 1 / lrmul (the equalized-learning-rate init: 100 in the mapping
network, 1 elsewhere), the constant input by 1, every bias and noise
weight by 0.2 (so that noise and biases reach the images; both start at 0
in a fresh run).  Returns {"g.<name>": tensor, "d.<name>": tensor}.
"""

from __future__ import annotations

import math

import torch

from .reference import draws, nets

WEIGHT_STREAM = 0x57


def _scale(name: str, shape, arch) -> float:
    if name.endswith("weight") and len(shape) >= 2:
        return 1.0 / arch["mapping_lrmul"] if "g_mapping" in name else 1.0
    if name.endswith("const"):
        return 1.0
    return 0.2


def make(arch, seed: int, device) -> dict:
    shapes = {**{"g." + k: v for k, v in nets.g_shapes(arch).items()},
              **{"d." + k: v for k, v in nets.d_shapes(arch).items()}}
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(
        draws.stream(seed, WEIGHT_STREAM))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scales = torch.repeat_interleave(
        torch.tensor([_scale(k, s, arch) for k, s in shapes.items()],
                     device=device),
        torch.tensor(sizes, device=device))
    flat.mul_(scales)
    return {k: t.view(s) for (k, s), t in
            zip(shapes.items(), flat.split(sizes))}


def split(weights: dict, side: str) -> dict:
    """The state dict of one network ("g" or "d")."""
    p = side + "."
    return {k[len(p):]: v for k, v in weights.items() if k.startswith(p)}
