"""The seeded draws a StyleGAN forward or train step takes, derived again
from the inputs the benchmark hands both sides (a run seed, a request
seed), as the configuration states them:

* a named random stream of a seed: ``SeedSequence([seed mod 2**64,
  *stream])``'s first 64-bit word, shifted right once;
* synthesis layer i's noise: a (B, 1, R, R) normal map from a device
  generator on stream (seed, 0, i), R = 2 ** (i // 2 + 2);
* style mixing: second latents from a device generator on stream
  (seed, 1); the cutoff in [1, 2 (depth + 1)] and the coin from a host
  generator on stream (seed, 2); a coin that says no mixes nothing;
* a training run: z from a device generator seeded with the run seed,
  one draw of (B, latent) per update; update k's step seed is stream
  (seed, 0x53, k); its D phase draws from stream (step seed, 0) and its G
  phase from stream (step seed, 1).
"""

from __future__ import annotations

import numpy as np
import torch

STEP_STREAM = 0x53


def stream(seed: int, *path: int) -> int:
    state = np.random.SeedSequence([seed % 2 ** 64, *path]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


def layer_res(i: int) -> int:
    return 2 ** (i // 2 + 2)


def noise(seed: int, i: int, batch: int, device, dtype) -> torch.Tensor:
    """Layer i's noise map, (B, 1, R, R) float32 of values drawn in
    `dtype`."""
    g = torch.Generator(device=device).manual_seed(stream(seed, 0, i))
    res = layer_res(i)
    n = torch.randn((batch, res, res, 1), generator=g, device=device,
                    dtype=dtype)
    return n.float().permute(0, 3, 1, 2)


def mixing(seed: int, batch: int, latent: int, depth: int, prob: float,
           device, dtype):
    """(second latents as float32, cutoff) of one train-mode forward."""
    g = torch.Generator(device=device).manual_seed(stream(seed, 1))
    z2 = torch.randn((batch, latent), generator=g, device=device, dtype=dtype)
    layers = 2 * (depth + 1)
    h = torch.Generator().manual_seed(stream(seed, 2))
    cutoff = int(torch.randint(1, layers + 1, (), generator=h))
    mix = float(torch.rand((), generator=h)) < prob
    return z2.float(), (cutoff if mix else layers)


class ZStream:
    """A training run's latents: one device generator seeded with the run
    seed."""

    def __init__(self, seed: int, device):
        self.g = torch.Generator(device=device).manual_seed(seed)
        self.device = device

    def draw(self, batch: int, latent: int, dtype) -> torch.Tensor:
        return torch.randn((batch, latent), generator=self.g,
                           device=self.device, dtype=dtype).float()


def step_seed(run_seed: int, update: int) -> int:
    return stream(run_seed, STEP_STREAM, update)
