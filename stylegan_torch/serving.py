"""Serving: a generator frozen into a request function (the port's
counterpart of ``make_serving_fn`` in ``stylegan_tpu/serving.py``).

    serve = make_serving_fn(gen_cfg, generator, depth=8)
    images = serve(z, seed)          # (B, H, W, 3) in [-1, 1]

The function is deterministic in (z, seed) on a given device: per-layer noise
and the train-quirk draws derive from the seed.  Eval semantics by default
(no style mixing, no train-branch truncation); `train_quirks=True` gives the
reference's train-mode sampling.  The ``jax.export`` artifact of the JAX
package becomes ``torch.export`` in a later slice.
"""

from __future__ import annotations

import torch

from . import resolve_device
from .ops.precision import get_precision, set_precision


def make_serving_fn(gen_cfg, generator, *, depth: int,
                    train_quirks: bool = False, device=None):
    """Returns serve(z, seed[, labels]) -> images on `device`.

    device: CUDA unless the caller passes 'cpu'; raises when CUDA is missing
    and the CPU was not asked for.  The generator is moved there.
    z: (B, latent) float32 (tensor or array); seed: int; labels: (B,) int64,
    only when gen_cfg.conditional.  Applies the process precision policy
    (float32 convs without TF32 unless set_precision('default'))."""
    device = resolve_device(device)
    generator.to(device)
    set_precision(get_precision())

    @torch.inference_mode()
    def serve(z, seed, labels=None):
        z = torch.as_tensor(z, dtype=torch.float32, device=device)
        if labels is not None:
            labels = torch.as_tensor(labels, dtype=torch.long, device=device)
        return generator(z, depth=depth, alpha=1.0, seed=int(seed),
                         train=train_quirks, labels=labels).images

    if gen_cfg.conditional:
        return lambda z, seed, labels: serve(z, seed, labels)
    return lambda z, seed: serve(z, seed)
