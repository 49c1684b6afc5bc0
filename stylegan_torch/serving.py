"""Serving: a generator frozen into a request function, and the same frozen
into a ``torch.export`` artifact (the port's counterpart of
``stylegan_tpu/serving.py``).

    serve = make_serving_fn(gen_cfg, generator, depth=8)
    images = serve(z, seed)          # (B, H, W, 3) in [-1, 1]

    # offline, once
    blob = export_generator(gen_cfg, generator, depth=8, batch_size=8)
    # serving host
    serve = load_exported(blob)      # or a path
    images = serve(z, seed)

The function is deterministic in (z, seed): per-layer noise and the
train-quirk draws derive from the seed, and a replayed request gives the
same bits, on the card as on the CPU, as the JAX package's does.  On the
card that holds for the same card, driver and cuDNN (another cuDNN may pick
other algorithms): every op of the forward sums in a fixed order there,
the fused upscale included, which runs as a sub-pixel convolution
(``ops/linear.py``) because cuDNN's transposed convolutions do not.  Eval
semantics by default (no style mixing, no train-branch truncation);
`train_quirks=True` gives the reference's train-mode sampling.

The artifact holds the traced generator at one (batch, depth), its weights
baked in.  It differs from the JAX package's StableHLO file, which is
self-contained: it needs ``stylegan_torch.ops`` importable, for the
registration of the epilogue's ``stylegan_torch::`` ops that its graph
calls (``serving`` imports it), and on the card the kernel library, which
``ops/kernels/epilogue.py`` builds from the repo's sources at first use.  It
needs no model code, config or checkpoint.  The request's draws stay
outside the traced graph: the per-layer noise maps (and, with train quirks,
the mixing latents and cutoff) are inputs of the program, drawn by
`load_exported`'s serve from the seed with the same functions
`make_serving_fn` uses, so that the two compute the same images, bit for
bit on either device.
"""

from __future__ import annotations

import io
import json

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from . import resolve_device
from .models.generator import draw_mixing
from .models.synthesis import layer_resolution, make_noise
from .ops import fused  # noqa: F401  (the artifact's epilogue ops)
from .ops.precision import get_precision, set_precision

# What load_exported needs to draw a request's inputs, stored beside the
# program.
_META = "stylegan_torch.json"
PLATFORMS = ("cuda", "cpu")


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


def _noise_layers(gen_cfg, depth: int) -> int:
    """The synthesis layers whose noise a forward at `depth` reads."""
    if not gen_cfg.synthesis.use_noise:
        return 0
    if gen_cfg.synthesis.structure == "fixed":
        return gen_cfg.num_layers
    return 2 * (depth + 1)


class _Served(nn.Module):
    """What export_generator traces: one forward at `depth` with the
    request's draws as inputs."""

    def __init__(self, generator, depth: int, train_quirks: bool):
        super().__init__()
        self.generator, self.depth = generator, depth
        self.train_quirks = train_quirks

    def forward(self, z, noises, labels=None, latents2=None, cutoff=None):
        mixing = None if latents2 is None else (latents2, cutoff)
        return self.generator(z, depth=self.depth, alpha=1.0,
                              train=self.train_quirks, labels=labels,
                              noises=noises, mixing=mixing).images


def _draws(meta: dict, seed: int, batch: int, device):
    """(noise maps, and with mixing (latents2, cutoff)) of one request, as
    the generator draws them from `seed` (synthesis.py, generator.py)."""
    noises = [make_noise(seed, i, batch, layer_resolution(i), device)
              for i in range(meta["noise_layers"])]
    if not meta["mixes"]:
        return noises, {}
    latents2, cutoff = draw_mixing(seed, (batch, meta["mapping_latent"]),
                                   meta["depth"], meta["style_mixing_prob"],
                                   device)
    return noises, {"latents2": latents2, "cutoff": torch.tensor(
        cutoff, dtype=torch.long, device=device)}


def export_generator(gen_cfg, generator, *, depth: int, batch_size: int,
                     platforms=PLATFORMS, train_quirks: bool = False,
                     spatial_devices: int = 1) -> bytes:
    """Serialize the generator at (batch_size, depth) with ``torch.export``.

    The program is traced under ``torch.no_grad()`` on the device the
    generator's weights lie on (a CUDA trace runs no kernel: the ops'
    fakes give the shapes).  Shapes are static: one artifact per (batch,
    depth).  `platforms` may name 'cuda' and 'cpu', the devices
    `load_exported` can move the program to; its weights are saved on the
    host either way.  Returns the bytes of ``torch.export.save``."""
    platforms = tuple(platforms)
    if "tpu" in platforms:
        raise ValueError("the port exports for 'cuda' and 'cpu'; a TPU "
                         "artifact comes from the JAX package "
                         "(stylegan_tpu.serving.export_generator)")
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"unknown platforms {unknown or platforms}: "
                         f"{PLATFORMS}")
    if spatial_devices > 1:
        raise NotImplementedError(
            "spatial_devices > 1 (a spatially sharded artifact) arrives with "
            "the port's parallel slice (ROADMAP queue 1, parallelism)")
    device = next(generator.parameters()).device
    meta = {"depth": depth, "platforms": list(platforms),
            "conditional": bool(gen_cfg.conditional),
            "noise_layers": _noise_layers(gen_cfg, depth),
            "mixes": bool(train_quirks and gen_cfg.style_mixing_prob),
            "style_mixing_prob": gen_cfg.style_mixing_prob,
            "mapping_latent": gen_cfg.mapping.latent_size}
    z = torch.zeros((batch_size, gen_cfg.latent_size), device=device)
    noises, kwargs = _draws(meta, 0, batch_size, device)
    if gen_cfg.conditional:
        kwargs["labels"] = torch.zeros((batch_size,), dtype=torch.long,
                                       device=device)
    with torch.no_grad():
        ep = torch.export.export(_Served(generator, depth, train_quirks),
                                 (z, noises), kwargs)
    ep.example_inputs = None        # the program needs no sample inputs
    if device.type != "cpu":
        ep = move_to_device_pass(ep, "cpu")
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


def load_exported(path_or_bytes, device=None):
    """Load an export_generator artifact onto `device` (CUDA unless the
    caller passes 'cpu'); returns serve(z, seed[, labels]) -> images, with
    the ``ExportedProgram`` as ``serve.exported``.

    z: (B, latent) float32 at the artifact's batch (another batch is
    rejected by the program); seed: int; labels: (B,) int64, only for a
    conditional model.  Applies the process precision policy, as
    make_serving_fn does."""
    device = resolve_device(device)
    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(bytes(path_or_bytes))
    extra = {_META: ""}
    ep = torch.export.load(path_or_bytes, extra_files=extra)
    meta = json.loads(extra[_META])
    if device.type not in meta["platforms"]:
        raise ValueError(f"the artifact was exported for {meta['platforms']}"
                         f", not {device.type}")
    if any(t.device.type != device.type for t in ep.state_dict.values()):
        ep = move_to_device_pass(ep, str(device))
    set_precision(get_precision())
    program = ep.module()

    @torch.inference_mode()
    def serve(z, seed, labels=None):
        z = torch.as_tensor(z, dtype=torch.float32, device=device)
        noises, kwargs = _draws(meta, int(seed), z.shape[0], device)
        if labels is not None:
            kwargs["labels"] = torch.as_tensor(labels, dtype=torch.long,
                                               device=device)
        return program(z, noises, **kwargs)

    if meta["conditional"]:
        def call(z, seed, labels):
            return serve(z, seed, labels)
    else:
        def call(z, seed):
            return serve(z, seed)
    call.exported = ep
    return call
