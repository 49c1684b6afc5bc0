"""Serving: a generator frozen into a request function, and the same frozen
into a ``torch.export`` artifact (the port's counterpart of
``stylegan_tpu/serving.py``).

    serve = make_serving_fn(gen_cfg, generator, depth=8)
    images = serve(z, seed)          # (B, H, W, 3) in [-1, 1], on the host

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
(``ops/linear.py``) because cuDNN's transposed convolutions do not, and
StyleGAN2's up-convolution, the port's own kernel
(``ops/kernels/modconv_up.py``).  Eval
semantics by default (no style mixing, no train-branch truncation);
`train_quirks=True` gives the reference's train-mode sampling.

`make_serving_fn`'s serve hands the images to the host: on the card it
copies them into page-locked host memory (PyTorch's caching host
allocator, so a request whose caller dropped an earlier result reuses that
block) and returns only once the copy has completed.  A caller that keeps
many results keeps that much page-locked memory, which cannot be swapped.
`load_exported`'s serve returns the images on its device.

The artifact holds the traced generator at one (batch, depth), its weights
baked in.  It differs from the JAX package's StableHLO file, which is
self-contained: it needs ``stylegan_torch.ops`` importable, for the
registration of the ``stylegan_torch::`` ops that its graph calls (the
epilogues', StyleGAN2's up-convolution; ``serving`` imports it), and on the
card the kernel libraries, which ``ops/kernels/epilogue.py`` builds from
the repo's sources at first use.  It
needs no model code, config or checkpoint.  The request's draws stay
outside the traced graph: the per-layer noise maps (and, with train quirks,
the mixing latents and cutoff) are inputs of the program, drawn by
`load_exported`'s serve from the seed with the same functions
`make_serving_fn` uses, so that the two compute the same images, bit for
bit on either device.

A spatial artifact (``spatial_devices=N``) holds the forward split by
height over N ranks (``parallel/spatial.py``): one program for every rank,
whose rank is an input (a 0-d int64 tensor that picks the halo rows and
the statistics' slot) and whose collectives are ``_c10d_functional``
nodes.  It exports from one process (the nodes name a process group; no
group is needed to trace them); each of N ranks loads it, and the loader
puts its mesh's group in those nodes.  Its serve draws the full noise of
every layer and passes the rank's rows of the split layers, and returns the
rank's rows of the images.
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
from .models.synthesis2 import noise_resolution
from .ops import fused  # noqa: F401  (the artifact's epilogue ops)
from .ops.precision import get_precision, set_precision
from .parallel import halo
from .utils.profiling import counters, span

# What load_exported needs to draw a request's inputs, stored beside the
# program.
_META = "stylegan_torch.json"
PLATFORMS = ("cuda", "cpu")


def make_serving_fn(gen_cfg, generator, *, depth: int,
                    train_quirks: bool = False, device=None):
    """Returns serve(z, seed[, labels]) -> images in host memory.

    device: CUDA unless the caller passes 'cpu'; raises when CUDA is missing
    and the CPU was not asked for.  The generator is moved there and runs
    the forward there.  On CUDA serve copies the images into a page-locked
    host tensor with the forward's shape, dtype and strides, and returns it
    after the copy has completed; a caller that keeps many results keeps
    that much page-locked host memory (the same bytes as a pageable copy,
    but they cannot be swapped).  On the CPU it returns the forward's
    images.
    z: (B, latent) float32 (tensor or array); seed: int; labels: (B,) int64,
    only when gen_cfg.conditional.  Applies the process precision policy
    (float32 convs without TF32 unless set_precision('default'))."""
    device = resolve_device(device)
    generator.to(device)
    set_precision(get_precision())

    @torch.inference_mode()
    def serve(z, seed, labels=None):
        with span("serve.request"):
            with span("serve.input"):
                z = torch.as_tensor(z, dtype=torch.float32, device=device)
            if labels is not None:
                labels = torch.as_tensor(labels, dtype=torch.long,
                                         device=device)
            images = generator(z, depth=depth, alpha=1.0, seed=int(seed),
                               train=train_quirks, labels=labels).images
            with span("serve.output"):
                return _to_host(images)

    if gen_cfg.conditional:
        return lambda z, seed, labels: serve(z, seed, labels)
    return lambda z, seed: serve(z, seed)


def _to_host(images: torch.Tensor) -> torch.Tensor:
    """`images` in host memory, their copy completed.  A CUDA tensor is
    copied in one DMA on its stream into a page-locked tensor of the same
    strides; the counters take the request (``serve.host_copies``) and,
    when the caching host allocator had to create a block for it,
    ``serve.host_allocs``."""
    if images.device.type != "cuda":
        return images
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    host = torch.empty_like(images, device="cpu", pin_memory=True)
    counters["serve.host_allocs"] += (
        torch.cuda.host_memory_stats()["num_host_alloc"] - allocs)
    counters["serve.host_copies"] += 1
    host.copy_(images, non_blocking=True)
    torch.cuda.current_stream(images.device).synchronize()
    return host


def _noise_layers(gen_cfg, depth: int) -> int:
    """The synthesis layers whose noise a forward at `depth` reads."""
    if gen_cfg.architecture == "stylegan2":
        return 2 * depth + 1
    if gen_cfg.architecture == "stylegan3":
        return 0
    if not gen_cfg.synthesis.use_noise:
        return 0
    if gen_cfg.synthesis.structure == "fixed":
        return gen_cfg.num_layers
    return 2 * (depth + 1)


def _noise_resolution(architecture: str):
    """Layer index -> its noise map's resolution, by architecture."""
    return noise_resolution if architecture == "stylegan2" \
        else layer_resolution


class _Served(nn.Module):
    """What export_generator traces: one forward at `depth` with the
    request's draws as inputs; split over `spatial_devices` ranks, whose
    rank is an input too."""

    def __init__(self, generator, depth: int, train_quirks: bool,
                 spatial_devices: int = 1):
        super().__init__()
        self.generator, self.depth = generator, depth
        self.train_quirks = train_quirks
        self.spatial_devices = spatial_devices

    def forward(self, z, noises, labels=None, latents2=None, cutoff=None,
                rank=None):
        mixing = None if latents2 is None else (latents2, cutoff)
        spatial = None if rank is None else halo.SpatialContext(
            self.spatial_devices, rank, halo.WORLD_GROUP)
        return self.generator(z, depth=self.depth, alpha=1.0,
                              train=self.train_quirks, labels=labels,
                              noises=noises, mixing=mixing,
                              spatial=spatial).images


def _rank_noises(noises, n: int, rank: torch.Tensor):
    """The maps a rank's program takes: its rows of a split layer's map,
    a short layer's map whole."""
    ctx = halo.SpatialContext(n, rank)
    return [halo.take_rows(m, ctx) if halo.splits(m.shape[1], ctx) else m
            for m in noises]


def _regroup(ep, group_name: str):
    """Point the exported program's collectives at `group_name`."""
    for node in ep.graph.nodes:
        if node.op == "call_function" and \
                node.target is torch.ops._c10d_functional.all_reduce.default:
            node.args = (*node.args[:2], group_name)
    ep.graph_module.recompile()


def _draws(meta: dict, seed: int, batch: int, device):
    """(noise maps, and with mixing (latents2, cutoff)) of one request, as
    the generator draws them from `seed` (synthesis.py, generator.py)."""
    res = _noise_resolution(meta.get("architecture", "stylegan1"))
    noises = [make_noise(seed, i, batch, res(i), device)
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
    host either way.  `spatial_devices` N > 1 exports the forward split by
    height over N ranks (the module docstring), from this one process; it
    refuses what the JAX package refuses: a conditional model, and an output
    resolution that does not divide by 4N.  Returns the bytes of
    ``torch.export.save``."""
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
        if gen_cfg.architecture != "stylegan1":
            raise ValueError(f"spatial export does not support architecture "
                             f"{gen_cfg.architecture!r} (it has no spatial "
                             f"path)")
        if gen_cfg.conditional:
            raise ValueError("spatial export does not support conditional "
                             "models (same restriction as generate_samples "
                             "--spatial_devices)")
        halo.check_shards(2 ** (depth + 2), spatial_devices)
    device = next(generator.parameters()).device
    meta = {"depth": depth, "platforms": list(platforms),
            "conditional": bool(gen_cfg.conditional),
            "architecture": gen_cfg.architecture,
            "noise_layers": _noise_layers(gen_cfg, depth),
            "mixes": bool(train_quirks and gen_cfg.style_mixing_prob),
            "style_mixing_prob": gen_cfg.style_mixing_prob,
            "mapping_latent": gen_cfg.mapping.latent_size,
            "spatial_devices": int(spatial_devices)}
    z = torch.zeros((batch_size, gen_cfg.latent_size), device=device)
    noises, kwargs = _draws(meta, 0, batch_size, device)
    if gen_cfg.conditional:
        kwargs["labels"] = torch.zeros((batch_size,), dtype=torch.long,
                                       device=device)
    if spatial_devices > 1:
        kwargs["rank"] = torch.zeros((), dtype=torch.long, device=device)
        noises = _rank_noises(noises, spatial_devices, kwargs["rank"])
    with torch.no_grad():
        ep = torch.export.export(
            _Served(generator, depth, train_quirks, spatial_devices),
            (z, noises), kwargs)
    ep.example_inputs = None        # the program needs no sample inputs
    if device.type != "cpu":
        ep = move_to_device_pass(ep, "cpu")
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


def load_exported(path_or_bytes, device=None, mesh=None):
    """Load an export_generator artifact onto `device` (CUDA unless the
    caller passes 'cpu'); returns serve(z, seed[, labels]) -> images, with
    the ``ExportedProgram`` as ``serve.exported``.

    z: (B, latent) float32 at the artifact's batch (another batch is
    rejected by the program); seed: int; labels: (B,) int64, only for a
    conditional model.  Applies the process precision policy, as
    make_serving_fn does.

    A spatial artifact of N ranks runs on `mesh`, a spatial mesh of N
    ranks that holds this one (default: ``create_spatial_mesh(N)``, which
    every rank of the world calls); it needs a process group of at least N
    ranks and raises otherwise, as the JAX package needs N devices.  Every
    rank of the mesh calls serve with the same arguments and gets its rows
    (B, H/N, W, 3) of the images (``parallel.gather_rows`` gathers
    them)."""
    device = resolve_device(device)
    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(bytes(path_or_bytes))
    extra = {_META: ""}
    ep = torch.export.load(path_or_bytes, extra_files=extra)
    meta = json.loads(extra[_META])
    if device.type not in meta["platforms"]:
        raise ValueError(f"the artifact was exported for {meta['platforms']}"
                         f", not {device.type}")
    n = meta.get("spatial_devices", 1)
    rank = None
    if n > 1:
        rank, group_name = _spatial_rank(n, mesh, device)
        _regroup(ep, group_name)
    if any(t.device.type != device.type for t in ep.state_dict.values()):
        ep = move_to_device_pass(ep, str(device))
    set_precision(get_precision())
    program = ep.module()

    @torch.inference_mode()
    def serve(z, seed, labels=None):
        z = torch.as_tensor(z, dtype=torch.float32, device=device)
        noises, kwargs = _draws(meta, int(seed), z.shape[0], device)
        if rank is not None:
            kwargs["rank"] = rank
            noises = _rank_noises(noises, n, rank)
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


def _spatial_rank(n: int, mesh, device):
    """(this rank as a 0-d tensor on `device`, its mesh's group name) for
    an artifact of `n` ranks."""
    import torch.distributed as dist

    from .parallel.spatial import create_spatial_mesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(f"the artifact was exported for {n} spatial "
                           f"devices, but this process group has {world} "
                           f"rank(s)")
    mesh = create_spatial_mesh(n) if mesh is None else mesh
    if mesh.size != n or not mesh.is_member:
        raise ValueError(f"the artifact runs on a spatial mesh of {n} ranks "
                         f"that holds this one, got {mesh.size} ranks and "
                         f"rank {mesh.rank}")
    return (torch.tensor(mesh.rank, dtype=torch.long, device=device),
            mesh.group.group_name)
