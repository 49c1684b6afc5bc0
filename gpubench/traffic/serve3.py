"""Traffic kind ``serve3``: the ``serve`` kind's closed loop, requests and
check (``check.serve_numbers``) for StyleGAN3-T, through
``serving.make_serving_fn(cfg, G, depth=...)`` with the configuration's
``model.gen.architecture: stylegan3``.  It has its own weights (the layout
of ``reference/nets3.py``), reference (``nets3.generator``, a sample at a
time: the unfused filtered leaky ReLU's oversampled planes of a whole
batch-8 request would take tens of GB) and counts (``counts3.py``); it
records the program's spans over the device stretch as ``serve2`` does.

The weights are one normal draw on the device from the run seed's stream
0x33, scaled as the configuration's ``assumed`` says: mapping weight
matrices by 1 / lrmul; every other kernel, the style affines' weights and
the input's channel mapping by 1; the input's transform affine's weight by
0.2 and its bias the published (1, 0, 0, 0); layer and mapping biases by
0.2; style affine biases 1 + 0.2 n.  The input's frequencies are the
published init's map of their normal draws into a disc of radius
``first_cutoff``, its phases a uniform draw in [-0.5, 0.5) on the same
stream, its transform the identity; every ``magnitude_ema`` is 1.

What each per-layer reader takes, and its route:

* ``serve``'s own readers (``mfu.serve``, ``conv_roofline.serve``,
  ``device_idle.serve``, ``launches.latency``): the Run and its traced
  stretches as ``layer.py`` takes them, with ``counts3``'s FLOPs in
  ``run.unit_flops`` (the convolutions; the filtered leaky ReLU runs
  under its own op, ``stylegan_torch::filtered_lrelu``, outside
  ``aten::convolution``);
* ``filtered_lrelu_roofline.serve3`` and ``modulate_ms.serve2``: this kind
  records the program's spans over the device stretch (``serve2``'s
  ``_SpanTracer``) and hands them and the stretch's trace file to the
  readers as ``run.span_record`` and ``run.span_trace``, as ``serve2``
  does, so ``serve2``'s reader of ``g.modulate`` reads this cell too.

Parameters (the traffic file): ``batch``, ``depth``, ``warmup`` requests
in set-up, ``check_requests``, ``trace_from`` and ``trace_units``.
"""

from __future__ import annotations

import math
import random
from pathlib import Path

import torch

from gpubench import cells, check, controls, counts3, drive
from gpubench.reference import draws, nets3

serve = cells.module(Path(__file__).with_name("serve.py"))
serve2 = cells.module(Path(__file__).with_name("serve2.py"))

WEIGHT_STREAM = 0x33


def _scale(name: str, arch) -> tuple[float, float]:
    """(scale, offset) of a tensor's normal draw."""
    if "g_mapping" in name:
        return (1.0 / arch["mapping_lrmul"], 0.0) if name.endswith(
            "weight") else (0.2, 0.0)
    if name.endswith("input.affine.weight"):
        return 0.2, 0.0
    if name.endswith("affine.bias"):
        return 0.2, 1.0
    if name.endswith(".bias"):
        return 0.2, 0.0
    return 1.0, 0.0


def make_weights(arch, seed: int, device) -> dict:
    """G's state dict, made from `seed` on `device` in one draw (and one
    uniform draw for the input's phases)."""
    shapes = nets3.shapes(arch)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(
        draws.stream(seed, WEIGHT_STREAM))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scale, offset = zip(*(_scale(k, arch) for k in shapes))

    def spread(v):
        return torch.repeat_interleave(torch.tensor(v, device=device),
                                       torch.tensor(sizes, device=device))
    flat = flat * spread(scale) + spread(offset)
    p = {k: t.view(s) for (k, s), t in
         zip(shapes.items(), flat.split(sizes))}
    q = "g_synthesis.input"
    freqs = p[f"{q}.freqs"]
    radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
    p[f"{q}.freqs"] = freqs / (radii * radii.square().exp().pow(0.25)) \
        * arch["first_cutoff"]
    p[f"{q}.phases"] = torch.rand(p[f"{q}.phases"].shape, generator=gen,
                                  device=device) - 0.5
    p[f"{q}.transform"] = torch.eye(3, device=device)
    p[f"{q}.affine.bias"] = torch.tensor([1.0, 0.0, 0.0, 0.0],
                                         device=device)
    for k in p:
        if k.endswith("magnitude_ema"):
            p[k] = torch.ones((), device=device)
    return p


Program = serve2.Program


class Load(serve2.Load):
    family = "serve"

    def __init__(self, prog_cls, cell, seed: int, device, ranks=None):
        drive.single(ranks)
        self.cell, self.seed, self.device = cell, seed, device
        self.arch = cell.config["architecture"]
        t = cell.traffic
        self.batch, self.depth = t["batch"], t["depth"]
        self.weights = make_weights(self.arch, seed, device)
        self.dtype = drive.dtype(cell.config)
        self.prog = None if prog_cls is None else prog_cls(
            cell.config, t, self.weights, seed, device)
        self.zg = torch.Generator(device=device).manual_seed(
            draws.stream(seed, drive.Z_STREAM))
        self.issued = 0
        self.sample = []
        self.rng = random.Random(draws.stream(seed, drive.SAMPLE_STREAM))
        flops = counts3.serve_image(self.arch)
        self.unit_flops = (flops[0] * self.batch, flops[1] * self.batch)

    def window(self, run, seconds: float, tracer=None):
        spans = None
        if tracer is not None and self.prog is not None \
                and hasattr(self.prog, "recording"):
            spans = tracer = serve2._SpanTracer(tracer, self.prog.recording)
        serve.Load.window(self, run, seconds, tracer)
        if spans is not None and spans.spans is not None:
            run.span_record = spans.spans
            run.span_trace = spans.tracer.path.with_suffix(".device.json")

    def reference(self, lower=None) -> list:
        """The reference's images (B, H, W, C) of the sampled requests, a
        sample at a time; with `lower`, computed one precision below the
        configuration's (the control)."""
        _, tf32 = controls.lower(lower)
        with torch.no_grad(), drive.precise(tf32):
            return [torch.cat([nets3.generator(self.weights, self.arch,
                                               z[i:i + 1].to(self.dtype)
                                               .float(), s)
                               for i in range(z.shape[0])])
                    for z, s, _ in self.sample]


def readings(cell, seed, device):
    """The control against the reference, over as many requests as a run
    checks, drawn as a run draws them."""
    load = Load(None, cell, seed, device)
    for _ in range(cell.traffic["check_requests"]):
        load.sample.append((*load.draw(), None))
    ref = load.reference()
    low = load.reference(controls.for_config(cell.config))
    return {"control": check.serve_numbers(low, ref)}
