"""Traffic kind ``serve2``: the ``serve`` kind's closed loop, requests and
check (``check.serve_numbers``) for StyleGAN2's skip generator, through
``serving.make_serving_fn(cfg, G, depth=...)`` with the configuration's
``model.gen.architecture: stylegan2``.  It has its own weights (the layout
of ``reference/nets2.py``), reference (``nets2.generator``) and counts
(``counts2.py``); ``serve`` holds StyleGAN1's.

The weights are one normal draw on the device from the run seed's stream
0x57, scaled as the configuration's ``assumed`` says: mapping weight
matrices by 1 / lrmul, every other kernel and style affine and the
constant by 1, every bias (the style affines' too) and noise strength by
0.2.

What each per-layer reader takes, and its route:

* ``serve``'s own readers (``mfu.serve``, ``conv_roofline.serve``,
  ``device_idle.serve``, ``launches.latency``): the Run and its traced
  stretches as ``layer.py`` takes them, with ``counts2``'s FLOPs in
  ``run.unit_flops``;
* ``epilogue2_roofline.serve2``: the epilogue's op is named
  ``stylegan_torch::epilogue2``, so ``trace.py`` puts its kernels' device
  time in the ops stretch's ``epilogue_s`` (its bytes table does not know
  the op and gives none); this kind hands the reader each unit's bytes
  bound from ``counts2`` as ``run.epilogue2_bytes``;
* ``modulate_ms.serve2``: this kind records the program's spans over the
  device stretch (``stylegan_torch.utils.profiling.recording()``, entered
  as the stretch's first unit begins and left as its last ends) and hands
  them and the stretch's trace file to the reader as ``run.span_record``
  and ``run.span_trace``; the reader joins them (``spans.join``).

Parameters (the traffic file): ``batch``, ``depth``, ``warmup`` requests
in set-up, ``check_requests``, ``trace_from`` and ``trace_units``.
"""

from __future__ import annotations

import math
import random
from pathlib import Path

import torch

from gpubench import cells, check, controls, counts2, drive
from gpubench.reference import draws, nets2

serve = cells.module(Path(__file__).with_name("serve.py"))

WEIGHT_STREAM = 0x57


def _scale(name: str, shape, arch) -> float:
    if name.endswith("weight") and len(shape) >= 2:
        return 1.0 / arch["mapping_lrmul"] if "g_mapping" in name else 1.0
    if name.endswith("const"):
        return 1.0
    return 0.2


def make_weights(arch, seed: int, device) -> dict:
    """G's state dict, made from `seed` on `device` in one draw."""
    shapes = nets2.shapes(arch)
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


class Program(serve.Program):
    """serve(z, seed) -> images on the host (``make_serving_fn``); and the
    program's span recorder."""

    @staticmethod
    def recording():
        from stylegan_torch.utils.profiling import recording
        return recording()


class _SpanTracer:
    """The run's tracer, with the program's spans recorded over its device
    stretch."""

    def __init__(self, tracer, recording):
        self.tracer, self.recording = tracer, recording
        self.first, self.end = tracer.stretches["device"]
        self.ctx = self.rec = None
        self.spans = None

    def before(self, i):
        self.tracer.before(i)
        if i == self.first:
            self.ctx = self.recording()
            self.rec = self.ctx.__enter__()

    def after(self, i):
        if i + 1 == self.end and self.ctx is not None:
            self.ctx.__exit__(None, None, None)
            self.spans, self.ctx = list(self.rec.spans), None
        self.tracer.after(i)


class Load(serve.Load):
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
        flops = counts2.serve_image(self.arch)
        self.unit_flops = (flops[0] * self.batch, flops[1] * self.batch)
        self.unit_bytes = counts2.epilogue2_forward_bytes(self.arch,
                                                          self.batch, 4)

    def window(self, run, seconds: float, tracer=None):
        spans = None
        if tracer is not None and self.prog is not None \
                and hasattr(self.prog, "recording"):
            spans = tracer = _SpanTracer(tracer, self.prog.recording)
        super().window(run, seconds, tracer)
        run.epilogue2_bytes = [self.unit_bytes] * run.units
        if spans is not None and spans.spans is not None:
            run.span_record = spans.spans
            run.span_trace = spans.tracer.path.with_suffix(".device.json")

    def reference(self, lower=None) -> list:
        """The reference's images (B, H, W, C) of the sampled requests;
        with `lower`, computed one precision below the configuration's
        (the control)."""
        _, tf32 = controls.lower(lower)
        with torch.no_grad(), drive.precise(tf32):
            return [nets2.generator(self.weights, self.arch,
                                    z.to(self.dtype).float(), s)
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
