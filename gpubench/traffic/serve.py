"""Traffic kind ``serve``: one client in a closed loop of requests through
``serving.make_serving_fn(cfg, G, depth=...)``, whose serve casts z to
float32.

Each request has fresh z (B, latent) from a device generator on the run
seed's stream 0x5A and its own request seed, stream (seed, 0x52, i); it
completes when its images are in host memory as
``cli/generate_samples.py`` takes them (``.float().cpu()``), and its
latency runs from the call until then.  A seeded reservoir keeps
``check_requests`` of the window's requests, whose images the reference
computes again after the window.

Parameters (the traffic file): ``batch``, ``depth``, ``warmup`` requests
in set-up, ``check_requests``, ``trace_from`` and ``trace_units``.
"""

from __future__ import annotations

import random
import sys
import time

import torch

from gpubench import check, controls, counts, drive, program
from gpubench import weights as wts
from gpubench.reference import draws, nets


class Program:
    """serve(z, seed) -> images on the device, and to_host."""

    def __init__(self, config, traffic, g_state: dict, seed: int, device):
        gen_cfg, gen = program.generator(config, g_state, seed, device)
        from stylegan_torch.serving import make_serving_fn
        self.serve = make_serving_fn(gen_cfg, gen, depth=traffic["depth"],
                                     device=device)

    @staticmethod
    def to_host(images):
        return images.float().cpu()


class Load:
    family = "serve"

    def __init__(self, prog_cls, cell, seed: int, device, ranks=None):
        drive.single(ranks)
        self.cell, self.seed, self.device = cell, seed, device
        self.arch = cell.config["architecture"]
        t = cell.traffic
        self.batch, self.depth = t["batch"], t["depth"]
        self.weights = wts.make(self.arch, seed, device)
        self.dtype = drive.dtype(cell.config)
        self.prog = None if prog_cls is None else prog_cls(
            cell.config, t, wts.split(self.weights, "g"), seed, device)
        self.zg = torch.Generator(device=device).manual_seed(
            draws.stream(seed, drive.Z_STREAM))
        self.issued = 0
        self.sample = []
        self.rng = random.Random(draws.stream(seed, drive.SAMPLE_STREAM))
        flops = counts.serve_image(self.arch)
        self.unit_flops = (flops[0] * self.batch, flops[1] * self.batch)

    def draw(self):
        """The next request's (z, request seed)."""
        z = torch.randn((self.batch, self.arch["latent_size"]),
                        generator=self.zg, device=self.device)
        s = draws.stream(self.seed, drive.REQUEST_STREAM, self.issued)
        self.issued += 1
        return z, s

    def request(self):
        """Issues the next request; returns (z, seed, host images,
        latency: the call until its images are on the host)."""
        z, s = self.draw()
        with drive.span("gpubench.request"):
            t = time.perf_counter()
            images = self.prog.serve(z, s)
            with drive.span("gpubench.to_host"):
                host = self.prog.to_host(images)
            return z, s, host, time.perf_counter() - t

    def warm(self):
        for _ in range(self.cell.traffic["warmup"]):
            self.request()

    def window(self, run, seconds: float, tracer=None):
        """The closed loop: the next request goes out when the last one's
        images are on the host."""
        k = self.cell.traffic["check_requests"]
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            if tracer:
                tracer.before(i)
            try:
                z, s, host, latency = self.request()
            except RuntimeError as e:
                print(f"request {i} failed: {e}", file=sys.stderr)
                run.failed += 1
                host = None
            if host is not None:
                run.latencies_s.append(latency)
                run.images += host.shape[0]
                j = i if i < k else self.rng.randint(0, i)
                if j < k:
                    if j < len(self.sample):
                        self.sample[j] = (z, s, host)
                    else:
                        self.sample.append((z, s, host))
            if tracer:
                tracer.after(i)
            i += 1
        run.window_s = time.perf_counter() - t0
        run.units = i
        run.unit_flops = [self.unit_flops] * i

    def release(self):
        del self.prog
        self.prog = None

    def reference(self, lower=None) -> list:
        """The reference's images (B, H, W, C) of the sampled requests;
        with `lower`, computed one precision below the configuration's
        (the control)."""
        g = wts.split(self.weights, "g")
        q, tf32 = controls.lower(lower)
        with torch.no_grad(), drive.precise(tf32):
            return [nets.generator(
                g, self.arch, z.to(self.dtype).float(), self.depth, 1.0, s,
                dtype=self.dtype, q=q).permute(0, 2, 3, 1)
                for z, s, _ in self.sample]

    def numbers(self) -> dict:
        return check.serve_numbers(
            [host.to(self.device) for _, _, host in self.sample],
            self.reference())


def readings(cell, seed, device):
    """The control against the reference, over as many requests as a run
    checks, drawn as a run draws them."""
    load = Load(None, cell, seed, device)
    for _ in range(cell.traffic["check_requests"]):
        load.sample.append((*load.draw(), None))
    ref = load.reference()
    low = load.reference(controls.for_config(cell.config))
    return {"control": check.serve_numbers(low, ref)}
