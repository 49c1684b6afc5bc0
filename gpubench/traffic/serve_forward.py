"""Traffic kind ``serve_forward``: the ``serve`` kind's closed loop,
requests and check, through the generator's eval forward on z in the
configuration's activation dtype under ``torch.inference_mode``, as
``tools/measure_latency.py`` runs it (the bf16 path, which
``make_serving_fn`` does not offer)."""

from __future__ import annotations

from pathlib import Path

import torch

from gpubench import cells, drive, program

serve = cells.module(Path(__file__).with_name("serve.py"))
Load, readings = serve.Load, serve.readings


class Program(serve.Program):
    def __init__(self, config, traffic, g_state: dict, seed: int, device):
        _, gen = program.generator(config, g_state, seed, device)
        depth = traffic["depth"]
        dtype = drive.dtype(config)

        def forward(z, seed):
            with torch.inference_mode():
                return gen(z.to(dtype), depth, 1.0, seed=seed,
                           train=False).images
        self.serve = forward
