"""Serving and training time of one checkout of the repo, for comparing two
trees on one card (for example a commit and its parent) in turns.

    python stylegan_torch/tools/host_ab.py --tree build/parent
    python stylegan_torch/tools/host_ab.py --tree .

Imports ``stylegan_torch`` and ``chip_smoke.py`` from `--tree` (its
seeded FFHQ-1024 models and train step, as phases 3 and 5(b) build them)
and prints one JSON line: the card's name and power limit; serving img/s
at batch 8, 1024^2, float32, in REPS windows of REQUESTS requests
(each ending in a synchronize, after a warm-up request), through
make_serving_fn and through the bare generator forward; ms per depth-8,
batch-2 logistic + R1 train step in windows of STEPS; and the host's
microseconds per epilogue call at a 8x4x4x512 plane, where the launch is
all host time: an inference call, and a forward plus backward under
autograd.  Run the trees alternately (A B B A) in one call: two calls may
land on cards with other power limits and hosts of other speed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


REPS = 5            # windows of each measurement
REQUESTS = 10       # served requests of batch 8 per window
STEPS = 5           # train steps per window
CALLS = 2000        # epilogue calls timed on the host


def parse_arguments(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tree", required=True,
                   help="root of the checkout to measure")
    return p.parse_args(argv)


def _host_us_per_call(fused, torch, dev, calls):
    """Host microseconds per epilogue call at a tiny plane (inference), and
    per forward + backward under autograd."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((8, 4, 4, 512), generator=g, device=dev)
    nw = torch.randn(512, generator=g, device=dev)
    noise = torch.randn((8, 4, 4, 1), generator=g, device=dev)
    style = torch.randn((8, 1024), generator=g, device=dev)
    cot = torch.randn_like(x)
    out = {}
    with torch.no_grad():
        for _ in range(50):
            fused.fused_epilogue(x, nw, noise, style)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fused.fused_epilogue(x, nw, noise, style)
        torch.cuda.synchronize()
        out["inference_us"] = (time.perf_counter() - t0) / calls * 1e6
    xs = x.clone().requires_grad_(True)
    st = style.clone().requires_grad_(True)
    for _ in range(20):
        fused.fused_epilogue(xs, nw, noise, st).backward(cot)
    torch.cuda.synchronize()
    n = calls // 4
    t0 = time.perf_counter()
    for _ in range(n):
        fused.fused_epilogue(xs, nw, noise, st).backward(cot)
    torch.cuda.synchronize()
    out["train_fwd_bwd_us"] = (time.perf_counter() - t0) / n * 1e6
    return out


def main(args):
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import chip_smoke as c
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    from stylegan_torch.models import Generator, generator_config_from_cfg
    from stylegan_torch.ops import fused
    from stylegan_torch.ops.kernels import epilogue as kern
    from stylegan_torch.serving import make_serving_fn
    from stylegan_torch.train import create_train_state

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    dev = torch.device("cuda")
    kern.build()
    cfg = get_default_cfg()
    cfg.merge_from_file(c.CONFIG)
    cfg.freeze()
    apply_runtime_knobs(cfg)
    report = {"tree": args.tree, "card": c.card_line()}

    gen_cfg = generator_config_from_cfg(cfg)
    gen = Generator(gen_cfg)
    gen.load_state_dict(c.random_state_dict(gen), strict=True)
    serve = make_serving_fn(gen_cfg, gen.requires_grad_(False), depth=8,
                            device=dev)
    rs = np.random.default_rng(1)
    z = rs.standard_normal((8, gen_cfg.latent_size), dtype=np.float32)

    def forward(z, seed):
        with torch.inference_mode():
            return gen(torch.from_numpy(z).to(dev), depth=8, alpha=1.0,
                       seed=seed).images

    # make_serving_fn, then the bare forward, each in REPS windows
    for key, fn in (("serve_img_per_s", serve),
                    ("forward_img_per_s", forward)):
        fn(z, 1000)
        torch.cuda.synchronize()
        img_s = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            for i in range(REQUESTS):
                fn(z, i)
                torch.cuda.synchronize()
            img_s.append(REQUESTS * 8 / (time.perf_counter() - t0))
        report[key] = img_s
    del serve, gen
    torch.cuda.empty_cache()

    gen_cfg, dis_cfg, gen, dis = c.train_models(cfg, dev)
    state = create_train_state(gen, dis, dict(cfg.model.g_optim),
                               dict(cfg.model.d_optim), use_ema=cfg.use_ema)
    step = c.train_step_fn(cfg, gen_cfg, dis_cfg, 8, cfg.loss)
    alpha = torch.tensor(0.5, device=dev)
    batch = tuple(t.to(dev) for t in c.train_batch(gen_cfg, 2, 20))
    step(state, *batch, 0, alpha)
    torch.cuda.synchronize()
    ms = []
    for r in range(REPS):
        t0 = time.perf_counter()
        for i in range(STEPS):
            step(state, *batch, 1 + r * STEPS + i, alpha)
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / STEPS * 1e3)
    report["train_ms_per_step"] = ms
    del state, step, gen, dis
    torch.cuda.empty_cache()
    report.update(_host_us_per_call(fused, torch, dev, CALLS))
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main(parse_arguments())
