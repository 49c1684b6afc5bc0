"""Where a replayed request stops agreeing bit for bit, on the card.

    python -m stylegan_torch.tools.replay_probe [--batch 8]

Builds the seeded FFHQ-1024 generator of ``chip_smoke.py``'s phase 3
(float32, TF32 off, cuDNN's default algorithms) and looks for the first
difference two ways:

* stages: one request is served twice with a forward hook on each synthesis
  stage (the input block, the 8 growth blocks, the to_rgb layers); the
  stages whose outputs differ between the two runs, in forward order;
* ops: one more forward under a dispatch mode that runs every operator
  twice on the same inputs (random, in-place and allocating operators once)
  and compares the two outputs bitwise; the operators whose two outputs
  differ, in forward order, with their shapes and max |diff|.

Prints one JSON line, beside the card's name and power limit.  Exits 1 when
the two runs of a request differ anywhere.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_ONCE = ("rand", "normal", "uniform", "bernoulli", "empty", "copy_")


def parse_arguments(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    return p.parse_args(argv)


def _bitwise_diff(a: torch.Tensor, b: torch.Tensor) -> float | None:
    """None when a and b hold the same bits, else max |a - b|."""
    if torch.equal(a, b):
        return None
    return float((a.double() - b.double()).abs().max())


class _TwiceMode(TorchDispatchMode):
    """Runs each operator twice and records the ones whose outputs differ."""

    def __init__(self):
        super().__init__()
        self.ops, self.differ = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        out = func(*args, **kwargs)
        if func._schema.is_mutable or any(s in name for s in _ONCE):
            return out
        self.ops += 1
        again = func(*args, **kwargs)
        first, _ = tree_flatten(out)
        second, _ = tree_flatten(again)
        for a, b in zip(first, second):
            if isinstance(a, torch.Tensor) and a.is_floating_point():
                d = _bitwise_diff(a, b)
                if d is not None:
                    shapes = [tuple(t.shape) for t in tree_flatten(args)[0]
                              if isinstance(t, torch.Tensor)]
                    self.differ.append({"index": self.ops, "op": name,
                                        "input_shapes": shapes,
                                        "max_abs_diff": d})
                    break
        return out


def main(args):
    sys.path.insert(0, REPO)
    import chip_smoke as c
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    from stylegan_torch.models import Generator, generator_config_from_cfg

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    dev = torch.device("cuda")
    cfg = get_default_cfg()
    cfg.merge_from_file(c.CONFIG)
    cfg.freeze()
    apply_runtime_knobs(cfg)          # float32, TF32 off
    gen_cfg = generator_config_from_cfg(cfg)
    gen = Generator(gen_cfg)
    gen.load_state_dict(c.random_state_dict(gen), strict=True)
    gen.requires_grad_(False).eval().to(dev)
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (args.batch, gen_cfg.latent_size), dtype=np.float32)).to(dev)

    def forward():
        with torch.inference_mode():
            return gen(z, depth=c.DEPTH, alpha=1.0, seed=0).images

    syn = gen.g_synthesis
    stages = [("init_block", syn.init_block)] + [
        (f"blocks.{i}", b) for i, b in enumerate(syn.blocks)] + [
        (f"to_rgb.{c.DEPTH}", syn.to_rgb[c.DEPTH])]
    runs = [[], []]
    run = [0]
    handles = [m.register_forward_hook(
        lambda mod, inp, out, name=name: runs[run[0]].append(
            (name, out.clone()))) for name, m in stages]
    forward()                         # warm-up: cuDNN picks its algorithms
    runs[0].clear()
    torch.cuda.synchronize()
    for r in (0, 1):
        run[0] = r
        forward()
        torch.cuda.synchronize()
    for h in handles:
        h.remove()
    stage_diffs = []
    for (name, a), (_, b) in zip(*runs):
        d = _bitwise_diff(a, b)
        if d is not None:
            stage_diffs.append({"stage": name, "shape": tuple(a.shape),
                                "max_abs_diff": d})
    del runs

    mode = _TwiceMode()
    with mode:
        forward()
    torch.cuda.synchronize()
    report = {"card": c.card_line(), "batch": args.batch,
              "stages_differing": stage_diffs,
              "ops_run_twice": mode.ops,
              "ops_differing": mode.differ[:20],
              "n_ops_differing": len(mode.differ)}
    print(json.dumps(report), flush=True)
    return 1 if stage_diffs or mode.differ else 0


if __name__ == "__main__":
    sys.exit(main(parse_arguments()))
