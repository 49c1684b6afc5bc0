"""The set-up of stylegan_torch that every traffic kind shares: its kernel
library, its merged configuration and its generator.  The kinds'
``Program`` hooks (``traffic/<kind>.py``) drive the system through its
own entry points from there."""

from __future__ import annotations

import time


def build_library() -> float:
    """Builds the program's kernel library if its cache misses; returns
    the seconds it took."""
    from stylegan_torch.ops.kernels import epilogue
    t = time.perf_counter()
    epilogue.build()
    return time.perf_counter() - t


def run_config(config: dict, seed: int):
    """The program's merged configuration (its defaults, the file's
    ``overlay``, the run's seed), with its numerics policy applied."""
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    cfg = get_default_cfg()
    cfg.merge_from_other_cfg(config["overlay"])
    cfg.seed = int(seed)
    cfg.freeze()
    apply_runtime_knobs(cfg)
    return cfg


def generator(config: dict, g_state: dict, seed: int, device):
    """(generator config, G in eval mode on `device` holding `g_state`)."""
    from stylegan_torch.models import Generator, generator_config_from_cfg
    gen_cfg = generator_config_from_cfg(run_config(config, seed))
    gen = Generator(gen_cfg)
    gen.load_state_dict(g_state, strict=True)
    gen.requires_grad_(False).eval().to(device)
    return gen_cfg, gen
