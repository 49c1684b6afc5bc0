"""What the generation CLIs share: the merged configuration and the
generator loaded onto its device."""

from __future__ import annotations

import numpy as np
import torch


def load_config(path: str):
    """The defaults merged with the yaml at `path`, frozen, with the
    process's numerics policy applied (float32, TF32 off by default)."""
    from stylegan_torch.config import apply_runtime_knobs, get_default_cfg
    opt = get_default_cfg()
    opt.merge_from_file(path)
    opt.freeze()
    apply_runtime_knobs(opt)
    return opt


def load_generator(opt, path: str, device):
    """The configured Generator with the weights at `path` (a JAX-package
    ``.npz`` or a reference ``.pth``), loaded partially as the JAX CLIs
    load them: a key the file lacks keeps its initial value, a ``.npz``
    shape mismatch warns, a ``.pth`` one raises.  Frozen, on `device`."""
    from stylegan_torch.convert import load_generator_file
    from stylegan_torch.models import Generator, generator_config_from_cfg
    print("Creating generator object ...")
    generator = Generator(generator_config_from_cfg(opt))
    print("Loading the generator weights from:", path)
    load_generator_file(generator, path)
    return generator.requires_grad_(False).to(device)


def rank_backend(device):
    """The process group backend of the ranks of a --spatial_devices run on
    `device`: gloo where every rank shares card i ('cuda:i': NCCL refuses
    two ranks on one device), else initialize_distributed's default (NCCL
    on the card, gloo on the CPU)."""
    device = torch.device(device)
    return "gloo" if device.type == "cuda" and device.index is not None \
        else None


def device_of(module) -> torch.device:
    return next(module.parameters()).device


def map_latents(generator, z: np.ndarray) -> np.ndarray:
    """Z (B, latent) float32 -> W through the generator's mapping network on
    its device, as a contiguous host array."""
    with torch.inference_mode():
        return np.ascontiguousarray(generator.g_mapping(
            torch.from_numpy(z).to(device_of(generator))).cpu().numpy())


def to_u8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8, truncating as the JAX figure CLIs do."""
    from stylegan_torch.io import adjust_dynamic_range
    return (adjust_dynamic_range(img) * 255).clip(0, 255).astype(np.uint8)


def pinned_noises(noises, batch: int, device):
    """The noise maps of one synthesis call of `batch` images: `noises` is a
    list of per-layer maps, or a callable batch -> such a list; None draws
    them in the synthesis from its seed."""
    if noises is None:
        return None
    maps = noises(batch) if callable(noises) else noises
    return [(n if torch.is_tensor(n) else torch.from_numpy(
        np.array(n, np.float32))).to(device) for n in maps]
