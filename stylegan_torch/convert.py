"""Weight bridge: JAX parameter trees, the JAX package's ``.npz`` files and
reference ``.pth`` files -> the port's ``Generator`` state_dict (the port's
copy of the generator half of ``stylegan_tpu/convert/torch_params.py``, the
``.npz`` layer of ``stylegan_tpu/io/checkpoint.py`` and
``stylegan_tpu/convert/pth_files.py``).

A JAX tree path maps to a reference state_dict key one to one; the only
renamed component is the epilogue noise weight:

  JAX (dotted path)                              reference / port key
  g_mapping.map.dense{i}.{weight,bias}           same
  g_synthesis.init_block.{const,bias}            same
  g_synthesis.init_block.dense.{weight,bias}     same
  g_synthesis.init_block.conv.{weight,bias}      same
  g_synthesis.*.epi{1,2}.noise.weight            *.epi{1,2}.top_epi.noise.weight
  g_synthesis.*.epi{1,2}.style_mod.lin.*         same
  g_synthesis.blocks.{i}.{conv0_up,conv1}.*      same
  g_synthesis.to_rgb.{i}.{weight,bias}           same
  truncation.avg_latent, class_embedding.weight  same

Layouts: dense JAX (in, out) -> torch (out, in); conv HWIO -> OIHW; the
const (1, 4, 4, C) -> (1, C, 4, 4); 1-D and the embedding unchanged.
The reference's blur-kernel buffers (``conv0_up.intermediate.kernel``) are
static configuration, not weights: ``.pth`` loading drops them.
"""

from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import torch
from torch import nn

_NOISE_JAX = re.compile(r"\.(epi[12])\.noise\.weight$")
_NOISE_TORCH = re.compile(r"\.(epi[12])\.top_epi\.noise\.weight$")
_BLUR_BUFFER = ".intermediate.kernel"


# axis permutation from the JAX layout to the torch layout, by kind
_TO_TORCH = {"dense": (1, 0), "conv": (3, 2, 0, 1), "const": (0, 3, 1, 2)}


def _kind(name: str, ndim: int) -> str:
    if name.endswith("init_block.const"):
        return "const"
    if ndim == 4:
        return "conv"
    if ndim == 2 and name != "class_embedding.weight":
        return "dense"
    return "plain"


def _to_torch_layout(kind: str, a: np.ndarray) -> np.ndarray:
    return a.transpose(_TO_TORCH[kind]) if kind in _TO_TORCH else a


def _to_jax_layout(kind: str, a: np.ndarray) -> np.ndarray:
    return a.transpose(np.argsort(_TO_TORCH[kind])) if kind in _TO_TORCH else a


def flatten_params(tree, prefix: str = "") -> dict:
    """Nested dicts / lists of arrays -> {dotted path: numpy array}, the key
    scheme of the JAX package's ``.npz`` files."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    flat = {}
    for k, v in items:
        flat.update(flatten_params(v, f"{prefix}.{k}" if prefix else str(k)))
    return flat


def state_dict_from_flat(flat: dict) -> dict:
    """{JAX dotted path: array} -> {port key: float32 tensor}."""
    sd = {}
    for path, a in flat.items():
        a = np.asarray(a, dtype=np.float32)
        name = _NOISE_JAX.sub(r".\1.top_epi.noise.weight", path)
        sd[name] = torch.from_numpy(np.array(
            _to_torch_layout(_kind(name, a.ndim), a), order="C"))
    return sd


def generator_state_dict_from_jax_params(params) -> dict:
    """JAX generator tree (numpy arrays) -> the port's state_dict."""
    return state_dict_from_flat(flatten_params(params))


def flat_from_state_dict(state_dict: dict) -> dict:
    """The port's state_dict -> {JAX dotted path: numpy array}."""
    flat = {}
    for name, t in state_dict.items():
        a = t.detach().cpu().numpy()
        path = _NOISE_TORCH.sub(r".\1.noise.weight", name)
        flat[path] = np.ascontiguousarray(_to_jax_layout(_kind(name, a.ndim), a))
    return flat


def load_generator_file(generator: nn.Module, path: str) -> nn.Module:
    """Load a JAX ``.npz`` or a reference ``.pth`` into `generator` (strict)."""
    if path.endswith(".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = {k: v for k, v in sd.items() if not k.endswith(_BLUR_BUFFER)}
    else:
        with np.load(path) as z:
            sd = state_dict_from_flat(
                {k: z[k] for k in z.files if k != "__metadata__"})
    generator.load_state_dict(sd, strict=True)
    return generator


def save_generator_file(generator: nn.Module, path: str):
    """Write `generator` as a JAX-package ``.npz`` (dotted paths, JAX
    layouts), atomically: a temp file renamed into place."""
    flat = flat_from_state_dict(generator.state_dict())
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
