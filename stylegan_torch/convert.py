"""Weight bridge: JAX parameter trees, the JAX package's ``.npz`` files and
reference ``.pth`` files <-> the port's ``Generator`` and ``Discriminator``
state_dicts (the port's copy of ``stylegan_tpu/convert/torch_params.py``,
the ``.npz`` layer of ``stylegan_tpu/io/checkpoint.py`` and
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
  blocks.{i}.{conv0,conv1_down}.*  (D)           same
  from_rgb.{i}.*, final_block.{conv,dense0,dense1}.*, embeddings.{i}.weight

Layouts: dense JAX (in, out) -> torch (out, in); conv HWIO -> OIHW; the
const (1, 4, 4, C) -> (1, C, 4, 4); 1-D and the embeddings (G's
``class_embedding``, D's ``embeddings.{i}``, both (n_classes, dim))
unchanged.  The reference's blur-kernel buffers (G's
``conv0_up.intermediate.kernel``, D's ``blocks.{i}.blur.kernel``) are static
configuration, not weights: ``.pth`` loading drops them, and a D ``.pth``
written here carries them, as the reference's does.

Loading is partial by default, as the JAX package's is: a shallow checkpoint
resumes into a deeper network, and a key the file lacks keeps the module's
value.  A shape mismatch depends on the kind of file, as in JAX: a ``.npz``
keeps the module's value and warns (`load_partial`,
``stylegan_tpu/io/checkpoint.py::unflatten_like``), a reference ``.pth`` (or
a converted TF pickle) raises and names the key (`load_reference_partial`,
``stylegan_tpu/convert/torch_params.py::_load_entries``).  The sample CLI
asks for a strict load instead: a file that misses keys would otherwise give
images of an initialised network, which the JAX CLIs warn about only on
shapes.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import warnings
from typing import Optional

import numpy as np
import torch
from torch import nn

_NOISE_JAX = re.compile(r"\.(epi[12])\.noise\.weight$")
_NOISE_TORCH = re.compile(r"\.(epi[12])\.top_epi\.noise\.weight$")
_BLUR_BUFFERS = (".intermediate.kernel", ".blur.kernel")
_EMBEDDING = re.compile(r"(^|\.)(class_embedding|embeddings\.\d+)\.weight$")


# axis permutation from the JAX layout to the torch layout, by kind
_TO_TORCH = {"dense": (1, 0), "conv": (3, 2, 0, 1), "const": (0, 3, 1, 2)}


def _kind(name: str, ndim: int) -> str:
    if name.endswith("init_block.const"):
        return "const"
    if ndim == 4:
        return "conv"
    if ndim == 2 and not _EMBEDDING.search(name):
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
    """{JAX dotted path: array} -> {port key: float32 tensor} (float64
    arrays stay float64)."""
    sd = {}
    for path, a in flat.items():
        a = np.asarray(a)
        a = a.astype(np.float64 if a.dtype == np.float64 else np.float32,
                     copy=False)
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


def discriminator_state_dict_from_jax_params(params) -> dict:
    """JAX discriminator tree (numpy arrays) -> the port's state_dict."""
    return state_dict_from_flat(flatten_params(params))


def _read_file(path: str) -> tuple[dict, str]:
    """A JAX ``.npz`` or a reference ``.pth`` as the port's state_dict (the
    ``.pth``'s blur-kernel buffers dropped), and the kind of file it was,
    ``"pth"`` or ``"npz"``."""
    if path.endswith(".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return ({k: v for k, v in sd.items()
                 if not k.endswith(_BLUR_BUFFERS)}, "pth")
    with np.load(path) as z:
        return state_dict_from_flat(
            {k: z[k] for k in z.files if k != "__metadata__"}), "npz"


def load_partial(module: nn.Module, sd: dict) -> nn.Module:
    """Load `sd` into `module` with the JAX package's partial semantics
    (``stylegan_tpu/io/checkpoint.py::unflatten_like``, partial=True, the
    reference's --start_depth resume): a key the module lacks is ignored, a
    key `sd` lacks keeps the module's value, and a shape mismatch keeps it
    too and warns with the count and the first 8 keys (a config mismatch
    that would otherwise pass for a restored model)."""
    own = module.state_dict()
    keep, mismatched = {}, []
    for k, v in sd.items():
        if k not in own:
            continue
        if tuple(v.shape) == tuple(own[k].shape):
            keep[k] = v
        else:
            mismatched.append(f"{k}: checkpoint {tuple(v.shape)} vs model "
                              f"{tuple(own[k].shape)}")
    if mismatched:
        more = (f" (+{len(mismatched) - 8} more)" if len(mismatched) > 8
                else "")
        warnings.warn(
            f"checkpoint restore kept {len(mismatched)} initialized tensors "
            f"due to shape mismatches (config mismatch?): "
            f"{'; '.join(mismatched[:8])}{more}", stacklevel=3)
    module.load_state_dict(keep, strict=False)
    return module


def load_reference_partial(module: nn.Module, sd: dict) -> nn.Module:
    """Load a reference-keyed state_dict (a ``.pth``, or a converted TF
    pickle; tensors or numpy arrays in torch layouts) into `module` with
    the semantics of the JAX package's ``.pth`` import (torch_params.py
    ``_load_entries``, the reference's ``load_state_dict(strict=False)``):
    a key the module lacks is ignored, a key `sd` lacks keeps the module's
    value, and a shape mismatch raises, naming the key and both shapes."""
    own = module.state_dict()
    keep = {}
    for k, v in sd.items():
        if k not in own:
            continue
        v = torch.as_tensor(v)
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch for {k}: file {tuple(v.shape)} "
                             f"vs model {tuple(own[k].shape)}")
        keep[k] = v
    module.load_state_dict(keep, strict=False)
    return module


def _load_file(module: nn.Module, path: str, strict: bool) -> nn.Module:
    sd, kind = _read_file(path)
    if strict:
        module.load_state_dict(sd, strict=True)
        return module
    if kind == "pth":
        return load_reference_partial(module, sd)
    return load_partial(module, sd)


def _write_atomically(path: str, write):
    """write(file object) into a temp file beside `path`, renamed into
    place."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_flat(path: str, flat: dict, metadata: Optional[dict] = None):
    """Write {dotted path: array} as a JAX-package ``.npz`` atomically, with
    `metadata` as its ``__metadata__`` entry (JSON bytes), as
    ``stylegan_tpu/io/checkpoint.py::save_params`` does."""
    if metadata is not None:
        flat = dict(flat, __metadata__=np.frombuffer(
            json.dumps(metadata).encode(), dtype=np.uint8))
    _write_atomically(path, lambda f: np.savez(f, **flat))


def load_generator_file(generator: nn.Module, path: str,
                        strict: bool = False) -> nn.Module:
    """Load a JAX ``.npz`` or a reference ``.pth`` into `generator`, partially
    as the JAX package does (a ``.npz``'s shape mismatch warns, a
    ``.pth``'s raises), or every key and shape required with strict=True."""
    return _load_file(generator, path, strict)


def _save_pth(path: str, sd: dict, buffers: dict):
    sd = {k: v.detach().cpu().clone() for k, v in sd.items()}
    sd.update(buffers)
    _write_atomically(path, lambda f: torch.save(sd, f))


def save_generator_file(generator: nn.Module, path: str,
                        metadata: Optional[dict] = None):
    """Write `generator` atomically (a temp file renamed into place): a path
    ending in ``.pth`` as a reference state_dict (with each growth block's
    ``conv0_up.intermediate.kernel`` blur buffer, shape (1, 1, k, k), where
    the synthesis blurs, as ``generator_state_dict_from_params(...,
    blur_filter=)`` emits them), any other as a JAX-package ``.npz``
    (dotted paths, JAX layouts, with `metadata`)."""
    sd = generator.state_dict()
    if path.endswith(".pth"):
        syn = generator.g_synthesis
        buffers = {}
        if syn.blur_kernel is not None:
            kernel = syn.blur_kernel.detach().cpu()[None, None].clone()
            buffers = {f"g_synthesis.blocks.{i}.conv0_up.intermediate.kernel":
                       kernel for i in range(len(syn.blocks))}
        _save_pth(path, sd, buffers)
    else:
        save_flat(path, flat_from_state_dict(sd), metadata)


def load_discriminator_file(discriminator: nn.Module, path: str,
                            strict: bool = False) -> nn.Module:
    """Load a JAX ``.npz`` or a reference ``.pth`` into `discriminator`
    (partially unless strict, as `load_generator_file`; a ``.pth``'s
    ``blocks.{i}.blur.kernel`` buffers are dropped)."""
    return _load_file(discriminator, path, strict)


def save_discriminator_file(discriminator: nn.Module, path: str,
                            metadata: Optional[dict] = None):
    """Write `discriminator` atomically: a path ending in ``.pth`` as a
    reference state_dict (with each block's ``blur.kernel`` buffer, the
    normalised blur of shape (1, 1, k, k)), any other as a JAX-package
    ``.npz`` (with `metadata`)."""
    sd = discriminator.state_dict()
    if path.endswith(".pth"):
        kernel = discriminator.blur_kernel.detach().cpu()[None, None].clone()
        _save_pth(path, sd, {f"blocks.{i}.blur.kernel": kernel
                             for i in range(len(discriminator.blocks))})
    else:
        save_flat(path, flat_from_state_dict(sd), metadata)
