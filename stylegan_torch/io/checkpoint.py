"""Optimizer and full-train-state checkpoints in the JAX package's layout
(the port's counterpart of ``stylegan_tpu/io/checkpoint.py``; the network
files are ``convert.py``'s).

The JAX optimizers are optax chains, whose states flatten to these
``.npz`` keys (dotted JAX parameter paths, JAX layouts):

  G  optax.chain(clip_by_global_norm, adam)   1.0.count, 1.0.{mu,nu}.<path>
  D  optax.adam                               0.count, 0.{mu,nu}.<path>

`count` is optax's one step count, an int32; torch keeps a step per
parameter, all equal on the train path (every parameter gets a gradient in
every update).  Writing takes the largest and warns when they differ.  Adam's
moments are elementwise, so they change layout like their parameter.  JAX's
G tree holds ``truncation.avg_latent`` as a leaf with moments of its own;
in the port it is a buffer: its moments are written as zeros and ignored on
load.

The full train state is the JAX package's npz fallback: one ``<path>.npz``
with top-level keys ``g_params``, ``d_params``, ``g_opt_state``,
``d_opt_state`` and ``g_shadow`` and a ``__metadata__`` entry (``depth``,
``epoch``, ``update_count``), which JAX's ``load_train_state`` reads.  JAX
writes an orbax directory instead where orbax is installed (an OCDBT store
of zarr arrays, one per leaf, with the metadata in ``<path>.meta.json``);
the port reads that through ``tensorstore`` without importing orbax, and
says so when tensorstore is missing.

Loading is partial, as the JAX package's is: a key the file lacks keeps the
current value, a shape mismatch keeps it and warns.  Every write is atomic.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..convert import (flat_from_state_dict, load_partial, save_flat,
                       state_dict_from_flat)
from ..train.state import ClippedAdam, TrainState


def _prefix(optimizer: torch.optim.Optimizer) -> str:
    """Where the Adam state sits in the JAX optimizer's state tuple."""
    return "1.0." if isinstance(optimizer, ClippedAdam) else "0."


def _sub(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def optimizer_flat(optimizer: torch.optim.Optimizer,
                   module: nn.Module) -> dict:
    """The Adam state of `module`'s parameters as the JAX optimizer's
    flattened state."""
    params = dict(module.named_parameters())
    mu, nu, steps = {}, {}, []
    for name, t in module.state_dict().items():
        st = optimizer.state.get(params[name]) if name in params else None
        if st:
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
            steps.append(int(st["step"]))
        else:   # a buffer (the W-average), or a parameter never stepped
            mu[name] = nu[name] = torch.zeros_like(t)
    count = max(steps, default=0)
    if steps and min(steps) != count:
        warnings.warn(
            f"the optimizer's per-parameter Adam steps differ (min "
            f"{min(steps)}, max {count}); the JAX layout carries one count "
            "and keeps the max, so bias correction of the lagging parameters "
            "will differ after a resume", stacklevel=2)
    pre = _prefix(optimizer)
    flat = {f"{pre}count": np.asarray(count, np.int32)}
    for key, moments in (("mu", mu), ("nu", nu)):
        flat.update({f"{pre}{key}.{k}": v for k, v in
                     flat_from_state_dict(moments).items()})
    return flat


def load_optimizer_flat(optimizer: torch.optim.Optimizer, module: nn.Module,
                        flat: dict):
    """Set the Adam state of `module`'s parameters from the JAX optimizer's
    flattened state, partially (keys the file lacks keep their value)."""
    pre = _prefix(optimizer)
    count = flat.get(f"{pre}count")
    moments = {key: state_dict_from_flat(_sub(flat, f"{pre}{key}."))
               for key in ("mu", "nu")}
    mismatched = []
    for name, p in module.named_parameters():
        st = optimizer.state[p]
        new = {}
        for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            v = moments[key].get(name)
            if v is not None and tuple(v.shape) != tuple(p.shape):
                mismatched.append(f"{key}.{name}")
                v = None
            new[torch_key] = (v.to(p) if v is not None
                              else st.get(torch_key, torch.zeros_like(p)))
        new["step"] = (torch.tensor(float(count), dtype=torch.float32)
                       if count is not None else
                       st.get("step", torch.tensor(0.0, dtype=torch.float32)))
        optimizer.state[p] = new
    if mismatched:
        warnings.warn(
            f"optimizer restore kept {len(mismatched)} moments due to shape "
            f"mismatches (config mismatch?): {'; '.join(mismatched[:8])}",
            stacklevel=2)


def _read(path: str) -> tuple[dict, Optional[dict]]:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = flat.pop("__metadata__", None)
    if meta is not None:
        meta = json.loads(meta.tobytes().decode())
    return flat, meta


def save_optimizer_file(path: str, optimizer: torch.optim.Optimizer,
                        module: nn.Module, metadata: Optional[dict] = None):
    """GAN_{GEN,DIS}_OPTIM_*.npz in the JAX layout, atomically."""
    save_flat(path, optimizer_flat(optimizer, module), metadata)


def load_optimizer_file(optimizer: torch.optim.Optimizer, module: nn.Module,
                        path: str) -> Optional[dict]:
    """Load a JAX-layout optimizer ``.npz``; returns its metadata."""
    flat, meta = _read(path)
    load_optimizer_flat(optimizer, module, flat)
    return meta


_PARTS = ("g_params", "d_params", "g_opt_state", "d_opt_state", "g_shadow")


def save_train_state(path: str, state: TrainState, step_meta: dict):
    """Write the whole TrainState as ``<path>.npz`` in the layout of the
    JAX package's ``save_train_state(..., use_orbax=False)``."""
    parts = {
        "g_params": flat_from_state_dict(state.generator.state_dict()),
        "d_params": flat_from_state_dict(state.discriminator.state_dict()),
        "g_opt_state": optimizer_flat(state.g_optimizer, state.generator),
        "d_opt_state": optimizer_flat(state.d_optimizer, state.discriminator),
    }
    if state.g_shadow is not None:
        parts["g_shadow"] = flat_from_state_dict(state.g_shadow.state_dict())
    flat = {f"{part}.{k}": v for part, sub in parts.items()
            for k, v in sub.items()}
    save_flat(path + ".npz", flat, step_meta)


def _read_orbax(path: str) -> tuple[dict, dict]:
    """An orbax ``StandardCheckpointer`` directory as {dotted path: array}
    and its ``<path>.meta.json``.  The leaves are those that the
    directory's ``_METADATA`` lists (``tree_metadata``: each leaf's key
    path, optax's namedtuple and tuple states included; empty states have
    no value), each read from the OCDBT store under its dotted path."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ValueError(
            f"{path} is an orbax checkpoint directory, which the port reads "
            "through tensorstore, and tensorstore is not installed; install "
            "it, or write the train state with the JAX package's "
            "save_train_state(..., use_orbax=False), which gives "
            f"{path}.npz") from e
    path = os.path.abspath(path)
    with open(os.path.join(path, "_METADATA")) as f:
        md = json.load(f)
    if not md.get("use_ocdbt", False):
        raise ValueError(f"{path}: only orbax's OCDBT layout is read "
                         "(use_ocdbt is false in its _METADATA)")
    # tensorstore's URL form: the OCDBT store in `path`, the zarr array at
    # the leaf's dotted path in it
    array = "zarr3:" if md.get("use_zarr3") else "zarr2:"
    flat = {}
    for leaf in md["tree_metadata"].values():
        value = leaf["value_metadata"]
        if value["value_type"] == "None" or value.get("skip_deserialize"):
            continue
        key = ".".join(str(k["key"]) for k in leaf["key_metadata"])
        url = f"file://{path}/|ocdbt:{key}|{array}"
        flat[key] = np.asarray(ts.open(url).result().read().result())
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return flat, meta


def load_train_state(path: str, state: TrainState) -> dict:
    """Restore a TrainState written by `save_train_state`, by the JAX
    package's npz fallback or by its orbax writer (a directory at `path`),
    in place; returns its metadata."""
    if os.path.isdir(path):
        flat, meta = _read_orbax(path)
    else:
        flat, meta = _read(path + ".npz")
    parts = {part: _sub(flat, part + ".") for part in _PARTS}
    load_partial(state.generator, state_dict_from_flat(parts["g_params"]))
    load_partial(state.discriminator, state_dict_from_flat(parts["d_params"]))
    load_optimizer_flat(state.g_optimizer, state.generator,
                        parts["g_opt_state"])
    load_optimizer_flat(state.d_optimizer, state.discriminator,
                        parts["d_opt_state"])
    if state.g_shadow is not None:
        load_partial(state.g_shadow, state_dict_from_flat(parts["g_shadow"]))
    return meta or {}
