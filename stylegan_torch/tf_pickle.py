"""Official-TF-weight import without TensorFlow (the port's copy of
``stylegan_tpu/convert/tf_pickle.py``; numpy and pickle only).

The official StyleGAN `.pkl` holds a (G, D, Gs) tuple of dnnlib.tflib.Network
objects whose pickled state is a plain dict (reference
dnnlib/tflib/network.py:256-266): name, static_kwargs, components (sub-
Networks), build source, and ``variables`` = [(local_name, np.ndarray)].  The
arrays are embedded in the pickle — TensorFlow is only needed by the
reference's convert.py because it replays the graph (network.py:268-300).  We
instead unpickle with a restricted Unpickler that:

  * maps dnnlib.tflib.network.Network -> a stub recording the state dict,
  * allows only numpy / collections reconstruction paths,
  * refuses everything else (the pickle's embedded source code is never
    executed).

Variable scoping mirrors TF: a component Network's variables live under
"<component.name>/<local_name>" (e.g. G_synthesis/4x4/Conv/weight).

Name translation reproduces the reference's TF->torch key mapping
(convert.py:34-73), so the result is a reference-keyed state_dict, which is
the port's key scheme: it loads as a reference ``.pth`` does
(``convert.py::load_reference_partial``: shapes asserted, missing keys kept):
  G_mapping/Dense{i}        -> g_mapping.map.dense{i}
  4x4/Const/...             -> g_synthesis.init_block.{const,bias,epi1...}
  4x4/Conv/...              -> g_synthesis.init_block.{conv,epi2...}
  {2^k}x{2^k}/Conv0_up,Conv1-> g_synthesis.blocks.{k-3}....
  ToRGB_lod0                -> g_synthesis.to_rgb.{out_depth}
  dlatent_avg               -> truncation.avg_latent
Layout: TF dense (in,out) -> torch (out,in); TF conv HWIO -> torch OIHW.
lod / noise{i} inputs / ToRGB_lod{>0} are dropped (same as the reference).
"""

from __future__ import annotations

import math
import pickle
from typing import Dict, List

import numpy as np

_ALLOWED = {
    ("collections", "OrderedDict"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
}


class NetworkStub:
    """Stands in for dnnlib.tflib.network.Network during unpickling."""

    def __setstate__(self, state: dict):
        self.name = state.get("name")
        self.static_kwargs = dict(state.get("static_kwargs", {}))
        self.components = dict(state.get("components", {}))
        self.variables = list(state.get("variables", []))

    # Network is pickled via REDUCE in some protocol variants
    def __init__(self, *args, **kwargs):
        self.name = None
        self.static_kwargs = {}
        self.components = {}
        self.variables = []


class _EasyDictStub(dict):
    pass


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ALLOWED:
            return super().find_class(module, name)
        if name == "Network" and "network" in module:
            return NetworkStub
        if name == "EasyDict":
            return _EasyDictStub
        raise pickle.UnpicklingError(
            f"blocked global during TF-pickle import: {module}.{name}")


def load_tf_networks(path: str) -> List[NetworkStub]:
    """Load an official StyleGAN pickle -> list of NetworkStubs (G, D, Gs)."""
    with open(path, "rb") as f:
        data = _RestrictedUnpickler(f).load()
    if isinstance(data, (list, tuple)):
        return list(data)
    return [data]


def collect_variables(net: NetworkStub) -> Dict[str, np.ndarray]:
    """Flatten a network's own + component variables with TF scope names."""
    out = {}
    for name, value in net.variables:
        out[name] = np.asarray(value)
    for comp in net.components.values():
        prefix = getattr(comp, "name", None) or ""
        for name, value in getattr(comp, "variables", []):
            out[f"{prefix}/{name}"] = np.asarray(value)
    return out


# ---------------------------------------------------------------------------
# TF name/layout -> torch-style state_dict (fed to torch_params loaders)
# ---------------------------------------------------------------------------

def _translate_key(key: str, out_depth: int):
    """TF scoped name -> reference state_dict key, or None to drop."""
    parts = key.lower().split("/")
    head = parts[0]

    if head == "g_mapping":
        # g_mapping/dense{i}/{weight,bias}
        return "g_mapping.map." + ".".join(parts[1:])

    if head == "g_synthesis":
        rest = parts[1:]
        if rest[0].startswith("noise"):
            return None  # per-layer noise input placeholders
        if rest[0].startswith("torgb_lod"):
            if rest[0] != "torgb_lod0":
                return None  # lower-lod RGB heads are unused at full res
            return f"g_synthesis.to_rgb.{out_depth}." + ".".join(rest[1:])
        if rest[0] == "4x4":
            block = "g_synthesis.init_block"
            body = rest[1:]
        else:
            res = int(rest[0].split("x")[0])
            block = f"g_synthesis.blocks.{int(math.log2(res)) - 3}"
            body = rest[1:]
        name = ".".join(body)
        # epilogue routing (reference convert.py:44-52)
        repl = {
            "const.const": "const",
            "const.bias": "bias",
            "const.noise.weight": "epi1.top_epi.noise.weight",
            "const.stylemod.weight": "epi1.style_mod.lin.weight",
            "const.stylemod.bias": "epi1.style_mod.lin.bias",
            "conv.noise.weight": "epi2.top_epi.noise.weight",
            "conv.stylemod.weight": "epi2.style_mod.lin.weight",
            "conv.stylemod.bias": "epi2.style_mod.lin.bias",
            "conv0_up.noise.weight": "epi1.top_epi.noise.weight",
            "conv0_up.stylemod.weight": "epi1.style_mod.lin.weight",
            "conv0_up.stylemod.bias": "epi1.style_mod.lin.bias",
            "conv1.noise.weight": "epi2.top_epi.noise.weight",
            "conv1.stylemod.weight": "epi2.style_mod.lin.weight",
            "conv1.stylemod.bias": "epi2.style_mod.lin.bias",
        }
        name = repl.get(name, name)
        return f"{block}.{name}"

    if head == "dlatent_avg":
        return "truncation.avg_latent"
    if head == "lod":
        return None
    return None


def _translate_value(torch_key: str, value: np.ndarray) -> np.ndarray:
    """TF layout -> torch layout for the translated key."""
    v = np.asarray(value, dtype=np.float32)
    if torch_key.endswith(".weight"):
        if v.ndim == 2:      # dense: TF (in,out) -> torch (out,in)
            return v.T
        if v.ndim == 4:      # conv: TF HWIO -> torch OIHW
            return np.transpose(v, (3, 2, 0, 1))
    if torch_key.endswith("init_block.const"):
        return v             # TF const already (1, C, 4, 4)
    return v


def tf_vars_to_state_dict(tf_vars: Dict[str, np.ndarray],
                          out_depth: int) -> Dict[str, np.ndarray]:
    """Translate a scoped TF var dict into a reference-style state_dict."""
    out = {}
    for key, value in tf_vars.items():
        tk = _translate_key(key, out_depth)
        if tk is None:
            continue
        out[tk] = _translate_value(tk, value)
    return out


def import_official_generator(pkl_path: str, generator, out_depth: int,
                              use_averaged: bool = True, report=print):
    """Load an official pickle into `generator` (the port's ``Generator``),
    in place, and return it.

    use_averaged: use Gs (the EMA generator, what the reference converts).
    Prints a shape diff report like reference convert.py:123-135, then
    loads as a reference ``.pth``: a key the pickle lacks keeps the
    generator's value, a shape mismatch raises.
    """
    from .convert import load_reference_partial
    nets = load_tf_networks(pkl_path)
    net = nets[2] if (use_averaged and len(nets) >= 3) else nets[0]
    tf_vars = collect_variables(net)
    state_dict = tf_vars_to_state_dict(tf_vars, out_depth)

    ours = {k: tuple(v.shape) for k, v in generator.state_dict().items()}
    theirs = {k: v.shape for k, v in state_dict.items()}
    for k in sorted(set(ours) | set(theirs)):
        if k not in theirs:
            report(f"sd only {k} {ours[k]}")
        elif k not in ours:
            report(f"pd only {k} {theirs[k]}")
        elif ours[k] != theirs[k]:
            report(f"mismatch! {k} {theirs[k]} {ours[k]}")

    return load_reference_partial(
        generator, {k: np.ascontiguousarray(v) for k, v in state_dict.items()})
