"""Configuration system (the port's copy of ``stylegan_tpu/config.py``).

A minimal, dependency-free re-implementation of the yacs ``CfgNode`` contract
used by the reference (reference: config.py:10-92, train.py:51-54): a nested
attribute-style node supporting ``merge_from_file`` (YAML overlay, unknown keys
are errors), ``merge_from_list`` and ``freeze``.  The key schema is the same as
the JAX package's, so every ``configs/*.yaml`` loads unchanged.

The TPU execution-layout knobs (``ops.use_pallas``, ``ops.packed``,
``ops.fold_blur``, ``ops.remat``, ``ops.fuse_scores``, ``ops.reuse_g_fwd``)
are accepted as keys and have no effect on the port's math: packing and
blur folding are the same math in another TPU layout, and the port always
runs its CUDA epilogue kernel on the card.
"""

from __future__ import annotations

import copy
import yaml


class ConfigNode(dict):
    """yacs-compatible config node: dict with attribute access + freeze."""

    _FROZEN = "__frozen__"

    def __init__(self, init_dict=None):
        super().__init__()
        object.__setattr__(self, ConfigNode._FROZEN, False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name} on a frozen ConfigNode")
        self[name] = value

    def __setitem__(self, key, value):
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {key} on a frozen ConfigNode")
        super().__setitem__(key, value)

    # -- freeze --------------------------------------------------------------
    def freeze(self):
        object.__setattr__(self, ConfigNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()

    def defrost(self):
        object.__setattr__(self, ConfigNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()

    def is_frozen(self):
        return getattr(self, ConfigNode._FROZEN)

    def clone(self):
        node = ConfigNode()
        for k, v in self.items():
            node[k] = v.clone() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return node

    # -- merging ---------------------------------------------------------------
    def merge_from_file(self, filename):
        with open(filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        self._merge_dict(loaded, path="")

    def merge_from_other_cfg(self, other):
        self._merge_dict(other, path="")

    def merge_from_list(self, opts):
        assert len(opts) % 2 == 0, "Override list must be key, value pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            if isinstance(value, str):
                value = _decode_value(value)
            node[leaf] = _coerce(value, node[leaf], key)

    def _merge_dict(self, d, path):
        for k, v in d.items():
            full = f"{path}.{k}" if path else k
            if k not in self:
                raise KeyError(f"Non-existent config key: {full}")
            cur = self[k]
            if isinstance(cur, ConfigNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot overwrite config section {full} "
                                    f"with a value of type {type(v)}")
                cur._merge_dict(v, full)
            else:
                self[k] = _coerce(v, cur, full)

    # -- misc -----------------------------------------------------------------
    def dump(self):
        def plain(node):
            return {k: plain(v) if isinstance(v, ConfigNode) else v
                    for k, v in node.items()}
        return yaml.safe_dump(plain(self), sort_keys=False)

    def __str__(self):
        return self.dump()


def _decode_value(s):
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def _coerce(value, existing, key):
    """Light type checking mirroring yacs (int->float promotion allowed)."""
    if existing is None or value is None:
        return value
    if isinstance(existing, float) and isinstance(value, int):
        return float(value)
    if isinstance(value, bool) and isinstance(existing, str):
        # tri-state knobs like ops.use_pallas default to 'auto' but accept
        # true/false in YAML — keep the bool
        return value
    if isinstance(existing, bool) != isinstance(value, bool) and (
            isinstance(existing, bool) or isinstance(value, bool)):
        raise TypeError(f"Type mismatch for key {key}: "
                        f"{type(value)} vs {type(existing)}")
    if isinstance(existing, (int, float)) and isinstance(value, (int, float)):
        return value
    if type(value) is not type(existing) and not (
            isinstance(value, (list, tuple)) and isinstance(existing, (list, tuple))):
        # the reference yamls use strings like "('3')" for device_id; accept
        # any scalar where a string default exists
        if isinstance(existing, str):
            return str(value)
        raise TypeError(f"Type mismatch for key {key}: "
                        f"{type(value)} vs {type(existing)}")
    return value


def get_default_cfg() -> ConfigNode:
    """Default config — key schema mirrors reference config.py:12-92."""
    c = ConfigNode()

    c.output_dir = ""
    c.device = "cuda"         # reference default (config.py:15); CLIs take --device
    c.device_id = "0"

    c.structure = "fixed"
    c.conditional = False
    c.n_classes = 0
    # registry name (losses.py): reference names plus the beyond-reference
    # conditional variants ('conditional-relativistic-hinge',
    # 'conditional-logistic' — the reference's only conditional objective
    # is plain BCE 'conditional-loss')
    c.loss = "logistic"
    c.drift = 0.001
    c.d_repeats = 1
    c.use_ema = True
    c.ema_decay = 0.999

    c.num_works = 4           # (sic) reference key name, config.py:27
    c.num_samples = 36
    c.feedback_factor = 10
    c.checkpoint_factor = 10

    # scheduler (reference config.py:35-42); lists indexed by depth
    c.sched = ConfigNode()
    c.sched.epochs = [4, 4, 4, 4, 8, 16, 32, 64, 64]
    c.sched.batch_sizes = [128, 128, 128, 64, 32, 16, 8, 4, 2]
    c.sched.fade_in_percentage = [50, 50, 50, 50, 50, 50, 50, 50, 50]

    # dataset (reference config.py:51-55)
    c.dataset = ConfigNode()
    c.dataset.img_dir = ""
    c.dataset.folder = True
    c.dataset.resolution = 128
    c.dataset.channels = 3

    c.model = ConfigNode()

    # generator (reference config.py:61-67)
    c.model.gen = ConfigNode()
    c.model.gen.latent_size = 512
    c.model.gen.mapping_layers = 4      # 8 in paper; yaml presets override
    c.model.gen.blur_filter = [1, 2, 1]
    c.model.gen.truncation_psi = 0.7
    c.model.gen.truncation_cutoff = 8

    # discriminator (reference config.py:72-74)
    c.model.dis = ConfigNode()
    c.model.dis.use_wscale = True
    c.model.dis.blur_filter = [1, 2, 1]

    # optimizers (reference config.py:79-92)
    c.model.g_optim = ConfigNode()
    c.model.g_optim.learning_rate = 0.003
    c.model.g_optim.beta_1 = 0.0
    c.model.g_optim.beta_2 = 0.99
    c.model.g_optim.eps = 1e-8

    c.model.d_optim = ConfigNode()
    c.model.d_optim.learning_rate = 0.003
    c.model.d_optim.beta_1 = 0.0
    c.model.d_optim.beta_2 = 0.99
    c.model.d_optim.eps = 1e-8

    # ---- keys of the JAX package (not present in reference yamls) ---------
    c.seed = 0
    c.precision = ConfigNode()
    # 'float32' | 'bfloat16': the activations' dtype in G and D (reals and
    # latents enter the step in it); parameters, optimizer state and the EMA
    # stay float32 (precision.params), weights cast at apply time
    c.precision.activations = "float32"
    c.precision.params = "float32"
    c.parallel = ConfigNode()
    c.parallel.data_axis = "auto"
    c.parallel.spatial = 0
    # TPU execution-layout knobs: accepted, no effect on the port's math
    c.ops = ConfigNode()
    c.ops.use_pallas = "auto"              # 'auto' | True | False
    c.ops.packed = "auto"                  # 'auto' | True | False
    c.ops.fold_blur = "auto"               # 'auto' | True | False | 'all'
    c.ops.remat = False
    c.ops.fuse_scores = "auto"
    c.ops.reuse_g_fwd = False
    # training keys (read by the trainer slice of the port)
    c.r1_interval = 1
    c.r1_gamma = 10.0
    c.r1_separate_reg = False
    c.mbstd_scope = "auto"

    return c


def resolve_packed(cfg) -> bool:
    """Resolve the `ops.packed` knob as the JAX package does: an explicit
    bool wins; 'auto' is on with bf16 activations.  Packed is a TPU layout
    of the same math: the port computes unpacked whatever this says and
    only reports the flag."""
    try:
        p = cfg.ops.packed
        if isinstance(p, bool):
            return p
        return cfg.precision.activations == "bfloat16"
    except AttributeError:
        return False


def resolve_fuse_scores(cfg) -> bool:
    """Resolve the `ops.fuse_scores` knob: an explicit bool wins; 'auto'
    turns on the fused real/fake D scoring (the same math) with bf16
    activations, as in the JAX package.  The step still skips it where an
    in-loss R1 pass runs (train/steps.py)."""
    try:
        f = cfg.ops.fuse_scores
        if isinstance(f, bool):
            return f
        return cfg.precision.activations == "bfloat16"
    except AttributeError:
        return False


def apply_runtime_knobs(cfg):
    """Apply the process-wide numerics policy of a merged config: float32
    activations compute in full float32 (TF32 off); bfloat16 activations
    (the networks carry them, models/ and train/trainer.py) allow TF32 for
    what still runs in float32, as the JAX package's set_precision
    ("default") on that key does."""
    from .ops.precision import set_precision
    set_precision("default" if cfg.precision.activations == "bfloat16"
                  else "highest")
