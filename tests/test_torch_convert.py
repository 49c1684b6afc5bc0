"""The weight bridge (stylegan_torch/convert.py) and the configuration copy
(stylegan_torch/config.py, models/configs.py) against the JAX package."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import jax

from stylegan_tpu.config import get_default_cfg as jax_default_cfg
from stylegan_tpu.convert import generator_state_dict_from_params
from stylegan_tpu.io.checkpoint import flatten_tree, load_params, save_params
from stylegan_tpu.models import GeneratorConfig as JaxGeneratorConfig
from stylegan_tpu.models import MappingConfig as JaxMappingConfig
from stylegan_tpu.models import SynthesisConfig as JaxSynthesisConfig
from stylegan_tpu.models import generator_config_from_cfg as jax_gen_cfg
from stylegan_tpu.models import generator_init
from stylegan_torch.config import get_default_cfg
from stylegan_torch.convert import (flat_from_state_dict, flatten_params,
                                    generator_state_dict_from_jax_params,
                                    load_generator_file, save_generator_file)
from stylegan_torch.models import Generator, generator_config_from_cfg
from stylegan_torch.models import configs as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 32
LAYOUT_ONLY = {"packed", "fold_blur", "remat"}   # JAX-only TPU layout knobs
# the port's own StyleGAN2 and StyleGAN3 keys and fields (no JAX
# counterpart), at their defaults (StyleGAN1's, and StyleGAN3-T's widths,
# which no other architecture reads)
PORT_ONLY_KEYS = {"model.gen.architecture": "stylegan1",
                  "model.gen.fmap_base": 8192,
                  "model.gen.channel_base": 32768,
                  "model.gen.channel_max": 512}
PORT_ONLY_FIELDS = {"architecture": "stylegan1", "gain_after_act": False}


def _cfgs(conditional=False, const_input=True):
    n_layers = (RES.bit_length() - 2) * 2
    lat = 32 * (2 if conditional else 1)

    def build(gc, mc, sc):
        return gc(resolution=RES, latent_size=32, dlatent_size=32,
                  conditional=conditional, n_classes=4 if conditional else 0,
                  mapping=mc(latent_size=lat, dlatent_size=32,
                             mapping_fmaps=32, mapping_layers=2,
                             dlatent_broadcast=n_layers),
                  synthesis=sc(resolution=RES, dlatent_size=32, fmap_base=128,
                               fmap_max=32, blur_filter=(1, 2, 1),
                               const_input_layer=const_input))
    return (build(JaxGeneratorConfig, JaxMappingConfig, JaxSynthesisConfig),
            build(tcfg.GeneratorConfig, tcfg.MappingConfig,
                  tcfg.SynthesisConfig))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _assert_loaded(gen, params):
    """gen's weights equal the JAX tree's, bitwise, through the bridge."""
    want = generator_state_dict_from_jax_params(_np_tree(params))
    got = gen.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("conditional,const_input",
                         [(False, True), (True, True), (False, False)],
                         ids=["const", "conditional", "dense_input"])
def test_jax_params_roundtrip_bitwise(conditional, const_input):
    jc, tc = _cfgs(conditional, const_input)
    params = _np_tree(generator_init(jax.random.PRNGKey(0), jc))
    sd = generator_state_dict_from_jax_params(params)
    gen = Generator(tc)
    gen.load_state_dict(sd, strict=True)        # names and shapes line up
    back = flat_from_state_dict(gen.state_dict())
    flat = flatten_params(params)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    # the reference's names and layouts, as the JAX package exports them
    ref = generator_state_dict_from_params(params)
    assert set(ref) == set(sd)
    for k, v in ref.items():
        assert np.array_equal(sd[k].numpy(), v), k


def test_load_jax_npz(tmp_path):
    jc, tc = _cfgs()
    params = generator_init(jax.random.PRNGKey(1), jc)
    path = str(tmp_path / "gen.npz")
    save_params(path, params, metadata={"depth": 3})
    gen = load_generator_file(Generator(tc), path)
    _assert_loaded(gen, params)


def test_load_reference_pth_ignores_blur_buffers(tmp_path):
    jc, tc = _cfgs()
    params = _np_tree(generator_init(jax.random.PRNGKey(2), jc))
    sd = generator_state_dict_from_params(params, blur_filter=(1, 2, 1))
    assert any(k.endswith("intermediate.kernel") for k in sd)
    path = str(tmp_path / "gen.pth")
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in sd.items()}, path)
    gen = load_generator_file(Generator(tc), path)
    _assert_loaded(gen, params)


def test_saved_npz_loads_in_the_jax_package(tmp_path):
    jc, tc = _cfgs(conditional=True)
    gen = Generator(tc, generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "port.npz")
    save_generator_file(gen, path)
    flat, _ = load_params(path)
    template = flatten_tree(generator_init(jax.random.PRNGKey(0), jc))
    assert set(flat) == set(template)
    for k, v in flat.items():
        assert v.shape == template[k].shape, k
    again = load_generator_file(Generator(tc), path)
    for k, v in gen.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_default_cfg_schema_matches_jax():
    def flat(node, prefix=""):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = v
        return out
    mine, theirs = flat(get_default_cfg()), flat(jax_default_cfg())
    assert set(mine) == set(theirs) | set(PORT_ONLY_KEYS)
    assert {k: mine[k] for k in PORT_ONLY_KEYS} == PORT_ONLY_KEYS
    assert {k for k in theirs if mine[k] != theirs[k]} == {"device"}


YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_yaml_gives_the_jax_generator_config(path):
    cfgs = []
    for default in (get_default_cfg, jax_default_cfg):
        c = default()
        c.merge_from_file(path)
        c.freeze()
        cfgs.append(c)
    mine, theirs = generator_config_from_cfg(cfgs[0]), jax_gen_cfg(cfgs[1])
    for name in ("mapping", "synthesis", None):
        m = getattr(mine, name) if name else mine
        t = getattr(theirs, name) if name else theirs
        fields = {f.name for f in dataclasses.fields(m)} - {"mapping",
                                                           "synthesis"}
        assert {f.name for f in dataclasses.fields(t)} - fields \
            - {"mapping", "synthesis"} <= LAYOUT_ONLY
        for f in fields - set(PORT_ONLY_FIELDS):
            assert getattr(m, f) == getattr(t, f), (name, f)
        for f in fields & set(PORT_ONLY_FIELDS):
            assert getattr(m, f) == PORT_ONLY_FIELDS[f], (name, f)
