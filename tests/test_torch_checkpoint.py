"""Checkpoints across the two packages: the port's partial loads, its
optimizer, param and full-state files against the JAX package's, and the
reference's Adam ``.pth`` loaded into both.

Every comparison is bitwise after the layout maps (dotted JAX paths and JAX
layouts on one side, the port's state_dicts and torch layouts on the
other)."""

import os
import re
import shutil
import sys
import warnings

import numpy as np
import pytest
import torch

import jax

from stylegan_tpu.convert import load_discriminator_file as jax_load_d
from stylegan_tpu.convert import load_generator_file as jax_load_g
from stylegan_tpu.convert.torch_optim import \
    discriminator_param_order as jax_d_order
from stylegan_tpu.convert.torch_optim import \
    generator_param_order as jax_g_order
from stylegan_tpu.convert.torch_params import (_discriminator_entries,
                                               _generator_entries,
                                               _to_torch_layout)
from stylegan_tpu.io import checkpoint as jckpt
from stylegan_tpu.models import configs as jcfg
from stylegan_tpu.models import discriminator_init, generator_init
from stylegan_tpu.train import StyleGAN as JaxStyleGAN
from stylegan_torch.convert import (flat_from_state_dict, flatten_params,
                                    load_discriminator_file,
                                    load_generator_file, state_dict_from_flat)
from stylegan_torch.io import checkpoint as ckpt
from stylegan_torch.io.reference_optim import (discriminator_param_order,
                                               generator_param_order)
from stylegan_torch.models import Discriminator, Generator
from stylegan_torch.models import configs as tcfg
from stylegan_torch.train import StyleGAN

RES = 8
G_ARGS = {"latent_size": 32, "mapping_layers": 2, "blur_filter": [1, 2, 1],
          "truncation_psi": 0.7, "truncation_cutoff": 8}
D_ARGS = {"use_wscale": True, "blur_filter": [1, 2, 1]}
OPT = {"learning_rate": 0.003, "beta_1": 0.0, "beta_2": 0.99, "eps": 1e-8}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """Checkpoints of the 512-channel networks take hundreds of MB: gone
    once the test has read them."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _trainers(conditional=False, **kw):
    args = dict(structure="linear", resolution=RES, num_channels=3,
                latent_size=32, g_args=G_ARGS, d_args=D_ARGS, g_opt_args=OPT,
                d_opt_args=OPT, conditional=conditional,
                n_classes=3 if conditional else 0, loss="logistic",
                use_ema=True, seed=0, **kw)
    return JaxStyleGAN(**args), StyleGAN(device="cpu", **args)


def _flat(tree):
    return {k: np.asarray(v) for k, v in jckpt.flatten_tree(tree).items()}


def _assert_flat_equal(got: dict, want: dict, skip=()):
    keys = {k for k in want if not any(s in k for s in skip)}
    assert keys <= set(got), sorted(keys - set(got))[:5]
    for k in keys:
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def _port_flat(t: StyleGAN) -> dict:
    """The port trainer's state, flattened as the JAX TrainState is."""
    s = t.state
    parts = {
        "g_params": flat_from_state_dict(s.generator.state_dict()),
        "d_params": flat_from_state_dict(s.discriminator.state_dict()),
        "g_opt_state": ckpt.optimizer_flat(s.g_optimizer, s.generator),
        "d_opt_state": ckpt.optimizer_flat(s.d_optimizer, s.discriminator),
        "g_shadow": flat_from_state_dict(s.g_shadow.state_dict())}
    return {f"{p}.{k}": v for p, sub in parts.items() for k, v in sub.items()}


def _trained_port(t: StyleGAN):
    """One update, so that the moments and the step count are not zero."""
    rs = np.random.RandomState(3)
    t.train_on_batch(rs.randn(4, RES, RES, 3).astype(np.float32), depth=1,
                     alpha=0.5)
    return t


def _randomized_jax(t: JaxStyleGAN, count=5):
    """Random moments, a step count and a shadow that differs from G, so
    that no value survives a load by chance."""
    rs = np.random.RandomState(4)

    def rnd(x):
        x = np.asarray(x)
        if x.dtype.kind == "i":
            return jax.numpy.asarray(count, x.dtype)
        return jax.numpy.asarray(rs.rand(*x.shape).astype(x.dtype))
    shadow = jax.tree_util.tree_map(
        lambda x: x + 0.25 * rs.randn(*np.shape(x)).astype(np.float32),
        t.state.g_shadow)
    t.state = t.state._replace(
        g_opt_state=jax.tree_util.tree_map(rnd, t.state.g_opt_state),
        d_opt_state=jax.tree_util.tree_map(rnd, t.state.d_opt_state),
        g_shadow=shadow)
    return t


# --------------------------------------------------------------------------
# the partial load

def _narrow_configs(res):
    """Widths that change with depth (fmap_base 128, fmap_max 32), so that a
    shallow file both misses keys and mismatches shapes of a deep model."""
    def build(m):
        n_layers = (res.bit_length() - 2) * 2
        g = m.GeneratorConfig(
            resolution=res, latent_size=32, dlatent_size=32,
            mapping=m.MappingConfig(latent_size=32, dlatent_size=32,
                                    mapping_fmaps=32, mapping_layers=2,
                                    dlatent_broadcast=n_layers),
            synthesis=m.SynthesisConfig(resolution=res, dlatent_size=32,
                                        fmap_base=128, fmap_max=32,
                                        blur_filter=(1, 2, 1)))
        d = m.DiscriminatorConfig(resolution=res, fmap_base=128, fmap_max=32,
                                  blur_filter=(1, 2, 1))
        return g, d
    return build(jcfg), build(tcfg)


def _kept(caught) -> int:
    """The count a partial load's shape-mismatch warning names."""
    for w in caught:
        m = re.search(r"kept (\d+) initialized", str(w.message))
        if m:
            return int(m.group(1))
    return 0


@pytest.mark.parametrize("network", ["generator", "discriminator"])
def test_partial_load_shallow_into_deep_equals_jax(tmp_path, network):
    """A 2-depth .npz into a 4-depth network on both sides (the reference's
    --start_depth resume): keys the file lacks keep the deep model's values,
    mismatched shapes keep them and warn with the same count, and every
    tensor ends equal to JAX's.  (The port loaded strictly before, and
    raised on the missing keys.)"""
    (jg8, jd8), _ = _narrow_configs(8)
    (jg32, jd32), (tg32, td32) = _narrow_configs(32)
    if network == "generator":
        init, jload, tload, module = (generator_init, jax_load_g,
                                      load_generator_file, Generator(tg32))
        shallow_cfg, deep_cfg = jg8, jg32
    else:
        init, jload, tload, module = (discriminator_init, jax_load_d,
                                      load_discriminator_file,
                                      Discriminator(td32))
        shallow_cfg, deep_cfg = jd8, jd32
    shallow = init(jax.random.PRNGKey(1), shallow_cfg)
    path = str(tmp_path / "shallow.npz")
    jckpt.save_params(path, shallow, {"depth": 1, "epoch": 1})
    deep = jax.tree_util.tree_map(np.asarray,
                                  init(jax.random.PRNGKey(2), deep_cfg))
    module.load_state_dict(state_dict_from_flat(flatten_params(deep)),
                           strict=True)

    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = _flat(jload(deep, path))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tload(module, path)
    got = flat_from_state_dict(module.state_dict())
    assert set(got) == set(want)
    _assert_flat_equal(got, want)
    assert _kept(jw) == _kept(tw)
    if network == "discriminator":
        assert _kept(tw) > 0       # the 8^2 D's widths differ at 32^2
    # something was loaded, and something kept
    loaded = flatten_params(jax.tree_util.tree_map(np.asarray, shallow))
    assert any(np.array_equal(got[k], v) for k, v in loaded.items()
               if k in got and got[k].shape == v.shape)
    assert any(k not in loaded for k in got)

    with pytest.raises(RuntimeError, match="Missing key"):
        tload(module, path, strict=True)


@pytest.mark.parametrize("network", ["generator", "discriminator"])
def test_pth_shape_mismatch_raises_as_in_jax(tmp_path, network):
    """A reference .pth whose tensor has another shape than the module's
    raises in both packages and names the key (JAX asserts in
    torch_params._load_entries); a key the .pth lacks keeps the module's
    value, as the reference's load_state_dict(strict=False) resume does.
    (The port kept the module's value and warned, as for a .npz.)"""
    from stylegan_tpu.convert import (discriminator_state_dict_from_params,
                                      generator_state_dict_from_params)
    (jg, jd), (tg, td) = _narrow_configs(8)
    if network == "generator":
        params = jax.tree_util.tree_map(
            np.asarray, generator_init(jax.random.PRNGKey(1), jg))
        sd = generator_state_dict_from_params(params, blur_filter=(1, 2, 1))
        bad, dropped = "g_mapping.map.dense0.weight", "g_synthesis.to_rgb.1.bias"
        module, tload, jload = Generator(tg), load_generator_file, jax_load_g
    else:
        params = jax.tree_util.tree_map(
            np.asarray, discriminator_init(jax.random.PRNGKey(1), jd))
        sd = discriminator_state_dict_from_params(params)
        bad, dropped = "blocks.0.conv0.weight", "final_block.dense1.bias"
        module, tload, jload = (Discriminator(td), load_discriminator_file,
                                jax_load_d)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    good = str(tmp_path / "good.pth")
    torch.save({k: v for k, v in sd.items() if k != dropped}, good)
    before = module.state_dict()[dropped].clone()
    tload(module, good)
    assert torch.equal(module.state_dict()[dropped], before)
    loaded = module.state_dict()[bad]
    assert torch.equal(loaded, sd[bad])

    w = sd[bad]
    sd[bad] = torch.cat([w, w[:, :1]], dim=1)     # one column / channel more
    path = str(tmp_path / "bad.pth")
    torch.save(sd, path)
    shapes = rf"\({', '.join(map(str, sd[bad].shape))}\)"
    with pytest.raises(ValueError, match=rf"{re.escape(bad)}: file {shapes}"):
        tload(module, path)
    assert torch.equal(module.state_dict()[bad], loaded)   # nothing loaded
    with pytest.raises(AssertionError, match=re.escape(bad)):
        jload(params, path)


# --------------------------------------------------------------------------
# the five files of a tag, and the full state

def test_port_checkpoints_load_in_jax_trainer(tmp_path):
    jt, pt = _trainers()
    _trained_port(pt)
    pt.save_checkpoints(str(tmp_path), depth=1, epoch=1)
    models = tmp_path / "models"
    assert sorted(os.listdir(models)) == sorted(
        f"GAN_{k}_1_1.npz" for k in ("GEN", "DIS", "GEN_OPTIM", "DIS_OPTIM",
                                     "GEN_SHADOW"))
    jt.load_generator(str(models / "GAN_GEN_1_1.npz"))
    jt.load_discriminator(str(models / "GAN_DIS_1_1.npz"))
    jt.load_gen_shadow(str(models / "GAN_GEN_SHADOW_1_1.npz"))
    jt.load_gen_optim(str(models / "GAN_GEN_OPTIM_1_1.npz"))
    jt.load_dis_optim(str(models / "GAN_DIS_OPTIM_1_1.npz"))
    want = _port_flat(pt)
    got = _flat(jt.state._asdict())
    assert set(got) == set(want)
    _assert_flat_equal(got, want)
    assert int(got["g_opt_state.1.0.count"]) == 1
    assert np.abs(got["d_opt_state.0.nu.blocks.0.conv0.weight"]).max() > 0
    with np.load(models / "GAN_GEN_1_1.npz") as z:
        assert "__metadata__" in z.files


def test_jax_checkpoints_load_in_port_trainer(tmp_path):
    jt, pt = _trainers()
    _randomized_jax(jt, count=5)
    jt.save_checkpoints(str(tmp_path), depth=1, epoch=2)
    models = tmp_path / "models"
    pt.load_generator(str(models / "GAN_GEN_1_2.npz"))
    pt.load_discriminator(str(models / "GAN_DIS_1_2.npz"))
    pt.load_gen_shadow(str(models / "GAN_GEN_SHADOW_1_2.npz"))
    pt.load_gen_optim(str(models / "GAN_GEN_OPTIM_1_2.npz"))
    pt.load_dis_optim(str(models / "GAN_DIS_OPTIM_1_2.npz"))
    # the W-average is a buffer in the port: its moments are not kept
    _assert_flat_equal(_port_flat(pt), _flat(jt.state._asdict()),
                       skip=("mu.truncation", "nu.truncation"))
    steps = {float(st["step"]) for st in pt.state.g_optimizer.state.values()}
    assert steps == {5.0}


def test_full_state_port_to_jax(tmp_path):
    jt, pt = _trainers()
    _trained_port(pt)
    path = str(tmp_path / "full")
    pt.save_full_state(path, depth=1, epoch=3)
    assert os.path.exists(path + ".npz")
    meta = jt.restore_full_state(path)
    assert meta == {"depth": 1, "epoch": 3, "update_count": 1}
    assert jt._update_count == 1
    want = _port_flat(pt)
    got = _flat(jt.state._asdict())
    assert set(got) == set(want)
    _assert_flat_equal(got, want)


def test_full_state_jax_to_port(tmp_path):
    jt, pt = _trainers()
    _randomized_jax(jt, count=9)
    path = str(tmp_path / "full")
    jckpt.save_train_state(path, jt.state, {"depth": 1, "epoch": 2,
                                            "update_count": 9},
                           use_orbax=False)
    meta = pt.restore_full_state(path)
    assert meta["update_count"] == 9 and pt._update_count == 9
    _assert_flat_equal(_port_flat(pt), _flat(jt.state._asdict()),
                       skip=("mu.truncation", "nu.truncation"))
    # and the restored port trainer trains on
    d, g = pt.train_on_batch(np.zeros((4, RES, RES, 3), np.float32), depth=1,
                             alpha=1.0)
    assert np.isfinite(d) and np.isfinite(g)


def test_full_state_jax_orbax_to_port(tmp_path):
    """A JAX trainer's save_full_state writes an orbax directory wherever
    orbax imports; the port reads it through tensorstore, bitwise, and the
    restored trainer steps.  (The port raised on any directory.)"""
    pytest.importorskip("orbax.checkpoint")
    pytest.importorskip("tensorstore")
    jt, pt = _trainers()
    _randomized_jax(jt, count=7)
    jt._update_count = 7
    path = str(tmp_path / "orbax_state")
    jt.save_full_state(path, depth=1, epoch=4)
    assert os.path.isdir(path)
    meta = pt.restore_full_state(path)
    assert meta == {"depth": 1, "epoch": 4, "update_count": 7}
    assert pt._update_count == 7
    want = _flat(jt.state._asdict())
    got = _port_flat(pt)
    _assert_flat_equal(got, want, skip=("mu.truncation", "nu.truncation"))
    assert int(got["g_opt_state.1.0.count"]) == 7
    steps = {float(st["step"]) for st in pt.state.d_optimizer.state.values()}
    assert steps == {7.0}
    d, g = pt.train_on_batch(np.zeros((4, RES, RES, 3), np.float32), depth=1,
                             alpha=1.0)
    assert np.isfinite(d) and np.isfinite(g)


def test_orbax_directory_without_tensorstore_raises(tmp_path, monkeypatch):
    """Without tensorstore the port cannot read the directory, and says
    so."""
    jt, pt = _trainers()
    path = str(tmp_path / "orbax_state")
    jt.save_full_state(path, depth=1, epoch=1)
    assert os.path.isdir(path)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ValueError,
                       match=r"tensorstore is not installed.*use_orbax=False"):
        pt.restore_full_state(path)


def test_unequal_steps_warn_on_save(tmp_path):
    _, pt = _trainers()
    _trained_port(pt)
    opt = pt.state.d_optimizer
    first = next(iter(opt.state.values()))
    first["step"] = first["step"] + 3
    with pytest.warns(UserWarning, match="steps differ"):
        ckpt.save_optimizer_file(str(tmp_path / "d.npz"), opt,
                                 pt.state.discriminator)
    with np.load(tmp_path / "d.npz") as z:
        assert int(z["0.count"]) == 4


# --------------------------------------------------------------------------
# the reference's Adam .pth

@pytest.mark.parametrize("conditional", [False, True],
                         ids=["unconditional", "conditional"])
def test_reference_param_order_equals_jax(conditional):
    """The index -> name maps of the port and of the JAX package agree, and
    differ from the port's own registration order where the trap is."""
    jt, pt = _trainers(conditional)
    g_order = generator_param_order(pt.state.generator)
    d_order = discriminator_param_order(pt.state.discriminator)
    assert g_order == jax_g_order(jt.state.g_params)
    assert d_order == jax_d_order(jt.state.d_params)
    assert d_order != [n for n, _ in
                       pt.state.discriminator.named_parameters()]
    if conditional:
        assert g_order[0] == "class_embedding.weight"
        assert g_order != [n for n, _ in pt.state.generator.named_parameters()]


def _reference_adam_pth(path, params, entries, order, step):
    """A torch Adam state_dict as the reference writes it: index i is the
    i-th name of `order` (the JAX package's, the oracle), moments in torch
    layout, distinct per tensor."""
    rs = np.random.RandomState(11)
    state = {}
    for i, name in enumerate(order):
        kind, arr = entries[name]
        shape = _to_torch_layout(kind, np.asarray(arr)).shape
        state[i] = {"step": torch.tensor(float(step)),
                    "exp_avg": torch.from_numpy(
                        rs.randn(*shape).astype(np.float32)),
                    "exp_avg_sq": torch.from_numpy(
                        rs.rand(*shape).astype(np.float32))}
    torch.save({"state": state,
                "param_groups": [{"lr": 0.003, "betas": (0.0, 0.99),
                                  "eps": 1e-8, "weight_decay": 0,
                                  "amsgrad": False,
                                  "params": list(range(len(order)))}]},
               path)


@pytest.mark.parametrize("conditional", [False, True],
                         ids=["unconditional", "conditional"])
@pytest.mark.parametrize("network", ["generator", "discriminator"])
def test_reference_adam_pth_gives_equal_moments(tmp_path, network,
                                                conditional):
    jt, pt = _trainers(conditional)
    path = str(tmp_path / "optim.pth")
    if network == "generator":
        params = jt.state.g_params
        _reference_adam_pth(path, params, _generator_entries(params),
                            jax_g_order(params), step=7)
        jt.load_gen_optim(path)
        pt.load_gen_optim(path)
        want = _flat(jt.state.g_opt_state)
        got = ckpt.optimizer_flat(pt.state.g_optimizer, pt.state.generator)
    else:
        params = jt.state.d_params
        _reference_adam_pth(path, params, _discriminator_entries(params),
                            jax_d_order(params), step=7)
        jt.load_dis_optim(path)
        pt.load_dis_optim(path)
        want = _flat(jt.state.d_opt_state)
        got = ckpt.optimizer_flat(pt.state.d_optimizer,
                                  pt.state.discriminator)
    assert set(got) == set(want)
    _assert_flat_equal(got, want)
    assert int(next(v for k, v in got.items() if k.endswith("count"))) == 7
