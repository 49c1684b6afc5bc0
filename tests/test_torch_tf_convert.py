"""The port's TF-pickle import (stylegan_torch/tf_pickle.py) and its convert
CLI against the JAX package's: a synthetic official-format pickle (built as
tests/test_tf_convert.py builds one) imported by both, every translated
tensor bitwise equal and the shape report identical; the restricted
unpickler; the CLI's .npz with its metadata, and --export_pth for G and D
against the JAX package's reference state_dicts.

Configuration: the yaml schema at 16^2 (512 channels, 2 mapping layers)."""

import os
import pickle
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from stylegan_tpu.config import get_default_cfg as jax_default_cfg
from stylegan_tpu.convert import (discriminator_state_dict_from_params,
                                  generator_state_dict_from_params)
from stylegan_tpu.convert import tf_pickle as jtf
from stylegan_tpu.io.checkpoint import load_params, save_params
from stylegan_tpu.models import discriminator_config_from_cfg as jax_dis_cfg
from stylegan_tpu.models import discriminator_init, generator_init
from stylegan_tpu.models import generator_config_from_cfg as jax_gen_cfg
from stylegan_torch import tf_pickle
from stylegan_torch.cli import convert as cli_convert
from stylegan_torch.config import get_default_cfg
from stylegan_torch.convert import flat_from_state_dict
from stylegan_torch.models import Generator, generator_config_from_cfg
from test_tf_convert import _install_fake_dnnlib, build_fake_pickle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """Weights files take tens of MB: gone once the test has read them."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_tf_convert")
    cfg_path = tmp / "toy.yaml"
    cfg_path.write_text(f"""
structure: 'linear'
model:
  gen:
    mapping_layers: 2
dataset:
  resolution: {RES}
""")
    jopt, topt = jax_default_cfg(), get_default_cfg()
    for o in (jopt, topt):
        o.merge_from_file(str(cfg_path))
    jc = jax_gen_cfg(jopt)
    out_depth = jc.synthesis.depth - 1
    params = generator_init(jax.random.PRNGKey(0), jc)
    pkl = build_fake_pickle(tmp, params, out_depth)
    yield types.SimpleNamespace(tmp=tmp, cfg=str(cfg_path), jopt=jopt,
                                jc=jc, tc=generator_config_from_cfg(topt),
                                out_depth=out_depth, params=params, pkl=pkl)
    shutil.rmtree(tmp, ignore_errors=True)


def _translated(path, out_depth):
    nets = jtf.load_tf_networks(path)
    return set(jtf.tf_vars_to_state_dict(jtf.collect_variables(nets[2]),
                                         out_depth))


@pytest.mark.parametrize("use_averaged", [True, False],
                         ids=["Gs", "G_current"])
def test_import_matches_jax(toy, use_averaged):
    jmsgs, tmsgs = [], []
    want = jtf.import_official_generator(
        toy.pkl, generator_init(jax.random.PRNGKey(1), toy.jc),
        toy.out_depth, use_averaged=use_averaged, report=jmsgs.append)
    gen = Generator(toy.tc, generator=torch.Generator().manual_seed(1))
    init = {k: v.clone() for k, v in gen.state_dict().items()}
    got = tf_pickle.import_official_generator(
        toy.pkl, gen, toy.out_depth, use_averaged=use_averaged,
        report=tmsgs.append)
    assert got is gen
    assert tmsgs == jmsgs
    want_sd = generator_state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, want))
    translated = _translated(toy.pkl, toy.out_depth)
    assert len(translated) > 20
    sd = gen.state_dict()
    for k in sd:
        if use_averaged and k in translated:
            assert np.array_equal(sd[k].numpy(), want_sd[k]), k
        else:   # not in the pickle (or G is empty): the module's value
            assert torch.equal(sd[k], init[k]), k
    if use_averaged:
        assert all(m.startswith("sd only g_synthesis.to_rgb.")
                   for m in tmsgs)


def test_pickle_shape_mismatch_raises_in_both(toy, tmp_path):
    """A pickle of another model's widths: JAX asserts, the port raises,
    both naming the key."""
    nets = tf_pickle.load_tf_networks(toy.pkl)
    gs = nets[2]
    name = "Dense0/weight"
    mapping = gs.components["mapping"]
    mapping.variables = [(n, np.concatenate([v, v[:1]]) if n == name else v)
                         for n, v in mapping.variables]
    Network = _install_fake_dnnlib()
    bad = Network(gs.name, gs.variables, {
        k: Network(c.name, c.variables) for k, c in gs.components.items()})
    path = str(tmp_path / "bad.pkl")
    with open(path, "wb") as f:
        pickle.dump((bad, bad, bad), f)
    with pytest.raises(AssertionError, match="g_mapping.map.dense0.weight"):
        jtf.import_official_generator(
            path, generator_init(jax.random.PRNGKey(1), toy.jc),
            toy.out_depth, report=lambda m: None)
    with pytest.raises(ValueError, match="g_mapping.map.dense0.weight"):
        tf_pickle.import_official_generator(path, Generator(toy.tc),
                                            toy.out_depth,
                                            report=lambda m: None)


def test_unpickler_refuses_arbitrary_globals(tmp_path):
    path = str(tmp_path / "evil.pkl")
    with open(path, "wb") as f:
        pickle.dump({"f": print}, f)
    with pytest.raises(pickle.UnpicklingError, match="builtins.print"):
        tf_pickle.load_tf_networks(path)


def test_translation_equals_jax(toy):
    nets = tf_pickle.load_tf_networks(toy.pkl)
    jnets = jtf.load_tf_networks(toy.pkl)
    for net, jnet in zip(nets, jnets):
        got = tf_pickle.collect_variables(net)
        want = jtf.collect_variables(jnet)
        assert got.keys() == want.keys()
        got = tf_pickle.tf_vars_to_state_dict(got, toy.out_depth)
        want = jtf.tf_vars_to_state_dict(want, toy.out_depth)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k


# --------------------------------------------------------------------------
# python -m stylegan_torch.cli.convert

def _run(args, ok=True):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", "stylegan_torch.cli.convert"]
                       + args, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    if ok:
        assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    return r


def test_convert_cli_writes_the_jax_npz(toy):
    out = str(toy.tmp / "converted.npz")
    _run(["--config", toy.cfg, "--input_file", toy.pkl, "--output_file", out,
          "--device", "cpu"])
    flat, meta = load_params(out)
    assert meta == {"source": os.path.basename(toy.pkl), "resolution": RES}
    want = jtf.import_official_generator(
        toy.pkl, generator_init(jax.random.PRNGKey(0), toy.jc),
        toy.out_depth, report=lambda m: None)
    want_sd = generator_state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, want))
    translated = _translated(toy.pkl, toy.out_depth)
    gen = Generator(toy.tc)
    gen.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                         want_sd.items()})
    want_flat = flat_from_state_dict(gen.state_dict())
    assert set(flat) == set(want_flat)
    checked = 0
    for path, v in flat.items():
        key = path.replace(".noise.weight", ".top_epi.noise.weight")
        if key in translated:
            assert np.array_equal(v, want_flat[path]), path
            checked += 1
    assert checked == len(translated & set(want_sd))


@pytest.mark.parametrize("network", ["gen", "dis"])
def test_convert_cli_export_pth(toy, network):
    """--export_pth of a JAX-package .npz gives the JAX package's reference
    state_dict, blur buffers included, bitwise."""
    if network == "gen":
        params = generator_init(jax.random.PRNGKey(2), toy.jc)
        want = generator_state_dict_from_params(
            params, blur_filter=toy.jc.synthesis.blur_filter)
    else:
        dc = jax_dis_cfg(toy.jopt)
        params = discriminator_init(jax.random.PRNGKey(2), dc)
        want = discriminator_state_dict_from_params(
            params, blur_filter=dc.blur_filter or (1, 2, 1))
    npz = str(toy.tmp / f"{network}.npz")
    save_params(npz, params)
    pth = str(toy.tmp / f"{network}.pth")
    _run(["--config", toy.cfg, "--export_pth", "--input_file", npz,
          "--output_file", pth, "--network", network, "--device", "cpu"])
    got = torch.load(pth, map_location="cpu", weights_only=True)
    assert set(got) == set(want)
    assert any(k.endswith(("intermediate.kernel", "blur.kernel"))
               for k in got)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k


def test_convert_cli_refuses_missing_cuda(toy, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli_convert.parse_arguments(
        ["--config", toy.cfg, "--input_file", toy.pkl, "--output_file",
         str(toy.tmp / "never.npz")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_convert.main(args)
    assert not (toy.tmp / "never.npz").exists()
