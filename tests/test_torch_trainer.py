"""The port's progressive trainer (stylegan_torch/train/trainer.py) on the
CPU at 16^2, held to the JAX package's StyleGAN where the two must agree:
the schedule (depths, alphas, batches, feedback points, grid names and
checkpoint tags) over the same data, the lazy-R1 step keys and the
full-state round trip; and the port's own behaviour: an end-to-end run, its
resume, `fixed` structure, the abort file, conditional steps, the windowed
throughput and G's remat."""

import dataclasses
import json
import logging
import os
import shutil
import time

import numpy as np
import pytest
import torch

from stylegan_tpu.data import SyntheticDataset as JaxSyntheticDataset
from stylegan_tpu.train import StyleGAN as JaxStyleGAN
from stylegan_torch.convert import flat_from_state_dict
from stylegan_torch.data import SyntheticDataset
from stylegan_torch.io import checkpoint as ckpt
from stylegan_torch.models import Generator
from stylegan_torch.models import configs as tcfg
from stylegan_torch.ops import fused
from stylegan_torch.train import StyleGAN
from stylegan_torch.train import trainer as trainer_mod

RES = 16
LOG = logging.getLogger("test_torch_trainer")


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


def _args(structure="linear", loss="relativistic-hinge", conditional=False,
          n_classes=0, use_ema=True, **kw):
    g_args = {"latent_size": 64, "mapping_layers": 2,
              "blur_filter": [1, 2, 1], "truncation_psi": 0.7,
              "truncation_cutoff": 8}
    d_args = {"use_wscale": True, "blur_filter": [1, 2, 1]}
    opt = {"learning_rate": 0.003, "beta_1": 0.0, "beta_2": 0.99, "eps": 1e-8}
    return dict(structure=structure, resolution=RES, num_channels=3,
                latent_size=64, g_args=g_args, d_args=d_args, g_opt_args=opt,
                d_opt_args=opt, conditional=conditional, n_classes=n_classes,
                loss=loss, use_ema=use_ema, seed=0, **kw)


def make_trainer(**kw):
    return StyleGAN(device="cpu", **_args(**kw))


def _train(t, out, dataset, epochs=(1, 1, 1), start_depth=0,
           feedback_factor=1, checkpoint_factor=1, batch=4):
    os.makedirs(out, exist_ok=True)
    t.train(dataset=dataset, num_workers=2, epochs=list(epochs),
            batch_sizes=[batch] * 3, fade_in_percentage=[50, 50, 50],
            logger=LOG, output=out, num_samples=4, start_depth=start_depth,
            feedback_factor=feedback_factor,
            checkpoint_factor=checkpoint_factor)


def _record(trainer, calls, tags, fake):
    """Wrap the trainer's step and checkpoint writer to record them; with
    `fake`, skip the work (the JAX side: no compile, no files)."""
    real_step = trainer.train_on_batch

    def step(images, depth, alpha, labels=None, fetch=True):
        calls.append((np.asarray(images).copy(), depth, float(alpha),
                      None if labels is None else np.asarray(labels)))
        if fake:
            return 0.0, 0.0
        return real_step(images, depth, alpha, labels, fetch=fetch)
    trainer.train_on_batch = step
    trainer.save_checkpoints = lambda out, depth, epoch, logger=None: \
        tags.append(f"{depth}_{epoch}")
    if fake:
        trainer.sample = lambda depth, alpha, z=None, labels=None, **_: \
            np.zeros((len(z), 2 ** (depth + 2), 2 ** (depth + 2), 3),
                     np.float32)


def test_schedule_equals_jax_trainer(tmp_path):
    """The same SyntheticDataset through both trainers' train(): every
    train_on_batch(images, depth, alpha, labels) in order with bitwise equal
    images, the same grid files, the same checkpoint tags.  The JAX side's
    step, sampler and writer are stubs (its loop is what is compared); the
    port's steps run."""
    runs = {}
    for name, cls, ds in (("jax", JaxStyleGAN, JaxSyntheticDataset),
                          ("port", StyleGAN, SyntheticDataset)):
        kw = {} if name == "jax" else {"device": "cpu"}
        t = cls(**_args(), **kw)
        calls, tags = [], []
        _record(t, calls, tags, fake=name == "jax")
        out = str(tmp_path / name)
        _train(t, out, ds(n=8, resolution=RES, random_flip=True),
               epochs=(1, 2, 1), feedback_factor=2, checkpoint_factor=2)
        runs[name] = (calls, tags, sorted(os.listdir(os.path.join(
            out, "samples"))))
    (jc, jt, js), (pc, pt, ps) = runs["jax"], runs["port"]
    assert len(pc) == len(jc) == 8
    for a, b in zip(pc, jc):
        assert a[1:] == b[1:]
        assert a[0].dtype == b[0].dtype and np.array_equal(a[0], b[0])
    assert [c[2] for c in pc][:4] == [1.0, 1.0, 0.5, 1.0]
    assert pt == jt == ["0_1", "1_1", "1_2", "2_1"]
    assert ps == js and len(ps) == 8


def test_progressive_run_and_resume(tmp_path):
    """A run over depths 1-2 writes grids, metrics and the five files per
    tag; a fresh trainer resumed from the last five equals the first, bitwise
    (G, D, shadow, both optimizers), and trains on.  (Depth 0 runs in the
    schedule test, whose checkpoint files are not written.)"""
    out = str(tmp_path / "run")
    t1 = make_trainer()
    _train(t1, out, SyntheticDataset(n=8, resolution=RES), start_depth=1,
           feedback_factor=2)
    samples = os.listdir(os.path.join(out, "samples"))
    assert {s.split("_")[1] for s in samples} == {"1", "2"}
    models = os.listdir(os.path.join(out, "models"))
    for stem in ["GAN_GEN_2_1", "GAN_DIS_2_1", "GAN_GEN_OPTIM_2_1",
                 "GAN_DIS_OPTIM_2_1", "GAN_GEN_SHADOW_2_1"]:
        assert f"{stem}.npz" in models, models
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert f.read().count("\n") == 4
    for p in t1.state.generator.parameters():
        assert torch.isfinite(p).all()

    t2 = make_trainer()
    t2._z.manual_seed(99)
    mdir = os.path.join(out, "models")
    t2.load_generator(os.path.join(mdir, "GAN_GEN_2_1.npz"))
    t2.load_discriminator(os.path.join(mdir, "GAN_DIS_2_1.npz"))
    t2.load_gen_shadow(os.path.join(mdir, "GAN_GEN_SHADOW_2_1.npz"))
    t2.load_gen_optim(os.path.join(mdir, "GAN_GEN_OPTIM_2_1.npz"))
    t2.load_dis_optim(os.path.join(mdir, "GAN_DIS_OPTIM_2_1.npz"))
    for part in ("generator", "discriminator", "g_shadow"):
        a = getattr(t1.state, part).state_dict()
        b = getattr(t2.state, part).state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), (part, k)
    for opt, mod in (("g_optimizer", "generator"),
                     ("d_optimizer", "discriminator")):
        a = ckpt.optimizer_flat(getattr(t1.state, opt),
                                getattr(t1.state, mod))
        b = ckpt.optimizer_flat(getattr(t2.state, opt),
                                getattr(t2.state, mod))
        for k in a:
            assert np.array_equal(a[k], b[k]), (opt, k)
    d, g = t2.train_on_batch(
        np.random.RandomState(0).randn(4, RES, RES, 3).astype(np.float32),
        depth=2, alpha=1.0)
    assert np.isfinite(d) and np.isfinite(g)


def test_full_state_round_trip_keeps_update_count(tmp_path):
    t = make_trainer(loss="logistic", r1_interval=2)
    imgs = np.random.RandomState(3).randn(4, RES, RES, 3).astype(np.float32)
    for _ in range(3):
        t.train_on_batch(imgs, depth=1, alpha=1.0)
    assert {k for k in t._steps} == {(1, 1, True), (1, 1, False)}
    path = str(tmp_path / "state")
    t.save_full_state(path, depth=1, epoch=2)
    fresh = make_trainer(loss="logistic", r1_interval=2)
    assert fresh._update_count == 0
    meta = fresh.restore_full_state(path)
    assert meta == {"depth": 1, "epoch": 2, "update_count": 3}
    assert fresh._update_count == t._update_count == 3
    a = flat_from_state_dict(t.state.discriminator.state_dict())
    b = flat_from_state_dict(fresh.state.discriminator.state_dict())
    assert all(np.array_equal(a[k], b[k]) for k in a)
    # the next update seeds its noise and style mixing alike in both
    seeds = []
    for trainer in (t, fresh):
        def spy(depth, with_r1, mesh=None, get_step=trainer._get_step):
            step = get_step(depth, with_r1, mesh)

            def run(state, reals, z, seed, *rest):
                seeds.append(seed)
                return step(state, reals, z, seed, *rest)
            return run
        trainer._get_step = spy
        trainer.train_on_batch(imgs, depth=1, alpha=1.0)
    assert seeds[0] == seeds[1]


def test_fixed_structure_trains_last_depth_only(tmp_path):
    out = str(tmp_path / "fixed")
    t = make_trainer(structure="fixed")
    _train(t, out, SyntheticDataset(n=4, resolution=RES))
    samples = os.listdir(os.path.join(out, "samples"))
    assert samples and all(s.startswith("gen_2_") for s in samples)


def test_abort_file_stops_training(tmp_path):
    out = str(tmp_path / "abort")
    os.makedirs(out)
    with open(os.path.join(out, "abort.txt"), "w") as f:
        f.write("stop")
    t = make_trainer()
    calls, tags = [], []
    _record(t, calls, tags, fake=False)
    _train(t, out, SyntheticDataset(n=4, resolution=RES), epochs=(5, 5, 5))
    samples = os.listdir(os.path.join(out, "samples"))
    assert samples and all(s.startswith("gen_0_1_") for s in samples)
    assert tags == ["0_1", "0_1"] and {c[1] for c in calls} == {0}


@pytest.mark.parametrize("loss", ["conditional-loss",
                                  "conditional-relativistic-hinge"])
def test_conditional_step(loss):
    t = make_trainer(loss=loss, conditional=True, n_classes=4)
    imgs = np.random.RandomState(1).randn(4, RES, RES, 3).astype(np.float32)
    labels = np.random.RandomState(2).randint(0, 4, size=4)
    d, g = t.train_on_batch(imgs, depth=1, alpha=0.5, labels=labels)
    assert np.isfinite(d) and np.isfinite(g)
    samples = t.sample(1, 0.5, num_samples=4, labels=labels)
    assert samples.shape == (4, 8, 8, 3) and np.isfinite(samples).all()


def test_lazy_r1_step_keys_equal_jax():
    """r1_interval 2: a regularized and an unregularized step per depth,
    under the keys the JAX trainer gives its programs; R1 on updates 0, 2,
    ...; non-logistic losses and interval 0 are refused."""
    t = make_trainer(loss="logistic", r1_interval=2)
    jt = JaxStyleGAN(**_args(loss="logistic", r1_interval=2))
    imgs = np.random.RandomState(3).randn(4, RES, RES, 3).astype(np.float32)
    seen = []
    real = t._get_step

    def get_step(depth, with_r1=True, mesh=None):
        seen.append(with_r1)
        return real(depth, with_r1, mesh)
    t._get_step = get_step
    for _ in range(3):
        d, g = t.train_on_batch(imgs, depth=1, alpha=1.0)
        assert np.isfinite(d) and np.isfinite(g)
    assert seen == [True, False, True]
    keys = {k for k in t._steps if isinstance(k, tuple) and len(k) == 3}
    jt._get_step(1, None, True)
    jt._get_step(1, None, False)
    assert keys == set(jt._steps) == {(1, 1, True), (1, 1, False)}
    with pytest.raises(ValueError):
        make_trainer(loss="hinge", r1_interval=4)
    with pytest.raises(ValueError):
        make_trainer(loss="logistic", r1_interval=0)


def test_separate_reg_corrects_d_adam_and_diverges():
    t_sep = make_trainer(loss="logistic", r1_interval=2, r1_separate_reg=True)
    t_fold = make_trainer(loss="logistic", r1_interval=2)
    group = t_sep.state.d_optimizer.param_groups[0]
    assert group["lr"] == pytest.approx(0.003 * 2 / 3)
    assert group["betas"][1] == pytest.approx(0.99 ** (2 / 3))
    imgs = np.random.RandomState(5).randn(4, RES, RES, 3).astype(np.float32)
    for _ in range(2):
        for t in (t_sep, t_fold):
            d, g = t.train_on_batch(imgs, depth=1, alpha=1.0)
            assert np.isfinite(d) and np.isfinite(g)
    diff = max(float((a - b).detach().abs().max()) for a, b in zip(
        t_sep.state.discriminator.parameters(),
        t_fold.state.discriminator.parameters()))
    assert diff > 1e-7
    with pytest.raises(ValueError):
        make_trainer(loss="hinge", r1_separate_reg=True)


def test_window_excludes_the_grid_write(tmp_path, monkeypatch):
    """The throughput window restarts after the feedback grid is written:
    a slow grid write does not show in the next window's step time."""
    slow = 0.4
    real_save = trainer_mod.save_image_grid

    def slow_save(*a, **kw):
        time.sleep(slow)
        real_save(*a, **kw)
    monkeypatch.setattr(trainer_mod, "save_image_grid", slow_save)
    t = make_trainer()
    zero = torch.zeros(())
    t.train_on_batch = lambda *a, **kw: (zero, zero)
    t.sample = lambda depth, alpha, z=None, labels=None, **_: np.zeros(
        (len(z), 4, 4, 3), np.float32)
    out = str(tmp_path / "window")
    t.save_checkpoints = lambda *a, **kw: None
    _train(t, out, SyntheticDataset(n=16, resolution=RES), epochs=(1, 1, 1),
           feedback_factor=4)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    timed = [r for r in rows if r["step_time"] is not None]
    assert len(timed) == 6
    assert all(r["step_time"] < slow / 4 for r in timed), timed


def test_train_on_batch_fetch_false_returns_tensors():
    t = make_trainer()
    imgs = np.random.RandomState(6).randn(4, RES, RES, 3).astype(np.float32)
    d, g = t.train_on_batch(torch.from_numpy(imgs), depth=0, alpha=1.0,
                            fetch=False)
    assert isinstance(d, torch.Tensor) and d.shape == () and d.device.type \
        == "cpu"
    assert torch.isfinite(d) and torch.isfinite(g)


def test_split_update_api():
    t = make_trainer()
    rs = np.random.RandomState(8)
    imgs = rs.randn(4, RES, RES, 3).astype(np.float32)
    z = rs.randn(4, 64).astype(np.float32)
    before = [p.clone() for p in t.state.discriminator.parameters()]
    d = t.optimize_discriminator(z, imgs, depth=1, alpha=0.5)
    g = t.optimize_generator(z, imgs, depth=1, alpha=0.5)
    assert isinstance(d, float) and np.isfinite(d) and np.isfinite(g)
    assert any(not torch.equal(a, b) for a, b in zip(
        before, t.state.discriminator.parameters()))


def test_sample_updates_the_shadow_average():
    t = make_trainer()
    before = t.state.g_shadow.truncation.avg_latent.clone()
    out = t.sample(2, 1.0, num_samples=2)
    assert out.shape == (2, RES, RES, 3) and out.dtype == np.float32
    assert not torch.equal(before, t.state.g_shadow.truncation.avg_latent)
    kept = t.state.g_shadow.truncation.avg_latent.clone()
    t.sample(2, 1.0, num_samples=2, update_shadow_avg=False)
    assert torch.equal(kept, t.state.g_shadow.truncation.avg_latent)


def _remat_generators():
    m = tcfg
    g = m.GeneratorConfig(
        resolution=16, latent_size=16, dlatent_size=16,
        mapping=m.MappingConfig(latent_size=16, dlatent_size=16,
                                mapping_fmaps=16, mapping_layers=2,
                                dlatent_broadcast=6),
        synthesis=m.SynthesisConfig(resolution=16, dlatent_size=16,
                                    fmap_base=64, fmap_max=16,
                                    blur_filter=(1, 2, 1)))
    plain = Generator(g, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():   # the noise term matters
        for name, p in plain.named_parameters():
            if name.endswith("noise.weight"):
                p.normal_(0.0, 0.3)
    re = Generator(dataclasses.replace(g, synthesis=dataclasses.replace(
        g.synthesis, remat=True)))
    re.load_state_dict(plain.state_dict())
    return plain, re


def test_generator_remat_gives_the_same_grads():
    """remat recomputes each synthesis block in the backward pass with the
    same noise maps (drawn outside the block from (seed, layer)): the same
    gradients, and the blocks' epilogues run once more each."""
    plain, re = _remat_generators()
    z = torch.from_numpy(np.random.RandomState(0).randn(3, 16).astype(
        np.float32))
    cot = torch.from_numpy(np.random.RandomState(1).randn(3, 16, 16, 3)
                           .astype(np.float32))
    grads, calls = [], []
    for g in (plain, re):
        g.zero_grad()
        fused.plain_calls = 0
        out = g(z, depth=2, alpha=0.5, seed=7, train=True).images
        (out * cot).sum().backward()
        calls.append(fused.plain_calls)
        grads.append({n: p.grad for n, p in g.named_parameters()})
    for n, want in grads[0].items():
        if want is None:      # a to_rgb the depth does not use
            assert grads[1][n] is None, n
        else:
            assert torch.equal(grads[1][n], want), n
    # 2 blocks recomputed, 2 epilogues each
    assert calls[1] - calls[0] == 4


def test_remat_blocks_reaches_both_networks():
    t = make_trainer(remat_blocks=True)
    assert t.gen_cfg.synthesis.remat and t.dis_cfg.remat
    imgs = np.random.RandomState(9).randn(4, RES, RES, 3).astype(np.float32)
    d, g = t.train_on_batch(imgs, depth=1, alpha=0.5)
    assert np.isfinite(d) and np.isfinite(g)


@pytest.mark.parametrize("kw", [{"spatial_devices": 2}],
                         ids=["spatial_devices"])
def test_unported_options_raise(kw):
    """Nothing is refused any more: spatial_devices in one process (one
    device, no world) trains the one-process step, as the JAX trainer does
    with one device, bitwise equal to a trainer without it."""
    imgs = np.random.RandomState(9).randn(2, RES, RES, 3).astype(np.float32)
    results = []
    for t in (make_trainer(max_devices=2, **kw), make_trainer()):
        assert t._mesh_for_step(2, 2) is None
        results.append(t.train_on_batch(imgs, depth=2, alpha=0.5))
        assert [k[1] for k in t._steps] == [1]
    assert results[0] == results[1] and all(np.isfinite(results[0]))


@pytest.mark.parametrize("case", ["mesh", "max_devices"])
def test_data_parallel_options_in_one_process(case):
    """The data-parallel options are ported (tests/test_torch_parallel.py
    runs them on two ranks).  In one process: `mesh` must be a
    parallel.Mesh; max_devices=2 trains alone where the stddev cap leaves
    one device (batch 4, group 4), and where the batch asks for a second
    rank (batch 8) it raises, as JAX's create_mesh asserts on one device."""
    if case == "mesh":
        with pytest.raises(TypeError, match="parallel.Mesh"):
            make_trainer(mesh=object())
        return
    t = make_trainer(max_devices=2)
    rs = np.random.RandomState(9)
    d, g = t.train_on_batch(rs.randn(4, RES, RES, 3).astype(np.float32),
                            depth=1, alpha=0.5)
    assert np.isfinite(d) and np.isfinite(g)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        t.train_on_batch(rs.randn(8, RES, RES, 3).astype(np.float32),
                         depth=1, alpha=0.5)


def test_accepted_layout_options_give_the_same_init():
    """packed_layout and fold_blur are the JAX package's TPU layouts of the
    same math: accepted, nothing changes."""
    a = make_trainer()
    b = make_trainer(packed_layout=True, fold_blur="all",
                     activations_dtype="bfloat16", mbstd_scope="global")
    for x, y in zip(a.state.generator.state_dict().values(),
                    b.state.generator.state_dict().values()):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        make_trainer(activations_dtype="float16")


def test_cuda_default_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StyleGAN(**_args())


def test_full_state_without_ema(tmp_path):
    """use_ema off: the state file has no shadow, and restores all else."""
    t = make_trainer(use_ema=False)
    assert t.state.g_shadow is None
    imgs = np.random.RandomState(4).randn(4, RES, RES, 3).astype(np.float32)
    t.train_on_batch(imgs, depth=1, alpha=1.0)
    path = str(tmp_path / "no_ema")
    t.save_full_state(path, depth=1, epoch=1)
    with np.load(path + ".npz") as z:
        assert not any(k.startswith("g_shadow.") for k in z.files)
    fresh = make_trainer(use_ema=False)
    fresh.restore_full_state(path)
    for a, b in zip(t.state.generator.parameters(),
                    fresh.state.generator.parameters()):
        assert torch.equal(a, b)
