"""The frozen counts equal the program's own at the cells' shapes."""

import pytest
import torch

from gpubench import counts
from gpubench.cells import load_cell
from gpubench.conftest import BENCH
from stylegan_torch.ops.kernels import epilogue
from stylegan_torch.utils import flops

import json

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
ARCHS = {c["name"]: load_cell(next(w["name"] for w in SPEC["workloads"]
                                   if w["config"] == c["name"])).config[
    "architecture"] for c in SPEC["configs"]}


def _kw(arch):
    return dict(latent_size=arch["latent_size"],
                dlatent_size=arch["dlatent_size"],
                mapping_layers=arch["mapping_layers"],
                mapping_fmaps=arch["mapping_fmaps"],
                num_channels=arch["num_channels"],
                fmap_base=arch["fmap_base"], fmap_decay=arch["fmap_decay"],
                fmap_max=arch["fmap_max"])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_flops_equal_the_programs(name):
    a = ARCHS[name]
    kw = _kw(a)
    assert counts.g_forward(a)[0] == flops.generator_forward_flops(
        a["resolution"], **kw)
    dkw = {k: kw[k] for k in ("num_channels", "fmap_base", "fmap_decay",
                              "fmap_max")}
    assert counts.d_forward(a)[0] == flops.discriminator_forward_flops(
        a["resolution"], mbstd_num_features=a["mbstd_num_features"], **dkw)
    for r1 in (True, False):
        assert counts.train_image(a, r1)[0] == flops.train_step_flops(
            a["resolution"], loss="logistic", with_r1=r1, **kw)
    g, gc = counts.g_forward(a)
    assert 0.9 * g < gc < g          # the dense layers are a sliver


def _planes(arch):
    for i in range(2 * (int.bit_length(arch["resolution"]) - 2)):
        res = 2 ** (i // 2 + 2)
        stage = max(1, i // 2 + 1)
        yield res, min(int(arch["fmap_base"] / 2 ** stage), arch["fmap_max"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 2, 8])
def test_epilogue_bytes_equal_the_programs(dtype, batch):
    es = torch.empty((), dtype=dtype).element_size()
    for res, c in _planes(ARCHS["ffhq1024-f32"]):
        x = torch.empty((batch, res, res, c), dtype=dtype, device="meta")
        shape = tuple(x.shape)
        for op, fn in (("stylegan_torch::epilogue", epilogue.bytes_moved),
                       ("stylegan_torch::epilogue_backward",
                        epilogue.bytes_moved_backward),
                       ("stylegan_torch::epilogue_partial",
                        epilogue.bytes_moved_partial),
                       ("stylegan_torch::epilogue_apply",
                        epilogue.bytes_moved_apply),
                       ("stylegan_torch::epilogue_backward_partial",
                        epilogue.bytes_moved_backward_partial),
                       ("stylegan_torch::epilogue_backward_apply",
                        epilogue.bytes_moved_backward_apply)):
            assert counts.epilogue_bytes(op, shape, es) == fn(x)
        assert counts.epilogue_bytes("stylegan_torch::epilogue_train", shape,
                                     es) == epilogue.bytes_moved(x) \
            + 8 * batch * c


def test_peaks_are_the_datasheets():
    p = counts.peaks("NVIDIA H100 80GB HBM3")
    assert p == {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
                 "hbm": 3.35e12}
    assert flops.peak_tflops_for("NVIDIA H100 80GB HBM3", "bfloat16") \
        == pytest.approx(p["bfloat16"] / 1e12, rel=1e-3)
    assert counts.peaks("NVIDIA A100-SXM4-80GB") is None
