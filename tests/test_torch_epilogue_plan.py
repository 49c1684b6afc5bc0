"""The epilogue kernel's launch plan (stylegan_torch/csrc/epilogue_plan.h),
compiled with the host C++ compiler into a small shared library and checked
on the CPU: the kernels themselves run only on the card (chip_smoke.py), but
the plan decides which rows and channels each block covers, how much shared
memory it asks for and how large the workspace is.  The plan must cover
every row and channel exactly once, fit the H100's per-block shared memory,
use portable cluster sizes, and size the workspace that the wrapper
allocates."""

import ctypes
import itertools
import shutil
import subprocess

import pytest
import torch

from stylegan_torch.ops.kernels import epilogue as kern

MAX_SMEM = 232448          # bytes of shared memory one block may use on sm_90
MAX_CLUSTER = 8            # the portable cluster size
MIN_BLOCKS = 128           # one-pass grids hold about one block per SM
BATCH = 8
# the 9 stages of a 1024^2 forward (resolution, channels), as chip_smoke.py
MAIN_SHAPES = [(4, 512), (8, 512), (16, 512), (32, 512), (64, 256),
               (128, 128), (256, 64), (512, 32), (1024, 16)]
# chip_smoke.py's ragged shapes (B, H, W, C, offset of x in elements)
RAGGED_SHAPES = [(3, 7, 9, 17, 0), (2, 5, 1, 20, 0), (2, 33, 31, 48, 1)]


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    cxx = next((c for c in ("g++", "c++", "clang++") if shutil.which(c)), None)
    if cxx is None:
        pytest.skip("no host C++ compiler to build epilogue_plan.h")
    d = tmp_path_factory.mktemp("epilogue_plan")
    shim = d / "shim.cc"
    shim.write_text('#include "epilogue_plan.h"\n')
    so = d / "libplan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-Wall", "-Wextra", "-Werror",
                    "-shared", "-fPIC", "-I", str(kern.SOURCE.parent),
                    "-o", str(so), str(shim)], check=True, capture_output=True)
    return kern.bind(ctypes.CDLL(str(so)))


def _align16(n):
    return (n + 15) // 16 * 16


def _pow2(n):
    return n > 0 and n & (n - 1) == 0


def check_plan(p, b, rows, c, bf16, aligned, launches=2):
    elem = 2 if bf16 else 4
    vec = (8 if bf16 else 4) if c % (8 if bf16 else 4) == 0 and aligned else 1
    assert p.vec == vec
    # channels: chunks of chunk_c cover [0, C) once; lanes past C are masked
    assert _pow2(p.tx) and p.tx <= 32 and _pow2(p.ty)
    assert p.tx * p.ty <= 256
    assert p.chunk_c == p.tx * p.vec
    assert (p.chunks - 1) * p.chunk_c < c <= p.chunks * p.chunk_c
    assert p.chunks <= 65535
    if p.path == 1:
        # rows: the cluster's ranks split [0, R) into non-empty runs
        assert p.cluster in (1, 2) and p.cluster <= MAX_CLUSTER
        assert (p.cluster - 1) * p.rows_per_rank < rows
        assert rows <= p.cluster * p.rows_per_rank
        # the slab, its noise column, the merge's buffers and the cluster's
        # exchange fit the shared memory the block asks for, and that fits
        need = (p.rows_per_rank * p.chunk_c * elem + p.rows_per_rank * elem
                + p.ty * p.chunk_c * 4 + p.chunk_c * 8)
        assert need <= p.smem_bytes <= MAX_SMEM
        assert p.ty >= min(p.rows_per_rank, 256 // p.tx)
        assert p.launches == 1 and p.workspace_bytes == 0
        assert p.chunks * p.cluster <= 2 ** 31 - 1
    else:
        assert p.path == 2 and p.cluster == 1
        assert p.tx * p.ty == 256
        # pass 1: splits cover [0, R) once, each a whole number of row groups
        assert p.rows_per_split % p.ty == 0
        assert (p.splits - 1) * p.rows_per_split < rows
        assert rows <= p.splits * p.rows_per_split
        # pass 2: blocks of rows_per_block rows
        assert p.rows_per_block >= p.ty
        # the last block's merge gives each channel 256 // chunk_c threads
        assert 256 % p.chunk_c == 0
        assert b <= 65535
        assert p.launches == launches
        # partials, stats, tickets
        assert p.stats_offset == _align16(b * p.splits * c * 8)
        assert p.tickets_offset == p.stats_offset + _align16(b * c * 8)
        assert p.workspace_bytes == (p.tickets_offset
                                     + _align16(b * p.chunks * 4))


def plan(lib, bf16, b, rows, c, aligned=1):
    return kern.make_plan(lib, bf16, b, rows, c, aligned)


@pytest.mark.parametrize("bf16", [0, 1], ids=["f32", "bf16"])
@pytest.mark.parametrize("res,c", MAIN_SHAPES,
                         ids=[f"{r}x{r}x{c}" for r, c in MAIN_SHAPES])
def test_main_path_plans(plan_lib, res, c, bf16):
    """The 18 epilogue calls of a batch-8 1024^2 forward: planes up to
    64^2 x 256 stay on chip in one launch with about a block per SM, in
    clusters of at most 2; the larger ones take two passes in two
    launches."""
    p = plan(plan_lib, bf16, BATCH, res * res, c)
    check_plan(p, BATCH, res * res, c, bf16, 1)
    if res <= 64:
        assert p.path == 1 and p.launches == 1
        assert BATCH * p.chunks * p.cluster >= MIN_BLOCKS
        assert p.cluster <= 2
    else:
        assert p.path == 2 and p.launches == 2


@pytest.mark.parametrize("bf16", [0, 1], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", RAGGED_SHAPES,
                         ids=["x".join(map(str, s)) for s in RAGGED_SHAPES])
def test_ragged_plans(plan_lib, shape, bf16):
    b, h, w, c, offset = shape
    aligned = int(offset * (2 if bf16 else 4) % 16 == 0)
    p = plan(plan_lib, bf16, b, h * w, c, aligned)
    check_plan(p, b, h * w, c, bf16, aligned)
    if c % (8 if bf16 else 4) or not aligned:
        assert p.vec == 1


# the slabs the split entries take on a 1024^2 forward split over n ranks:
# (res / n rows of res, channels) for every stage of res >= 4n
SPLIT_SLABS = [(n, res, c) for n in (2, 4) for res, c in MAIN_SHAPES
               if res >= 4 * n]


@pytest.mark.parametrize("bf16", [0, 1], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, BATCH], ids=["b1", f"b{BATCH}"])
@pytest.mark.parametrize("n,res,c", SPLIT_SLABS,
                         ids=[f"{r}x{r}x{c}_over{n}"
                              for n, r, c in SPLIT_SLABS])
def test_split_plans(plan_lib, n, res, c, batch, bf16):
    """K1-partial and K2-apply (a plane whose rows lie on n ranks) take the
    two-pass geometry on every slab, the small ones too: one code path, one
    launch per entry, splits covering the slab's rows once."""
    rows = res // n * res
    p = kern.make_split_plan(plan_lib, bf16, batch, rows, c, 1)
    assert p.path == 2 and p.launches == 1
    check_plan(p, batch, rows, c, bf16, 1, launches=1)


@pytest.mark.parametrize("bf16", [0, 1], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", RAGGED_SHAPES,
                         ids=["x".join(map(str, s)) for s in RAGGED_SHAPES])
def test_split_plans_ragged(plan_lib, shape, bf16):
    b, h, w, c, offset = shape
    aligned = int(offset * (2 if bf16 else 4) % 16 == 0)
    p = kern.make_split_plan(plan_lib, bf16, b, h * w, c, aligned)
    check_plan(p, b, h * w, c, bf16, aligned, launches=1)
    with pytest.raises(ValueError, match="no split epilogue plan"):
        kern.make_split_plan(plan_lib, bf16, 0, h * w, c, aligned)


SWEEP_B = [1, 2, 3, 8]
SWEEP_R = [1, 2, 7, 16, 63, 64, 100, 1000, 1024, 4095, 4096, 16384, 16385,
           65536, 100003, 262144, 2 ** 20]
SWEEP_C = [1, 3, 4, 8, 16, 17, 20, 32, 48, 64, 100, 128, 256, 384, 512]


@pytest.mark.parametrize("aligned", [1, 0], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("bf16", [0, 1], ids=["f32", "bf16"])
def test_plan_sweep(plan_lib, bf16, aligned):
    """Every (B <= 8, H*W <= 2^20, C <= 512) of the sweep has a plan that
    covers it, in both dtypes, aligned or not."""
    paths = set()
    for b, rows, c in itertools.product(SWEEP_B, SWEEP_R, SWEEP_C):
        p = plan(plan_lib, bf16, b, rows, c, aligned)
        check_plan(p, b, rows, c, bf16, aligned)
        paths.add((p.path, p.cluster))
    assert {1, 2} <= {path for path, _ in paths}
    assert {cl for path, cl in paths if path == 1} == {1, 2}


@pytest.mark.parametrize("dims", [(0, 16, 16), (1, 0, 16), (1, 16, 0)])
def test_empty_calls_refused(plan_lib, dims):
    b, rows, c = dims
    with pytest.raises(ValueError, match="no epilogue plan"):
        plan(plan_lib, 0, b, rows, c)


class _Recorder:
    """The kernel library with the plan from the host-compiled header and the
    launch recorded instead of run."""

    def __init__(self, lib):
        self.lib = lib
        self.forward_calls = []

    def sgt_epilogue_plan(self, *args):
        return self.lib.sgt_epilogue_plan(*args)

    def sgt_epilogue_forward(self, *args):
        self.forward_calls.append(args)
        return 0


@pytest.mark.parametrize("res,c", [(4, 512), (64, 256), (1024, 16)],
                         ids=["4x4x512", "64x64x256", "1024x1024x16"])
def test_wrapper_allocates_the_plans_workspace(plan_lib, monkeypatch, res, c):
    rec = _Recorder(plan_lib)
    monkeypatch.setattr(kern, "_library", lambda: rec)
    monkeypatch.setattr(kern, "_stream", lambda device: 7)
    monkeypatch.setattr(kern, "_capturing", lambda: False)
    monkeypatch.setattr(kern, "_plans", {})
    monkeypatch.setattr(kern, "_workspaces", {})
    b = 2
    x = torch.zeros((b, res, res, c))
    out = torch.empty_like(x)
    nw, noise, style = torch.zeros(c), torch.zeros((b, res, res, 1)), \
        torch.zeros((b, 2 * c))
    kern._launch(x, nw, noise, style, out)
    p = plan(plan_lib, 0, b, res * res, c)
    (args,) = rec.forward_calls
    if p.path == 1:    # one pass needs no workspace
        assert kern._workspaces == {} and args[5:7] == (0, 0)
    else:
        ws, = kern._workspaces.values()
        assert args[5] == ws.data_ptr() and args[6] == ws.numel()
        assert ws.numel() == p.workspace_bytes
        assert bool((ws[p.tickets_offset:] == 0).all())
    # the launch is handed the cached plan, equal to a fresh one
    (cached,) = kern._plans.values()
    assert args[11] is cached and cached.as_dict() == p.as_dict()


# ---------------------------------------------------------------- backward --

def check_bwd_plan(p, b, rows, c, bf16, aligned, want_dn):
    """The backward's plan.  Both paths: chunks cover every channel once;
    the last block's fixed-order merges give each channel tx * ty // chunk_c
    >= 1 threads; the workspace holds the pass-1 partials and coefficients
    (path 2 only), the dnoise_weight and (when summed over chunks) dnoise
    partials, and the tickets, in that order.  Path 1: one launch of
    (chunks * cluster, B) blocks whose slabs of g and x, noise column and
    buffers fit the shared memory the block asks for; the cluster's ranks
    are the row splits and cover every row once.  Path 2: two launches of
    the grid (splits, chunks, B) of 256-thread blocks."""
    elem = 2 if bf16 else 4
    vec = (8 if bf16 else 4) if c % (8 if bf16 else 4) == 0 and aligned else 1
    assert p.vec == vec
    assert _pow2(p.tx) and p.tx <= 32 and _pow2(p.ty)
    assert p.chunk_c == p.tx * p.vec and p.chunk_c * elem <= 128
    assert (p.chunks - 1) * p.chunk_c < c <= p.chunks * p.chunk_c
    assert p.chunks <= 65535 and b <= 65535
    assert (p.tx * p.ty) % p.chunk_c == 0 and p.ty >= p.vec
    assert (p.splits - 1) * p.rows_per_split < rows <= p.splits * \
        p.rows_per_split
    if p.path == 1:
        assert p.cluster in (1, 2) and p.splits == p.cluster
        assert p.tx * p.ty <= 256 and p.launches == 1
        assert p.ty >= min(p.rows_per_split, 256 // p.tx)
        # g and x slabs, their noise column, the reduction buffer and the
        # cluster's exchange
        need = (2 * _align16(p.rows_per_split * p.chunk_c * elem)
                + _align16(p.rows_per_split * elem)
                + _align16(p.ty * p.chunk_c * 4) + p.chunk_c * 8)
        assert need <= p.smem_bytes <= MAX_SMEM
        assert p.chunks * p.cluster <= 2 ** 31 - 1
        parts = 0
    else:
        assert p.path == 2 and p.cluster == 1 and p.smem_bytes == 0
        assert p.tx * p.ty == 256 and 256 % p.chunk_c == 0
        assert p.rows_per_split % p.ty == 0
        assert p.launches == 2
        parts = _align16(b * p.splits * c * 8)
        assert p.dnw_offset == p.coef_offset + _align16(b * c * 16)
    assert p.dn_partials == int(bool(want_dn) and p.chunks > 1)
    assert p.coef_offset == parts
    assert p.dn_offset == p.dnw_offset + _align16(b * p.splits * c * 4)
    dn_bytes = _align16(p.chunks * b * rows * 4) if p.dn_partials else 0
    assert p.tickets_offset == p.dn_offset + dn_bytes
    assert p.workspace_bytes == p.tickets_offset + _align16(
        (b * p.chunks + p.chunks + b * p.splits) * 4)


def bwd_plan(lib, bf16, b, rows, c, aligned=1, want_dn=0):
    return kern.make_bwd_plan(lib, bf16, b, rows, c, aligned, want_dn)


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("bf16", [0, 1], ids=["f32", "bf16"])
@pytest.mark.parametrize("res,c", MAIN_SHAPES,
                         ids=[f"{r}x{r}x{c}" for r, c in MAIN_SHAPES])
def test_backward_main_path_plans(plan_lib, res, c, bf16, batch):
    """The 18 backward calls of a 1024^2 G step, at the training batch (2)
    and at the serving batch (8): planes up to 64^2 x 256 hold g and x on
    chip in one launch, in clusters of at most 2, with about a block per SM
    or chunks already at a 32-byte row; the larger ones take two passes of
    about 256 blocks (one wave of about two blocks per SM), at least 8 rows
    a thread."""
    for want_dn in (0, 1):
        p = bwd_plan(plan_lib, bf16, batch, res * res, c, want_dn=want_dn)
        check_bwd_plan(p, batch, res * res, c, bf16, 1, want_dn)
        if res <= 64:
            assert p.path == 1 and p.launches == 1 and p.cluster <= 2
            assert (batch * p.chunks * p.cluster >= MIN_BLOCKS
                    or p.chunk_c * (2 if bf16 else 4) == 32)
        else:
            assert p.path == 2 and p.launches == 2
            blocks = p.splits * p.chunks * batch
            assert blocks <= 512
            assert blocks >= 128 or p.rows_per_split == 8 * p.ty


@pytest.mark.parametrize("want_dn", [0, 1], ids=["no-dnoise", "dnoise"])
@pytest.mark.parametrize("aligned", [1, 0], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("bf16", [0, 1], ids=["f32", "bf16"])
def test_backward_plan_sweep(plan_lib, bf16, aligned, want_dn):
    """Every (B <= 8, H*W <= 2^20, C <= 512) of the sweep has a backward
    plan that covers it, and the sweep reaches both paths and both cluster
    sizes of path 1."""
    paths = set()
    for b, rows, c in itertools.product(SWEEP_B, SWEEP_R, SWEEP_C):
        p = bwd_plan(plan_lib, bf16, b, rows, c, aligned, want_dn)
        check_bwd_plan(p, b, rows, c, bf16, aligned, want_dn)
        paths.add((p.path, p.cluster))
    assert paths == {(1, 1), (1, 2), (2, 1)}


@pytest.mark.parametrize("dims", [(0, 16, 16), (1, 0, 16), (1, 16, 0)])
def test_backward_empty_calls_refused(plan_lib, dims):
    b, rows, c = dims
    with pytest.raises(ValueError, match="no epilogue backward plan"):
        bwd_plan(plan_lib, 0, b, rows, c)
