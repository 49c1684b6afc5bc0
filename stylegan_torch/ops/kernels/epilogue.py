"""CUDA kernel: fused synthesis-layer epilogue (the port's counterpart of
``stylegan_tpu/ops/pallas/epilogue.py``).

    y   = leaky_relu(x + noise_weight[c] * noise, 0.2)
    out = (y - mean_hw(y)) * rsqrt(var_hw(y) + 1e-5) * (s0 + 1) + s1

The kernels are ``stylegan_torch/csrc/epilogue.cu`` (see its header for the
design and what bounds it); the plan of a call (path, block shape, chunks,
cluster, splits, shared memory, workspace) is ``csrc/epilogue_plan.h``.
Both are compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use, cached under ``build/stylegan_torch/`` by a
hash of the sources, and called through ``ctypes`` on PyTorch's current
stream: one call per epilogue, handed the plan.  The plan is made once per
(dtype, B, H*W, C, 16-byte alignment of x and out).  Its workspace, whose
ticket counters the kernels leave at zero, is made once per plan, device and
stream for eager calls; a call made while the stream is captured into a CUDA
graph takes a workspace of its own from the graph's memory pool, so that a
graph never shares counters with eager calls or with other graphs.

The backward (`epilogue_backward`) takes one launch (path 1) or two (path 2)
of the same library, planned by ``sgt_epilogue_bwd_plan`` per (dtype, B,
H*W, C, alignment, whether dnoise is wanted), with workspaces kept the same
way; it reads the per-(b, c) (mean, rstd) that the forward saved.  It
replaces the JAX custom VJP's backward, which is XLA autodiff of the plain
composition.

The kernels reach PyTorch as ``torch.library`` custom ops, each with a
fake (meta) implementation that checks shapes and dtypes as the launch does
and returns outputs of the real shapes, so that ``torch.export`` traces
them as nodes of their own and an exported program launches them on the
card:

* ``stylegan_torch::epilogue`` (x, noise_weight, noise, style) -> out, the
  inference forward.  Its CUDA implementation is `epilogue_forward`; its
  CPU implementation, registered by ``ops/fused.py``, is the plain
  `_reference_epilogue`.
* ``stylegan_torch::epilogue_train`` -> (out, saved): the forward that also
  writes the (B, C, 2) (mean, rstd) the backward reads.
* ``stylegan_torch::epilogue_backward`` (g, x, noise_weight, noise, style,
  saved, needs) -> the gradients whose entry of `needs` is true, in the
  order (dx, dnoise_weight, dnoise, dstyle): a custom op returns no
  optional tensors.

* ``stylegan_torch::epilogue_partial`` (x, noise_weight, noise) -> (B, C, 2)
  float32 (mean, M2) over x's rows, and ``stylegan_torch::epilogue_apply``
  (x, noise_weight, noise, style, stats) -> out: the split-plane forward
  (K1-partial, K2-apply) of a plane whose rows lie on several ranks, between
  which ``ops/fused.py`` gathers the ranks' partials and merges them into
  the (B, C, 2) (mean, rstd * (s0 + 1)) that K2-apply reads.  Their CUDA
  implementations are `epilogue_partial`, one launch on the plan of
  ``sgt_epilogue_partial_plan`` (clusters of blocks that merge over
  distributed shared memory), and `epilogue_apply`, one launch on the plan
  of ``sgt_epilogue_split_plan`` (path 2's geometry at every size); each
  plan is cached per (dtype, B, H*W, C, alignment), K1-partial's workspace
  (none where one cluster covers a (b, chunk)) as the forward's; their CPU
  implementations, registered by ``ops/fused.py``, are the plain versions.
* ``stylegan_torch::epilogue_backward_partial`` (g, x, noise_weight, noise,
  saved) -> (sums, dstyle) and ``stylegan_torch::epilogue_backward_apply``
  (g, x, noise_weight, noise, style, saved, sums, rows, needs) -> the
  gradients asked for of (dx, dnoise_weight, dnoise): the split-plane
  backward (K3-partial, K3-apply).  K3-partial gives this rank's (B, C, 2)
  float32 (sum g, sum g * (y - mean)) over its rows, with `saved` the
  merged (mean, rstd) its split forward kept, and its share of dstyle;
  ``ops/fused.py`` gathers the ranks' sums and adds them in rank order, and
  K3-apply writes dx, this rank's share of dnoise_weight and its rows of
  dnoise from the merged sums over the plane's `rows` rows.  Their CUDA
  implementations are `epilogue_backward_partial`, one launch on the plan
  of ``sgt_epilogue_bwd_partial_plan`` (K1-partial's kind), and
  `epilogue_backward_apply`, one launch on the plan of
  ``sgt_epilogue_bwd_apply_plan`` (a cluster per channel chunk for a small
  slab, with no workspace unless dnoise spans several chunks; a streaming
  grid of whole waves, its blocks' per-wave count asked of the card once
  per (dtype, C, alignment) through ``sgt_epilogue_bwd_apply_wave``, for a
  large one), each with a plan and workspace cache of its own; their CPU
  implementations, registered by ``ops/fused.py``, are the plain versions.

The training path is the ``torch.autograd.Function`` `_KernelEpilogue`
(the counterpart of the JAX ``pallas_epilogue`` custom VJP), whose forward
and backward call ``::epilogue_train`` and ``::epilogue_backward``; the
Function, not ``register_autograd``, keeps the once-differentiable error
and the incoming gradient's copy to NHWC where they were.  The training
ops' one implementation serves every device and launches the kernels,
which raise on anything but a CUDA tensor: ``ops/fused.py`` sends a CPU
tensor that needs a gradient to the plain versions and never to these
ops.  The launch itself is still the ``ctypes`` call below, inside the
op.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from ...utils.profiling import counters

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "epilogue.cu"
SOURCES = (SOURCE, _PKG / "csrc" / "epilogue_plan.h")
BUILD_DIR = _PKG.parent / "build" / "stylegan_torch"

# The kernels each path of the plan launches, by the names a profiler
# reports, one launch each per call.
KERNELS_BY_PATH = {1: ("onepass_kernel",), 2: ("stats_kernel", "apply_kernel")}
KERNEL_NAMES = KERNELS_BY_PATH[1] + KERNELS_BY_PATH[2]
# The backward's, the same way.
BWD_KERNELS_BY_PATH = {1: ("onepass_bwd_kernel",),
                       2: ("bwd_sums_kernel", "bwd_dx_kernel")}
BWD_KERNEL_NAMES = BWD_KERNELS_BY_PATH[1] + BWD_KERNELS_BY_PATH[2]

# The counts this module keeps in utils.profiling.counters, each under
# "epilogue.<name>": `launches`, the calls of epilogue_forward that launched
# the kernels (one per call), and `cuda_launches`, the CUDA launches they made
# (the plan's `launches`: 1 on path 1, 2 on path 2); the same two,
# `backward_launches` and `backward_cuda_launches`, for epilogue_backward;
# `backward_g_copies`, the autograd backward's calls whose incoming gradient
# was not contiguous NHWC, so that it had to be copied before the kernels could
# read it; and the launches of the split-plane entries (one CUDA launch each),
# `partial_launches`, `apply_launches`, `backward_partial_launches` and
# `backward_apply_launches`.

_lib = None
_plans: dict = {}        # (is_bf16, B, rows, C, aligned) -> Plan
_workspaces: dict = {}   # (plan key, device, stream) -> eager workspace
_bwd_plans: dict = {}    # (is_bf16, B, rows, C, aligned, want_dn) -> BwdPlan
_bwd_workspaces: dict = {}
_split_plans: dict = {}  # K2-apply's: (is_bf16, B, rows, C, aligned) -> Plan
_bwd_apply_plans: dict = {}  # K3-apply's: (..., aligned, want_dn) -> ApplyPlan
_bwd_apply_workspaces: dict = {}
_apply_waves: dict = {}  # K3-apply's blocks per wave: (is_bf16, C, aligned)
_partial_plans: dict = {}  # K1-partial's: (is_bf16, B, rows, C, aligned)
_partial_workspaces: dict = {}
_bwd_partial_plans: dict = {}  # K3-partial's, the same keys
_bwd_partial_workspaces: dict = {}


class Plan(ctypes.Structure):
    """``SgtPlan`` of epilogue_plan.h."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "path", "vec", "tx", "ty", "chunk_c", "chunks", "cluster", "splits",
        "launches")]
        + [(n, ctypes.c_longlong) for n in (
            "rows_per_rank", "rows_per_split", "rows_per_block", "smem_bytes",
            "stats_offset", "tickets_offset", "workspace_bytes")])

    def as_dict(self) -> dict:
        return {n: getattr(self, n) for n, _ in self._fields_}


class BwdPlan(ctypes.Structure):
    """``SgtBwdPlan`` of epilogue_plan.h."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "path", "vec", "tx", "ty", "chunk_c", "chunks", "cluster", "splits",
        "launches", "dn_partials")]
        + [(n, ctypes.c_longlong) for n in (
            "rows_per_split", "smem_bytes", "coef_offset", "dnw_offset",
            "dn_offset", "tickets_offset", "workspace_bytes")])

    as_dict = Plan.as_dict


class PartialPlan(ctypes.Structure):
    """``SgtPartialPlan`` of epilogue_plan.h."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "vec", "tx", "ty", "chunk_c", "chunks", "cluster", "groups",
        "splits", "nonportable", "unroll")]
        + [(n, ctypes.c_longlong) for n in (
            "rows_per_split", "tickets_offset", "workspace_bytes")])

    as_dict = Plan.as_dict


class ApplyPlan(ctypes.Structure):
    """``SgtApplyPlan`` of epilogue_plan.h."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "form", "vec", "tx", "ty", "chunk_c", "chunks", "cluster", "splits",
        "nonportable", "unroll", "reverse", "dn_partials", "ring", "ahead")]
        + [(n, ctypes.c_longlong) for n in (
            "rows_per_split", "smem_bytes", "dn_offset", "tickets_offset",
            "workspace_bytes")])

    as_dict = Plan.as_dict


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           f"{SOURCE.name}")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(sources=SOURCES, name: str = "epilogue") -> tuple[str, str]:
    """Compile the kernel library `name` from `sources` (its ``.cu`` files
    and the headers they include) if they have not been built yet.

    Returns (path of the shared library, nvcc's report: registers, shared
    memory and spills per kernel; empty when the library was cached)."""
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources))
    so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if so.exists():
        return str(so), ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), *(str(p) for p in sources if p.suffix == ".cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees a partial file
    return str(so), r.stderr


def bind(lib):
    """Declare the C interface's argument types on a loaded library (the
    kernel library, or a host-compiled copy of the plan alone)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # is_bf16 B R C aligned plan
    lib.sgt_epilogue_plan.argtypes = [i, i, ll, i, i, ctypes.POINTER(Plan)]
    lib.sgt_epilogue_plan.restype = ctypes.c_int
    # is_bf16 B R C aligned want_dn plan
    lib.sgt_epilogue_bwd_plan.argtypes = [i, i, ll, i, i, i,
                                          ctypes.POINTER(BwdPlan)]
    lib.sgt_epilogue_bwd_plan.restype = ctypes.c_int
    lib.sgt_epilogue_split_plan.argtypes = [i, i, ll, i, i,
                                            ctypes.POINTER(Plan)]
    lib.sgt_epilogue_split_plan.restype = ctypes.c_int
    # is_bf16 B R C aligned want_dn wave plan
    lib.sgt_epilogue_bwd_apply_plan.argtypes = [i, i, ll, i, i, i, ll,
                                                ctypes.POINTER(ApplyPlan)]
    lib.sgt_epilogue_bwd_apply_plan.restype = ctypes.c_int
    for name in ("sgt_epilogue_partial_plan", "sgt_epilogue_bwd_partial_plan"):
        getattr(lib, name).argtypes = [i, i, ll, i, i,
                                       ctypes.POINTER(PartialPlan)]
        getattr(lib, name).restype = ctypes.c_int
    if hasattr(lib, "sgt_epilogue_forward"):
        # is_bf16 C aligned, the blocks per wave
        lib.sgt_epilogue_bwd_apply_wave.argtypes = [
            i, i, i, ctypes.POINTER(ll)]
        lib.sgt_epilogue_bwd_apply_wave.restype = ctypes.c_int
        lib.sgt_epilogue_partial.argtypes = [
            p, p, p, p,           # x noise noise_weight partial
            p, ll,                # workspace, its bytes
            i, i, ll, i,          # is_bf16 B R C
            ctypes.POINTER(PartialPlan), p]  # plan, stream
        lib.sgt_epilogue_partial.restype = ctypes.c_int
        lib.sgt_epilogue_apply.argtypes = [
            p, p, p, p, p, p,     # x noise noise_weight style stats out
            i, i, ll, i,          # is_bf16 B R C
            ctypes.POINTER(Plan), p]  # plan, stream
        lib.sgt_epilogue_apply.restype = ctypes.c_int
        lib.sgt_epilogue_forward.argtypes = [
            p, p, p, p, p,        # x noise noise_weight style out
            p, ll,                # workspace, its bytes
            i, i, ll, i,          # is_bf16 B R C
            ctypes.POINTER(Plan), p, p]  # plan, saved stats, stream
        lib.sgt_epilogue_forward.restype = ctypes.c_int
        lib.sgt_epilogue_backward.argtypes = [
            p, p, p, p, p, p,     # g x noise noise_weight style saved
            p, p, p, p,           # dx dnoise_weight dnoise dstyle
            p, ll,                # workspace, its bytes
            i, i, ll, i,          # is_bf16 B R C
            ctypes.POINTER(BwdPlan), p]  # plan, stream
        lib.sgt_epilogue_backward.restype = ctypes.c_int
        lib.sgt_epilogue_backward_partial.argtypes = [
            p, p, p, p, p,        # g x noise noise_weight saved
            p, p,                 # sums dstyle
            p, ll,                # workspace, its bytes
            i, i, ll, i,          # is_bf16 B R C
            ctypes.POINTER(PartialPlan), p]  # plan, stream
        lib.sgt_epilogue_backward_partial.restype = ctypes.c_int
        lib.sgt_epilogue_backward_apply.argtypes = [
            p, p, p, p, p, p, p,  # g x noise noise_weight style saved sums
            ll,                   # the plane's rows
            p, p, p,              # dx dnoise_weight dnoise
            p, ll,                # workspace, its bytes
            i, i, ll, i,          # is_bf16 B R C
            ctypes.POINTER(ApplyPlan), p]  # plan, stream
        lib.sgt_epilogue_backward_apply.restype = ctypes.c_int
    return lib


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        _lib = bind(ctypes.CDLL(path))
    return _lib


def _stream(device: torch.device) -> int:
    # the handle of PyTorch's current stream, without building a Stream
    return torch._C._cuda_getCurrentRawStream(device.index)


def _capturing() -> bool:
    # whether the current stream is being captured into a CUDA graph
    return torch.cuda.is_current_stream_capturing()


def make_plan(lib, is_bf16: int, b: int, rows: int, c: int,
              aligned: int) -> Plan:
    """The plan of one call, from the library's sgt_epilogue_plan."""
    plan = Plan()
    if lib.sgt_epilogue_plan(is_bf16, b, rows, c, aligned, plan) != 0:
        raise ValueError(f"no epilogue plan for B={b} R={rows} C={c} "
                         f"bf16={is_bf16} aligned={aligned}")
    return plan


def plan_for(x: torch.Tensor) -> dict:
    """The plan a call on x would take (with a 16-byte-aligned out)."""
    b, h, w, c = x.shape
    return make_plan(_library(), int(x.dtype == torch.bfloat16), b, h * w, c,
                     int(x.data_ptr() % 16 == 0)).as_dict()


def _check_layout(x, noise_weight, noise, style, g=None, saved=None,
                  stats=None):
    """Raise unless the tensors have the shapes, dtypes, device and layout
    the kernels take (see epilogue_forward, epilogue_backward and the split
    entries, where style may be None); the ops' fakes run this, where the
    device is whatever the trace's is."""
    if x.ndim != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be 4-D float32/bfloat16 NHWC, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, h, w, c = x.shape
    checks = [("noise", noise, (b, h, w, 1), x.dtype),
              ("noise_weight", noise_weight, (c,), torch.float32)]
    if style is not None:
        checks.append(("style", style, (b, 2 * c), torch.float32))
    if g is not None:
        checks.append(("g", g, (b, h, w, c), x.dtype))
    if saved is not None:
        checks.append(("saved", saved, (b, c, 2), torch.float32))
    if stats is not None:
        checks.append(("stats", stats, (b, c, 2), torch.float32))
    for name, t, shape, dtype in checks:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (channels_last NCHW)")


def _check_inputs(x, noise_weight, noise, style, g=None, saved=None,
                  stats=None):
    """Raise unless the tensors are what the kernels take: _check_layout,
    and on a CUDA device."""
    _check_layout(x, noise_weight, noise, style, g, saved, stats)
    if x.device.type != "cuda":
        raise ValueError(
            f"epilogue kernel needs a CUDA tensor, got {x.device}")


def _on_device(device, fn, *args):
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fn(*args)
    return fn(*args)


def epilogue_forward(x: torch.Tensor, noise_weight: torch.Tensor,
                     noise: torch.Tensor, style: torch.Tensor,
                     saved: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel.  x: (B, H, W, C) contiguous NHWC (channels-last
    storage), float32 or bfloat16, on a CUDA device; noise (B, H, W, 1) of
    x's dtype; noise_weight (C,) and style (B, 2C) float32.  With `saved`, a
    (B, C, 2) float32 tensor, the kernel also writes there the (mean, rstd)
    per (b, c) that epilogue_backward reads.  Raises on anything else, never
    copies."""
    _check_inputs(x, noise_weight, noise, style, saved=saved)
    out = torch.empty_like(x)
    _on_device(x.device, _launch, x, noise_weight, noise, style, out, saved)
    return out


def _workspace(plan: Plan, device) -> torch.Tensor:
    """A workspace for `plan` with its ticket counters zeroed (the kernels
    leave them at zero; the partials and stats need no zeroing)."""
    ws = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=device)
    ws[plan.tickets_offset:].zero_()
    return ws


def _workspace_for(cache, key, plan, device, stream):
    """(cache key or None, workspace or None) for a call of `plan`: the eager
    calls' workspace per (plan, device, stream), or, for a call captured into
    a CUDA graph, one of its own from the graph's pool (freed back to it in
    stream order after the launch), so that a graph never shares ticket
    counters."""
    if not plan.workspace_bytes:
        return None, None
    if _capturing():
        return None, _workspace(plan, device)
    ws_key = (key, device, stream)
    ws = cache.get(ws_key)
    if ws is None:
        ws = cache[ws_key] = _workspace(plan, device)
    return ws_key, ws


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch(x, noise_weight, noise, style, out, saved=None):
    """One ctypes call on x's device, which is the current one."""
    b, h, w, c = x.shape
    rows, is_bf16 = h * w, int(x.dtype == torch.bfloat16)
    aligned = int((x.data_ptr() | out.data_ptr()) % 16 == 0)
    lib = _library()
    key = (is_bf16, b, rows, c, aligned)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = make_plan(lib, is_bf16, b, rows, c, aligned)
    stream = _stream(x.device)
    ws_key, ws = _workspace_for(_workspaces, key, plan, x.device, stream)
    err = lib.sgt_epilogue_forward(
        x.data_ptr(), noise.data_ptr(), noise_weight.data_ptr(),
        style.data_ptr(), out.data_ptr(), _ptr(ws), plan.workspace_bytes,
        is_bf16, b, rows, c, plan, _ptr(saved), stream)
    if err != 0:
        # its tickets may be left counting: the next call makes a new one
        _workspaces.pop(ws_key, None)
        raise RuntimeError(f"epilogue kernel launch failed: cudaError {err}")
    counters["epilogue.launches"] += 1
    counters["epilogue.cuda_launches"] += plan.launches


def make_bwd_plan(lib, is_bf16: int, b: int, rows: int, c: int,
                  aligned: int, want_dn: int) -> BwdPlan:
    """The backward's plan of one call, from sgt_epilogue_bwd_plan."""
    plan = BwdPlan()
    if lib.sgt_epilogue_bwd_plan(is_bf16, b, rows, c, aligned, want_dn,
                                 plan) != 0:
        raise ValueError(f"no epilogue backward plan for B={b} R={rows} "
                         f"C={c} bf16={is_bf16} aligned={aligned}")
    return plan


def bwd_plan_for(x: torch.Tensor) -> dict:
    """The backward's plan for a train-step call on x (no dnoise; g and dx
    16-byte aligned as x is)."""
    b, h, w, c = x.shape
    return make_bwd_plan(_library(), int(x.dtype == torch.bfloat16), b, h * w,
                         c, int(x.data_ptr() % 16 == 0), 0).as_dict()


def epilogue_backward(g, x, noise_weight, noise, style, saved,
                      needs=(True, True, True, True)):
    """Launch the backward kernel(s): the gradients (dx, dnoise_weight, dnoise,
    dstyle) of the epilogue's output w.r.t. its inputs, given g, the
    gradient of the output (x's shape and dtype, contiguous), and `saved`,
    the (B, C, 2) float32 (mean, rstd) that epilogue_forward wrote.  A
    gradient whose entry of `needs` is false is not computed (None).
    Inputs as for epilogue_forward; raises on anything else, never copies."""
    if saved is None:
        raise ValueError("saved must be the (B, C, 2) statistics that "
                         "epilogue_forward wrote")
    _check_inputs(x, noise_weight, noise, style, g=g, saved=saved)
    dx = torch.empty_like(x) if needs[0] else None
    dnw = torch.empty_like(noise_weight) if needs[1] else None
    dn = torch.empty_like(noise) if needs[2] else None
    dstyle = torch.empty_like(style) if needs[3] else None
    _on_device(x.device, _launch_backward, g, x, noise_weight, noise, style,
               saved, dx, dnw, dn, dstyle)
    return dx, dnw, dn, dstyle


def _launch_backward(g, x, noise_weight, noise, style, saved, dx, dnw, dn,
                     dstyle):
    """One ctypes call on x's device, which is the current one."""
    b, h, w, c = x.shape
    rows, is_bf16 = h * w, int(x.dtype == torch.bfloat16)
    aligned = int((g.data_ptr() | x.data_ptr() | _ptr(dx)) % 16 == 0)
    lib = _library()
    key = (is_bf16, b, rows, c, aligned, int(dn is not None))
    plan = _bwd_plans.get(key)
    if plan is None:
        plan = _bwd_plans[key] = make_bwd_plan(lib, *key)
    stream = _stream(x.device)
    ws_key, ws = _workspace_for(_bwd_workspaces, key, plan, x.device, stream)
    err = lib.sgt_epilogue_backward(
        g.data_ptr(), x.data_ptr(), noise.data_ptr(), noise_weight.data_ptr(),
        style.data_ptr(), saved.data_ptr(), _ptr(dx), _ptr(dnw), _ptr(dn),
        _ptr(dstyle), _ptr(ws), plan.workspace_bytes, is_bf16, b, rows, c,
        plan, stream)
    if err != 0:
        _bwd_workspaces.pop(ws_key, None)
        raise RuntimeError(
            f"epilogue backward kernel launch failed: cudaError {err}")
    counters["epilogue.backward_launches"] += 1
    counters["epilogue.backward_cuda_launches"] += plan.launches


# --------------------------------------------------------------------------
# The split-plane forward: K1-partial and K2-apply on one rank's rows.

def make_split_plan(lib, is_bf16: int, b: int, rows: int, c: int,
                    aligned: int) -> Plan:
    """K2-apply's plan of one call, from sgt_epilogue_split_plan."""
    plan = Plan()
    if lib.sgt_epilogue_split_plan(is_bf16, b, rows, c, aligned, plan) != 0:
        raise ValueError(f"no split epilogue plan for B={b} R={rows} C={c} "
                         f"bf16={is_bf16} aligned={aligned}")
    return plan


def make_partial_plan(lib, is_bf16: int, b: int, rows: int, c: int,
                      aligned: int) -> PartialPlan:
    """K1-partial's plan of one call, from sgt_epilogue_partial_plan."""
    plan = PartialPlan()
    if lib.sgt_epilogue_partial_plan(is_bf16, b, rows, c, aligned, plan) != 0:
        raise ValueError(f"no K1-partial plan for B={b} R={rows} C={c} "
                         f"bf16={is_bf16} aligned={aligned}")
    return plan


def _cached_plan(cache, make, x, aligned, *extra):
    b, h, w, c = x.shape
    key = (int(x.dtype == torch.bfloat16), b, h * w, c, aligned, *extra)
    plan = cache.get(key)
    if plan is None:
        plan = cache[key] = make(_library(), *key)
    return key, plan


def epilogue_partial(x: torch.Tensor, noise_weight: torch.Tensor,
                     noise: torch.Tensor) -> torch.Tensor:
    """Launch K1-partial: the (B, C, 2) float32 (mean, M2) per (b, c) of
    y = lrelu(x + noise_weight * noise, 0.2) over x's rows (this rank's slab
    of a split plane).  Inputs as for epilogue_forward; raises on anything
    else, never copies."""
    _check_inputs(x, noise_weight, noise, None)
    partial = torch.empty((x.shape[0], x.shape[-1], 2), dtype=torch.float32,
                          device=x.device)
    _on_device(x.device, _launch_partial, x, noise_weight, noise, partial)
    return partial


def _launch_partial(x, noise_weight, noise, partial):
    b, h, w, c = x.shape
    key, plan = _cached_plan(_partial_plans, make_partial_plan, x,
                             int(x.data_ptr() % 16 == 0))
    stream = _stream(x.device)
    ws_key, ws = _workspace_for(_partial_workspaces, key, plan, x.device,
                                stream)
    err = _library().sgt_epilogue_partial(
        x.data_ptr(), noise.data_ptr(), noise_weight.data_ptr(),
        partial.data_ptr(), _ptr(ws), plan.workspace_bytes, key[0], b,
        h * w, c, plan, stream)
    if err != 0:
        _partial_workspaces.pop(ws_key, None)
        raise RuntimeError(f"epilogue K1-partial launch failed: cudaError "
                           f"{err}")
    counters["epilogue.partial_launches"] += 1


def epilogue_apply(x: torch.Tensor, noise_weight: torch.Tensor,
                   noise: torch.Tensor, style: torch.Tensor,
                   stats: torch.Tensor) -> torch.Tensor:
    """Launch K2-apply: (y - mean) * scale + s1 over x's rows, with
    `stats` the (B, C, 2) float32 (mean, scale = rstd * (s0 + 1)) merged
    from every rank's K1-partial and s1 the second half of style.  Inputs
    as for epilogue_forward; raises on anything else, never copies."""
    _check_inputs(x, noise_weight, noise, style, stats=stats)
    out = torch.empty_like(x)
    _on_device(x.device, _launch_apply, x, noise_weight, noise, style, stats,
               out)
    return out


def _launch_apply(x, noise_weight, noise, style, stats, out):
    b, h, w, c = x.shape
    key, plan = _cached_plan(_split_plans, make_split_plan, x,
                             int((x.data_ptr() | out.data_ptr()) % 16 == 0))
    err = _library().sgt_epilogue_apply(
        x.data_ptr(), noise.data_ptr(), noise_weight.data_ptr(),
        style.data_ptr(), stats.data_ptr(), out.data_ptr(), key[0], b, h * w,
        c, plan, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"epilogue K2-apply launch failed: cudaError {err}")
    counters["epilogue.apply_launches"] += 1


# --------------------------------------------------------------------------
# The split-plane backward: K3-partial and K3-apply on one rank's rows.

def apply_wave(lib, is_bf16: int, c: int, aligned: int) -> int:
    """K3-apply's stream-form blocks per wave on the current card, from
    sgt_epilogue_bwd_apply_wave (asked once per (dtype, C, alignment))."""
    key = (is_bf16, c, aligned)
    wave = _apply_waves.get(key)
    if wave is None:
        out = ctypes.c_longlong()
        err = lib.sgt_epilogue_bwd_apply_wave(is_bf16, c, aligned,
                                              ctypes.byref(out))
        if err != 0 or out.value < 1:
            raise RuntimeError(f"K3-apply's occupancy query failed: "
                               f"cudaError {err}")
        wave = _apply_waves[key] = out.value
    return wave


def make_bwd_apply_plan(lib, is_bf16: int, b: int, rows: int, c: int,
                        aligned: int, want_dn: int,
                        wave: int | None = None) -> ApplyPlan:
    """K3-apply's plan of one call, from sgt_epilogue_bwd_apply_plan, for
    `wave` blocks per wave (by default the current card's)."""
    if wave is None:
        wave = apply_wave(lib, is_bf16, c, aligned)
    plan = ApplyPlan()
    if lib.sgt_epilogue_bwd_apply_plan(is_bf16, b, rows, c, aligned, want_dn,
                                       wave, plan) != 0:
        raise ValueError(f"no K3-apply plan for B={b} R={rows} C={c} "
                         f"bf16={is_bf16} aligned={aligned} wave={wave}")
    return plan


def make_bwd_partial_plan(lib, is_bf16: int, b: int, rows: int, c: int,
                          aligned: int) -> PartialPlan:
    """K3-partial's plan of one call, from sgt_epilogue_bwd_partial_plan."""
    plan = PartialPlan()
    if lib.sgt_epilogue_bwd_partial_plan(is_bf16, b, rows, c, aligned,
                                         plan) != 0:
        raise ValueError(f"no K3-partial plan for B={b} R={rows} C={c} "
                         f"bf16={is_bf16} aligned={aligned}")
    return plan


def epilogue_backward_partial(g: torch.Tensor, x: torch.Tensor,
                              noise_weight: torch.Tensor,
                              noise: torch.Tensor, saved: torch.Tensor):
    """Launch K3-partial: (sums, dstyle), sums the (B, C, 2) float32
    (sum g, sum g * (y - mean)) per (b, c) over x's rows (this rank's slab
    of a split plane) and dstyle the (B, 2C) float32 [sum g * yh | sum g]
    over them (this rank's share); `saved` is the (B, C, 2) float32
    (mean, rstd) of the whole plane.  Inputs as for epilogue_backward;
    raises on anything else, never copies."""
    _check_inputs(x, noise_weight, noise, None, g=g, saved=saved)
    b, c = x.shape[0], x.shape[-1]
    sums = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    dstyle = torch.empty((b, 2 * c), dtype=torch.float32, device=x.device)
    _on_device(x.device, _launch_backward_partial, g, x, noise_weight, noise,
               saved, sums, dstyle)
    return sums, dstyle


def _launch_backward_partial(g, x, noise_weight, noise, saved, sums, dstyle):
    b, h, w, c = x.shape
    key, plan = _cached_plan(_bwd_partial_plans, make_bwd_partial_plan, x,
                             int((g.data_ptr() | x.data_ptr()) % 16 == 0))
    stream = _stream(x.device)
    ws_key, ws = _workspace_for(_bwd_partial_workspaces, key, plan, x.device,
                                stream)
    err = _library().sgt_epilogue_backward_partial(
        g.data_ptr(), x.data_ptr(), noise.data_ptr(), noise_weight.data_ptr(),
        saved.data_ptr(), sums.data_ptr(), dstyle.data_ptr(), _ptr(ws),
        plan.workspace_bytes, key[0], b, h * w, c, plan, stream)
    if err != 0:
        _bwd_partial_workspaces.pop(ws_key, None)
        raise RuntimeError(f"epilogue K3-partial launch failed: cudaError "
                           f"{err}")
    counters["epilogue.backward_partial_launches"] += 1


def epilogue_backward_apply(g, x, noise_weight, noise, style, saved, sums,
                            rows: int, needs=(True, True, True)):
    """Launch K3-apply: the gradients (dx, dnoise_weight, dnoise) over x's
    rows whose entry of `needs` is true (else None): dx, this rank's share
    of dnoise_weight and its rows of dnoise, from `sums`, the (B, C, 2)
    float32 that every rank's K3-partial gave, added in rank order, over
    the plane's `rows` rows.  style (B, 2C) and saved (B, C, 2) float32;
    inputs as for epilogue_backward; raises on anything else, never
    copies."""
    _check_inputs(x, noise_weight, noise, style, g=g, saved=saved,
                  stats=sums)
    if rows < x.shape[1] * x.shape[2]:
        raise ValueError(f"the plane's rows ({rows}) must hold this slab's "
                         f"{x.shape[1] * x.shape[2]}")
    dx = torch.empty_like(x) if needs[0] else None
    dnw = torch.empty_like(noise_weight) if needs[1] else None
    dn = torch.empty_like(noise) if needs[2] else None
    _on_device(x.device, _launch_backward_apply, g, x, noise_weight, noise,
               style, saved, sums, rows, dx, dnw, dn)
    return dx, dnw, dn


def _launch_backward_apply(g, x, noise_weight, noise, style, saved, sums,
                           rows, dx, dnw, dn):
    b, h, w, c = x.shape
    key, plan = _cached_plan(
        _bwd_apply_plans, make_bwd_apply_plan, x,
        int((g.data_ptr() | x.data_ptr() | noise.data_ptr() | _ptr(dx)) % 16
            == 0), int(dn is not None))
    stream = _stream(x.device)
    ws_key, ws = _workspace_for(_bwd_apply_workspaces, key, plan, x.device,
                                stream)
    err = _library().sgt_epilogue_backward_apply(
        g.data_ptr(), x.data_ptr(), noise.data_ptr(), noise_weight.data_ptr(),
        style.data_ptr(), saved.data_ptr(), sums.data_ptr(), rows, _ptr(dx),
        _ptr(dnw), _ptr(dn), _ptr(ws), plan.workspace_bytes, key[0], b,
        h * w, c, plan, stream)
    if err != 0:
        _bwd_apply_workspaces.pop(ws_key, None)
        raise RuntimeError(f"epilogue K3-apply launch failed: cudaError "
                           f"{err}")
    counters["epilogue.backward_apply_launches"] += 1


def bytes_moved_backward_partial(x: torch.Tensor) -> int:
    """Bytes K3-partial must move: g, x and noise read once, plus
    noise_weight and the saved statistics, the (B, C, 2) sums and the
    (B, 2C) dstyle share written (float32)."""
    b, h, w, c = x.shape
    n = b * h * w
    return x.element_size() * (2 * n * c + n) + 4 * (c + 2 * b * c
                                                     + 2 * b * c + 2 * b * c)


def bytes_moved_backward_apply(x: torch.Tensor) -> int:
    """Bytes K3-apply must move in a train step (no dnoise): g, x and noise
    read once, dx written once, plus noise_weight, style, the saved
    statistics and the merged sums read and dnoise_weight written
    (float32)."""
    b, h, w, c = x.shape
    n = b * h * w
    return x.element_size() * (3 * n * c + n) + 4 * (2 * c + 2 * b * c
                                                     + 4 * b * c)


def bytes_moved_partial(x: torch.Tensor) -> int:
    """Bytes K1-partial must move: x and noise read once, noise_weight
    read, the (B, C, 2) float32 partials written."""
    b, h, w, c = x.shape
    return x.element_size() * b * h * w * (c + 1) + 4 * (c + 2 * b * c)


def bytes_moved_apply(x: torch.Tensor) -> int:
    """Bytes K2-apply must move: x and noise read once, out written once,
    plus noise_weight, style and the (B, C, 2) statistics (float32)."""
    return bytes_moved(x) + 8 * x.shape[0] * x.shape[-1]


def bytes_moved(x: torch.Tensor) -> int:
    """Bytes the epilogue must move: x and noise read once, out written once,
    plus noise_weight and style (float32)."""
    b, h, w, c = x.shape
    return (x.element_size() * b * h * w * (2 * c + 1)
            + 4 * (c + 2 * b * c))


def bytes_moved_backward(x: torch.Tensor) -> int:
    """Bytes a train step's backward must move: g, x and noise read once, dx
    written once, plus noise_weight, style, the saved statistics and the
    float32 gradients of noise_weight and style."""
    b, h, w, c = x.shape
    n = b * h * w
    return (x.element_size() * (3 * n * c + n)
            + 4 * (2 * c + 4 * b * c + 2 * b * c))


# --------------------------------------------------------------------------
# The kernels as torch.library ops.  The implementations look up
# epilogue_forward / epilogue_backward when called, so a test can stand a
# plain version in for the launch.

@torch.library.custom_op("stylegan_torch::epilogue", mutates_args=(),
                         device_types="cuda")
def epilogue_op(x: torch.Tensor, noise_weight: torch.Tensor,
                noise: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """The inference forward: the kernel on the card; on the CPU the plain
    version (registered by ops/fused.py)."""
    return epilogue_forward(x, noise_weight, noise, style)


@epilogue_op.register_fake
def _(x, noise_weight, noise, style):
    _check_layout(x, noise_weight, noise, style)
    return torch.empty_like(x)


@torch.library.custom_op("stylegan_torch::epilogue_train", mutates_args=())
def epilogue_train_op(x: torch.Tensor, noise_weight: torch.Tensor,
                      noise: torch.Tensor, style: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (out, saved (B, C, 2) float32 (mean, rstd))."""
    saved = torch.empty((x.shape[0], x.shape[-1], 2), dtype=torch.float32,
                        device=x.device)
    return epilogue_forward(x, noise_weight, noise, style, saved), saved


@epilogue_train_op.register_fake
def _(x, noise_weight, noise, style):
    _check_layout(x, noise_weight, noise, style)
    return torch.empty_like(x), x.new_empty((x.shape[0], x.shape[-1], 2),
                                            dtype=torch.float32)


@torch.library.custom_op("stylegan_torch::epilogue_backward", mutates_args=())
def epilogue_backward_op(g: torch.Tensor, x: torch.Tensor,
                         noise_weight: torch.Tensor, noise: torch.Tensor,
                         style: torch.Tensor, saved: torch.Tensor,
                         needs: list[bool]) -> list[torch.Tensor]:
    """The backward: the gradients asked for by `needs`, in order."""
    grads = epilogue_backward(g, x, noise_weight, noise, style, saved,
                              tuple(needs))
    return [d for d, need in zip(grads, needs) if need]


@epilogue_backward_op.register_fake
def _(g, x, noise_weight, noise, style, saved, needs):
    _check_layout(x, noise_weight, noise, style, g=g, saved=saved)
    return [torch.empty_like(t) for t, need in
            zip((x, noise_weight, noise, style), needs) if need]


@torch.library.custom_op("stylegan_torch::epilogue_partial", mutates_args=(),
                         device_types="cuda")
def epilogue_partial_op(x: torch.Tensor, noise_weight: torch.Tensor,
                        noise: torch.Tensor) -> torch.Tensor:
    """K1-partial: the kernel on the card; on the CPU the plain version
    (registered by ops/fused.py)."""
    return epilogue_partial(x, noise_weight, noise)


@epilogue_partial_op.register_fake
def _(x, noise_weight, noise):
    _check_layout(x, noise_weight, noise, None)
    return x.new_empty((x.shape[0], x.shape[-1], 2), dtype=torch.float32)


@torch.library.custom_op("stylegan_torch::epilogue_apply", mutates_args=(),
                         device_types="cuda")
def epilogue_apply_op(x: torch.Tensor, noise_weight: torch.Tensor,
                      noise: torch.Tensor, style: torch.Tensor,
                      stats: torch.Tensor) -> torch.Tensor:
    """K2-apply: the kernel on the card; on the CPU the plain version
    (registered by ops/fused.py)."""
    return epilogue_apply(x, noise_weight, noise, style, stats)


@epilogue_apply_op.register_fake
def _(x, noise_weight, noise, style, stats):
    _check_layout(x, noise_weight, noise, style, stats=stats)
    return torch.empty_like(x)


@torch.library.custom_op("stylegan_torch::epilogue_backward_partial",
                         mutates_args=(), device_types="cuda")
def epilogue_backward_partial_op(g: torch.Tensor, x: torch.Tensor,
                                 noise_weight: torch.Tensor,
                                 noise: torch.Tensor, saved: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3-partial: the kernel on the card; on the CPU the plain version
    (registered by ops/fused.py)."""
    return epilogue_backward_partial(g, x, noise_weight, noise, saved)


@epilogue_backward_partial_op.register_fake
def _(g, x, noise_weight, noise, saved):
    _check_layout(x, noise_weight, noise, None, g=g, saved=saved)
    b, c = x.shape[0], x.shape[-1]
    return (x.new_empty((b, c, 2), dtype=torch.float32),
            x.new_empty((b, 2 * c), dtype=torch.float32))


@torch.library.custom_op("stylegan_torch::epilogue_backward_apply",
                         mutates_args=(), device_types="cuda")
def epilogue_backward_apply_op(g: torch.Tensor, x: torch.Tensor,
                               noise_weight: torch.Tensor,
                               noise: torch.Tensor, style: torch.Tensor,
                               saved: torch.Tensor, sums: torch.Tensor,
                               rows: int, needs: list[bool]
                               ) -> list[torch.Tensor]:
    """K3-apply: the gradients asked for by `needs`, in the order (dx,
    dnoise_weight, dnoise); the kernel on the card, on the CPU the plain
    version (registered by ops/fused.py)."""
    grads = epilogue_backward_apply(g, x, noise_weight, noise, style, saved,
                                    sums, rows, tuple(needs))
    return [d for d, need in zip(grads, needs) if need]


@epilogue_backward_apply_op.register_fake
def _(g, x, noise_weight, noise, style, saved, sums, rows, needs):
    _check_layout(x, noise_weight, noise, style, g=g, saved=saved,
                  stats=sums)
    return [torch.empty_like(t) for t, need in
            zip((x, noise_weight, noise), needs) if need]


class _KernelEpilogue(torch.autograd.Function):
    """Forward and backward: the kernels through their training ops (the
    forward saves the (mean, rstd) the backward reads).  The backward
    kernels are once differentiable: a backward that would be
    differentiated again (create_graph=True) raises rather than hand
    autograd gradients with no graph behind them."""

    @staticmethod
    def forward(ctx, x, noise_weight, noise, style):
        out, saved = epilogue_train_op(x, noise_weight, noise, style)
        ctx.save_for_backward(x, noise_weight, noise, style, saved)
        return out

    @staticmethod
    def backward(ctx, g):
        # autograd runs a backward with grad mode on only for create_graph
        if torch.is_grad_enabled():
            raise RuntimeError(
                "the epilogue's CUDA backward is once differentiable: a "
                "second derivative through it (create_graph=True) is not "
                "implemented")
        x, noise_weight, noise, style, saved = ctx.saved_tensors
        # autograd may hand g in another layout; the kernel reads NHWC rows
        if not g.is_contiguous():
            counters["epilogue.backward_g_copies"] += 1
            g = g.contiguous()
        needs = list(ctx.needs_input_grad)
        grads = iter(epilogue_backward_op(g, x, noise_weight, noise, style,
                                          saved, needs))
        return tuple(next(grads) if need else None for need in needs)


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def kernel_epilogue(x, noise_weight, noise, style):
    """Differentiable kernel epilogue; same arguments as epilogue_forward.
    Where no gradient can flow (inference, or no input requiring one) the
    inference op is called, without the autograd.Function's host cost."""
    if needs_grad(x, noise_weight, noise, style):
        return _KernelEpilogue.apply(x, noise_weight, noise, style)
    return epilogue_op(x, noise_weight, noise, style)
