"""Frechet Inception Distance and Inception Score behind a local-weights
flag (the port's counterpart of ``stylegan_tpu/metrics/fid.py``).

  * the InceptionV3 feature extractor is the torchvision ``inception_v3``
    architecture (BasicConv2d = conv -> BN(eps=1e-3) -> relu; Mixed_5b..7c;
    2048-d pool3 features), written here as functional PyTorch over a flat
    parameter dict, BN folded into the convolutions;
  * weights load from a local ``.npz`` whose keys are the torchvision
    state_dict names verbatim (Conv2d_1a_3x3.conv.weight, Mixed_5b.branch1x1
    .bn.running_mean, ...); convert once, anywhere torchvision exists:

      sd = torchvision.models.inception_v3(weights="IMAGENET1K_V1").state_dict()
      np.savez("inception_v3.npz", **{k: v.numpy() for k, v in sd.items()})

  * without weights, eval_metrics falls back to SWD (metrics/swd.py).

Input pipeline as pytorch-fid: images in [0, 1], bilinear resize to 299x299
(half-pixel centers, antialiased when it shrinks, as ``jax.image.resize``),
scaled to [-1, 1], features = global-avg-pooled Mixed_7c output.  FID =
||mu1-mu2||^2 + tr(S1 + S2 - 2 sqrtm(S1 S2)), in float64 numpy on the host.
The network runs on the device of its parameters (CUDA unless the caller
asks for the CPU); its convolutions follow the process's TF32 policy
(``ops/precision.py``; off by default).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_BN_EPS = 1e-3


# ---------------------------------------------------------------------------
# architecture table (torchvision inception_v3 layer names and shapes)
# ---------------------------------------------------------------------------

def _conv_spec(name, cin, cout, kh, kw, stride=1, pad=(0, 0)):
    return (name, cin, cout, kh, kw, stride, pad)


def _stem_specs():
    return [
        _conv_spec("Conv2d_1a_3x3", 3, 32, 3, 3, 2),
        _conv_spec("Conv2d_2a_3x3", 32, 32, 3, 3),
        _conv_spec("Conv2d_2b_3x3", 32, 64, 3, 3, 1, (1, 1)),
        # maxpool 3x3 s2 between 2b/3b and 4a/5b (handled in apply)
        _conv_spec("Conv2d_3b_1x1", 64, 80, 1, 1),
        _conv_spec("Conv2d_4a_3x3", 80, 192, 3, 3),
    ]


def _inception_a(prefix, cin, pool_features):
    return [
        _conv_spec(f"{prefix}.branch1x1", cin, 64, 1, 1),
        _conv_spec(f"{prefix}.branch5x5_1", cin, 48, 1, 1),
        _conv_spec(f"{prefix}.branch5x5_2", 48, 64, 5, 5, 1, (2, 2)),
        _conv_spec(f"{prefix}.branch3x3dbl_1", cin, 64, 1, 1),
        _conv_spec(f"{prefix}.branch3x3dbl_2", 64, 96, 3, 3, 1, (1, 1)),
        _conv_spec(f"{prefix}.branch3x3dbl_3", 96, 96, 3, 3, 1, (1, 1)),
        _conv_spec(f"{prefix}.branch_pool", cin, pool_features, 1, 1),
    ]


def _inception_b(prefix, cin):
    return [
        _conv_spec(f"{prefix}.branch3x3", cin, 384, 3, 3, 2),
        _conv_spec(f"{prefix}.branch3x3dbl_1", cin, 64, 1, 1),
        _conv_spec(f"{prefix}.branch3x3dbl_2", 64, 96, 3, 3, 1, (1, 1)),
        _conv_spec(f"{prefix}.branch3x3dbl_3", 96, 96, 3, 3, 2),
    ]


def _inception_c(prefix, cin, c7):
    return [
        _conv_spec(f"{prefix}.branch1x1", cin, 192, 1, 1),
        _conv_spec(f"{prefix}.branch7x7_1", cin, c7, 1, 1),
        _conv_spec(f"{prefix}.branch7x7_2", c7, c7, 1, 7, 1, (0, 3)),
        _conv_spec(f"{prefix}.branch7x7_3", c7, 192, 7, 1, 1, (3, 0)),
        _conv_spec(f"{prefix}.branch7x7dbl_1", cin, c7, 1, 1),
        _conv_spec(f"{prefix}.branch7x7dbl_2", c7, c7, 7, 1, 1, (3, 0)),
        _conv_spec(f"{prefix}.branch7x7dbl_3", c7, c7, 1, 7, 1, (0, 3)),
        _conv_spec(f"{prefix}.branch7x7dbl_4", c7, c7, 7, 1, 1, (3, 0)),
        _conv_spec(f"{prefix}.branch7x7dbl_5", c7, 192, 1, 7, 1, (0, 3)),
        _conv_spec(f"{prefix}.branch_pool", cin, 192, 1, 1),
    ]


def _inception_d(prefix, cin):
    return [
        _conv_spec(f"{prefix}.branch3x3_1", cin, 192, 1, 1),
        _conv_spec(f"{prefix}.branch3x3_2", 192, 320, 3, 3, 2),
        _conv_spec(f"{prefix}.branch7x7x3_1", cin, 192, 1, 1),
        _conv_spec(f"{prefix}.branch7x7x3_2", 192, 192, 1, 7, 1, (0, 3)),
        _conv_spec(f"{prefix}.branch7x7x3_3", 192, 192, 7, 1, 1, (3, 0)),
        _conv_spec(f"{prefix}.branch7x7x3_4", 192, 192, 3, 3, 2),
    ]


def _inception_e(prefix, cin):
    return [
        _conv_spec(f"{prefix}.branch1x1", cin, 320, 1, 1),
        _conv_spec(f"{prefix}.branch3x3_1", cin, 384, 1, 1),
        _conv_spec(f"{prefix}.branch3x3_2a", 384, 384, 1, 3, 1, (0, 1)),
        _conv_spec(f"{prefix}.branch3x3_2b", 384, 384, 3, 1, 1, (1, 0)),
        _conv_spec(f"{prefix}.branch3x3dbl_1", cin, 448, 1, 1),
        _conv_spec(f"{prefix}.branch3x3dbl_2", 448, 384, 3, 3, 1, (1, 1)),
        _conv_spec(f"{prefix}.branch3x3dbl_3a", 384, 384, 1, 3, 1, (0, 1)),
        _conv_spec(f"{prefix}.branch3x3dbl_3b", 384, 384, 3, 1, 1, (1, 0)),
        _conv_spec(f"{prefix}.branch_pool", cin, 192, 1, 1),
    ]


def all_conv_specs():
    specs = list(_stem_specs())
    specs += _inception_a("Mixed_5b", 192, 32)
    specs += _inception_a("Mixed_5c", 256, 64)
    specs += _inception_a("Mixed_5d", 288, 64)
    specs += _inception_b("Mixed_6a", 288)
    for name, c7 in [("Mixed_6b", 128), ("Mixed_6c", 160),
                     ("Mixed_6d", 160), ("Mixed_6e", 192)]:
        specs += _inception_c(name, 768, c7)
    specs += _inception_d("Mixed_7a", 768)
    specs += _inception_e("Mixed_7b", 1280)
    specs += _inception_e("Mixed_7c", 2048)
    return specs


# ---------------------------------------------------------------------------
# params: flat dict keyed by torchvision state_dict names
# ---------------------------------------------------------------------------

def inception_v3_init(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random params with the exact torchvision key schema and shapes, from a
    seeded numpy generator (for pipeline tests; real FID needs converted
    pretrained weights).  He init with the relu gain, so that the ~94-conv
    feature path keeps unit activation scale."""
    rs = np.random.default_rng(seed)
    params = {}
    for name, cin, cout, kh, kw, _, _ in all_conv_specs():
        std = math.sqrt(2.0 / (cin * kh * kw))
        params[f"{name}.conv.weight"] = (
            rs.standard_normal((cout, cin, kh, kw), np.float32) * std)
        params[f"{name}.bn.weight"] = np.ones((cout,), np.float32)
        params[f"{name}.bn.bias"] = np.zeros((cout,), np.float32)
        params[f"{name}.bn.running_mean"] = np.zeros((cout,), np.float32)
        params[f"{name}.bn.running_var"] = np.ones((cout,), np.float32)
    # classifier head (fc): FID ignores it, Inception Score needs it
    params["fc.weight"] = (rs.standard_normal((1000, 2048), np.float32)
                           * math.sqrt(1.0 / 2048))
    params["fc.bias"] = np.zeros((1000,), np.float32)
    return params


def load_inception_weights(path: str, need_fc: bool = False) \
        -> Dict[str, np.ndarray]:
    """Load a torchvision-schema `.npz`; verifies every conv/BN tensor the
    feature path needs is present with the right shape.  FID uses pool3
    features only (fc / AuxLogits keys ignored); need_fc=True additionally
    requires the (1000, 2048) classifier head (Inception Score)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    missing, bad = [], []
    if need_fc:
        if "fc.weight" not in flat or "fc.bias" not in flat:
            missing.append("fc.weight/fc.bias")
        else:
            if tuple(flat["fc.weight"].shape) != (1000, 2048):
                bad.append(
                    f"fc.weight: {flat['fc.weight'].shape} != (1000, 2048)")
            if tuple(flat["fc.bias"].shape) != (1000,):
                bad.append(f"fc.bias: {flat['fc.bias'].shape} != (1000,)")
    for name, cin, cout, kh, kw, _, _ in all_conv_specs():
        wk = f"{name}.conv.weight"
        if wk not in flat:
            missing.append(wk)
        elif tuple(flat[wk].shape) != (cout, cin, kh, kw):
            bad.append(f"{wk}: {flat[wk].shape} != {(cout, cin, kh, kw)}")
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            bk = f"{name}.bn.{leaf}"
            if bk not in flat:
                missing.append(bk)
            elif tuple(flat[bk].shape) != (cout,):
                bad.append(f"{bk}: {flat[bk].shape} != {(cout,)}")
    if missing or bad:
        raise ValueError(
            "inception weights file does not match the torchvision "
            f"inception_v3 schema; missing={missing[:5]} bad={bad[:5]} "
            f"(+{max(0, len(missing) + len(bad) - 10)} more)")
    return flat


def _prepare(params: Dict[str, np.ndarray], device):
    """Fold BN into each conv's weight (OIHW, scaled per output channel) and
    a per-channel shift, on `device`."""
    folded = {}
    for name, *_ in all_conv_specs():
        def t(key):
            return torch.as_tensor(np.asarray(params[key], np.float32),
                                   device=device)
        scale = t(f"{name}.bn.weight") * torch.rsqrt(
            t(f"{name}.bn.running_var") + _BN_EPS)
        shift = t(f"{name}.bn.bias") - t(f"{name}.bn.running_mean") * scale
        w = t(f"{name}.conv.weight") * scale[:, None, None, None]
        folded[name] = (w.contiguous(memory_format=torch.channels_last),
                        shift[None, :, None, None])
    return folded


# ---------------------------------------------------------------------------
# forward (NCHW in channels-last storage)
# ---------------------------------------------------------------------------

_SPECS = {s[0]: s for s in all_conv_specs()}


def _bconv(folded, name, x):
    """BasicConv2d: conv (folded BN scale) -> shift -> relu."""
    _, _, _, _, _, stride, pad = _SPECS[name]
    w, shift = folded[name]
    return F.relu(F.conv2d(x, w, stride=stride, padding=pad) + shift)


def _maxpool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


def _avgpool3s1p1(x):
    # count_include_pad=True (torch default for nn.AvgPool2d used here)
    return F.avg_pool2d(x, 3, stride=1, padding=1)


def _block_a(folded, p, x):
    b1 = _bconv(folded, f"{p}.branch1x1", x)
    b5 = _bconv(folded, f"{p}.branch5x5_2",
                _bconv(folded, f"{p}.branch5x5_1", x))
    b3 = _bconv(folded, f"{p}.branch3x3dbl_3",
                _bconv(folded, f"{p}.branch3x3dbl_2",
                       _bconv(folded, f"{p}.branch3x3dbl_1", x)))
    bp = _bconv(folded, f"{p}.branch_pool", _avgpool3s1p1(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _block_b(folded, p, x):
    b3 = _bconv(folded, f"{p}.branch3x3", x)
    bd = _bconv(folded, f"{p}.branch3x3dbl_3",
                _bconv(folded, f"{p}.branch3x3dbl_2",
                       _bconv(folded, f"{p}.branch3x3dbl_1", x)))
    return torch.cat([b3, bd, _maxpool3s2(x)], dim=1)


def _block_c(folded, p, x):
    b1 = _bconv(folded, f"{p}.branch1x1", x)
    b7 = x
    for leaf in ("branch7x7_1", "branch7x7_2", "branch7x7_3"):
        b7 = _bconv(folded, f"{p}.{leaf}", b7)
    bd = x
    for leaf in ("branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                 "branch7x7dbl_4", "branch7x7dbl_5"):
        bd = _bconv(folded, f"{p}.{leaf}", bd)
    bp = _bconv(folded, f"{p}.branch_pool", _avgpool3s1p1(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _block_d(folded, p, x):
    b3 = _bconv(folded, f"{p}.branch3x3_2",
                _bconv(folded, f"{p}.branch3x3_1", x))
    b7 = x
    for leaf in ("branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
                 "branch7x7x3_4"):
        b7 = _bconv(folded, f"{p}.{leaf}", b7)
    return torch.cat([b3, b7, _maxpool3s2(x)], dim=1)


def _block_e(folded, p, x):
    b1 = _bconv(folded, f"{p}.branch1x1", x)
    b3 = _bconv(folded, f"{p}.branch3x3_1", x)
    b3 = torch.cat([_bconv(folded, f"{p}.branch3x3_2a", b3),
                    _bconv(folded, f"{p}.branch3x3_2b", b3)], dim=1)
    bd = _bconv(folded, f"{p}.branch3x3dbl_2",
                _bconv(folded, f"{p}.branch3x3dbl_1", x))
    bd = torch.cat([_bconv(folded, f"{p}.branch3x3dbl_3a", bd),
                    _bconv(folded, f"{p}.branch3x3dbl_3b", bd)], dim=1)
    bp = _bconv(folded, f"{p}.branch_pool", _avgpool3s1p1(x))
    return torch.cat([b1, b3, bd, bp], dim=1)


def resize_299(images01: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW (channels-last storage) at 299x299: bilinear with
    half-pixel centers, antialiased when shrinking (``jax.image.resize``'s
    "bilinear"); unchanged at 299."""
    x = images01.permute(0, 3, 1, 2)
    if x.shape[2] != 299 or x.shape[3] != 299:
        x = F.interpolate(x, size=(299, 299), mode="bilinear",
                          align_corners=False, antialias=True)
    return x.contiguous(memory_format=torch.channels_last)


def make_feature_fn(params: Dict[str, np.ndarray], device="cuda"):
    """Returns fn: images01 (B, H, W, 3) in [0, 1] (tensor or array) ->
    (B, 2048) float32 features on `device`."""
    from .. import resolve_device
    device = resolve_device(device)
    folded = _prepare(params, device)

    @torch.inference_mode()
    def features(images01):
        x = torch.as_tensor(images01, dtype=torch.float32).to(device)
        x = resize_299(x) * 2.0 - 1.0  # pytorch-fid normalize_input
        for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            x = _bconv(folded, name, x)
        x = _maxpool3s2(x)
        x = _bconv(folded, "Conv2d_3b_1x1", x)
        x = _bconv(folded, "Conv2d_4a_3x3", x)
        x = _maxpool3s2(x)
        for p in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = _block_a(folded, p, x)
        x = _block_b(folded, "Mixed_6a", x)
        for p in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = _block_c(folded, p, x)
        x = _block_d(folded, "Mixed_7a", x)
        x = _block_e(folded, "Mixed_7b", x)
        x = _block_e(folded, "Mixed_7c", x)
        return x.mean(dim=(2, 3))  # global average pool -> (B, 2048)

    return features


# ---------------------------------------------------------------------------
# Frechet distance
# ---------------------------------------------------------------------------

def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mu (D,), sigma (D, D)) in float64."""
    f = np.asarray(features, np.float64)
    mu = f.mean(axis=0)
    sigma = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + tr(S1 + S2 - 2 sqrtm(S1 S2)).

    tr(sqrtm(S1 S2)) is computed via the symmetric form sqrtm(S1)^T S2
    sqrtm(S1): both factors are PSD, so the trace equals the sum of the
    square roots of that symmetric product's eigenvalues — no non-symmetric
    sqrtm (scipy) needed.
    """
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    s1 = np.asarray(sigma1, np.float64) + eps * np.eye(len(mu1))
    s2 = np.asarray(sigma2, np.float64) + eps * np.eye(len(mu2))

    # sqrtm of the symmetric PSD s1 via eigendecomposition
    w, v = np.linalg.eigh(s1)
    sq1 = (v * np.sqrt(np.clip(w, 0, None))) @ v.T
    m = sq1 @ s2 @ sq1
    ev = np.linalg.eigvalsh((m + m.T) / 2.0)
    tr_sqrt = float(np.sum(np.sqrt(np.clip(ev, 0, None))))

    diff = mu1 - mu2
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * tr_sqrt)


def fid_from_features(real_features, fake_features) -> float:
    mu_r, s_r = compute_statistics(real_features)
    mu_f, s_f = compute_statistics(fake_features)
    return frechet_distance(mu_r, s_r, mu_f, s_f)


def _run_batched(fn, images, batch_size: int) -> np.ndarray:
    return np.concatenate([fn(images[i:i + batch_size]).cpu().numpy()
                           for i in range(0, len(images), batch_size)])


def compute_fid(reals01, fakes01, weights_path: str, batch_size: int = 32,
                device="cuda") -> float:
    """End-to-end FID between two [0, 1] NHWC image sets."""
    feats = make_feature_fn(load_inception_weights(weights_path), device)
    return fid_from_features(_run_batched(feats, reals01, batch_size),
                             _run_batched(feats, fakes01, batch_size))


# ---------------------------------------------------------------------------
# Inception Score (Salimans et al. 2016): the same network and weights
# ---------------------------------------------------------------------------

def make_probs_fn(params: Dict[str, np.ndarray], device="cuda"):
    """Returns fn: images01 (B, H, W, 3) in [0, 1] -> class probabilities
    (B, 1000) through the torchvision fc head on the pool3 features."""
    from .. import resolve_device
    device = resolve_device(device)
    feature_fn = make_feature_fn(params, device)
    fc_w = torch.as_tensor(np.asarray(params["fc.weight"], np.float32),
                           device=device)
    fc_b = torch.as_tensor(np.asarray(params["fc.bias"], np.float32),
                           device=device)

    @torch.inference_mode()
    def probs(images01):
        return torch.softmax(feature_fn(images01) @ fc_w.T + fc_b, dim=-1)

    return probs


def inception_score_from_probs(probs: np.ndarray,
                               splits: int = 10) -> Tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) || p(y))), mean/std over `splits` chunks."""
    p = np.asarray(probs, np.float64)
    n = len(p)
    splits = max(1, min(splits, n))
    scores = []
    for chunk in np.array_split(p, splits):
        marginal = chunk.mean(axis=0, keepdims=True)
        kl = np.sum(chunk * (np.log(chunk + 1e-16)
                             - np.log(marginal + 1e-16)), axis=1)
        scores.append(float(np.exp(kl.mean())))
    return float(np.mean(scores)), float(np.std(scores))


def compute_inception_score(fakes01, weights_path: str, batch_size: int = 32,
                            splits: int = 10,
                            device="cuda") -> Tuple[float, float]:
    """End-to-end Inception Score of a [0, 1] NHWC image set."""
    probs_fn = make_probs_fn(load_inception_weights(weights_path,
                                                    need_fc=True), device)
    return inception_score_from_probs(
        _run_batched(probs_fn, fakes01, batch_size), splits)
