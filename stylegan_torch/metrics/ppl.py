"""Perceptual Path Length (Karras et al. 2019, arXiv:1812.04948 §4.1; the
port's counterpart of ``stylegan_tpu/metrics/ppl.py``).

PPL measures latent-space smoothness: the expected perceptual distance
between images generated from infinitesimally perturbed latent
interpolations,

    PPL = E[ (1/eps^2) * d(G(lerp(t)), G(lerp(t + eps))) ],  eps = 1e-4,

with slerp in Z space or lerp in W space, t ~ U(0,1) ("full") or t = 0
("end").

The perceptual distance d is pluggable:

  * with ``--lpips_weights``: LPIPS over a VGG16 backbone (the paper's
    metric), weights from a local ``.npz`` holding the torchvision ``vgg16``
    ``features.*`` conv tensors plus the lpips linear calibration heads (the
    recipe is in the JAX module's docstring);
  * without weights: a Laplacian-pyramid L2 distance (multi-scale, no
    weights; the pyramid the SWD metric uses).  Not comparable to published
    LPIPS-PPL numbers, but a consistent smoothness measure.

Images are center-cropped to the face region and downsampled to 256 before
the distance, as in the official implementation.  The draws of each batch
(z1, z2, t, the noise maps, the labels) come from a host
``torch.Generator`` seeded from (seed, batch index), or are passed pinned
(``draws=``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .swd import laplacian_pyramid

EPSILON = 1e-4

# torchvision vgg16.features conv layer indices and the relu taps LPIPS uses
_VGG_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG_CHANNELS = {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128),
                 10: (128, 256), 12: (256, 256), 14: (256, 256),
                 17: (256, 512), 19: (512, 512), 21: (512, 512),
                 24: (512, 512), 26: (512, 512), 28: (512, 512)}
_LPIPS_TAPS = (2, 7, 14, 21, 28)      # relu1_2, 2_2, 3_3, 4_3, 5_3
_POOL_AFTER = (2, 7, 14, 21)          # maxpool follows these taps
_LPIPS_DIMS = (64, 128, 256, 512, 512)
# LPIPS input scaling (lpips.ScalingLayer constants)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


# ---------------------------------------------------------------------------
# latent interpolation
# ---------------------------------------------------------------------------

def slerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation along the last axis (paper appendix).

    Degenerate (near-parallel) pairs fall back to lerp instead of dividing
    by sin(omega) ~ 0: one NaN distance would poison the whole PPL
    percentile reduction."""
    a_n = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b_n = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    dot = torch.clamp(torch.sum(a_n * b_n, dim=-1, keepdim=True), -1.0, 1.0)
    omega = torch.arccos(dot)
    so = torch.sin(omega)
    safe = torch.abs(so) > 1e-6
    so_safe = torch.where(safe, so, torch.ones_like(so))
    spherical = (torch.sin((1.0 - t) * omega) / so_safe) * a \
        + (torch.sin(t * omega) / so_safe) * b
    return torch.where(safe, spherical, lerp(a, b, t))


def lerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    return a + (b - a) * t


# ---------------------------------------------------------------------------
# LPIPS (VGG16) distance
# ---------------------------------------------------------------------------

def lpips_vgg_init(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random weights with the exact expected schema and shapes, from a
    seeded numpy generator (pipeline tests; real PPL needs converted
    weights)."""
    rs = np.random.default_rng(seed)
    params = {}
    for idx in _VGG_CONVS:
        cin, cout = _VGG_CHANNELS[idx]
        std = float(np.sqrt(2.0 / (cin * 9)))
        params[f"features.{idx}.weight"] = (
            rs.standard_normal((cout, cin, 3, 3), np.float32) * std)
        params[f"features.{idx}.bias"] = np.zeros((cout,), np.float32)
    for i, dim in enumerate(_LPIPS_DIMS):
        params[f"lin{i}.weight"] = (
            np.abs(rs.standard_normal((1, dim, 1, 1), np.float32)) / dim)
    return params


def load_lpips_weights(path: str) -> Dict[str, np.ndarray]:
    """Load and schema-check an lpips_vgg16 ``.npz``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    missing, bad = [], []
    for idx in _VGG_CONVS:
        cin, cout = _VGG_CHANNELS[idx]
        for leaf, shape in ((f"features.{idx}.weight", (cout, cin, 3, 3)),
                            (f"features.{idx}.bias", (cout,))):
            if leaf not in flat:
                missing.append(leaf)
            elif tuple(flat[leaf].shape) != shape:
                bad.append(f"{leaf}: {flat[leaf].shape} != {shape}")
    for i, dim in enumerate(_LPIPS_DIMS):
        k = f"lin{i}.weight"
        if k not in flat:
            missing.append(k)
        elif tuple(np.squeeze(flat[k]).shape) != (dim,):
            bad.append(f"{k}: {flat[k].shape} squeezes to "
                       f"{np.squeeze(flat[k]).shape} != ({dim},)")
    if missing or bad:
        raise ValueError("lpips weights file does not match the vgg16+lin "
                         f"schema; missing={missing[:5]} bad={bad[:5]} "
                         f"(+{max(0, len(missing) + len(bad) - 10)} more)")
    return flat


def make_lpips_fn(params: Dict[str, np.ndarray], device="cuda"):
    """Returns fn(img_a, img_b) -> (B,) LPIPS distances on `device`.

    Inputs are NHWC in [-1, 1] (the generator's range, the lpips input
    convention)."""
    from .. import resolve_device
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    convs = {idx: (t(params[f"features.{idx}.weight"]).contiguous(
                       memory_format=torch.channels_last),
                   t(params[f"features.{idx}.bias"]))
             for idx in _VGG_CONVS}
    lins = [t(np.squeeze(params[f"lin{i}.weight"]))[None, :, None, None]
            for i in range(len(_LPIPS_DIMS))]
    shift = t(_SHIFT)[None, :, None, None]
    scale = t(_SCALE)[None, :, None, None]

    def features(x):
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = (x - shift) / scale
        taps = []
        for idx in _VGG_CONVS:
            w, b = convs[idx]
            x = F.relu(F.conv2d(x, w, b, padding=1))
            if idx in _LPIPS_TAPS:
                taps.append(x)
            if idx in _POOL_AFTER:
                x = F.max_pool2d(x, 2, 2)
        return taps

    @torch.inference_mode()
    def distance(img_a, img_b):
        a = torch.as_tensor(img_a, dtype=torch.float32).to(device)
        b = torch.as_tensor(img_b, dtype=torch.float32).to(device)
        d = torch.zeros((a.shape[0],), dtype=torch.float32, device=device)
        for ta, tb, lin in zip(features(a), features(b), lins):
            na = ta * torch.rsqrt(ta.square().sum(1, keepdim=True) + 1e-10)
            nb = tb * torch.rsqrt(tb.square().sum(1, keepdim=True) + 1e-10)
            # lpips: per-channel lin weights on squared diffs, spatial mean
            d = d + ((na - nb).square() * lin).sum(1).mean(dim=(1, 2))
        return d

    return distance


def make_pyramid_distance(levels: int = 4):
    """Fallback distance with no weights: L2 over a Laplacian pyramid,
    level-weighted so coarse structure counts like fine detail."""

    @torch.inference_mode()
    def distance(img_a, img_b):
        a = torch.as_tensor(img_a, dtype=torch.float32)
        b = torch.as_tensor(img_b, dtype=torch.float32).to(a.device)
        d = torch.zeros((a.shape[0],), dtype=torch.float32, device=a.device)
        for la, lb in zip(laplacian_pyramid(a, levels),
                          laplacian_pyramid(b, levels)):
            d = d + (la - lb).square().mean(dim=(1, 2, 3))
        return d / levels

    return distance


# ---------------------------------------------------------------------------
# PPL harness
# ---------------------------------------------------------------------------

def crop_and_resize(images: torch.Tensor) -> torch.Tensor:
    """Official PPL pipeline: center-crop the face region unconditionally
    (with cell = side//8: rows 3..7 cells, cols 2..6 cells), then
    area-downsample to 256 if still larger.  The official implementation
    crops at every resolution, so PPL numbers at <=256 stay comparable to
    published ones.  Only images smaller than 8 px skip the crop, which
    would be empty."""
    b, h, w, c = images.shape
    if h >= 8:
        ch, cw = h // 8, w // 8
        images = images[:, ch * 3: ch * 7, cw * 2: cw * 6, :]
        h, w = images.shape[1], images.shape[2]
    if h > 256:
        f = h // 256
        images = images.reshape(b, 256, f, w // f, f, c).mean(dim=(2, 4))
    return images


def draw_ppl_batch(generator, batch_size: int, seed: int, index: int,
                   sampling: str, n_classes: Optional[int] = None) -> dict:
    """The draws of batch `index`: z1, z2 (B, latent), t (B, 1), the noise
    maps of every layer (B, res, res, 1), and labels when `n_classes`; on
    the host, from (seed, index)."""
    from ..models.synthesis import layer_resolution, stream_seed
    cfg = generator.cfg
    g = torch.Generator().manual_seed(stream_seed(seed, 3, index))
    draws = {"z1": torch.randn((batch_size, cfg.latent_size), generator=g),
             "z2": torch.randn((batch_size, cfg.latent_size), generator=g)}
    draws["t"] = (torch.rand((batch_size, 1), generator=g)
                  if sampling == "full" else torch.zeros((batch_size, 1)))
    draws["noises"] = [
        torch.randn((batch_size, layer_resolution(i), layer_resolution(i), 1),
                    generator=g) for i in range(cfg.num_layers)]
    if n_classes is not None:
        draws["labels"] = torch.randint(0, n_classes, (batch_size,),
                                        generator=g)
    return draws


def ppl_samples(generator, distance_fn, *, num_samples: int, batch_size: int,
                seed: int = 0, space: str = "w", sampling: str = "full",
                labels=None, n_classes: Optional[int] = None,
                draws: Optional[Callable[[int], dict]] = None) -> np.ndarray:
    """Per-pair scaled perceptual distances (the PPL integrand).

    space 'z': slerp in latent Z, each endpoint through the whole generator.
    space 'w': lerp in W (broadcast to all layers), then the synthesis.
    Both eval-mode, no truncation or mixing, as the official metric.
    Both images of a pair share their noise maps.

    Conditional models: pass `labels` to pin every pair to fixed classes,
    or `n_classes` to sample labels per batch.  `draws(i)` pins batch i's
    draws (the keys of `draw_ppl_batch`); else they come from `seed`."""
    assert space in ("z", "w") and sampling in ("full", "end")
    assert labels is None or n_classes is None, \
        "pass fixed `labels` or `n_classes` to sample them, not both"
    cfg = generator.cfg
    device = next(generator.parameters()).device
    depth = cfg.synthesis.depth - 1
    eps = EPSILON

    @torch.inference_mode()
    def batch_distances(d):
        z1, z2, t = (d[k].to(device) for k in ("z1", "z2", "t"))
        noises = [n.to(device) for n in d["noises"]]
        labels_b = d.get("labels", labels)
        if labels_b is not None:
            labels_b = torch.as_tensor(labels_b, dtype=torch.long,
                                       device=device)
        if space == "z":
            za, zb = slerp(z1, z2, t), slerp(z1, z2, t + eps)
            ia = generator(za, depth=depth, alpha=1.0, train=False,
                           labels=labels_b, noises=noises).images
            ib = generator(zb, depth=depth, alpha=1.0, train=False,
                           labels=labels_b, noises=noises).images
        else:
            zin1, zin2 = z1, z2
            if cfg.conditional:
                from ..models.generator import embed_labels
                emb = embed_labels(generator.class_embedding.weight, labels_b)
                zin1 = torch.cat([z1, emb], dim=1)
                zin2 = torch.cat([z2, emb], dim=1)
            w1, w2 = generator.g_mapping(zin1), generator.g_mapping(zin2)
            if w1.ndim == 2:  # no broadcast configured: expand to all layers
                w1 = w1[:, None, :].expand(-1, cfg.num_layers, -1)
                w2 = w2[:, None, :].expand(-1, cfg.num_layers, -1)
            wa = lerp(w1, w2, t[:, :, None])
            wb = lerp(w1, w2, (t + eps)[:, :, None])
            ia = generator.g_synthesis(wa, depth=depth, alpha=1.0,
                                       noises=noises)
            ib = generator.g_synthesis(wb, depth=depth, alpha=1.0,
                                       noises=noises)
        ia, ib = crop_and_resize(ia), crop_and_resize(ib)
        return (distance_fn(ia, ib) * (1.0 / eps ** 2)).float().cpu().numpy()

    out = []
    for i in range((num_samples + batch_size - 1) // batch_size):
        d = (draws(i) if draws is not None else
             draw_ppl_batch(generator, batch_size, seed, i, sampling,
                            n_classes))
        out.append(batch_distances(d))
    return np.concatenate(out)[:num_samples]


def ppl_score(distances: np.ndarray) -> float:
    """Official reduction: mean after clipping away the lowest/highest 1%."""
    d = np.asarray(distances, np.float64)
    lo, hi = np.percentile(d, 1), np.percentile(d, 99)
    keep = d[(d >= lo) & (d <= hi)]
    return float(keep.mean()) if keep.size else float(d.mean())
