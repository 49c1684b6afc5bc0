"""The numbers that decide `correct`, each held to its limit.

Serving: ``image_gap``, the widest gap between a served pixel and the
reference's, over every image of the sampled requests, as a share of the
reference images' largest magnitude; ``image_rms_gap``, the RMS of the
difference over the reference's RMS, the worst request's.

Training (the first three updates, which the reference follows):
``loss_gap``, the widest gap between a step's loss and the reference's,
relative to the reference's; ``grad_gap``, over the leaves of G and D,
the gap between the norm of the gradient the optimizer took on the first
update and the reference's; ``change_gap``, over the leaves of G, D and
G's shadow, the gap between the norm of a leaf's change after three
updates and the reference's.  A leaf's gap is measured against the
reference's norm of that leaf or of the network's median leaf, whichever
is larger.  Leaves whose first gradient in the reference is under a
thousandth of the median leaf's do not count for the change: Adam moves
them by round-off alone.
"""

from __future__ import annotations

import statistics

import torch

NEGLIGIBLE = 1e-3


def norms(tensors: dict) -> dict:
    """{name: float norm} in one transfer."""
    names = list(tensors)
    if not names:
        return {}
    v = torch.stack([torch.linalg.vector_norm(tensors[k].float())
                     for k in names]).tolist()
    return dict(zip(names, v))


def change_norms(now: dict, start: dict) -> dict:
    return norms({k: now[k].detach().float() - start[k].float()
                  for k in now})


def leaf_gaps(got: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |got - ref| over max(ref, the median of ref)."""
    med = statistics.median(ref.values())
    out = {}
    for k, r in ref.items():
        if keep is None or k in keep:
            gap = abs(got[k] - r) / max(r, med, 1e-30)
            out[k] = gap if gap == gap else float("inf")
    return out


def counted(ref_grads: dict) -> set:
    med = statistics.median(ref_grads.values())
    return {k for k, v in ref_grads.items() if v >= NEGLIGIBLE * med}


def _rel(p, r):
    gap = abs(p - r) / max(abs(r), 1e-30)
    return gap if gap == gap else float("inf")


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog and ref: {"losses": [(d, g) per step], "grads": {"g": norms,
    "d": norms}, "change": {"g", "d", "shadow": norms}}.  Besides the
    worst gaps: the first update's two losses, D's and G's first gradient
    apart, by the worst and by the median leaf, and the median leaf's
    change, steadier readings of the same quantities (names of the worst
    leaves too)."""
    losses = [[_rel(p, r) for p, r in zip(ps, rs)]
              for ps, rs in zip(prog["losses"], ref["losses"])]
    grads = {n: leaf_gaps(prog["grads"][n], ref["grads"][n])
             for n in ("g", "d")}
    change = {n: leaf_gaps(prog["change"][n], ref["change"][n],
                           counted(ref["grads"]["g" if n == "shadow"
                                             else n]))
              for n in ("g", "d", "shadow")}
    every = {f"{n}.{k}": v for n, c in change.items() for k, v in c.items()}
    return {"loss_gap": max(max(x) for x in losses),
            "d_loss1_gap": losses[0][0],
            "g_loss1_gap": losses[0][1],
            "grad_gap": max(max(g.values()) for g in grads.values()),
            "grad_d_gap": max(grads["d"].values()),
            "grad_g_gap": max(grads["g"].values()),
            "grad_d_median_gap": statistics.median(grads["d"].values()),
            "grad_g_median_gap": statistics.median(grads["g"].values()),
            "change_gap": max(every.values()),
            "change_median_gap": max(statistics.median(c.values())
                                     for c in change.values()),
            "grad_worst": max(((v, f"{n}.{k}") for n, g in grads.items()
                               for k, v in g.items()))[1],
            "change_worst": max(every, key=every.get),
            "losses": [[round(x, 6) for x in step] for step in losses]}


def image_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    g = (got.float() - ref.float()).abs().max()
    gap = float(g / ref.float().abs().max().clamp_min(1e-30))
    return gap if gap == gap else float("inf")


def image_rms_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The RMS of the difference over the reference's RMS."""
    d = torch.linalg.vector_norm(got.float() - ref.float())
    gap = float(d / torch.linalg.vector_norm(ref.float()).clamp_min(1e-30))
    return gap if gap == gap else float("inf")


def serve_numbers(got: list, ref: list) -> dict:
    """The widest and the RMS gap over the sampled requests' images."""
    return {"image_gap": max(image_gap(a, b) for a, b in zip(got, ref)),
            "image_rms_gap": max(image_rms_gap(a, b)
                                 for a, b in zip(got, ref))}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict, dict]:
    """(every number with a limit within it, {name: {value, limit}} of
    those, {name: value} of the numbers read but not compared).  A limit
    without its number fails, and so does a cell with no limit."""
    checks, ok = {}, bool(limits)
    for k, lim in sorted(limits.items()):
        v = numbers.get(k)
        checks[k] = {"value": v, "limit": lim}
        ok = ok and v is not None and lim is not None and v <= lim
    return ok, checks, {k: v for k, v in numbers.items() if k not in limits}
