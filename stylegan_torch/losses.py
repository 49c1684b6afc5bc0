"""GAN loss functions (reference models/Losses.py; the port's counterpart of
``stylegan_tpu/losses.py``).

Each loss is a pair ``dis_loss`` / ``gen_loss`` taking a ``dis_fn(images) ->
scores`` closure (the discriminator with depth, alpha and labels bound).
The R1 penalty and the gradient penalty take the gradient of D's scores
w.r.t. its input with ``create_graph=True``, so that the loss's own backward
runs through it (a double backward through D).

Formulas (held against the JAX package in tests/test_torch_losses.py):
  StandardGAN                 Losses.py:96-133  (BCE-with-logits vs 1/0)
  HingeGAN                    Losses.py:136-151
  RelativisticAverageHingeGAN Losses.py:154-189 (the reference's default)
  LogisticGAN (+R1, gamma=10) Losses.py:192-229
  ConditionalGANLoss          Losses.py:54-89   (BCE, labels routed to D)
  wgan, wgan-gp               the ProGAN formulation the reference names
                              but leaves out (GAN.py:464-470, 517)

Data-parallel exactness: every loss takes ``axis_name``, a parallel.Mesh
(the JAX package names a mesh axis; torch passes the group).  Given one,
each batch mean is the group's mean of the shards' means (JAX's pmean) and
the R1 penalty the group's sum (psum), so every rank computes the
global-batch loss; parallel/distributed.py says how its gradient is taken.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .parallel.distributed import pmean, psum


def _mean(x, axis_name=None):
    m = torch.mean(x)
    return m if axis_name is None else pmean(m, axis_name)


def _bce_with_logits(logits, target: float, axis_name=None):
    # mean(softplus(x) - x * t) == BCEWithLogitsLoss
    return _mean(F.softplus(logits) - logits * target, axis_name)


def _score_pair(dis_fn, reals, fakes):
    """Scores for reals and fakes: two D passes, or the one batch-2B pass of
    `dis_fn.score_pair` where the train step attached it (its minibatch-
    stddev groups are chunked per half, so the math is the two passes')."""
    pair = getattr(dis_fn, "score_pair", None)
    if pair is not None:
        return pair(reals, fakes)
    return dis_fn(reals), dis_fn(fakes)


# ---------------------------------------------------------------- standard --

def standard_dis_loss(dis_fn, reals, fakes, axis_name=None):
    r, f = _score_pair(dis_fn, reals, fakes)
    r, f = torch.squeeze(r), torch.squeeze(f)
    return (_bce_with_logits(r, 1.0, axis_name)
            + _bce_with_logits(f, 0.0, axis_name)) / 2


def standard_gen_loss(dis_fn, reals, fakes, axis_name=None):
    # the intended math of the reference's StandardGAN.gen_loss, whose
    # tuple unpacking (Losses.py:131) would crash
    return _bce_with_logits(torch.squeeze(dis_fn(fakes)), 1.0, axis_name)


# ------------------------------------------------------------------- hinge --

def hinge_dis_loss(dis_fn, reals, fakes, axis_name=None):
    r, f = _score_pair(dis_fn, reals, fakes)
    return _mean(F.relu(1.0 - r), axis_name) + _mean(F.relu(1.0 + f),
                                                     axis_name)


def hinge_gen_loss(dis_fn, reals, fakes, axis_name=None):
    return -_mean(dis_fn(fakes), axis_name)


# ------------------------------------------------------ relativistic-hinge --

def relativistic_hinge_dis_loss(dis_fn, reals, fakes, axis_name=None):
    r, f = _score_pair(dis_fn, reals, fakes)
    r_f_diff = r - _mean(f, axis_name)
    f_r_diff = f - _mean(r, axis_name)
    return (_mean(F.relu(1.0 - r_f_diff), axis_name)
            + _mean(F.relu(1.0 + f_r_diff), axis_name))


def relativistic_hinge_gen_loss(dis_fn, reals, fakes, axis_name=None):
    r, f = _score_pair(dis_fn, reals, fakes)
    r_f_diff = r - _mean(f, axis_name)
    f_r_diff = f - _mean(r, axis_name)
    return (_mean(F.relu(1.0 + r_f_diff), axis_name)
            + _mean(F.relu(1.0 - f_r_diff), axis_name))


# ---------------------------------------------------------- logistic + R1 --

def _input_grad(dis_fn, x):
    """d sum(D(x)) / dx, kept differentiable (create_graph) so that the
    penalty's backward reaches D's parameters."""
    x = x.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(dis_fn(x).sum(), x, create_graph=True)
    return grad


def r1_penalty(dis_fn, reals, axis_name=None):
    """Sum over batch and pixels of ||dD(x)/dx||^2 (Losses.py:197-211):
    the reference *sums* over the batch, and so does this (over the
    group's global batch, given `axis_name`)."""
    pen = _input_grad(dis_fn, reals).square().sum()
    return pen if axis_name is None else psum(pen, axis_name)


def logistic_dis_loss(dis_fn, reals, fakes, axis_name=None,
                      r1_gamma: float = 10.0):
    r, f = _score_pair(dis_fn, reals, fakes)
    loss = _mean(F.softplus(f), axis_name) + _mean(F.softplus(-r), axis_name)
    if r1_gamma != 0.0:
        loss = loss + r1_penalty(dis_fn, reals, axis_name) * (r1_gamma * 0.5)
    return loss


def logistic_gen_loss(dis_fn, reals, fakes, axis_name=None):
    return _mean(F.softplus(-dis_fn(fakes)), axis_name)


# ----------------------------------------------------------- wgan, wgan-gp --

def wgan_dis_loss(dis_fn, reals, fakes, axis_name=None, drift: float = 0.001):
    r, f = _score_pair(dis_fn, reals, fakes)
    return (_mean(f, axis_name) - _mean(r, axis_name)
            + drift * _mean(r.square(), axis_name))


def wgan_gen_loss(dis_fn, reals, fakes, axis_name=None):
    return -_mean(dis_fn(fakes), axis_name)


def gradient_penalty(dis_fn, reals, fakes,
                     generator: Optional[torch.Generator] = None,
                     eps: Optional[torch.Tensor] = None, axis_name=None):
    """mean((||dD/dx_hat||_2 - 1)^2) over per-sample interpolates x_hat =
    eps * reals + (1 - eps) * fakes, eps ~ U[0, 1) of shape (B, 1, 1, 1):
    drawn from `generator`, or given as `eps`."""
    b = reals.shape[0]
    if eps is None:
        eps = torch.rand((b,) + (1,) * (reals.ndim - 1), generator=generator,
                         device=reals.device, dtype=reals.dtype)
    merged = (eps * reals + (1.0 - eps) * fakes).detach()
    grads = _input_grad(dis_fn, merged)
    norms = torch.sqrt(grads.reshape(b, -1).square().sum(dim=1) + 1e-12)
    return _mean(torch.square(norms - 1.0), axis_name)


def wgan_gp_dis_loss(dis_fn, reals, fakes, axis_name=None, generator=None,
                     eps=None, drift: float = 0.001, gp_lambda: float = 10.0):
    if generator is None and eps is None:
        raise ValueError("wgan-gp needs a torch.Generator or eps= for the "
                         "interpolates")
    loss = wgan_dis_loss(dis_fn, reals, fakes, axis_name, drift)
    return loss + gp_lambda * gradient_penalty(dis_fn, reals, fakes,
                                               generator, eps, axis_name)


def wgan_gp_gen_loss(dis_fn, reals, fakes, axis_name=None):
    return -_mean(dis_fn(fakes), axis_name)


# ------------------------------------------------------------- conditional --

def conditional_dis_loss(dis_fn, reals, fakes, axis_name=None):
    # dis_fn already closes over the labels
    return standard_dis_loss(dis_fn, reals, fakes, axis_name)


def conditional_gen_loss(dis_fn, reals, fakes, axis_name=None):
    return _bce_with_logits(torch.squeeze(dis_fn(fakes)), 1.0, axis_name)


# ------------------------------------------ registry (GAN.py:535-555 names) --

LOSSES = {
    "standard-gan": (standard_dis_loss, standard_gen_loss),
    "hinge": (hinge_dis_loss, hinge_gen_loss),
    "relativistic-hinge": (relativistic_hinge_dis_loss,
                           relativistic_hinge_gen_loss),
    "logistic": (logistic_dis_loss, logistic_gen_loss),
    "wgan": (wgan_dis_loss, wgan_gen_loss),
    "wgan-gp": (wgan_gp_dis_loss, wgan_gp_gen_loss),
    "conditional-loss": (conditional_dis_loss, conditional_gen_loss),
    # the stronger unconditional objectives on label-aware scores
    "conditional-relativistic-hinge": (relativistic_hinge_dis_loss,
                                       relativistic_hinge_gen_loss),
    "conditional-logistic": (logistic_dis_loss, logistic_gen_loss),
}

# losses whose dis_loss draws random numbers (the GP interpolates)
NEEDS_KEY = {"wgan-gp"}

# losses that ARE the logistic objective (the R1 knobs apply to these)
LOGISTIC_LIKE = ("logistic", "conditional-logistic")

CONDITIONAL_LOSSES = ("conditional-loss", "conditional-relativistic-hinge",
                      "conditional-logistic")
UNCONDITIONAL_LOSSES = ("logistic", "hinge", "standard-gan",
                        "relativistic-hinge", "wgan", "wgan-gp")


def get_loss(name: str, conditional: bool = False):
    """(dis_loss, gen_loss) of a registry name; conditional models take the
    conditional names, the others the rest."""
    name = name.lower()
    allowed = CONDITIONAL_LOSSES if conditional else UNCONDITIONAL_LOSSES
    if name not in allowed:
        kind = "conditional " if conditional else ""
        raise ValueError(f"Unknown {kind}loss {name}")
    return LOSSES[name]
