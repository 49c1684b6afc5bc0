"""The fused train step and its parts (the port's counterpart of
``stylegan_tpu/train/steps.py``, single device).

One step (reference GAN.py:557-659):

  reals' = progressive fade-in downsample                 (GAN.py:557-589)
  d_repeats x { fake = G(z) without grad; D loss; Adam }  (GAN.py:591-622)
  [R1 as a separate Adam update, when r1_separate_reg]
  G loss on the same z, fresh draws; clip(10) + Adam      (GAN.py:624-659)
  the truncation W-average threaded back after every G forward (GAN.py:278)
  EMA of G's parameters into the shadow

Reals and z may be bfloat16 (the bf16 activation path): the networks then
carry bf16 activations, R1 differentiates D with respect to the bf16 reals,
and the losses come back as float32 scalars; parameters, gradients and
Adam's state are float32 either way.

The modules and optimizers of the TrainState are updated in place.  Every
G forward's randomness (noise maps, style mixing, the GP interpolates) comes
from `seed` through `stream_seed`: repeat `rep` of the D phase draws from
stream_seed(seed, rep), the G phase from stream_seed(seed, d_repeats).  For
tests and cross-device checks the draws can be pinned instead: `noises=`
and `mixing=` go to every G forward (models/generator.py), `gp_eps=` (one
(B, 1, 1, 1) tensor per D repeat) to the gradient penalty.

Every parameter gets a gradient in each update, zero where none flows (a
from_rgb or to_rgb the depth does not use), as the JAX package's dense
gradient trees do, so that Adam's moments and step counts match it.

Data parallelism (``mesh=``, and with it the minibatch-stddev scope) is not
ported yet.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import partial
from typing import Optional

import torch

from ..losses import (LOGISTIC_LIKE, NEEDS_KEY, get_loss, logistic_dis_loss,
                      r1_penalty)
from ..models.ema import ema_update
from ..models.synthesis import stream_seed
from ..ops import avg_pool2d, upscale2d
from .state import TrainState

GP_STREAM = 0x6B    # the gradient penalty's stream of a repeat's seed


def progressive_downsample(reals: torch.Tensor, total_depth: int, depth: int,
                           alpha, structure: str) -> torch.Tensor:
    """Fade-in downsampling of real images (reference GAN.py:557-589):
    reals (NHWC, full resolution) at the depth's resolution, blended by
    alpha with a 2x nearest upsample of the half resolution."""
    if structure == "fixed":
        return reals
    factor = 2 ** (total_depth - depth - 1)
    ds = avg_pool2d(reals, factor) if factor > 1 else reals
    if depth > 0:
        prior = upscale2d(avg_pool2d(reals, factor * 2))
        # keep the blend in the activation dtype (alpha may be float32)
        return (alpha * ds + (1.0 - alpha) * prior).to(reals.dtype)
    return ds


def _zero_grads(module: torch.nn.Module):
    """Give every parameter a zeroed gradient (allocated where missing)."""
    grads = []
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            grads.append(p.grad)
    if grads:
        torch._foreach_zero_(grads)


@contextmanager
def _frozen(module: torch.nn.Module):
    """No parameter gradients for `module` inside (the G phase needs D's
    input gradient only)."""
    module.requires_grad_(False)
    try:
        yield
    finally:
        module.requires_grad_(True)


def _wide(loss: torch.Tensor) -> torch.Tensor:
    """The detached loss, at least float32 (a bf16 step's loss is read as
    float32)."""
    return loss.detach().to(torch.promote_types(loss.dtype, torch.float32))


def _with_avg(generator, avg):
    """Store the truncation W-average a train-mode forward returned."""
    if avg is not None and hasattr(generator, "truncation"):
        with torch.no_grad():
            generator.truncation.avg_latent.copy_(avg)


class _Phases:
    """The D update, the separate R1 update and the G update of one depth
    and loss, shared by build_train_step, build_d_step and build_g_step."""

    def __init__(self, dis_cfg, depth, loss, conditional, drift,
                 r1_gamma=None, r1_separate_reg=False, fuse_scores=False):
        # `loss` is a registry name or a (dis_loss_fn, gen_loss_fn) pair
        if isinstance(loss, tuple):
            dis_loss_fn, gen_loss_fn = loss
            loss = "custom"
        else:
            dis_loss_fn, gen_loss_fn = get_loss(loss, conditional)
        self.reg_gamma = None    # the separate-update R1 coefficient
        if r1_separate_reg or r1_gamma is not None:
            if loss not in LOGISTIC_LIKE:
                raise ValueError("r1_gamma and r1_separate_reg apply to the "
                                 "logistic losses only")
            gamma = 10.0 if r1_gamma is None else float(r1_gamma)
            if r1_separate_reg:
                self.reg_gamma = gamma if gamma != 0.0 else None
                gamma = 0.0
            dis_loss_fn = partial(logistic_dis_loss, r1_gamma=gamma)
        self.dis_cfg, self.depth = dis_cfg, depth
        self.loss, self.drift, self.conditional = loss, drift, conditional
        self.dis_loss_fn, self.gen_loss_fn = dis_loss_fn, gen_loss_fn
        # the fused real/fake pass, where no R1 pass would reuse D(reals)
        in_loss_r1 = (loss in LOGISTIC_LIKE and not r1_separate_reg
                      and (r1_gamma is None or r1_gamma != 0.0))
        self.fuse = fuse_scores and not (in_loss_r1
                                         or self.reg_gamma is not None)

    def reals_at_depth(self, reals, alpha):
        return progressive_downsample(reals, self.dis_cfg.depth, self.depth,
                                      alpha, self.dis_cfg.structure)

    def dis_fn(self, discriminator, alpha, labels):
        depth = self.depth

        def fn(images):
            return discriminator(images, depth, alpha, labels)
        if self.fuse:
            def score_pair(reals, fakes):
                b = reals.shape[0]
                lab = None if labels is None else torch.cat([labels, labels])
                s = discriminator(torch.cat([reals, fakes]), depth, alpha,
                                  lab, mbstd_chunks=2)
                return s[:b], s[b:]
            fn.score_pair = score_pair
        return fn

    def g_forward(self, generator, z, seed, alpha, labels, noises, mixing):
        if self.conditional and labels is None:
            raise ValueError("a conditional step needs labels")
        return generator(z, self.depth, alpha, seed=seed, train=True,
                         labels=labels, noises=noises, mixing=mixing)

    def dis_loss(self, dis_fn, reals, fakes, seed, gp_eps):
        if self.loss in NEEDS_KEY:      # wgan-gp: the interpolates' draws
            gen = None
            if gp_eps is None:
                gen = torch.Generator(device=reals.device)
                gen.manual_seed(stream_seed(seed, GP_STREAM))
            return self.dis_loss_fn(dis_fn, reals, fakes, generator=gen,
                                    eps=gp_eps, drift=self.drift)
        if self.loss == "wgan":
            return self.dis_loss_fn(dis_fn, reals, fakes, drift=self.drift)
        return self.dis_loss_fn(dis_fn, reals, fakes)

    def d_update(self, generator, discriminator, d_optimizer, reals_cur, z,
                 seed, alpha, labels, noises, mixing, gp_eps, fakes=None):
        """One D update; G's W-average is threaded back.  Returns the loss
        (detached).  `fakes` given (reuse_g_fwd) skips the G forward."""
        if fakes is None:
            with torch.no_grad():
                out = self.g_forward(generator, z, seed, alpha, labels,
                                     noises, mixing)
            fakes = out.images
            _with_avg(generator, out.avg_latent)
        _zero_grads(discriminator)
        loss = self.dis_loss(self.dis_fn(discriminator, alpha, labels),
                             reals_cur, fakes, seed, gp_eps)
        loss.backward()
        d_optimizer.step()
        return _wide(loss)

    def d_phase(self, generator, discriminator, d_optimizer, reals_cur, z,
                seed, alpha, labels, noises, mixing, gp_eps, d_repeats):
        """d_repeats D updates, repeat `rep` drawing from stream_seed(seed,
        rep) (or gp_eps[rep]); returns the mean loss."""
        total = 0.0
        for rep in range(d_repeats):
            total = total + self.d_update(
                generator, discriminator, d_optimizer, reals_cur, z,
                stream_seed(seed, rep), alpha, labels, noises, mixing,
                None if gp_eps is None else gp_eps[rep])
        return total / d_repeats

    def reg_update(self, discriminator, d_optimizer, reals_cur, alpha,
                   labels):
        """The separate R1 Adam update (StyleGAN2's lazy-regularization
        phase): the gradient of 0.5 * gamma * sum ||dD/dx||^2 alone, through
        the same optimizer (its hyperparameters corrected by the caller,
        state.lazy_reg_adam_correction)."""
        _zero_grads(discriminator)
        dis_fn = self.dis_fn(discriminator, alpha, labels)
        (r1_penalty(dis_fn, reals_cur) * (self.reg_gamma * 0.5)).backward()
        d_optimizer.step()

    def g_update(self, generator, discriminator, g_optimizer, shadow,
                 reals_cur, z, seed, alpha, labels, noises, mixing,
                 ema_decay, out=None):
        """One G update, then EMA into `shadow` (when given).  Returns the
        loss (detached).  `out` given (reuse_g_fwd) is the forward whose
        graph the loss's backward runs through."""
        with _frozen(discriminator):
            if out is None:
                out = self.g_forward(generator, z, seed, alpha, labels,
                                     noises, mixing)
            _zero_grads(generator)
            loss = self.gen_loss_fn(
                self.dis_fn(discriminator, alpha, labels), reals_cur,
                out.images)
            loss.backward()
        g_optimizer.step()
        _with_avg(generator, out.avg_latent)
        if shadow is not None:
            ema_update(shadow, generator, ema_decay)
        return _wide(loss)


def _refuse_parallel(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "the data-parallel train step (mesh=) is not ported yet")


def build_train_step(gen_cfg, dis_cfg, *, depth: int,
                     loss="relativistic-hinge", d_repeats: int = 1,
                     use_ema: bool = True, ema_decay: float = 0.999,
                     conditional: bool = False, drift: float = 0.001,
                     mesh=None, r1_gamma: Optional[float] = None,
                     r1_separate_reg: bool = False,
                     fuse_scores: bool = False, reuse_g_fwd: bool = False):
    """Returns step(state, reals, z, seed, alpha, labels=None, *,
    noises=None, mixing=None, gp_eps=None) -> (state, metrics).  gen_cfg
    and dis_cfg as the JAX package's (the networks are the state's).

    reals: (B, R, R, C) at the *final* resolution (downsampled on the device
    to the depth's, like the reference); z: (B, latent); seed: int; alpha:
    float or 0-d tensor.  metrics: {"d_loss", "g_loss"}, 0-d tensors on the
    device (reading them waits for the step).

    r1_gamma overrides the logistic loss's R1 coefficient (default 10);
    r1_separate_reg applies R1 as a separate Adam update after the D update
    (pair it with state.lazy_reg_adam_correction).  fuse_scores scores
    reals and fakes in one batch-2B D pass with minibatch-stddev groups
    chunked per half (the same math), where no R1 pass is active.
    reuse_g_fwd (d_repeats == 1) runs G's forward once: its detached images
    feed the D update, then the G loss through the updated D backpropagates
    through the same forward's graph; the D and G phases then share their
    noise and mixing draws (stream_seed(seed, 0)), and the forward sees the
    W-average before the D phase's update."""
    _refuse_parallel(mesh)
    phases = _Phases(dis_cfg, depth, loss, conditional, drift, r1_gamma,
                     r1_separate_reg, fuse_scores)
    reuse = reuse_g_fwd and d_repeats == 1

    def step(state: TrainState, reals, z, seed: int, alpha, labels=None, *,
             noises=None, mixing=None, gp_eps=None):
        G, D = state.generator, state.discriminator
        shadow = state.g_shadow if use_ema else None
        reals_cur = phases.reals_at_depth(reals, alpha)
        if reuse:
            seed0 = stream_seed(seed, 0)
            out = phases.g_forward(G, z, seed0, alpha, labels, noises,
                                   mixing)
            d_loss = phases.d_update(G, D, state.d_optimizer, reals_cur, z,
                                     seed0, alpha, labels, noises, mixing,
                                     None if gp_eps is None else gp_eps[0],
                                     fakes=out.images.detach())
            if phases.reg_gamma is not None:
                phases.reg_update(D, state.d_optimizer, reals_cur, alpha,
                                  labels)
            g_loss = phases.g_update(G, D, state.g_optimizer, shadow,
                                     reals_cur, z, seed0, alpha, labels,
                                     noises, mixing, ema_decay, out=out)
            return state, {"d_loss": d_loss, "g_loss": g_loss}
        d_loss = phases.d_phase(G, D, state.d_optimizer, reals_cur, z, seed,
                                alpha, labels, noises, mixing, gp_eps,
                                d_repeats)
        if phases.reg_gamma is not None:  # StyleGAN2's order: D, then R1
            phases.reg_update(D, state.d_optimizer, reals_cur, alpha, labels)
        g_loss = phases.g_update(G, D, state.g_optimizer, shadow, reals_cur,
                                 z, stream_seed(seed, d_repeats), alpha,
                                 labels, noises, mixing, ema_decay)
        return state, {"d_loss": d_loss, "g_loss": g_loss}

    return step


def build_d_step(gen_cfg, dis_cfg, *, depth: int, loss="relativistic-hinge",
                 d_repeats: int = 1, conditional: bool = False,
                 drift: float = 0.001, mesh=None):
    """The standalone D update (reference optimize_discriminator,
    GAN.py:591-622): step(generator, discriminator, d_optimizer, reals, z,
    seed, alpha, labels=None, *, noises=None, mixing=None, gp_eps=None) ->
    the mean loss; updates D and G's W-average in place."""
    _refuse_parallel(mesh)
    if isinstance(loss, tuple):
        loss = (loss[0], None)
    phases = _Phases(dis_cfg, depth, loss, conditional, drift)

    def step(generator, discriminator, d_optimizer, reals, z, seed: int,
             alpha, labels=None, *, noises=None, mixing=None, gp_eps=None):
        return phases.d_phase(generator, discriminator, d_optimizer,
                              phases.reals_at_depth(reals, alpha), z, seed,
                              alpha, labels, noises, mixing, gp_eps,
                              d_repeats)

    return step


def build_g_step(gen_cfg, dis_cfg, *, depth: int, loss="relativistic-hinge",
                 use_ema: bool = True, ema_decay: float = 0.999,
                 conditional: bool = False, mesh=None):
    """The standalone G update (reference optimize_generator,
    GAN.py:624-659): step(generator, discriminator, g_optimizer, g_shadow,
    reals, z, seed, alpha, labels=None, *, noises=None, mixing=None) -> the
    loss; updates G, its W-average and (with use_ema) the shadow in
    place."""
    _refuse_parallel(mesh)
    if isinstance(loss, tuple):
        loss = (None, loss[1])
    phases = _Phases(dis_cfg, depth, loss, conditional, 0.0)

    def step(generator, discriminator, g_optimizer, g_shadow, reals, z,
             seed: int, alpha, labels=None, *, noises=None, mixing=None):
        reals_cur = phases.reals_at_depth(reals, alpha)
        return phases.g_update(generator, discriminator, g_optimizer,
                               g_shadow if use_ema else None, reals_cur, z,
                               seed, alpha, labels, noises, mixing,
                               ema_decay)

    return step


def build_sample_fn(gen_cfg, *, depth: int, train_semantics: bool = True):
    """Sampling for feedback grids and the generate CLIs: fn(generator, z,
    seed, alpha, labels=None) -> (images, new W-average).  The reference
    samples with its modules in train mode (style mixing and truncation
    active, GAN.py:710-793); train_semantics=True does the same.  The
    W-average is returned, not stored."""
    def fn(generator, z, seed: int, alpha, labels=None):
        with torch.no_grad():
            out = generator(z, depth, alpha, seed=seed, train=train_semantics,
                            labels=labels)
        return out.images, out.avg_latent

    return fn
