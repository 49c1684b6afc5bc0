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

Data parallelism (``mesh=``, a parallel.Mesh): every rank of the mesh runs
the step at once on its own shard of the global batch (reals, z, labels and
any pinned draws are the rank's rows), with the same seed and alpha and a
replicated TrainState.  The losses' batch means are the group's means and
R1 the group's sum (losses.py), so each rank's loss is the global-batch
loss; after each backward the gradients are averaged over the group (one
all-reduce per module and update: R1 differentiates twice through D, which
DistributedDataParallel's hooks do not follow, and the JAX step averages
explicitly after each update too), so G's clipping and both Adams see the
global gradient on every rank.  The W-average of each G forward is rank
0's (the global batch's first sample, as on one device), and the returned
losses are the group's mean.  With `shard_rng` (the default) rank r draws
its noise, mixing and GP interpolates from stream_seed(seed, SHARD_STREAM,
r), independent per rank as JAX's fold_in(key, axis_index) is; without
it every rank draws from `seed`.  Minibatch stddev is shard-local (groups
of min(4, local batch)) unless mbstd_scope='global', which takes it over
the group's global batch; `mbstd_chunks` is the one-process form of the
shard-local statistic.

Spatial parallelism (`build_spatial_train_step`, a parallel.Mesh2D): the
same step over a (data, spatial) grid of ranks, each image's rows split
over the spatial axis and the batch over the data axis; its docstring says
how its draws and gradients are taken.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import partial
from typing import Optional

import torch

from ..losses import (LOGISTIC_LIKE, NEEDS_KEY, get_loss, logistic_dis_loss,
                      r1_penalty)
from ..models.ema import ema_update
from ..models.generator import draw_mixing
from ..models.synthesis import layer_resolution, make_noise, stream_seed
from ..ops import avg_pool2d, upscale2d
from ..parallel.distributed import average_gradients, broadcast_, pmean
from ..parallel.halo import SpatialContext
from ..parallel.mesh import Mesh, Mesh2D
from .state import TrainState

GP_STREAM = 0x6B    # the gradient penalty's stream of a repeat's seed
SHARD_STREAM = 0x5D  # a rank's stream of the step's seed (shard_rng)


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


def _with_avg(generator, avg, mesh=None):
    """Store the truncation W-average a train-mode forward returned; under
    a mesh, rank 0's (each rank computes it from its own first sample)."""
    if avg is not None and hasattr(generator, "truncation"):
        with torch.no_grad():
            if mesh is not None:
                avg = avg.clone()
                broadcast_([avg], mesh)
            generator.truncation.avg_latent.copy_(avg)


def _check_mesh(mesh):
    if mesh is None:
        return
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh, got {type(mesh)}")
    if not mesh.is_member:
        raise ValueError("this rank is not in the mesh")


def _rank_seed(seed: int, mesh, shard_rng: bool) -> int:
    """The seed of this rank's draws."""
    if mesh is None or not shard_rng:
        return seed
    return stream_seed(seed, SHARD_STREAM, mesh.rank)


def _group_mean(losses: dict, mesh) -> dict:
    """The group's mean of the (detached) losses: one all-reduce."""
    if mesh is None:
        return losses
    with torch.no_grad():
        means = pmean(torch.stack(list(losses.values())), mesh)
    return dict(zip(losses, means.unbind()))


class _Phases:
    """The D update, the separate R1 update and the G update of one depth
    and loss, shared by build_train_step, build_d_step and build_g_step."""

    def __init__(self, dis_cfg, depth, loss, conditional, drift,
                 r1_gamma=None, r1_separate_reg=False, fuse_scores=False,
                 mesh=None, mbstd_scope=None, mbstd_chunks=1):
        _check_mesh(mesh)
        if mbstd_scope not in (None, "local", "global"):
            raise ValueError(f"mbstd_scope {mbstd_scope!r}")
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
        self.mesh = mesh            # the losses' means and the gradients'
        self.avg_mesh = mesh        # whose rank 0's W-average every rank takes
        self.spatial = None         # a SpatialContext: D's images are slabs
        self.mbstd_axis = mesh if mbstd_scope == "global" else None
        self.mbstd_chunks = mbstd_chunks
        # the fused real/fake pass, where no R1 pass would reuse D(reals),
        # and whose per-half stddev groups neither scope above changes
        in_loss_r1 = (loss in LOGISTIC_LIKE and not r1_separate_reg
                      and (r1_gamma is None or r1_gamma != 0.0))
        self.fuse = (fuse_scores and self.mbstd_axis is None
                     and mbstd_chunks == 1
                     and not (in_loss_r1 or self.reg_gamma is not None))

    def reals_at_depth(self, reals, alpha):
        return progressive_downsample(reals, self.dis_cfg.depth, self.depth,
                                      alpha, self.dis_cfg.structure)

    def dis_fn(self, discriminator, alpha, labels):
        depth = self.depth
        kw = {} if self.spatial is None else {"spatial": self.spatial}

        def fn(images):
            return discriminator(images, depth, alpha, labels,
                                 mbstd_chunks=self.mbstd_chunks,
                                 mbstd_axis=self.mbstd_axis, **kw)
        fn.spatial = self.spatial
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
        axis = self.mesh
        if self.loss in NEEDS_KEY:      # wgan-gp: the interpolates' draws
            gen = None
            if gp_eps is None:
                gen = torch.Generator(device=reals.device)
                gen.manual_seed(stream_seed(seed, GP_STREAM))
            return self.dis_loss_fn(dis_fn, reals, fakes, axis, generator=gen,
                                    eps=gp_eps, drift=self.drift)
        if self.loss == "wgan":
            return self.dis_loss_fn(dis_fn, reals, fakes, axis,
                                    drift=self.drift)
        return self.dis_loss_fn(dis_fn, reals, fakes, axis)

    def backward(self, loss, module):
        """loss.backward(), then the group's mean of `module`'s gradients."""
        loss.backward()
        if self.mesh is not None:
            average_gradients(module, self.mesh)

    def d_update(self, generator, discriminator, d_optimizer, reals_cur, z,
                 seed, alpha, labels, noises, mixing, gp_eps, fakes=None):
        """One D update; G's W-average is threaded back.  Returns the loss
        (detached).  `fakes` given (reuse_g_fwd) skips the G forward."""
        if fakes is None:
            with torch.no_grad():
                out = self.g_forward(generator, z, seed, alpha, labels,
                                     noises, mixing)
            fakes = out.images
            _with_avg(generator, out.avg_latent, self.avg_mesh)
        _zero_grads(discriminator)
        loss = self.dis_loss(self.dis_fn(discriminator, alpha, labels),
                             reals_cur, fakes, seed, gp_eps)
        self.backward(loss, discriminator)
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
        self.backward(r1_penalty(dis_fn, reals_cur, self.mesh)
                      * (self.reg_gamma * 0.5), discriminator)
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
                out.images, self.mesh)
            self.backward(loss, generator)
        g_optimizer.step()
        _with_avg(generator, out.avg_latent, self.avg_mesh)
        if shadow is not None:
            ema_update(shadow, generator, ema_decay)
        return _wide(loss)


def build_train_step(gen_cfg, dis_cfg, *, depth: int,
                     loss="relativistic-hinge", d_repeats: int = 1,
                     use_ema: bool = True, ema_decay: float = 0.999,
                     conditional: bool = False, drift: float = 0.001,
                     mesh=None, shard_rng: bool = True,
                     r1_gamma: Optional[float] = None,
                     r1_separate_reg: bool = False,
                     mbstd_scope: Optional[str] = None,
                     mbstd_chunks: int = 1,
                     fuse_scores: bool = False, reuse_g_fwd: bool = False):
    """Returns step(state, reals, z, seed, alpha, labels=None, *,
    noises=None, mixing=None, gp_eps=None) -> (state, metrics).  gen_cfg
    and dis_cfg as the JAX package's (the networks are the state's).

    reals: (B, R, R, C) at the *final* resolution (downsampled on the device
    to the depth's, like the reference); z: (B, latent); seed: int; alpha:
    float or 0-d tensor.  metrics: {"d_loss", "g_loss"}, 0-d tensors on the
    device (reading them waits for the step).  Under `mesh`, B is this
    rank's shard of the global batch (the module docstring).

    r1_gamma overrides the logistic loss's R1 coefficient (default 10);
    r1_separate_reg applies R1 as a separate Adam update after the D update
    (pair it with state.lazy_reg_adam_correction).  fuse_scores scores
    reals and fakes in one batch-2B D pass with minibatch-stddev groups
    chunked per half (the same math), where no R1 pass is active and the
    stddev scope is the plain one.
    reuse_g_fwd (d_repeats == 1) runs G's forward once: its detached images
    feed the D update, then the G loss through the updated D backpropagates
    through the same forward's graph; the D and G phases then share their
    noise and mixing draws (stream_seed(seed, 0)), and the forward sees the
    W-average before the D phase's update."""
    phases = _Phases(dis_cfg, depth, loss, conditional, drift, r1_gamma,
                     r1_separate_reg, fuse_scores, mesh, mbstd_scope,
                     mbstd_chunks)
    reuse = reuse_g_fwd and d_repeats == 1

    def step(state: TrainState, reals, z, seed: int, alpha, labels=None, *,
             noises=None, mixing=None, gp_eps=None):
        losses = _fused_update(
            phases, state, phases.reals_at_depth(reals, alpha), z,
            _rank_seed(seed, mesh, shard_rng), alpha, labels, noises, mixing,
            gp_eps, d_repeats, reuse, use_ema, ema_decay)
        return state, _group_mean(losses, mesh)

    return step


def _fused_update(phases, state, reals_cur, z, seed, alpha, labels, noises,
                  mixing, gp_eps, d_repeats, reuse, use_ema, ema_decay):
    """The D phase, the separate R1 update where there is one, and the G
    update with EMA, on the state in place; returns the two losses."""
    G, D = state.generator, state.discriminator
    shadow = state.g_shadow if use_ema else None
    if reuse:
        seed0 = stream_seed(seed, 0)
        out = phases.g_forward(G, z, seed0, alpha, labels, noises, mixing)
        d_loss = phases.d_update(G, D, state.d_optimizer, reals_cur, z,
                                 seed0, alpha, labels, noises, mixing,
                                 None if gp_eps is None else gp_eps[0],
                                 fakes=out.images.detach())
        if phases.reg_gamma is not None:
            phases.reg_update(D, state.d_optimizer, reals_cur, alpha, labels)
        g_loss = phases.g_update(G, D, state.g_optimizer, shadow, reals_cur,
                                 z, seed0, alpha, labels, noises, mixing,
                                 ema_decay, out=out)
    else:
        d_loss = phases.d_phase(G, D, state.d_optimizer, reals_cur, z, seed,
                                alpha, labels, noises, mixing, gp_eps,
                                d_repeats)
        if phases.reg_gamma is not None:  # StyleGAN2's order: D, then R1
            phases.reg_update(D, state.d_optimizer, reals_cur, alpha, labels)
        g_loss = phases.g_update(G, D, state.g_optimizer, shadow, reals_cur,
                                 z, stream_seed(seed, d_repeats), alpha,
                                 labels, noises, mixing, ema_decay)
    return {"d_loss": d_loss, "g_loss": g_loss}


class _SpatialPhases(_Phases):
    """_Phases on one rank of a (data, spatial) grid (build_spatial_train_
    step): this rank's batch shard and rows of each image; the losses'
    means over the data axis; D on slabs; each G forward's draws the
    one-process step's for the global batch, cut to the shard (and by the
    synthesis to the rows); gradients averaged over the grid."""

    def __init__(self, dis_cfg, depth, loss, conditional, drift, r1_gamma,
                 r1_separate_reg, mesh, mbstd_scope):
        data = mesh.data if mesh.shape[0] > 1 else None
        super().__init__(dis_cfg, depth, loss, conditional, drift, r1_gamma,
                         r1_separate_reg, mesh=data)
        # every rank takes the W of the global batch's first sample itself
        self.avg_mesh = None
        self.grid = mesh.grid
        self.shape = mesh.shape
        self.index = (mesh.data.rank, mesh.spatial.rank)
        self.row = mesh.spatial
        self.mbstd_axis = None if mbstd_scope == "local" else data

    def bind(self, device):
        """The row's SpatialContext on `device` (None for a row of one)."""
        if self.shape[1] > 1 and (self.spatial is None
                                  or self.spatial.rank.device != device):
            self.spatial = SpatialContext(
                self.shape[1], torch.tensor(self.index[1], device=device),
                self.row.group.group_name)

    def rows(self, t):
        """This rank's rows (dim 1) of a tensor of the whole height."""
        h = t.shape[1] // self.shape[1]
        return t[:, self.index[1] * h:(self.index[1] + 1) * h]

    def shard(self, t, b):
        """This rank's batch shard of a global-batch tensor (b rows)."""
        return t[self.index[0] * b:(self.index[0] + 1) * b]

    def g_forward(self, generator, z, seed, alpha, labels, noises, mixing):
        if self.conditional and labels is None:
            raise ValueError("a conditional step needs labels")
        cfg, b = generator.cfg, z.shape[0]
        batch = b * self.shape[0]
        if noises is None and cfg.synthesis.use_noise:
            noises = [self.shard(make_noise(seed, i, batch,
                                            layer_resolution(i), z.device,
                                            z.dtype), b)
                      for i in range(2 * (self.depth + 1))]
        if mixing is None and cfg.style_mixing_prob:
            latents2, cutoff = draw_mixing(
                seed, (batch, cfg.mapping.latent_size), self.depth,
                cfg.style_mixing_prob, z.device, z.dtype)
            mixing = (self.shard(latents2, b), cutoff)
        return generator(z, self.depth, alpha, seed=seed, train=True,
                         labels=labels, noises=noises, mixing=mixing,
                         spatial=self.spatial, avg_from=self.grid)

    def dis_loss(self, dis_fn, reals, fakes, seed, gp_eps):
        if self.loss in NEEDS_KEY and gp_eps is None:
            b = reals.shape[0]
            gen = torch.Generator(device=reals.device)
            gen.manual_seed(stream_seed(seed, GP_STREAM))
            gp_eps = self.shard(torch.rand(
                (b * self.shape[0],) + (1,) * (reals.ndim - 1), generator=gen,
                device=reals.device, dtype=reals.dtype), b)
        return super().dis_loss(dis_fn, reals, fakes, seed, gp_eps)

    def backward(self, loss, module):
        loss.backward()
        average_gradients(module, self.grid)


def build_spatial_train_step(gen_cfg, dis_cfg, *, depth: int, mesh,
                             loss="relativistic-hinge", d_repeats: int = 1,
                             use_ema: bool = True, ema_decay: float = 0.999,
                             conditional: bool = False, drift: float = 0.001,
                             r1_gamma: Optional[float] = None,
                             r1_separate_reg: bool = False,
                             mbstd_scope: Optional[str] = None,
                             reuse_g_fwd: bool = False):
    """The fused step over a 2-D (data, spatial) grid of ranks (the port's
    counterpart of the JAX package's build_gspmd_train_step): the same
    step(state, reals, z, seed, alpha, labels=None, *, noises=None,
    mixing=None, gp_eps=None) -> (state, metrics) as build_train_step's,
    run by every rank of `mesh` (a parallel.Mesh2D) at once with the same
    seed and alpha and a replicated TrainState.

    reals, z and labels are this rank's data row's shard of the global
    batch (the global batch / data ranks), reals at their whole height:
    the step takes the rank's rows of every image, and every stage of side
    res >= 4 * spatial runs on slabs of rows in G and in D (the shorter
    ones whole on every rank of the row).  Pinned draws are the shard's:
    noise maps whole or the rank's rows, mixing (latents2, cutoff), gp_eps
    (one (b, 1, 1, 1) tensor per D repeat).  Unpinned, the draws are the
    one-process step's for the global batch (seed is not folded with the
    rank), cut to the shard and rows, and the W-average comes from the
    global batch's first sample, as JAX's step is the one-device body.
    Minibatch-stddev groups span the global batch (the data axis's
    all-gather) unless mbstd_scope='local' (groups within each shard);
    fused scoring is off.  The losses are the global batch's on every
    rank.

    Gradients: every rank seeds its copy of the loss with 1, and every
    collective's backward is its transpose (parallel/halo.py), so a rank's
    gradient is the grid's size times its share: a tensor that every rank
    of a row holds whole (D's head, G's early stages, the styles) gets the
    whole row's gradient on each, a slab op's parameters the row's size
    times the slab's, and average_gradients over the grid gives the
    gradient of the global loss on every rank.  The inner gradient of R1
    and of the gradient penalty is a value, not a parameter gradient: it is
    seeded 1/spatial on each rank (losses.py), so that the gather's
    transpose gives each slab its true rows of dD/dx; seeded 1 it would
    scale the penalty by spatial^2.  The split epilogue's backward gives
    each rank its slab's share of dstyle and dnoise_weight.  Every
    collective under autograd is one that records its transpose: the
    functional collectives pass a gradient through unchanged."""
    if not isinstance(mesh, Mesh2D):
        names = getattr(mesh, "axis_names", (getattr(mesh, "axis_name",
                                                     None),))
        raise ValueError(f"gspmd mesh needs ('data', 'spatial') axes, got "
                         f"{tuple(names)}")
    if not mesh.is_member:
        raise ValueError("this rank is not in the mesh")
    res, n_sp = 2 ** (depth + 2), mesh.shape[1]
    if res % (n_sp * 4):
        raise ValueError(f"depth-{depth} resolution {res} must divide over "
                         f"{n_sp} spatial shards with at least 4 rows each")
    if mbstd_scope not in (None, "local", "global"):
        raise ValueError(f"mbstd_scope {mbstd_scope!r}")
    phases = _SpatialPhases(dis_cfg, depth, loss, conditional, drift,
                            r1_gamma, r1_separate_reg, mesh, mbstd_scope)
    reuse = reuse_g_fwd and d_repeats == 1

    def step(state: TrainState, reals, z, seed: int, alpha, labels=None, *,
             noises=None, mixing=None, gp_eps=None):
        phases.bind(reals.device)
        reals_cur = phases.rows(phases.reals_at_depth(reals, alpha))
        losses = _fused_update(phases, state, reals_cur, z, seed, alpha,
                               labels, noises, mixing, gp_eps, d_repeats,
                               reuse, use_ema, ema_decay)
        return state, losses

    return step


def build_d_step(gen_cfg, dis_cfg, *, depth: int, loss="relativistic-hinge",
                 d_repeats: int = 1, conditional: bool = False,
                 drift: float = 0.001, mesh=None):
    """The standalone D update (reference optimize_discriminator,
    GAN.py:591-622): step(generator, discriminator, d_optimizer, reals, z,
    seed, alpha, labels=None, *, noises=None, mixing=None, gp_eps=None) ->
    the mean loss; updates D and G's W-average in place.  Under `mesh`, as
    build_train_step's (each rank's draws its own)."""
    if isinstance(loss, tuple):
        loss = (loss[0], None)
    phases = _Phases(dis_cfg, depth, loss, conditional, drift, mesh=mesh)

    def step(generator, discriminator, d_optimizer, reals, z, seed: int,
             alpha, labels=None, *, noises=None, mixing=None, gp_eps=None):
        loss = phases.d_phase(generator, discriminator, d_optimizer,
                              phases.reals_at_depth(reals, alpha), z,
                              _rank_seed(seed, mesh, True), alpha, labels,
                              noises, mixing, gp_eps, d_repeats)
        return _group_mean({"loss": loss}, mesh)["loss"]

    return step


def build_g_step(gen_cfg, dis_cfg, *, depth: int, loss="relativistic-hinge",
                 use_ema: bool = True, ema_decay: float = 0.999,
                 conditional: bool = False, mesh=None):
    """The standalone G update (reference optimize_generator,
    GAN.py:624-659): step(generator, discriminator, g_optimizer, g_shadow,
    reals, z, seed, alpha, labels=None, *, noises=None, mixing=None) -> the
    loss; updates G, its W-average and (with use_ema) the shadow in
    place.  Under `mesh`, as build_train_step's."""
    if isinstance(loss, tuple):
        loss = (None, loss[1])
    phases = _Phases(dis_cfg, depth, loss, conditional, 0.0, mesh=mesh)

    def step(generator, discriminator, g_optimizer, g_shadow, reals, z,
             seed: int, alpha, labels=None, *, noises=None, mixing=None):
        reals_cur = phases.reals_at_depth(reals, alpha)
        loss = phases.g_update(generator, discriminator, g_optimizer,
                               g_shadow if use_ema else None, reals_cur, z,
                               _rank_seed(seed, mesh, True), alpha, labels,
                               noises, mixing, ema_decay)
        return _group_mean({"loss": loss}, mesh)["loss"]

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
