"""Progressive-growing trainer (the port's counterpart of
``stylegan_tpu/train/trainer.py``; reference StyleGAN wrapper,
GAN.py:447-826).

Host-side orchestration over the fused step (steps.py), which updates the
TrainState's modules and optimizers in place.  The progressive schedule
(per-depth epochs, batch sizes and fade-in) follows the reference and the
JAX package exactly: alpha ramps linearly over the first
``fade_in_percentage`` of a depth's batches (GAN.py:748-753), reals are
fade-blended on the device, feedback grids come from the EMA shadow
generator in train-mode sampling (GAN.py:786-793) at the cadence
``i % int(total_batches / feedback_factor + 1) == 0 or i == 1``, and
checkpoints are the JAX package's five ``.npz`` files per tag, written on
the same epochs (GAN.py:803-824).

Two deliberate differences from the JAX trainer:
* the throughput window restarts after the feedback grid is saved, so the
  next window's img/s does not include sampling and the PNG write;
* randomness is pinned, not matched: z comes from one ``torch.Generator`` on
  the device seeded from `seed`, each step's integer seed (noise, style
  mixing) from `seed` and the update count, the feedback latents from a
  CPU generator seeded 42 (the same z on the CPU and on the card).

Between feedback points the loop does not wait for the device: the losses
stay device tensors until a feedback point reads them.

``activations_dtype='bfloat16'`` is the JAX package's bf16 policy: reals
and z enter each fused step (train_on_batch) in bfloat16, G and D carry
bf16 activations (weights cast at apply time, norm and minibatch-stddev
statistics in float32), and the parameters, Adam's moments, the EMA shadow
and the checkpoints stay float32.  As in the JAX trainer, the feedback
samples and the split update API (optimize_discriminator /
optimize_generator) take float32 latents and reals.  The process's TF32
setting is ``config.apply_runtime_knobs``'s.

Data parallelism runs over ranks, one process per device
(parallel/distributed.py): `mesh` (a parallel.Mesh) fixes the group for
every step; `max_devices` sizes it per depth instead, the largest group of
at most max_devices ranks that the depth's global batch divides with a
whole minibatch-stddev group on every rank (`_mesh_for_batch`).  Every rank
runs `train` with the same arguments.  At a depth whose group is smaller
than the world, the ranks outside it skip the depth and wait at its end;
the state (modules, optimizers, the update count and the z stream) is
broadcast from rank 0 whenever a rank starts training under a new group,
so replicas are bitwise equal again when the group grows.  Each rank of
the group loads its own stripe of every epoch (shard_index = its rank in
the group, num_shards = the group's size, batch = global batch / size) and
draws the whole global z, keeping its rows.  Checkpoints, grids and
metrics.jsonl are written by rank 0 only.  ``packed_layout`` and
``fold_blur`` are accepted and give the unpacked math.

Spatial parallelism (the JAX trainer's 2-D mesh): with `spatial_devices`
and `max_devices`, a depth whose data group leaves ranks idle (the deep
progressive tail, whose batches of 4 and 2 cap the data axis) and whose
resolution divides by 4 * n trains on a (data, spatial) grid of ranks
(parallel.Mesh2D, `_mesh_for_step`) through build_spatial_train_step: each
data row loads its stripe of the epoch, and the ranks of a row split each
image's rows.  A fixed Mesh2D may be passed as `mesh`.  The split update
API (optimize_discriminator / optimize_generator) is data-parallel only,
as in the JAX trainer.  In one process there is one device, so
spatial_devices trains the one-process step, as the JAX trainer does on
one device.
"""

from __future__ import annotations

import datetime
import os
import time
from dataclasses import replace

import numpy as np
import torch

from .. import resolve_device
from ..convert import (load_discriminator_file, load_generator_file,
                       save_discriminator_file, save_generator_file)
from ..data import PinnedRing, device_prefetch, get_data_loader
from ..io import checkpoint as ckpt
from ..io.image import save_image_grid
from ..models import Discriminator, Generator
from ..models.configs import (discriminator_config_from_args,
                              generator_config_from_args)
from ..models.synthesis import stream_seed
from ..parallel.distributed import (broadcast_, global_shard, host_count,
                                    host_index, replicate)
from ..parallel.mesh import (Mesh, Mesh2D, compatible_mesh_size, create_mesh,
                             create_mesh_2d)
from ..utils.profiling import MetricsWriter, span
from .state import create_train_state, lazy_reg_adam_correction
from .steps import (build_d_step, build_g_step, build_sample_fn,
                    build_spatial_train_step, build_train_step)

# streams of `seed`: module init; the fused step of each update; the other
# draws (feedback samples, the split update API)
_INIT, _STEP, _DRAW = 0x49, 0x53, 0x44
_UNSET = object()   # no group yet (None is a group of one: this device)


class StyleGAN:
    """Generator+Discriminator training wrapper (API mirror of the JAX
    package's StyleGAN; `device` picks the card or, when asked, the CPU)."""

    def __init__(self, structure, resolution, num_channels, latent_size,
                 g_args, d_args, g_opt_args, d_opt_args, conditional=False,
                 n_classes=0, loss="relativistic-hinge", drift=0.001,
                 d_repeats=1, use_ema=False, ema_decay=0.999,
                 mesh=None, max_devices=None, seed=0,
                 activations_dtype="float32", packed_layout=False,
                 fold_blur="auto",
                 r1_interval=1, r1_gamma=10.0, r1_separate_reg=False,
                 remat_blocks=False,
                 spatial_devices=0, mbstd_scope=None, fuse_scores=False,
                 reuse_g_fwd=False, device=None):
        if structure not in ("fixed", "linear"):
            raise ValueError(f"unknown structure {structure!r}")
        if conditional and n_classes <= 0:
            raise ValueError("Conditional GANs require n_classes > 0")
        if mesh is not None and not isinstance(mesh, (Mesh, Mesh2D)):
            raise TypeError(f"mesh must be a parallel.Mesh or Mesh2D, got "
                            f"{type(mesh)}")
        if activations_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"activations_dtype {activations_dtype!r}")
        # minibatch-stddev scope: None = each step's natural (shard-local)
        # statistic; 'local' | 'global' pin one across every step
        if mbstd_scope not in (None, "auto", "local", "global"):
            raise ValueError(f"mbstd_scope {mbstd_scope!r}")
        self.mbstd_scope = None if mbstd_scope == "auto" else mbstd_scope
        self.mesh = mesh
        self.max_devices = max_devices
        self.spatial_devices = int(spatial_devices or 0)
        self.rank, self.world = host_index(), host_count()
        self._meshes = {}           # group size or grid shape -> mesh
        self._last_mesh = _UNSET     # the group the state was last placed on
        self._train_mesh = _UNSET    # the depth's group inside train()

        self.device = resolve_device(device)
        self.structure = structure
        self.depth = int(np.log2(resolution)) - 1
        self.latent_size = latent_size
        self.d_repeats = d_repeats
        self.conditional = conditional
        self.n_classes = n_classes
        self.use_ema = use_ema
        self.ema_decay = ema_decay
        self.seed = int(seed)
        # the dtype reals and z enter the step in; parameters stay float32
        self.activations_dtype = getattr(torch, activations_dtype)
        self.fuse_scores = bool(fuse_scores)
        self.reuse_g_fwd = bool(reuse_g_fwd)
        # a registry name, or a (dis_loss_fn, gen_loss_fn) pair
        self.loss_name = loss if isinstance(loss, (str, tuple)) \
            else "relativistic-hinge"
        self.drift = drift
        # lazy R1 (logistic losses only): the penalty every r1_interval
        # updates with gamma scaled by the interval; r1_separate_reg makes
        # it a separate Adam update with the N/(N+1) correction of D's Adam
        self.r1_interval = int(r1_interval)
        self.r1_gamma = float(r1_gamma)
        if self.r1_interval < 1:
            raise ValueError(
                f"r1_interval must be >= 1 (got {r1_interval}); R1 itself is "
                "part of the logistic loss — pick a different loss to "
                "disable it")
        logistic = self.loss_name in ("logistic", "conditional-logistic")
        if self.r1_interval > 1 and not logistic:
            raise ValueError("r1_interval > 1 requires the logistic loss")
        self.r1_separate_reg = bool(r1_separate_reg)
        if self.r1_separate_reg:
            if not logistic:
                raise ValueError("r1_separate_reg requires the logistic loss")
            d_opt_args = lazy_reg_adam_correction(dict(d_opt_args),
                                                  self.r1_interval)
        self._update_count = 0

        self.gen_cfg = generator_config_from_args(
            structure, resolution, num_channels, latent_size, conditional,
            n_classes, g_args)
        if self.gen_cfg.architecture != "stylegan1":
            raise ValueError(
                f"the trainer trains architecture 'stylegan1' only, got "
                f"{self.gen_cfg.architecture!r}: StyleGAN2 and StyleGAN3 "
                f"are served (serving.make_serving_fn), and training them "
                f"needs StyleGAN2's residual discriminator, path-length "
                f"regularisation and lazy R1, which the port does not have")
        self.dis_cfg = discriminator_config_from_args(
            structure, resolution, num_channels, conditional, n_classes,
            d_args)
        if remat_blocks:
            self.gen_cfg = replace(self.gen_cfg, synthesis=replace(
                self.gen_cfg.synthesis, remat=True))
            self.dis_cfg = replace(self.dis_cfg, remat=True)

        init = torch.Generator().manual_seed(stream_seed(self.seed, _INIT))
        gen = Generator(self.gen_cfg, generator=init).to(self.device)
        dis = Discriminator(self.dis_cfg, generator=init).to(self.device)
        self.state = create_train_state(gen, dis, dict(g_opt_args),
                                        dict(d_opt_args), use_ema=use_ema)
        self._z = torch.Generator(device=self.device).manual_seed(self.seed)
        self._draws = 0
        self._steps = {}        # step key -> step function
        self._sample_fns = {}   # depth -> sampler

    # ------------------------------------------------------------------
    def _mesh_for_batch(self, batch_size: int):
        """The fixed mesh if given; else the largest group of at most
        max_devices ranks that the global batch divides (None = one
        device).

        Minibatch-stddev groups are shard-local, so the group is also
        capped so that every rank holds at least one whole stddev group:
        batch 8 over 8 ranks would leave groups of 1, a constant stddev
        feature, and D would lose the reference's group = min(4, B)
        statistic (CustomLayers.py:294).  Creating a group is collective:
        every rank calls this with the same batch sizes in the same order."""
        if self.mesh is not None:
            return self.mesh
        if not self.max_devices or self.max_devices <= 1:
            return None
        group = max(1, int(self.dis_cfg.mbstd_group_size))
        cap = min(self.max_devices, max(1, batch_size // group))
        n = compatible_mesh_size(cap, [batch_size])
        if n <= 1:
            return None
        if n not in self._meshes:
            self._meshes[n] = create_mesh(n)
        return self._meshes[n]

    def _mesh_for_step(self, batch_size: int, depth: int):
        """The group of the fused step at this (global batch, depth): the
        data group of _mesh_for_batch, upgraded to a (data, spatial) grid
        when spatial_devices is set and the data axis leaves ranks idle
        (the deep progressive tail, where batches of 4 and 2 cap data
        parallelism): the most spatial ranks, at most spatial_devices and
        the idle ranks' count, that the resolution divides by 4 times.
        Collective where it creates groups, as _mesh_for_batch."""
        data_mesh = self._mesh_for_batch(batch_size)
        if (self.spatial_devices <= 1 or self.mesh is not None
                or not self.max_devices):
            return data_mesh
        data_n = data_mesh.size if data_mesh is not None else 1
        avail = min(self.max_devices, self.world)
        sp_n = min(self.spatial_devices, avail // data_n)
        res = 2 ** (depth + 2)
        while sp_n > 1 and res % (sp_n * 4) != 0:
            sp_n -= 1
        if sp_n <= 1:
            return data_mesh
        key = (data_n, sp_n)
        if key not in self._meshes:
            self._meshes[key] = create_mesh_2d(data_n, sp_n)
        return self._meshes[key]

    def _call_mesh(self, batch: int):
        """The mesh and global batch of a train_on_batch / optimize_* call:
        in one process `batch` is the global batch and the group adapts to
        it (one device: never a 2-D grid); across processes each rank
        passes its data row's shard, and the group is the fixed `mesh` (the
        JAX package asks the same of several hosts) or, inside `train`, the
        depth's group."""
        if self.world == 1:
            return self._mesh_for_batch(batch), batch
        mesh = self.mesh if self.mesh is not None else self._train_mesh
        if mesh is _UNSET:
            raise ValueError(
                "several processes: train_on_batch and optimize_* need a "
                "fixed mesh (StyleGAN(mesh=create_mesh())) outside train(), "
                "which sizes the group per depth")
        return mesh, batch * _data_size(mesh)

    def _ensure_placement(self, mesh):
        """Make this rank's state rank 0's when it starts training under a
        new group (the JAX trainer re-places its arrays on a mesh change):
        the modules, both optimizers, the update count and the z stream.
        Ranks that sat out a depth thereby catch up."""
        if self._last_mesh is mesh:
            return
        group = _whole_group(mesh)
        if group is not None:
            replicate(group, self.state)
            counters = torch.tensor([self._update_count, self._draws])
            z_state = self._z.get_state()
            broadcast_([counters, z_state], group)
            self._update_count, self._draws = map(int, counters.tolist())
            self._z.set_state(z_state)
        self._last_mesh = mesh

    def _rank0_says(self, flag: bool, mesh) -> bool:
        """Rank 0's `flag`, on every rank of `mesh` (None: as it is)."""
        group = _whole_group(mesh)
        if group is None:
            return flag
        t = torch.tensor([int(flag)])
        broadcast_([t], group)
        return bool(t.item())

    def _get_step(self, depth: int, with_r1: bool = True, mesh=None):
        """The fused step of (depth, group).  Under lazy R1 two exist per
        key: the regularized one (gamma * interval) and a gamma = 0 one
        with no double backward.  Keyed as the JAX trainer keys its
        programs (depth, mesh size or ("spatial", data, spatial), R1
        phase); a 2-D mesh takes build_spatial_train_step, without fused
        scoring."""
        lazy = self.r1_interval > 1
        spatial = isinstance(mesh, Mesh2D)
        mesh_key = (("spatial",) + tuple(mesh.shape) if spatial
                    else mesh.size if mesh is not None else 1)
        key = (depth, mesh_key, with_r1 if lazy else True)
        if key not in self._steps:
            r1_gamma = None
            if lazy:
                r1_gamma = self.r1_gamma * self.r1_interval if with_r1 else 0.0
            elif self.loss_name in ("logistic", "conditional-logistic") \
                    and self.r1_gamma != 10.0:
                r1_gamma = self.r1_gamma  # non-default gamma, every-step R1
            # separate-reg only on steps that carry the penalty
            separate = self.r1_separate_reg and (with_r1 or not lazy)
            if separate and r1_gamma is None:
                r1_gamma = self.r1_gamma
            common = dict(
                depth=depth, loss=self.loss_name, d_repeats=self.d_repeats,
                use_ema=self.use_ema, ema_decay=self.ema_decay,
                conditional=self.conditional, drift=self.drift, mesh=mesh,
                r1_gamma=r1_gamma, r1_separate_reg=separate,
                mbstd_scope=self.mbstd_scope, reuse_g_fwd=self.reuse_g_fwd)
            if spatial:
                self._steps[key] = build_spatial_train_step(
                    self.gen_cfg, self.dis_cfg, **common)
            else:
                self._steps[key] = build_train_step(
                    self.gen_cfg, self.dis_cfg, fuse_scores=self.fuse_scores,
                    **common)
        return self._steps[key]

    def _get_sample_fn(self, depth: int):
        if depth not in self._sample_fns:
            self._sample_fns[depth] = build_sample_fn(self.gen_cfg,
                                                      depth=depth)
        return self._sample_fns[depth]

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _labels(self, labels):
        return None if labels is None else self._tensor(labels, torch.long)

    def _draw_z(self, batch: int, dtype=None):
        """Latents from the trainer's stream, in the activations' dtype
        unless `dtype` is given."""
        return torch.randn((batch, self.latent_size), generator=self._z,
                           device=self.device,
                           dtype=dtype or self.activations_dtype)

    def _draw_seed(self) -> int:
        """A fresh integer seed per draw outside the fused step (the JAX
        trainer's _next_key)."""
        self._draws += 1
        return stream_seed(self.seed, _DRAW, self._draws)

    # ------------------------------------------------------------------
    # Reference-parity single-network update API (GAN.py:591-659)
    def optimize_discriminator(self, noise, real_batch, depth, alpha,
                               labels=None):
        mesh, _ = self._call_mesh(len(real_batch))
        _refuse_2d(mesh)
        self._ensure_placement(mesh)
        key = ("d", depth, mesh.size if mesh is not None else 1)
        if key not in self._steps:
            self._steps[key] = build_d_step(
                self.gen_cfg, self.dis_cfg, depth=depth, loss=self.loss_name,
                d_repeats=self.d_repeats, conditional=self.conditional,
                drift=self.drift, mesh=mesh)
        s = self.state
        loss = self._steps[key](
            s.generator, s.discriminator, s.d_optimizer,
            self._tensor(real_batch), self._tensor(noise), self._draw_seed(),
            float(alpha), self._labels(labels))
        return float(loss)

    def optimize_generator(self, noise, real_batch, depth, alpha,
                           labels=None):
        mesh, _ = self._call_mesh(len(real_batch))
        _refuse_2d(mesh)
        self._ensure_placement(mesh)
        key = ("g", depth, mesh.size if mesh is not None else 1)
        if key not in self._steps:
            self._steps[key] = build_g_step(
                self.gen_cfg, self.dis_cfg, depth=depth, loss=self.loss_name,
                use_ema=self.use_ema, ema_decay=self.ema_decay,
                conditional=self.conditional, mesh=mesh)
        s = self.state
        loss = self._steps[key](
            s.generator, s.discriminator, s.g_optimizer, s.g_shadow,
            self._tensor(real_batch), self._tensor(noise), self._draw_seed(),
            float(alpha), self._labels(labels))
        return float(loss)

    @staticmethod
    def create_grid(samples, scale_factor, img_file):
        """Save a sample grid (reference GAN.py:661-680)."""
        save_image_grid(adjust01(samples), img_file,
                        scale_factor=int(scale_factor))

    # ------------------------------------------------------------------
    def train_on_batch(self, images, depth, alpha, labels=None, fetch=True):
        """One fused D+G update on a batch of full-resolution reals (numpy,
        or a tensor, on any device).

        One process: `images` is the global batch.  Several processes
        (after parallel.initialize_distributed): `images` is this rank's
        shard of the global batch (global batch = shard * the mesh's size;
        on a 2-D mesh its data row's shard, at full height, and the shard
        times the data axis's size), under the fixed `mesh`, whose every
        rank calls this at once.

        fetch=False returns the two losses as device tensors and does not
        wait for the device: nothing here reads a device value, so steps
        queue back to back until the caller reads one."""
        with span("train.step"):
            mesh, global_batch = self._call_mesh(len(images))
            self._ensure_placement(mesh)
            with_r1 = (self._update_count % self.r1_interval) == 0
            self._update_count += 1
            step = self._get_step(depth, with_r1, mesh)
            with span("train.input"):
                reals = self._tensor(images, self.activations_dtype)
                # every rank draws the global z and keeps its rows: the z
                # streams stay equal, and the global z is the one-process run's
                z = self._draw_z(global_batch)
                if mesh is not None:
                    z = global_shard(_data_axis(mesh), z)
            # the update count, which a full-state resume restores, seeds the
            # step's noise and style mixing
            seed = stream_seed(self.seed, _STEP, self._update_count)
            _, metrics = step(self.state, reals, z, seed, float(alpha),
                              self._labels(labels))
            if not fetch:
                return metrics["d_loss"], metrics["g_loss"]
            return float(metrics["d_loss"]), float(metrics["g_loss"])

    def sample(self, depth, alpha, num_samples=None, z=None, labels=None,
               update_shadow_avg=True):
        """Feedback sampling through the EMA shadow generator, train-mode
        semantics like the reference (GAN.py:786-793); numpy NHWC."""
        fn = self._get_sample_fn(depth)
        shadow = self.state.g_shadow if self.use_ema else None
        module = shadow if shadow is not None else self.state.generator
        z = (self._draw_z(num_samples, torch.float32) if z is None
             else self._tensor(z))
        images, new_avg = fn(module, z, self._draw_seed(), float(alpha),
                             self._labels(labels))
        if update_shadow_avg and new_avg is not None and shadow is not None:
            with torch.no_grad():
                shadow.truncation.avg_latent.copy_(new_avg)
        return images.float().cpu().numpy()

    # ------------------------------------------------------------------
    def train(self, dataset, num_workers, epochs, batch_sizes,
              fade_in_percentage, logger, output, num_samples=36,
              start_depth=0, feedback_factor=100, checkpoint_factor=1):
        """Progressive training loop (reference GAN.py:682-826).  Across
        processes every rank calls it with the same arguments; batch sizes
        are global."""
        for name, sched in (("epochs", epochs), ("batch_sizes", batch_sizes),
                            ("fade_in_percentage", fade_in_percentage)):
            if self.depth > len(sched):
                raise ValueError(f"{name} not compatible with depth")
        if self.structure == "fixed":
            start_depth = self.depth - 1
        # a fixed mesh's data axis must split every depth's global batch (a
        # 2-D mesh's height handles the rest)
        data_n = _data_size(self.mesh)
        for d in range(start_depth, self.depth):
            if batch_sizes[d] % data_n:
                raise ValueError(
                    f"global batch {batch_sizes[d]} must divide evenly over "
                    f"the mesh's {data_n}-device data axis (adjust "
                    "sched.batch_sizes or the mesh, or use max_devices= for "
                    "adaptive meshes)")
        # every depth's group, created up front in the same order on every
        # rank (creating one is collective; a rank that sits out a depth
        # must not wait inside a creation)
        meshes = {d: self._mesh_for_step(batch_sizes[d], d)
                  for d in range(start_depth, self.depth)}

        writer = (MetricsWriter(os.path.join(output, "metrics.jsonl"))
                  if self.rank == 0 else None)
        abort_file = os.path.join(output, "abort.txt")
        fixed_input = torch.randn(
            (num_samples, self.latent_size),
            generator=torch.Generator().manual_seed(42)).to(self.device)
        fixed_labels = None
        if self.conditional:
            fixed_labels = np.linspace(
                0, self.n_classes - 1, num_samples).astype(np.int64)

        logger.info("Starting the training process ... \n")
        world = (Mesh(self.world, self.rank, torch.distributed.group.WORLD)
                 if self.world > 1 else None)
        clock = {"global": time.time(), "step": 1}
        try:
            for current_depth in range(start_depth, self.depth):
                mesh = meshes[current_depth]
                if mesh.is_member if mesh is not None else self.rank == 0:
                    self._train_mesh = mesh
                    stop = self._train_depth(
                        dataset, num_workers, current_depth, mesh,
                        batch_sizes[current_depth], epochs[current_depth],
                        fade_in_percentage[current_depth], logger, output,
                        writer, abort_file, fixed_input, fixed_labels,
                        feedback_factor, checkpoint_factor, clock)
                else:   # outside this depth's group: wait for its end
                    self._last_mesh, stop = _UNSET, False
                # rank 0's verdict reaches the ranks that sat it out
                if self._rank0_says(stop, world):
                    return
            logger.info("Training completed.\n")
        finally:
            self._train_mesh = _UNSET
            if writer is not None:
                writer.close()

    def _train_depth(self, dataset, num_workers, current_depth, mesh,
                     batch_size, n_epochs, fade_in, logger, output, writer,
                     abort_file, fixed_input, fixed_labels, feedback_factor,
                     checkpoint_factor, clock) -> bool:
        """One depth of `train` on this rank of `mesh` (or alone); True when
        abort.txt stopped the run."""
        current_res = 2 ** (current_depth + 2)
        logger.info("Currently working on depth: %d", current_depth + 1)
        logger.info("Current resolution: %d x %d", current_res, current_res)
        n = _data_size(mesh)
        ticker = 1
        if isinstance(mesh, Mesh2D):
            logger.info("Spatial grid: %d data x %d spatial ranks",
                        *mesh.shape)
        data = get_data_loader(dataset, batch_size // n, num_workers,
                               shard_index=_data_axis(mesh).rank if mesh
                               else 0, num_shards=n)
        ring = PinnedRing(self.device) if self.device.type == "cuda" else None
        window_t0 = time.perf_counter()
        window_imgs, window_steps = 0, 0
        for epoch in range(1, n_epochs + 1):
            start = time.time()
            logger.info("Epoch: [%d]", epoch)
            total_batches = len(data)
            fade_point = int((fade_in / 100) * n_epochs * total_batches)

            for i, batch in enumerate(
                    device_prefetch(iter(data), self.device, ring=ring), 1):
                alpha = ticker / fade_point if ticker <= fade_point else 1
                if self.conditional:
                    images, labels = batch
                else:
                    images, labels = batch, None
                dis_loss, gen_loss = self.train_on_batch(
                    images, current_depth, alpha, labels, fetch=False)
                window_imgs += batch_size
                window_steps += 1

                if i % int(total_batches / feedback_factor + 1) == 0 \
                        or i == 1:
                    # float() waits for every queued step, so window
                    # wall time over window images is the throughput
                    dis_loss, gen_loss = float(dis_loss), float(gen_loss)
                    now = time.perf_counter()
                    ips = (window_imgs / (now - window_t0)
                           if now > window_t0 and i > 1 else None)
                    step_time = ((now - window_t0) / max(1, window_steps)
                                 if i > 1 else None)
                    elapsed = str(datetime.timedelta(
                        seconds=time.time() - clock["global"])).split(".")[0]
                    logger.info(
                        "Elapsed: [%s] Step: %d  Batch: %d  "
                        "D_Loss: %f  G_Loss: %f  imgs/s: %s",
                        elapsed, clock["step"], i, dis_loss, gen_loss,
                        f"{ips:.1f}" if ips else "n/a")
                    # every rank samples: the shadow's W-average moves
                    samples = self.sample(current_depth, alpha,
                                          z=fixed_input, labels=fixed_labels)
                    if writer is not None:
                        writer.write(
                            step=clock["step"], depth=current_depth,
                            epoch=epoch, batch=i, alpha=float(alpha),
                            d_loss=dis_loss, g_loss=gen_loss,
                            step_time=step_time, imgs_per_sec=ips)
                        scale = (2 ** (self.depth - current_depth - 1)
                                 if self.structure == "linear" else 1)
                        save_image_grid(adjust01(samples), os.path.join(
                            output, "samples",
                            f"gen_{current_depth}_{epoch}_{i}.png"),
                            scale_factor=scale)
                    # the next window starts after the grid is written
                    window_t0 = time.perf_counter()
                    window_imgs, window_steps = 0, 0
                ticker += 1
                clock["step"] += 1

            elapsed = str(datetime.timedelta(
                seconds=time.time() - start)).split(".")[0]
            logger.info("Time taken for epoch: %s\n", elapsed)

            if self.rank == 0 and (epoch % checkpoint_factor == 0
                                   or epoch == 1 or epoch == n_epochs):
                self.save_checkpoints(output, current_depth, epoch, logger)

            # graceful stop: the reference's abort.txt polling
            # (dnnlib/submission/run_context.py:60-75), rank 0's reading
            if self._rank0_says(os.path.exists(abort_file), mesh):
                logger.info("abort.txt found — checkpointing and "
                            "stopping.\n")
                if self.rank == 0:
                    self.save_checkpoints(output, current_depth, epoch,
                                          logger)
                return True
        return False

    # ------------------------------------------------------------------
    def save_checkpoints(self, output, depth, epoch, logger=None):
        """The five files of a tag, in the JAX package's layout."""
        save_dir = os.path.join(output, "models")
        tag = f"{depth}_{epoch}"
        meta = {"depth": depth, "epoch": epoch}
        s = self.state

        def path(kind):
            return os.path.join(save_dir, f"GAN_{kind}_{tag}.npz")
        save_generator_file(s.generator, path("GEN"), meta)
        save_discriminator_file(s.discriminator, path("DIS"), meta)
        ckpt.save_optimizer_file(path("GEN_OPTIM"), s.g_optimizer,
                                 s.generator, meta)
        ckpt.save_optimizer_file(path("DIS_OPTIM"), s.d_optimizer,
                                 s.discriminator, meta)
        if self.use_ema and s.g_shadow is not None:
            save_generator_file(s.g_shadow, path("GEN_SHADOW"), meta)
        if logger:
            logger.info("Saved checkpoints to %s (tag %s)\n", save_dir, tag)

    def load_generator(self, path):
        load_generator_file(self.state.generator, path)

    def load_gen_shadow(self, path):
        if self.state.g_shadow is not None:
            load_generator_file(self.state.g_shadow, path)

    def load_discriminator(self, path):
        load_discriminator_file(self.state.discriminator, path)

    def load_gen_optim(self, path):
        """A JAX-layout .npz, or the reference's GAN_GEN_OPTIM_*.pth (torch
        Adam moments by reference index — reference train.py:40-48)."""
        self._load_optim(self.state.g_optimizer, self.state.generator, path)

    def load_dis_optim(self, path):
        self._load_optim(self.state.d_optimizer, self.state.discriminator,
                         path)

    @staticmethod
    def _load_optim(optimizer, module, path):
        if path.endswith(".pth"):
            from ..io.reference_optim import load_adam_state_file
            load_adam_state_file(optimizer, module, path)
        else:
            ckpt.load_optimizer_file(optimizer, module, path)

    # full-train-state checkpointing (one file instead of five)
    def save_full_state(self, path, depth, epoch):
        # update_count keeps the lazy-R1 phase across a resume
        ckpt.save_train_state(path, self.state,
                              {"depth": depth, "epoch": epoch,
                               "update_count": self._update_count})

    def restore_full_state(self, path) -> dict:
        """Restore a save_full_state checkpoint (the port's or the JAX
        package's npz); returns its metadata."""
        meta = ckpt.load_train_state(path, self.state)
        if meta.get("update_count") is not None:
            self._update_count = int(meta["update_count"])
        return meta


def _data_size(mesh) -> int:
    """The ranks along a mesh's data axis (1 for none)."""
    if isinstance(mesh, Mesh2D):
        return mesh.shape[0]
    return mesh.size if mesh is not None else 1


def _data_axis(mesh):
    """The 1-D group along a step mesh's data axis (a 2-D mesh's column
    of this rank)."""
    return mesh.data if isinstance(mesh, Mesh2D) else mesh


def _whole_group(mesh):
    """The 1-D group of every rank of a step's mesh (a 2-D mesh's grid)."""
    return mesh.grid if isinstance(mesh, Mesh2D) else mesh


def _refuse_2d(mesh):
    if isinstance(mesh, Mesh2D):
        raise NotImplementedError(
            "the split optimize_discriminator/optimize_generator API is "
            "data-parallel only; 2-D (data, spatial) meshes run through "
            "the fused train_on_batch")


def adjust01(samples) -> np.ndarray:
    """[-1,1] -> [0,1] for the grid writer."""
    return np.clip((np.asarray(samples) + 1.0) / 2.0, 0.0, 1.0)
