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

Not ported yet, and refused: data parallelism (``mesh``, ``max_devices >
1``, ``spatial_devices > 1``, more than one process: ROADMAP queue 1,
parallelism).  ``packed_layout`` and ``fold_blur`` are accepted and give
the unpacked math.
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
from ..utils.profiling import MetricsWriter
from .state import create_train_state, lazy_reg_adam_correction
from .steps import (build_d_step, build_g_step, build_sample_fn,
                    build_train_step)

# streams of `seed`: module init; the fused step of each update; the other
# draws (feedback samples, the split update API)
_INIT, _STEP, _DRAW = 0x49, 0x53, 0x44


def _refuse_parallel(mesh, max_devices, spatial_devices):
    if mesh is not None or (max_devices or 1) > 1 \
            or (spatial_devices or 0) > 1:
        raise NotImplementedError(
            "data and spatial parallelism (mesh, max_devices > 1, "
            "spatial_devices > 1) are not ported yet (ROADMAP queue 1, "
            "parallelism)")
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "multi-process training is not ported yet (ROADMAP queue 1, "
            "parallelism)")


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
        _refuse_parallel(mesh, max_devices, spatial_devices)
        if activations_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"activations_dtype {activations_dtype!r}")
        # one device: a shard-local and a global minibatch-stddev agree
        if mbstd_scope not in (None, "auto", "local", "global"):
            raise ValueError(f"mbstd_scope {mbstd_scope!r}")

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
    def _get_step(self, depth: int, with_r1: bool = True):
        """The fused step of `depth`.  Under lazy R1 two exist per depth:
        the regularized one (gamma * interval) and a gamma = 0 one with no
        double backward.  Keyed as the JAX trainer keys its programs
        (depth, mesh size, R1 phase)."""
        lazy = self.r1_interval > 1
        key = (depth, 1, with_r1 if lazy else True)
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
            self._steps[key] = build_train_step(
                self.gen_cfg, self.dis_cfg, depth=depth, loss=self.loss_name,
                d_repeats=self.d_repeats, use_ema=self.use_ema,
                ema_decay=self.ema_decay, conditional=self.conditional,
                drift=self.drift, r1_gamma=r1_gamma,
                r1_separate_reg=separate, fuse_scores=self.fuse_scores,
                reuse_g_fwd=self.reuse_g_fwd)
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
        key = ("d", depth, 1)
        if key not in self._steps:
            self._steps[key] = build_d_step(
                self.gen_cfg, self.dis_cfg, depth=depth, loss=self.loss_name,
                d_repeats=self.d_repeats, conditional=self.conditional,
                drift=self.drift)
        s = self.state
        loss = self._steps[key](
            s.generator, s.discriminator, s.d_optimizer,
            self._tensor(real_batch), self._tensor(noise), self._draw_seed(),
            float(alpha), self._labels(labels))
        return float(loss)

    def optimize_generator(self, noise, real_batch, depth, alpha,
                           labels=None):
        key = ("g", depth, 1)
        if key not in self._steps:
            self._steps[key] = build_g_step(
                self.gen_cfg, self.dis_cfg, depth=depth, loss=self.loss_name,
                use_ema=self.use_ema, ema_decay=self.ema_decay,
                conditional=self.conditional)
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

        fetch=False returns the two losses as device tensors and does not
        wait for the device: nothing here reads a device value, so steps
        queue back to back until the caller reads one."""
        with_r1 = (self._update_count % self.r1_interval) == 0
        self._update_count += 1
        step = self._get_step(depth, with_r1)
        reals = self._tensor(images, self.activations_dtype)
        z = self._draw_z(reals.shape[0])
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
        """Progressive training loop (reference GAN.py:682-826)."""
        for name, sched in (("epochs", epochs), ("batch_sizes", batch_sizes),
                            ("fade_in_percentage", fade_in_percentage)):
            if self.depth > len(sched):
                raise ValueError(f"{name} not compatible with depth")

        metrics_writer = MetricsWriter(os.path.join(output, "metrics.jsonl"))
        window_t0 = time.perf_counter()
        window_imgs, window_steps = 0, 0
        abort_file = os.path.join(output, "abort.txt")

        global_time = time.time()
        fixed_input = torch.randn(
            (num_samples, self.latent_size),
            generator=torch.Generator().manual_seed(42)).to(self.device)
        fixed_labels = None
        if self.conditional:
            fixed_labels = np.linspace(
                0, self.n_classes - 1, num_samples).astype(np.int64)

        logger.info("Starting the training process ... \n")
        if self.structure == "fixed":
            start_depth = self.depth - 1
        step_count = 1
        for current_depth in range(start_depth, self.depth):
            current_res = 2 ** (current_depth + 2)
            logger.info("Currently working on depth: %d", current_depth + 1)
            logger.info("Current resolution: %d x %d", current_res, current_res)
            ticker = 1
            data = get_data_loader(dataset, batch_sizes[current_depth],
                                   num_workers)
            ring = (PinnedRing(self.device) if self.device.type == "cuda"
                    else None)
            for epoch in range(1, epochs[current_depth] + 1):
                start = time.time()
                logger.info("Epoch: [%d]", epoch)
                total_batches = len(data)
                fade_point = int((fade_in_percentage[current_depth] / 100)
                                 * epochs[current_depth] * total_batches)

                for i, batch in enumerate(
                        device_prefetch(iter(data), self.device, ring=ring),
                        1):
                    alpha = ticker / fade_point if ticker <= fade_point else 1
                    if self.conditional:
                        images, labels = batch
                    else:
                        images, labels = batch, None
                    dis_loss, gen_loss = self.train_on_batch(
                        images, current_depth, alpha, labels, fetch=False)
                    window_imgs += len(images)
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
                            seconds=time.time() - global_time)).split(".")[0]
                        logger.info(
                            "Elapsed: [%s] Step: %d  Batch: %d  "
                            "D_Loss: %f  G_Loss: %f  imgs/s: %s",
                            elapsed, step_count, i, dis_loss, gen_loss,
                            f"{ips:.1f}" if ips else "n/a")
                        metrics_writer.write(
                            step=step_count, depth=current_depth, epoch=epoch,
                            batch=i, alpha=float(alpha), d_loss=dis_loss,
                            g_loss=gen_loss,
                            step_time=step_time, imgs_per_sec=ips)
                        grid_file = os.path.join(
                            output, "samples",
                            f"gen_{current_depth}_{epoch}_{i}.png")
                        samples = self.sample(current_depth, alpha,
                                              z=fixed_input,
                                              labels=fixed_labels)
                        scale = (2 ** (self.depth - current_depth - 1)
                                 if self.structure == "linear" else 1)
                        save_image_grid(
                            adjust01(samples), grid_file, scale_factor=scale)
                        # the next window starts after the grid is written
                        window_t0 = time.perf_counter()
                        window_imgs, window_steps = 0, 0
                    ticker += 1
                    step_count += 1

                elapsed = str(datetime.timedelta(
                    seconds=time.time() - start)).split(".")[0]
                logger.info("Time taken for epoch: %s\n", elapsed)

                if epoch % checkpoint_factor == 0 or epoch == 1 \
                        or epoch == epochs[current_depth]:
                    self.save_checkpoints(output, current_depth, epoch, logger)

                # graceful stop: the reference's abort.txt polling
                # (dnnlib/submission/run_context.py:60-75)
                if os.path.exists(abort_file):
                    logger.info("abort.txt found — checkpointing and "
                                "stopping.\n")
                    self.save_checkpoints(output, current_depth, epoch, logger)
                    metrics_writer.close()
                    return
        metrics_writer.close()
        logger.info("Training completed.\n")

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


def adjust01(samples) -> np.ndarray:
    """[-1,1] -> [0,1] for the grid writer."""
    return np.clip((np.asarray(samples) + 1.0) / 2.0, 0.0, 1.0)
