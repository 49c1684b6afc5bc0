"""Training entry point (the port's counterpart of ``train.py``).

    python -m stylegan_torch.cli.train --config configs/sample.yaml
        [--start_depth N] [--generator_file G.npz] [--gen_shadow_file S.npz]
        [--discriminator_file D.npz] [--gen_optim_file GO.npz]
        [--dis_optim_file DO.npz] [--resume STATE] [--device cpu]

The flags, the yaml configs, the refusal of an existing ``output_dir``, the
source snapshot into ``<output_dir>/src`` and the resume precedence are
``train.py``'s.  Checkpoints are the JAX package's ``.npz`` files, which
either trainer resumes from; the ``*_file`` flags also take the reference's
``.pth`` files.  Runs on CUDA unless ``--device cpu``.

Data parallelism: the JAX CLI drives up to N devices from one process, N
being ``--num_devices``, else the yaml's ``parallel.data_axis``, else every
visible device (``resolve_max_devices``).  PyTorch runs one process per
device instead, so N devices are N ranks, each on its own card:

* under ``torchrun --nproc_per_node N -m stylegan_torch.cli.train ...``
  each process joins torchrun's world, and the world is the device budget;
* otherwise, when N > 1, this command starts the N ranks itself (one
  process per card, over tcp://localhost) and waits for them, so the
  command line stays the JAX one.  Asking for more cards than are visible
  raises.  With ``--device cpu`` the ranks are gloo processes on the host,
  the counterpart of JAX's forced host devices, and N is 1 unless asked.

The trainer then sizes the group per depth (train/trainer.py).  Rank 0
alone makes ``output_dir`` and writes the log, checkpoints, grids and
metrics; the other ranks log warnings only.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# seconds a collective may wait: a rank outside a depth's smaller group
# waits through that whole depth in one
RANK_TIMEOUT = 30 * 24 * 3600


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description="StyleGAN on PyTorch/CUDA (the stylegan_torch port).")
    parser.add_argument("--config", default="./configs/sample.yaml")
    parser.add_argument("--start_depth", action="store", type=int, default=0,
                        help="Starting depth for training the network")
    parser.add_argument("--generator_file", action="store", type=str,
                        default=None, help="pretrained Generator file")
    parser.add_argument("--gen_shadow_file", action="store", type=str,
                        default=None, help="pretrained gen_shadow file")
    parser.add_argument("--discriminator_file", action="store", type=str,
                        default=None, help="pretrained Discriminator file")
    parser.add_argument("--gen_optim_file", action="store", type=str,
                        default=None, help="saved state of generator optimizer")
    parser.add_argument("--dis_optim_file", action="store", type=str,
                        default=None,
                        help="saved state of discriminator optimizer")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="limit the data-parallel group (ranks, one per "
                             "device)")
    parser.add_argument("--resume", type=str, default=None,
                        help="full train-state checkpoint (from "
                             "save_full_state) to restore G, D, EMA and both "
                             "optimizers in one shot")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def build_trainer(opt, device, num_devices=None):
    """The StyleGAN trainer of a merged config, as train.py builds it."""
    from stylegan_torch.config import resolve_fuse_scores, resolve_packed
    from stylegan_torch.train import StyleGAN
    return StyleGAN(structure=opt.structure,
                    conditional=opt.conditional,
                    n_classes=opt.n_classes,
                    resolution=opt.dataset.resolution,
                    num_channels=opt.dataset.channels,
                    latent_size=opt.model.gen.latent_size,
                    g_args=opt.model.gen,
                    d_args=opt.model.dis,
                    g_opt_args=opt.model.g_optim,
                    d_opt_args=opt.model.d_optim,
                    loss=opt.loss,
                    drift=opt.drift,
                    d_repeats=opt.d_repeats,
                    use_ema=opt.use_ema,
                    ema_decay=opt.ema_decay,
                    max_devices=num_devices,
                    seed=opt.seed,
                    activations_dtype=opt.precision.activations,
                    packed_layout=resolve_packed(opt),
                    fold_blur=opt.ops.fold_blur,
                    r1_interval=opt.r1_interval,
                    r1_gamma=opt.r1_gamma,
                    r1_separate_reg=opt.r1_separate_reg,
                    remat_blocks=opt.ops.remat,
                    spatial_devices=opt.parallel.spatial,
                    mbstd_scope=opt.mbstd_scope,
                    fuse_scores=resolve_fuse_scores(opt),
                    reuse_g_fwd=opt.ops.reuse_g_fwd,
                    device=device)


def _config(args):
    from stylegan_torch.config import get_default_cfg
    opt = get_default_cfg()
    opt.merge_from_file(args.config)
    opt.freeze()
    return opt


def main(args):
    """Train on this process's device, or start the ranks of a
    data-parallel run and wait for them (the module docstring)."""
    import torch

    from stylegan_torch import resolve_device
    from stylegan_torch.parallel import (initialize_distributed,
                                         resolve_max_devices, spawn)

    device = resolve_device(args.device)
    opt = _config(args)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        rank_device = initialize_distributed(device=args.device,
                                             timeout=RANK_TIMEOUT)
        try:
            _train(args, opt, rank_device)
        finally:
            torch.distributed.destroy_process_group()
        return
    n = resolve_max_devices(opt.parallel, args.num_devices, device)
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"{n} devices asked for, "
                         f"{torch.cuda.device_count()} visible")
    if n > 1:
        spawn(_rank_main, n, (args,), device=device.type,
              timeout=RANK_TIMEOUT)
    else:
        _train(args, opt, device)


def _rank_main(rank, device, args):
    _train(args, _config(args), device)


def _train(args, opt, device):
    import torch

    from stylegan_torch.config import apply_runtime_knobs, resolve_fuse_scores
    from stylegan_torch.parallel import (device_count, host_index,
                                         resolve_max_devices)
    from stylegan_torch.utils import make_logger, snapshot_sources

    output_dir = opt.output_dir
    if host_index() == 0:
        if os.path.exists(output_dir):
            raise FileExistsError(
                f"output_dir '{output_dir}' already exists — refusing to "
                "clobber a previous run (pick a new dir or remove it)")
        os.makedirs(output_dir)
        # snapshot sources + config for reproducibility
        snapshot_sources(REPO_ROOT, os.path.join(output_dir, "src"))
        shutil.copy2(args.config, output_dir)
        logger = make_logger("project", opt.output_dir, "log")
    else:
        logger = make_logger(f"project.rank{host_index()}", None, "log")
        logger.setLevel(logging.WARNING)
    max_devices = resolve_max_devices(opt.parallel, args.num_devices, device)
    if torch.distributed.is_initialized() and max_devices > device_count():
        raise ValueError(f"{max_devices} devices asked for, the world has "
                         f"{device_count()} ranks")
    logger.info("Training on %s, up to %d rank(s), per-depth adaptive data "
                "parallelism", device, max_devices)

    apply_runtime_knobs(opt)
    if opt.precision.activations == "bfloat16":
        logger.info("precision.activations bfloat16: bf16 activations in G "
                    "and D, float32 parameters, optimizer state and "
                    "statistics, TF32 for the float32 ops; fused real/fake "
                    "scoring %s", "on" if resolve_fuse_scores(opt) else "off")

    from stylegan_torch.data import make_dataset
    dataset = make_dataset(opt.dataset, conditional=opt.conditional)

    style_gan = build_trainer(opt, device, max_devices)

    start_depth = args.start_depth
    if args.resume is not None:
        logger.info("Restoring full train state from: %s", args.resume)
        meta = style_gan.restore_full_state(args.resume)
        if args.start_depth == 0 and meta.get("depth") is not None:
            start_depth = int(meta["depth"])
            logger.info("Resuming at depth %d (from checkpoint metadata)",
                        start_depth)

    # resume from checkpoints (partial loads — reference train.py:24-29)
    if args.generator_file is not None:
        logger.info("Restoring generator params <- %s", args.generator_file)
        style_gan.load_generator(args.generator_file)
    else:
        logger.info("No generator checkpoint given; starting with fresh "
                    "initialization.")
    if args.discriminator_file is not None:
        logger.info("Restoring discriminator params <- %s",
                    args.discriminator_file)
        style_gan.load_discriminator(args.discriminator_file)
    if args.gen_shadow_file is not None and opt.use_ema:
        logger.info("Restoring EMA shadow generator <- %s",
                    args.gen_shadow_file)
        style_gan.load_gen_shadow(args.gen_shadow_file)
    if args.gen_optim_file is not None:
        logger.info("Restoring generator optimizer state <- %s",
                    args.gen_optim_file)
        style_gan.load_gen_optim(args.gen_optim_file)
    if args.dis_optim_file is not None:
        logger.info("Restoring discriminator optimizer state <- %s",
                    args.dis_optim_file)
        style_gan.load_dis_optim(args.dis_optim_file)

    style_gan.train(dataset=dataset,
                    num_workers=opt.num_works,
                    epochs=opt.sched.epochs,
                    batch_sizes=opt.sched.batch_sizes,
                    fade_in_percentage=opt.sched.fade_in_percentage,
                    logger=logger,
                    output=output_dir,
                    num_samples=opt.num_samples,
                    start_depth=start_depth,
                    feedback_factor=opt.feedback_factor,
                    checkpoint_factor=opt.checkpoint_factor)


if __name__ == "__main__":
    main(parse_arguments())
