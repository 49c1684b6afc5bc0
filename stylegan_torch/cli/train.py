"""Training entry point (the port's counterpart of ``train.py``).

    python -m stylegan_torch.cli.train --config configs/sample.yaml
        [--start_depth N] [--generator_file G.npz] [--gen_shadow_file S.npz]
        [--discriminator_file D.npz] [--gen_optim_file GO.npz]
        [--dis_optim_file DO.npz] [--resume STATE] [--device cpu]

The flags, the yaml configs, the refusal of an existing ``output_dir``, the
source snapshot into ``<output_dir>/src`` and the resume precedence are
``train.py``'s.  Checkpoints are the JAX package's ``.npz`` files, which
either trainer resumes from; the ``*_file`` flags also take the reference's
``.pth`` files.  Runs on CUDA unless ``--device cpu``; one device only
(``--num_devices`` above 1 raises until the port's parallel slice).
"""

from __future__ import annotations

import argparse
import os
import shutil

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


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
                        help="devices to train on (not yet ported: at most 1)")
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


def main(args):
    from stylegan_torch import resolve_device
    from stylegan_torch.config import (apply_runtime_knobs, get_default_cfg,
                                       resolve_fuse_scores)

    if (args.num_devices or 1) > 1:
        raise NotImplementedError(
            "--num_devices > 1 arrives with the port's parallel slice "
            "(ROADMAP queue 1, parallelism)")
    opt = get_default_cfg()
    opt.merge_from_file(args.config)
    opt.freeze()
    device = resolve_device(args.device)

    output_dir = opt.output_dir
    if os.path.exists(output_dir):
        raise FileExistsError(
            f"output_dir '{output_dir}' already exists — refusing to "
            "clobber a previous run (pick a new dir or remove it)")
    os.makedirs(output_dir)

    # snapshot sources + config for reproducibility
    from stylegan_torch.utils import make_logger, snapshot_sources
    snapshot_sources(REPO_ROOT, os.path.join(output_dir, "src"))
    shutil.copy2(args.config, output_dir)
    logger = make_logger("project", opt.output_dir, "log")
    logger.info("Training on %s", device)

    apply_runtime_knobs(opt)
    if opt.precision.activations == "bfloat16":
        logger.info("precision.activations bfloat16: bf16 activations in G "
                    "and D, float32 parameters, optimizer state and "
                    "statistics, TF32 for the float32 ops; fused real/fake "
                    "scoring %s", "on" if resolve_fuse_scores(opt) else "off")

    from stylegan_torch.data import make_dataset
    dataset = make_dataset(opt.dataset, conditional=opt.conditional)

    style_gan = build_trainer(opt, device, args.num_devices)

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
