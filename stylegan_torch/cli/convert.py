"""Convert official TF StyleGAN weights to the JAX package's checkpoint
format (the port's counterpart of ``convert.py``), without TensorFlow: the
official ``.pkl``'s numpy arrays come out through a restricted unpickler
(``stylegan_torch/tf_pickle.py``) that never runs the pickle's embedded
code.

    python -m stylegan_torch.cli.convert --config configs/sample_ffhq_1024.yaml \\
        --input_file karras2019stylegan-ffhq-1024x1024.pkl \\
        --output_file ffhq_1024_gen.npz

The imported generator is written as a ``.npz`` with the metadata
``{"source", "resolution"}``.  The pickle loads as a reference ``.pth``
does: a key it lacks keeps the generator's initial value (the lower-lod
to_rgb heads), a shape mismatch raises.

The reverse direction, --export_pth, turns a ``.npz`` checkpoint (loaded
partially, as the JAX CLI loads it: a shape mismatch warns) into a state_dict
``.pth`` that the reference's Generator / Discriminator load; a G ``.pth``
carries the ``conv0_up.intermediate.kernel`` blur buffers, a D ``.pth`` the
``blocks.{i}.blur.kernel`` ones.

    python -m stylegan_torch.cli.convert --config ... --export_pth \\
        --input_file gen.npz --output_file gen.pth [--network dis]

The networks are built and loaded on CUDA unless --device cpu (no
network runs: the conversion is the same on either).
"""

from __future__ import annotations

import argparse
import os


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="./configs/sample.yaml")
    parser.add_argument("--input_file", action="store", type=str,
                        required=True,
                        help="pretrained weights pickle from the official "
                             "tensorflow repo")
    parser.add_argument("--output_file", action="store", type=str,
                        required=True, help="path to the output weights (.npz)")
    parser.add_argument("--use_current", action="store_true",
                        help="convert the snapshot generator G instead of "
                             "the averaged Gs")
    parser.add_argument("--export_pth", action="store_true",
                        help="reverse direction: a .npz checkpoint -> a "
                             "reference-loadable torch state_dict .pth")
    parser.add_argument("--network", choices=["gen", "dis"], default="gen",
                        help="which network an --export_pth input holds")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def main(args):
    from stylegan_torch import resolve_device
    from stylegan_torch.config import get_default_cfg
    from stylegan_torch.convert import save_generator_file
    from stylegan_torch.models import Generator, generator_config_from_cfg
    from stylegan_torch.tf_pickle import import_official_generator

    opt = get_default_cfg()
    opt.merge_from_file(args.config)
    opt.freeze()
    device = resolve_device(args.device)
    if args.export_pth:
        return export_pth(args, opt, device)

    print("Creating generator object ...")
    gen_cfg = generator_config_from_cfg(opt)
    generator = Generator(gen_cfg).to(device)
    out_depth = gen_cfg.synthesis.depth - 1

    print("Importing TF weights from:", args.input_file)
    import_official_generator(args.input_file, generator, out_depth,
                              use_averaged=not args.use_current)
    save_generator_file(generator, args.output_file,
                        metadata={"source": os.path.basename(args.input_file),
                                  "resolution": gen_cfg.resolution})
    print("Saved:", args.output_file)
    print("Done.")


def export_pth(args, opt, device):
    """A .npz checkpoint -> a reference torch state_dict .pth."""
    from stylegan_torch.convert import (load_discriminator_file,
                                        load_generator_file,
                                        save_discriminator_file,
                                        save_generator_file)
    from stylegan_torch.models import (Discriminator, Generator,
                                       discriminator_config_from_cfg,
                                       generator_config_from_cfg)

    print("Loading checkpoint:", args.input_file)
    if args.network == "gen":
        net = load_generator_file(
            Generator(generator_config_from_cfg(opt)).to(device),
            args.input_file)
        save_generator_file(net, args.output_file)
    else:
        net = load_discriminator_file(
            Discriminator(discriminator_config_from_cfg(opt)).to(device),
            args.input_file)
        save_discriminator_file(net, args.output_file)
    print(f"Saved reference-loadable {args.network} state_dict: "
          f"{args.output_file}")
    print("Done.")


if __name__ == "__main__":
    main(parse_arguments())
