"""One-command real-assets fidelity gate on the port (the counterpart of
``tools/fidelity_gate.py``).

Given an official FFHQ pickle and pretrained Inception / LPIPS weights, this
one command produces the fidelity numbers of BASELINE.md with pass/fail:

    python -m stylegan_torch.tools.fidelity_gate \\
        --pickle karras2019stylegan-ffhq-1024x1024.pkl \\
        --images /data/ffhq_dir --inception inception_v3.npz \\
        [--lpips vgg16.npz] [--reference path/to/StyleGAN.pytorch]

Stages (each skipped when its asset is absent):

1. convert — the official TF pickle -> the port's Generator through the
             restricted unpickler (``stylegan_torch/tf_pickle.py``); the
             shape-diff report of reference convert.py:123-135; saves the
             converted generator as a JAX-package ``.npz``.
2. golden  — the same pickle's weights loaded into the reference's own
             torch Generator (tf_vars -> torch state_dict, the reference-name
             translation), then a fixed-z, pinned-noise forward of both: max
             abs pixel delta must be <= 1e-2 (BASELINE.json).  Needs the
             reference repository at --reference; skipped without it.
3. fid     — FID between N generated samples and --images with the
             --inception weights (``stylegan_torch/metrics/fid.py``).
4. ppl     — PPL with the --lpips VGG16 weights
             (``stylegan_torch/metrics/ppl.py``).

Writes <out>/gate.json and prints a one-line JSON summary, with the JAX
tool's keys; the exit code is 0 iff every executed stage passed its target
(FID and PPL are recorded, not thresholded: parity is a comparison against a
reference run of the same command on the same --images).  The generator
runs on CUDA unless --device cpu; a missing GPU is an error.  The draws of
the samples are the port's own (seeded from --seed), not the JAX tool's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

PIXEL_BAR = 1e-2  # BASELINE.json converted-weights fidelity target


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def install_torchvision_stub():
    """The reference's models package transitively imports torchvision; a
    stub satisfies the import."""
    import types
    if "torchvision" in sys.modules:
        return
    tv = types.ModuleType("torchvision")
    for sub in ("datasets", "transforms", "utils"):
        m = types.ModuleType(f"torchvision.{sub}")
        setattr(tv, sub, m)
        sys.modules[f"torchvision.{sub}"] = m

    class _Unavailable:
        def __init__(self, *a, **k):
            raise RuntimeError("torchvision stub")

    sys.modules["torchvision.datasets"].ImageFolder = _Unavailable
    for name in ("ToTensor", "Normalize", "Compose", "Resize",
                 "RandomHorizontalFlip"):
        setattr(sys.modules["torchvision.transforms"], name, _Unavailable)
    sys.modules["torchvision.utils"].save_image = _Unavailable
    sys.modules["torchvision"] = tv


def make_noises(batch, num_stages, res0=4, seed=3):
    rs = np.random.RandomState(seed)
    noises, res = [], res0
    for _ in range(num_stages):
        noises.append(rs.randn(batch, res, res, 1).astype(np.float32))
        noises.append(rs.randn(batch, res, res, 1).astype(np.float32))
        res *= 2
    return noises


def gate_config(res, mapping_layers):
    """The official FFHQ generator's configuration at `res`."""
    from stylegan_torch.models import (GeneratorConfig, MappingConfig,
                                       SynthesisConfig)
    return GeneratorConfig(
        resolution=res,
        mapping=MappingConfig(latent_size=512, mapping_layers=mapping_layers,
                              dlatent_broadcast=(int(np.log2(res)) - 1) * 2),
        synthesis=SynthesisConfig(resolution=res, blur_filter=(1, 2, 1),
                                  structure="linear"))


def parse_arguments(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pickle", required=True,
                    help="official TF pickle (karras2019stylegan-*.pkl)")
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--mapping_layers", type=int, default=8)
    ap.add_argument("--images", default=None,
                    help="real-image dir for FID (flat files or folders)")
    ap.add_argument("--inception", default=None,
                    help="InceptionV3 weights .npz for FID")
    ap.add_argument("--lpips", default=None,
                    help="LPIPS VGG16 weights .npz for PPL")
    ap.add_argument("--reference", default=None,
                    help="the reference repository (StyleGAN.pytorch) for "
                         "the golden torch comparison; skipped without it")
    ap.add_argument("--out", default="runs/fidelity_gate")
    ap.add_argument("--num_samples", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--golden_samples", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip_golden", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_arguments(argv)
    import torch
    from stylegan_torch import resolve_device
    from stylegan_torch.convert import save_generator_file
    from stylegan_torch.models import Generator
    from stylegan_torch.models.synthesis import stream_seed
    from stylegan_torch.tf_pickle import (collect_variables,
                                          import_official_generator,
                                          load_tf_networks,
                                          tf_vars_to_state_dict)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    RES = args.res
    depth = int(np.log2(RES)) - 2
    cfg = gate_config(RES, args.mapping_layers)

    gate = {"pickle": args.pickle, "res": RES, "stages": {},
            "targets": {"pixel_max_abs_diff": PIXEL_BAR,
                        "fid": "parity vs reference on the same --images",
                        "ppl": "recorded"}}
    failures = []
    t0 = time.time()

    def finish():
        gate["wall_s"] = round(time.time() - t0, 1)
        gate["pass"] = not failures
        gate["failures"] = failures
        with open(os.path.join(args.out, "gate.json"), "w") as f:
            json.dump(gate, f, indent=1)
        summary = {"pass": gate["pass"],
                   **{s: (v.get("pixel_max_abs_diff", v.get("fid",
                          v.get("ppl", v.get("ok")))))
                      for s, v in gate["stages"].items()}}
        print(json.dumps(summary), flush=True)
        sys.exit(0 if gate["pass"] else 1)

    # ---- stage 1: convert --------------------------------------------------
    log("stage 1/4: converting official pickle...")
    gen = Generator(cfg, generator=torch.Generator().manual_seed(0))
    gen.requires_grad_(False).eval().to(device)
    msgs = []
    try:
        import_official_generator(args.pickle, gen, depth,
                                  report=msgs.append)
    except Exception as e:  # noqa: BLE001 — bad asset -> clean gate failure
        for m in msgs:
            log(f"  {m}")
        gate["stages"]["convert"] = {
            "ok": False, "error": repr(e),
            "issues": [m for m in msgs if m.startswith(("mismatch",
                                                        "pd only"))]}
        failures.append(f"convert: {e!r}")
        finish()
    issues = [m for m in msgs if m.startswith(("mismatch", "pd only"))
              or (m.startswith("sd only")
                  and not m.startswith("sd only g_synthesis.to_rgb."))]
    for m in msgs:
        log(f"  {m}")
    npz = os.path.join(args.out, "converted_generator.npz")
    save_generator_file(gen, npz, {"source": os.path.basename(args.pickle)})
    gate["stages"]["convert"] = {
        "ok": not issues, "converted_npz": npz,
        "shape_report_lines": len(msgs), "issues": issues}
    if issues:
        failures.append("convert: shape report has mismatches")

    # ---- stage 2: golden fixed-input pixel diff vs the reference ---------
    if args.skip_golden:
        gate["stages"]["golden"] = {"ok": None, "skipped": "--skip_golden"}
    elif not (args.reference
              and os.path.isdir(os.path.join(args.reference, "models"))):
        gate["stages"]["golden"] = {
            "ok": None, "skipped": f"reference not found at {args.reference}"}
        log("stage 2/4: reference repo unavailable — golden diff skipped")
    else:
        log("stage 2/4: golden pixel diff vs the reference torch model...")
        sys.path.append(args.reference)
        install_torchvision_stub()
        from models.CustomLayers import NoiseLayer
        from models.GAN import Generator as TorchGenerator
        tg = TorchGenerator(resolution=RES, latent_size=512,
                            mapping_layers=args.mapping_layers,
                            blur_filter=[1, 2, 1], structure="linear")
        # pickle -> torch through the reference-name translation of the
        # reference's own convert.py
        nets = load_tf_networks(args.pickle)
        sd = tf_vars_to_state_dict(
            collect_variables(nets[2] if len(nets) >= 3 else nets[0]), depth)
        missing, unexpected = tg.load_state_dict(
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in sd.items()}, strict=False)
        for k in missing:  # only non-parameter buffers may be absent
            assert ("blur" in k or "intermediate" in k
                    or "to_rgb" in k or "torgb" in k), f"missing {k}"
        assert not unexpected, unexpected
        tg.eval()

        b = args.golden_samples
        noises = make_noises(b, int(np.log2(RES)) - 1, seed=3)
        layers = [m for m in tg.modules() if isinstance(m, NoiseLayer)]
        for layer, n in zip(layers, noises):
            layer.noise = torch.from_numpy(
                np.transpose(n, (0, 3, 1, 2)).copy())
        z = np.random.RandomState(args.seed + 1).randn(b, 512).astype(
            np.float32)
        with torch.no_grad():
            ref = np.transpose(
                tg(torch.from_numpy(z), depth=depth, alpha=1.0)
                .detach().numpy(), (0, 2, 3, 1))
            ours = gen(torch.from_numpy(z).to(device), depth, 1.0,
                       train=False,
                       noises=[torch.from_numpy(n).to(device)
                               for n in noises]).images.float().cpu().numpy()
        delta = float(np.max(np.abs(ours - ref)))
        ok = delta <= PIXEL_BAR
        gate["stages"]["golden"] = {"ok": ok, "pixel_max_abs_diff": delta,
                                    "samples": b, "target": PIXEL_BAR}
        log(f"  max abs pixel diff {delta:.2e} (target <= {PIXEL_BAR})")
        if not ok:
            failures.append(f"golden: pixel diff {delta:.3e} > {PIXEL_BAR}")

    # ---- generated samples for the FID stage -----------------------------
    fakes = None
    if args.images and args.inception:
        log(f"generating {args.num_samples} samples...")
        chunks = []
        for k, i in enumerate(range(0, args.num_samples, args.batch)):
            n = min(args.batch, args.num_samples - i)
            g = torch.Generator().manual_seed(stream_seed(args.seed, 4, k))
            zz = torch.randn((n, cfg.latent_size), generator=g).to(device)
            with torch.inference_mode():
                chunks.append(gen(zz, depth, 1.0,
                                  seed=stream_seed(args.seed, 5, k),
                                  train=False).images.float())
        fakes = torch.cat(chunks)[:args.num_samples]

    # ---- stage 3: FID ------------------------------------------------------
    if args.images and args.inception:
        log("stage 3/4: FID vs --images...")
        from stylegan_torch.config import get_default_cfg
        from stylegan_torch.data import make_dataset
        from stylegan_torch.metrics import compute_fid
        dcfg = get_default_cfg().dataset
        dcfg.img_dir = args.images
        dcfg.resolution = RES
        dcfg.folder = False
        dataset = make_dataset(dcfg)
        rs = np.random.RandomState(args.seed)
        idx = rs.choice(len(dataset), size=min(args.num_samples, len(dataset)),
                        replace=len(dataset) < args.num_samples)
        reals = torch.from_numpy(
            np.stack([dataset.get(int(i), rs) for i in idx])).to(device)
        fid = compute_fid(torch.clamp((reals + 1) / 2, 0, 1),
                          torch.clamp((fakes + 1) / 2, 0, 1),
                          args.inception, batch_size=args.batch,
                          device=device)
        gate["stages"]["fid"] = {"ok": True, "fid": round(float(fid), 4),
                                 "num_samples": int(len(idx))}
        log(f"  FID {fid:.3f}")
    else:
        gate["stages"]["fid"] = {
            "ok": None,
            "skipped": "needs --images and --inception weights"}

    # ---- stage 4: PPL ------------------------------------------------------
    if args.lpips:
        log("stage 4/4: PPL (LPIPS-VGG16)...")
        from stylegan_torch.metrics import (load_lpips_weights, make_lpips_fn,
                                            ppl_samples, ppl_score)
        d = ppl_samples(gen, make_lpips_fn(load_lpips_weights(args.lpips),
                                           device),
                        num_samples=args.num_samples, batch_size=args.batch,
                        seed=args.seed, space="w", sampling="full")
        gate["stages"]["ppl"] = {"ok": True, "ppl": round(ppl_score(d), 4),
                                 "num_samples": args.num_samples}
        log(f"  PPL {gate['stages']['ppl']['ppl']}")
    else:
        gate["stages"]["ppl"] = {"ok": None,
                                 "skipped": "needs --lpips weights"}

    finish()


if __name__ == "__main__":
    main()
