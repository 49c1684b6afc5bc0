"""Write a structured synthetic image dataset to disk for CLI-driven runs
(the port's counterpart of ``tools/make_synthetic_dataset.py``).

Materializes the gradient-blob family of
``stylegan_torch.tools.train_quality_run.structured_batch`` as PNG files
that ``FlatDirectoryImageDataset`` reads (the reference's dataset contract,
DataLoader.py:14-60), so that ``stylegan_torch.cli.train`` and
``stylegan_torch.cli.eval_metrics`` run end to end without a real dataset.
The same seed writes the same files as the JAX tool.  Numpy and PIL only.

    python -m stylegan_torch.tools.make_synthetic_dataset --out /tmp/data \\
        --n 2048 --res 128
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from stylegan_torch.tools.train_quality_run import structured_batch


def parse_arguments(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=256,
                    help="images generated per host-memory chunk")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_arguments(argv)
    from PIL import Image
    os.makedirs(args.out, exist_ok=True)
    rs = np.random.RandomState(args.seed)
    done = 0
    while done < args.n:
        k = min(args.chunk, args.n - done)
        batch = structured_batch(rs, k, args.res)
        u8 = np.clip((batch + 1) * 127.5, 0, 255).astype(np.uint8)
        for i in range(k):
            Image.fromarray(u8[i]).save(
                os.path.join(args.out, f"{done + i:06d}.png"))
        done += k
        print(f"# {done}/{args.n}", file=sys.stderr, flush=True)
    print(f"wrote {done} images at {args.res}^2 to {args.out}")


if __name__ == "__main__":
    main()
