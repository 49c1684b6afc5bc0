"""Source-tree snapshot for run reproducibility (the port's copy of
``stylegan_tpu/utils/snapshot.py``).

Counterpart of the reference's copy of the whole working tree into
<output>/src at train start (utils/copy.py:7-51, train.py:63-66).  The port's
copy also takes the kernel sources (``.cu``) and skips the build outputs.
"""

from __future__ import annotations

import os
import shutil
from typing import Iterable

_SUFFIXES = (".py", ".yaml", ".md", ".txt", ".cc", ".cu", ".h")


def snapshot_sources(src_root: str, out_dir: str,
                     ignores: Iterable[str] = ("configs", "diagrams", ".git",
                                               "__pycache__", "output",
                                               "build", "chiprun_out")):
    ignores = set(ignores)
    for dirpath, dirnames, filenames in os.walk(src_root):
        dirnames[:] = [d for d in dirnames if d not in ignores
                       and not d.startswith(".")]
        rel = os.path.relpath(dirpath, src_root)
        for f in filenames:
            if not f.endswith(_SUFFIXES):
                continue
            dst_dir = os.path.join(out_dir, rel) if rel != "." else out_dir
            os.makedirs(dst_dir, exist_ok=True)
            shutil.copy2(os.path.join(dirpath, f), os.path.join(dst_dir, f))
