"""Run logger (the port's copy of ``stylegan_tpu/utils/logger.py``): stdout +
<save_dir>/<name>.txt, the contract of the reference's utils/logger.py:6-25
(a named stdlib logger writing to both)."""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname)s: %(message)s"


def make_logger(name: str, save_dir: str, save_filename: str) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()

    handlers = [logging.StreamHandler(stream=sys.stdout)]
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        log_path = os.path.join(save_dir, f"{save_filename}.txt")
        handlers.append(logging.FileHandler(log_path, mode="w"))
    for h in handlers:
        h.setLevel(logging.DEBUG)
        h.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(h)
    return logger
