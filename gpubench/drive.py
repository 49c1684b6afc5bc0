"""What the traffic kinds share: the Run the readers read, the streams
their draws come from, and the precision the reference runs in.

A traffic kind is a module ``traffic/<kind>.py`` (found by name, see
cells.py) with three names:

* ``Program``: the hook that drives the system under test, built from
  (configuration, traffic, weights, seed, device); the one place a kind
  imports ``stylegan_torch``;
* ``Load(program, cell, seed, device, ranks)``: ``warm()``, then
  ``window(run, seconds, tracer)``, ``release()`` and ``numbers()`` (the
  checks' numbers, from the reference on the same inputs); its ``family``
  ("serve" or "train") is the Run's ``entry``, which the readers test;
  ``ranks`` is (this rank, the ranks, a host-side group) in a cell on
  several chips, else None;
* ``readings(cell, seed, device)``: the control's and the planted faults'
  numbers against the reference, without the program (control.py).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

Z_STREAM, REQUEST_STREAM, SAMPLE_STREAM, REALS_STREAM = 0x5A, 0x52, 0x53, 0x4C


@dataclass
class Run:
    """What the readers read."""
    entry: str
    config: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0
    failed: int = 0
    images: int = 0
    latencies_s: list = field(default_factory=list)
    unit_flops: list = field(default_factory=list)   # (all, conv) per unit
    trace: dict | None = None
    peaks: dict | None = None

    @property
    def precision(self) -> str:
        return self.config["overlay"]["precision"]["activations"]


def dtype(config) -> torch.dtype:
    """The configuration's activation dtype."""
    return getattr(torch, config["overlay"]["precision"]["activations"])


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def single(ranks):
    """Refuses the ranks of a cell on several chips, for a kind that
    drives one."""
    if ranks is not None and ranks[1] > 1:
        raise ValueError("this traffic kind drives one chip")


@contextmanager
def precise(tf32: bool = False):
    """Full float32 for the reference (TF32 off; on for the control of a
    float32 configuration), restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def span(name):
    return torch.profiler.record_function(name)
