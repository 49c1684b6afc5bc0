"""stylegan_torch — the PyTorch/CUDA port of ``stylegan_tpu`` for NVIDIA
Hopper (H100).

The JAX package stays the reference; this package imports neither it nor
JAX.  Public functions keep the JAX package's layouts (NHWC feature maps,
(B, H, W, 1) noise, (B, 2C) styles, (B, num_layers, D) W).  The synthesis
epilogue runs as a hand-written CUDA kernel on the card
(``csrc/epilogue.cu``); everything else is PyTorch.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU.  Raises when CUDA is asked for (or defaulted to) and missing: an
    entry point never carries on quietly on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device
