"""StyleGAN op library in PyTorch (NHWC at the public functions; StyleGAN2's
``modconv`` takes NCHW).

Importing it registers the ``stylegan_torch::`` epilogue ops
(``ops/fused.py``, ``ops/kernels/epilogue.py``; StyleGAN2's
``ops/modconv.py``, ``ops/kernels/epilogue2.py``)."""

from .primitives import (add_noise, avg_pool2d, blur2d, downscale2d,
                         instance_norm, leaky_relu, make_blur_kernel,
                         minibatch_stddev, pixel_norm, style_modulate,
                         truncate_dlatents, update_moving_average, upscale2d)
from .linear import (EqualizedConv2d, EqualizedLinear, conv2d_apply,
                     equalized_scales, linear_apply)
# registers the epilogue's torch.library ops, CPU implementation included,
# which a program exported with torch.export needs to load
from . import fused, modconv  # noqa: E402,F401

__all__ = [
    "add_noise", "avg_pool2d", "blur2d", "downscale2d", "instance_norm",
    "leaky_relu", "make_blur_kernel", "minibatch_stddev", "pixel_norm",
    "style_modulate", "truncate_dlatents",
    "update_moving_average", "upscale2d",
    "EqualizedConv2d", "EqualizedLinear", "conv2d_apply", "equalized_scales",
    "linear_apply",
]
