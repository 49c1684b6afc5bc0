"""Training: the state (networks, shadow, optimizers), the fused steps and
the progressive trainer."""

from .state import (TrainState, create_train_state, lazy_reg_adam_correction,
                    make_d_optimizer, make_g_optimizer)
from .steps import (build_d_step, build_g_step, build_sample_fn,
                    build_spatial_train_step, build_train_step,
                    progressive_downsample)
from .trainer import StyleGAN, adjust01

__all__ = [
    "TrainState", "create_train_state", "lazy_reg_adam_correction",
    "make_d_optimizer", "make_g_optimizer", "build_d_step", "build_g_step",
    "build_sample_fn", "build_spatial_train_step", "build_train_step",
    "progressive_downsample",
    "StyleGAN", "adjust01",
]
