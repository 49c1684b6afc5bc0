"""Training: the state (networks, shadow, optimizers) and the fused steps."""

from .state import (TrainState, create_train_state, lazy_reg_adam_correction,
                    make_d_optimizer, make_g_optimizer)
from .steps import (build_d_step, build_g_step, build_sample_fn,
                    build_train_step, progressive_downsample)

__all__ = [
    "TrainState", "create_train_state", "lazy_reg_adam_correction",
    "make_d_optimizer", "make_g_optimizer", "build_d_step", "build_g_step",
    "build_sample_fn", "build_train_step", "progressive_downsample",
]
