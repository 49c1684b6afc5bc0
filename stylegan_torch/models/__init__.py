"""Networks: mapping, synthesis, generator, discriminator; and the EMA."""

from .configs import (DiscriminatorConfig, GeneratorConfig, MappingConfig,
                      SynthesisConfig, discriminator_config_from_args,
                      discriminator_config_from_cfg,
                      generator_config_from_args, generator_config_from_cfg)
from .discriminator import Discriminator
from .ema import ema_update
from .generator import Generator, GeneratorOutput
from .mapping import GMapping
from .synthesis import GSynthesis

__all__ = [
    "DiscriminatorConfig", "GeneratorConfig", "MappingConfig",
    "SynthesisConfig", "discriminator_config_from_args",
    "discriminator_config_from_cfg", "generator_config_from_args",
    "generator_config_from_cfg", "Discriminator", "ema_update", "Generator",
    "GeneratorOutput", "GMapping", "GSynthesis",
]
