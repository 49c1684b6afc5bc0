"""Generator networks: mapping, synthesis, generator."""

from .configs import (GeneratorConfig, MappingConfig, SynthesisConfig,
                      generator_config_from_args, generator_config_from_cfg)
from .generator import Generator, GeneratorOutput
from .mapping import GMapping
from .synthesis import GSynthesis

__all__ = [
    "GeneratorConfig", "MappingConfig", "SynthesisConfig",
    "generator_config_from_args", "generator_config_from_cfg",
    "Generator", "GeneratorOutput", "GMapping", "GSynthesis",
]
