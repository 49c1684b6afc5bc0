"""Static generator configuration dataclasses (the port's copy of
``stylegan_tpu/models/configs.py``).

Field names and defaults mirror the reference network constructors:
  MappingConfig    -> reference GAN.py:39-41 (GMapping)
  SynthesisConfig  -> reference GAN.py:105-109 (GSynthesis)
  GeneratorConfig  -> reference GAN.py:213-216 (Generator)
  DiscriminatorConfig -> reference GAN.py:302-306 (Discriminator)

The JAX package's TPU execution-layout fields (``packed``, ``fold_blur``) are
left out: they select layouts with the same math, and the port has one
layout.  ``remat`` of the synthesis and the discriminator (recompute each
block in the backward instead of holding its activations) is kept; the port
honours it with ``torch.utils.checkpoint``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


def _nf(stage: int, fmap_base: int, fmap_decay: float, fmap_max: int) -> int:
    return min(int(fmap_base / (2.0 ** (stage * fmap_decay))), fmap_max)


@dataclass(frozen=True)
class MappingConfig:
    latent_size: int = 512
    dlatent_size: int = 512
    dlatent_broadcast: Optional[int] = None
    mapping_layers: int = 8
    mapping_fmaps: int = 512
    mapping_lrmul: float = 0.01
    mapping_nonlinearity: str = "lrelu"
    use_wscale: bool = True
    normalize_latents: bool = True

    def layer_dims(self) -> Tuple[Tuple[int, int], ...]:
        dims = []
        for i in range(self.mapping_layers):
            fin = self.latent_size if i == 0 else self.mapping_fmaps
            fout = (self.dlatent_size if i == self.mapping_layers - 1
                    else self.mapping_fmaps)
            dims.append((fin, fout))
        return tuple(dims)


@dataclass(frozen=True)
class SynthesisConfig:
    dlatent_size: int = 512
    num_channels: int = 3
    resolution: int = 1024
    fmap_base: int = 8192
    fmap_decay: float = 1.0
    fmap_max: int = 512
    use_styles: bool = True
    const_input_layer: bool = True
    use_noise: bool = True
    nonlinearity: str = "lrelu"
    use_wscale: bool = True
    use_pixel_norm: bool = False
    use_instance_norm: bool = True
    blur_filter: Optional[Tuple[int, ...]] = None
    structure: str = "linear"
    # recompute each growth block in the backward pass instead of keeping
    # its activations (the JAX package's remat_blocks)
    remat: bool = False

    @property
    def resolution_log2(self) -> int:
        r = int(math.log2(self.resolution))
        assert self.resolution == 2 ** r and self.resolution >= 4
        return r

    @property
    def depth(self) -> int:
        """Number of stages == log2(res) - 1 (reference GAN.py:145)."""
        return self.resolution_log2 - 1

    @property
    def num_layers(self) -> int:
        return self.resolution_log2 * 2 - 2

    def nf(self, stage: int) -> int:
        return _nf(stage, self.fmap_base, self.fmap_decay, self.fmap_max)


@dataclass(frozen=True)
class GeneratorConfig:
    resolution: int = 1024
    latent_size: int = 512
    dlatent_size: int = 512
    conditional: bool = False
    n_classes: int = 0
    truncation_psi: float = 0.7
    truncation_cutoff: int = 8
    dlatent_avg_beta: float = 0.995
    style_mixing_prob: Optional[float] = 0.9
    mapping: MappingConfig = field(default_factory=MappingConfig)
    synthesis: SynthesisConfig = field(default_factory=SynthesisConfig)

    @property
    def num_layers(self) -> int:
        return (int(math.log2(self.resolution)) - 1) * 2

    @property
    def use_truncation(self) -> bool:
        # psi <= 0 disables the truncation module (reference GAN.py:246-252;
        # yaml convention: truncation_psi: -1. means off)
        return self.truncation_psi > 0

    @property
    def effective_latent_size(self) -> int:
        """Mapping input doubles when a class embedding is concatenated
        (reference GAN.py:233-236)."""
        return self.latent_size * 2 if self.conditional else self.latent_size


@dataclass(frozen=True)
class DiscriminatorConfig:
    resolution: int = 1024
    num_channels: int = 3
    conditional: bool = False
    n_classes: int = 0
    fmap_base: int = 8192
    fmap_decay: float = 1.0
    fmap_max: int = 512
    nonlinearity: str = "lrelu"
    use_wscale: bool = True
    mbstd_group_size: int = 4
    mbstd_num_features: int = 1
    blur_filter: Optional[Tuple[int, ...]] = None
    structure: str = "linear"
    # recompute each block in the backward pass instead of keeping its
    # activations (R1's double backward holds them twice otherwise)
    remat: bool = False

    @property
    def resolution_log2(self) -> int:
        r = int(math.log2(self.resolution))
        assert self.resolution == 2 ** r and self.resolution >= 4
        return r

    @property
    def depth(self) -> int:
        return self.resolution_log2 - 1

    def nf(self, stage: int) -> int:
        return _nf(stage, self.fmap_base, self.fmap_decay, self.fmap_max)

    @property
    def input_channels(self) -> int:
        """Image channels doubled by the label embedding planes when
        conditional (reference GAN.py:326-329)."""
        return self.num_channels * 2 if self.conditional else self.num_channels


def generator_config_from_args(structure, resolution, num_channels,
                               latent_size, conditional, n_classes,
                               g_args) -> GeneratorConfig:
    """GeneratorConfig from a g_args mapping — the counterpart of the
    reference passing cfg.model.gen as Generator(**g_args) kwargs
    (train.py:84-99).  Recognized keys mirror Generator's kwargs."""
    g = dict(g_args)
    blur = g.get("blur_filter", [1, 2, 1])
    blur = tuple(blur) if blur else None
    latent = int(g.get("latent_size", latent_size))
    eff_latent = latent * 2 if conditional else latent
    num_layers = (int(math.log2(resolution)) - 1) * 2
    return GeneratorConfig(
        resolution=int(resolution),
        latent_size=latent,
        conditional=bool(conditional),
        n_classes=int(n_classes),
        truncation_psi=float(g.get("truncation_psi", 0.7)),
        truncation_cutoff=int(g.get("truncation_cutoff", 8)),
        dlatent_avg_beta=float(g.get("dlatent_avg_beta", 0.995)),
        style_mixing_prob=g.get("style_mixing_prob", 0.9),
        mapping=MappingConfig(
            latent_size=eff_latent,
            dlatent_broadcast=num_layers,
            mapping_layers=int(g.get("mapping_layers", 8)),
        ),
        synthesis=SynthesisConfig(
            resolution=int(resolution),
            num_channels=int(num_channels),
            blur_filter=blur,
            structure=str(structure),
        ),
    )


def discriminator_config_from_args(structure, resolution, num_channels,
                                   conditional, n_classes,
                                   d_args) -> DiscriminatorConfig:
    d = dict(d_args)
    blur = d.get("blur_filter", [1, 2, 1])
    blur = tuple(blur) if blur else None
    return DiscriminatorConfig(
        resolution=int(resolution),
        num_channels=int(num_channels),
        conditional=bool(conditional),
        n_classes=int(n_classes),
        use_wscale=bool(d.get("use_wscale", True)),
        blur_filter=blur,
        structure=str(structure),
    )


def generator_config_from_cfg(cfg) -> GeneratorConfig:
    """Build a GeneratorConfig from a full yacs-style cfg; ``ops.remat`` is
    read, the other ``ops.*`` layout knobs have no effect on the port's
    math."""
    g = generator_config_from_args(
        cfg.structure, cfg.dataset.resolution, cfg.dataset.channels,
        cfg.model.gen.latent_size, cfg.conditional, cfg.n_classes,
        cfg.model.gen)
    if getattr(cfg.ops, "remat", False):
        g = replace(g, synthesis=replace(g.synthesis, remat=True))
    return g


def discriminator_config_from_cfg(cfg) -> DiscriminatorConfig:
    """Build a DiscriminatorConfig from a full yacs-style cfg; ``ops.remat``
    is read, the other ``ops.*`` layout knobs (``packed``, ``fold_blur``)
    are accepted and give the unpacked path's math."""
    d = discriminator_config_from_args(
        cfg.structure, cfg.dataset.resolution, cfg.dataset.channels,
        cfg.conditional, cfg.n_classes, cfg.model.dis)
    return replace(d, remat=bool(getattr(cfg.ops, "remat", False)))
