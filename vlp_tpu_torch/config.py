"""What the port's serving path reads of an experiment config.

The experiment configs live in the JAX package (``vlp_tpu.config``). The
serving path needs only seven of their fields, so it takes them as a
``ServeConfig`` and imports nothing of ``vlp_tpu``: the machine with the card
runs without the JAX package. ``ServeConfig.from_config`` reads the fields
off a ``vlp_tpu.config.Config``; ``EXPERIMENTS`` holds the ported
experiments' values, and tests hold each entry against ``get_experiment``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    task: str = "only_imaging"            # cfg.model.task
    model: str = "resnet34"               # cfg.model.model
    precision: str = "bf16"               # cfg.trainer.precision
    image_size: int = 224                 # cfg.data.image_size
    in_channels: int = 3                  # cfg.data.in_channels
    scale_intensity: bool = False         # cfg.data.scale_intensity_normalization
    crop: bool = False                    # cfg.data.crop_larger_dimension

    @classmethod
    def from_config(cls, cfg: Any) -> "ServeConfig":
        """The serving fields of a ``vlp_tpu.config.Config``."""
        return cls(task=cfg.model.task, model=cfg.model.model,
                   precision=cfg.trainer.precision,
                   image_size=cfg.data.image_size,
                   in_channels=cfg.data.in_channels,
                   scale_intensity=cfg.data.scale_intensity_normalization,
                   crop=cfg.data.crop_larger_dimension)


def as_serve_config(cfg: Any) -> ServeConfig:
    """``cfg`` itself if it is a ``ServeConfig``, else its serving fields."""
    return cfg if isinstance(cfg, ServeConfig) else ServeConfig.from_config(cfg)


EXPERIMENTS: Dict[str, ServeConfig] = {
    # vlp_tpu/config/experiments/__init__.py:35-40 (model nest_small) on
    # baseline_only_imaging_resnet34 (:17-32, crop_larger_dimension) and the
    # Config defaults (224x224, 3 channels, bf16)
    "baseline_only_imaging_nest_small": ServeConfig(model="nest_small",
                                                    crop=True),
}
