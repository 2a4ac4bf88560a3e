"""The port's experiment configs, and what its serving and training paths
read of them.

``vlp_tpu_torch.config.core`` is the port's copy of the JAX package's config
tree, experiment registry and overrides (``Config``, ``get_experiment``,
``apply_overrides``), and ``vlp_tpu_torch.config.experiments`` registers
the same 61 experiments; ``tests/test_torch_port_experiments.py`` holds each
one's ``to_dict()`` against ``vlp_tpu.config.get_experiment``. Nothing here
imports the JAX package: the machine with the card runs without it.
The serving path needs only the model's and the input's fields (the dual
tower's among them), so it takes them as a ``ServeConfig``, and the
training step adds the optimizer, schedule, parameter-group, caption
length, augmentation and parameter-sharding fields in a ``TrainConfig``; ``from_config`` reads
them off a ``Config`` (the port's, or the JAX package's in tests).
``EXPERIMENTS`` and ``TRAIN_EXPERIMENTS`` are ``from_config`` of every
registered experiment, keyed by its name, and of ``NEST_UNFUSED``, keyed
by the name and its override as a command line gives them; tests hold
each entry against the JAX package's ``get_experiment``.
``serve_config`` resolves a command line's ``experiment=`` and overrides
of the serving fields.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from vlp_tpu_torch.config.core import (  # noqa: F401
    Config, DataConfig, MeshConfig, ModelConfig, OptimizerConfig,
    SchedulerConfig, TrainerConfig, _parse_value, apply_overrides,
    get_experiment, list_experiments, register_experiment)
from vlp_tpu_torch.config import experiments as _experiments  # noqa: F401
from vlp_tpu_torch.ops.augment import AugmentConfig


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    task: str = "only_imaging"            # cfg.model.task
    model: str = "resnet34"               # cfg.model.model
    precision: str = "bf16"               # cfg.trainer.precision
    image_size: int = 224                 # cfg.data.image_size
    in_channels: int = 3                  # cfg.data.in_channels
    scale_intensity: bool = False         # cfg.data.scale_intensity_normalization
    crop: bool = False                    # cfg.data.crop_larger_dimension
    fused_attention: Optional[bool] = None  # cfg.model.fused_attention
    megakernel: bool = True               # cfg.model.megakernel
    remat: bool = False                   # cfg.model.remat
    stem: str = "conv7"                   # cfg.model.stem
    bn_dtype: str = "fp32"                # cfg.trainer.bn_dtype
    # the dual tower (task vision_language)
    text_model: str = "distilbert"        # cfg.model.text_model
    embedding_dim: int = 128              # cfg.model.embedding_dim
    image_dropout: float = 0.0            # cfg.model.image_dropout
    logit_scale_init: float = 2.6592      # cfg.model.logit_scale_init
    logit_scale_max: float = 100.0        # cfg.model.logit_scale_max
    loss_variant: str = "symmetric_infonce"  # cfg.model.loss_variant
    infonce_impl: str = "gspmd"           # cfg.mesh.infonce_impl

    @classmethod
    def from_config(cls, cfg: Any) -> "ServeConfig":
        """The serving fields of a ``Config``."""
        m = cfg.model
        return cls(task=m.task, model=m.model,
                   precision=cfg.trainer.precision,
                   image_size=cfg.data.image_size,
                   in_channels=cfg.data.in_channels,
                   scale_intensity=cfg.data.scale_intensity_normalization,
                   crop=cfg.data.crop_larger_dimension,
                   fused_attention=m.fused_attention,
                   megakernel=m.megakernel, remat=m.remat,
                   stem=m.stem, bn_dtype=cfg.trainer.bn_dtype,
                   text_model=m.text_model, embedding_dim=m.embedding_dim,
                   image_dropout=m.image_dropout,
                   logit_scale_init=m.logit_scale_init,
                   logit_scale_max=m.logit_scale_max,
                   loss_variant=m.loss_variant,
                   infonce_impl=cfg.mesh.infonce_impl)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    serve: ServeConfig = ServeConfig()
    optimizer: str = "adamw"                # cfg.optimizer.name
    lr: float = 1e-3                        # cfg.optimizer.lr
    weight_decay: float = 0.01              # cfg.optimizer.weight_decay
    b1: float = 0.9                         # cfg.optimizer.b1
    b2: float = 0.999                       # cfg.optimizer.b2
    eps: float = 1e-8                       # cfg.optimizer.eps
    scheduler: str = "cosine"               # cfg.scheduler.name
    warmup_epochs: int = 4                  # cfg.scheduler.warmup_epochs
    batch_size: int = 128                   # cfg.data.batch_size
    max_epochs: int = 10                    # cfg.trainer.max_epochs
    coral_lambda: float = 0.0               # cfg.model.coral_lambda
    vision_encoder_lr: Optional[float] = None  # cfg.model.vision_encoder_lr
    freeze_encoder: bool = False            # cfg.model.freeze_encoder
    disable_augmentations: bool = False     # cfg.data.disable_augmentations
    # cfg.data.gaussian_noise_augmentation
    gaussian_noise_augmentation: bool = True
    shear_augmentation: bool = False        # cfg.data.shear_augmentation
    # the dual tower's parameter groups; lr 0 freezes a group
    image_encoder_lr: Optional[float] = None  # cfg.model.image_encoder_lr
    text_encoder_lr: Optional[float] = None   # cfg.model.text_encoder_lr
    projection_lr: Optional[float] = None     # cfg.model.projection_lr
    max_token_length: int = 40              # cfg.data.max_token_length
    param_sharding: str = "replicated"      # cfg.mesh.param_sharding

    @classmethod
    def from_config(cls, cfg: Any) -> "TrainConfig":
        """The training fields of a ``Config``."""
        o, m, d = cfg.optimizer, cfg.model, cfg.data
        return cls(serve=ServeConfig.from_config(cfg), optimizer=o.name,
                   lr=o.lr, weight_decay=o.weight_decay, b1=o.b1, b2=o.b2,
                   eps=o.eps, scheduler=cfg.scheduler.name,
                   warmup_epochs=cfg.scheduler.warmup_epochs,
                   batch_size=d.batch_size,
                   max_epochs=cfg.trainer.max_epochs,
                   coral_lambda=m.coral_lambda,
                   vision_encoder_lr=m.vision_encoder_lr,
                   freeze_encoder=m.freeze_encoder,
                   disable_augmentations=d.disable_augmentations,
                   gaussian_noise_augmentation=d.gaussian_noise_augmentation,
                   shear_augmentation=d.shear_augmentation,
                   image_encoder_lr=m.image_encoder_lr,
                   text_encoder_lr=m.text_encoder_lr,
                   projection_lr=m.projection_lr,
                   max_token_length=d.max_token_length,
                   param_sharding=cfg.mesh.param_sharding)

    def augment(self) -> AugmentConfig:
        """The switches mapped as ``vlp_tpu/data/datamodule.py:49-54``."""
        return AugmentConfig(
            enabled=not self.disable_augmentations,
            noise_prob=0.5 if self.gaussian_noise_augmentation else 0.0,
            shear_deg=5.0 if self.shear_augmentation else 0.0)


def as_serve_config(cfg: Any) -> ServeConfig:
    """``cfg`` itself if it is a ``ServeConfig``, the ``serve`` part of a
    ``TrainConfig``, else the serving fields of a ``Config``."""
    if isinstance(cfg, ServeConfig):
        return cfg
    if isinstance(cfg, TrainConfig):
        return cfg.serve
    return ServeConfig.from_config(cfg)


# The ServeConfig field of each override a command line may give
# (the config tree's dotted names); serve_config raises on any other.
SERVE_OVERRIDES = {
    "model.task": "task", "model.model": "model",
    "trainer.precision": "precision", "data.image_size": "image_size",
    "data.in_channels": "in_channels",
    "data.scale_intensity_normalization": "scale_intensity",
    "data.crop_larger_dimension": "crop",
    "model.fused_attention": "fused_attention",
    "model.megakernel": "megakernel", "model.remat": "remat",
    "model.stem": "stem", "trainer.bn_dtype": "bn_dtype"}


def serve_config(overrides: List[str]) -> ServeConfig:
    """``experiment=<name>`` (from ``EXPERIMENTS``; the Config defaults when
    absent) with ``dotted.field=value`` overrides of the serving fields
    applied, as ``apply_overrides`` applies them."""
    names = [o.split("=", 1)[1] for o in overrides
             if o.startswith("experiment=")]
    if names and names[-1] not in EXPERIMENTS:
        raise KeyError(f"unknown experiment {names[-1]!r}; available: "
                       f"{list_experiments()}")
    cfg = EXPERIMENTS[names[-1]] if names else ServeConfig()
    for item in overrides:
        if item.startswith("experiment="):
            continue
        key, sep, raw = item.partition("=")
        if not sep or key not in SERVE_OVERRIDES:
            raise ValueError(
                f"override {item!r}: the port's serving path takes "
                f"experiment=<name> and {sorted(SERVE_OVERRIDES)}")
        cfg = dataclasses.replace(cfg, **{SERVE_OVERRIDES[key]:
                                          _parse_value(raw)})
    return cfg


NEST_UNFUSED = "baseline_only_imaging_nest_small model.megakernel=false"
# VLP pretraining, the experiment the chip checks and bench.py run
PRETRAIN = "pretrain_resnet34_tinybert"


def _experiment(key: str) -> Config:
    """The Config a key names: the experiment, then the overrides written
    after it (``NEST_UNFUSED``)."""
    name, *overrides = key.split(" ")
    return apply_overrides(get_experiment(name), overrides)


_KEYS = sorted(list_experiments()) + [NEST_UNFUSED]
EXPERIMENTS: Dict[str, ServeConfig] = {
    key: ServeConfig.from_config(_experiment(key)) for key in _KEYS}
TRAIN_EXPERIMENTS: Dict[str, TrainConfig] = {
    key: TrainConfig.from_config(_experiment(key)) for key in _KEYS}
