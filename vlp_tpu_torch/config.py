"""What the port's serving and training paths read of an experiment config.

The experiment configs live in the JAX package (``vlp_tpu.config``). The
serving path needs only twelve of their fields, so it takes them as a
``ServeConfig``, and the training step adds the optimizer, schedule and
augmentation fields in a ``TrainConfig``; neither imports anything of
``vlp_tpu``: the machine with the card runs without the JAX package.
``from_config`` reads the fields off a ``vlp_tpu.config.Config``;
``EXPERIMENTS`` and ``TRAIN_EXPERIMENTS`` hold the ported experiments'
values (keyed by the experiment name, or by the name and an override as
the command line gives them), and tests hold each entry against
``get_experiment`` and ``apply_overrides``. ``serve_config`` resolves a
command line's ``experiment=`` and overrides of the serving fields.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Any, Dict, List, Optional

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

    @classmethod
    def from_config(cls, cfg: Any) -> "ServeConfig":
        """The serving fields of a ``vlp_tpu.config.Config``."""
        return cls(task=cfg.model.task, model=cfg.model.model,
                   precision=cfg.trainer.precision,
                   image_size=cfg.data.image_size,
                   in_channels=cfg.data.in_channels,
                   scale_intensity=cfg.data.scale_intensity_normalization,
                   crop=cfg.data.crop_larger_dimension,
                   fused_attention=cfg.model.fused_attention,
                   megakernel=cfg.model.megakernel, remat=cfg.model.remat,
                   stem=cfg.model.stem, bn_dtype=cfg.trainer.bn_dtype)


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

    @classmethod
    def from_config(cls, cfg: Any) -> "TrainConfig":
        """The training fields of a ``vlp_tpu.config.Config``."""
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
                   shear_augmentation=d.shear_augmentation)

    def augment(self) -> AugmentConfig:
        """The switches mapped as ``vlp_tpu/data/datamodule.py:49-54``."""
        return AugmentConfig(
            enabled=not self.disable_augmentations,
            noise_prob=0.5 if self.gaussian_noise_augmentation else 0.0,
            shear_deg=5.0 if self.shear_augmentation else 0.0)


def as_serve_config(cfg: Any) -> ServeConfig:
    """``cfg`` itself if it is a ``ServeConfig``, the ``serve`` part of a
    ``TrainConfig``, else the serving fields of a ``vlp_tpu`` Config."""
    if isinstance(cfg, ServeConfig):
        return cfg
    if isinstance(cfg, TrainConfig):
        return cfg.serve
    return ServeConfig.from_config(cfg)


# The ServeConfig field of each override a command line may give
# (vlp_tpu.config's dotted names); serve_config raises on any other.
SERVE_OVERRIDES = {
    "model.task": "task", "model.model": "model",
    "trainer.precision": "precision", "data.image_size": "image_size",
    "data.in_channels": "in_channels",
    "data.scale_intensity_normalization": "scale_intensity",
    "data.crop_larger_dimension": "crop",
    "model.fused_attention": "fused_attention",
    "model.megakernel": "megakernel", "model.remat": "remat",
    "model.stem": "stem", "trainer.bn_dtype": "bn_dtype"}


def _parse_value(raw: str) -> Any:
    """A command-line value as ``vlp_tpu.config`` parses it."""
    low = raw.lower()
    if low in ("null", "none"):
        return None
    if low in ("true", "false"):
        return low == "true"
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def serve_config(overrides: List[str]) -> ServeConfig:
    """``experiment=<name>`` (from ``EXPERIMENTS``; the Config defaults when
    absent) with ``dotted.field=value`` overrides of the serving fields
    applied, as ``vlp_tpu.config.apply_overrides`` applies them."""
    names = [o.split("=", 1)[1] for o in overrides
             if o.startswith("experiment=")]
    if names and names[-1] not in EXPERIMENTS:
        raise KeyError(f"experiment {names[-1]!r} is not ported; ported: "
                       f"{sorted(EXPERIMENTS)}")
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

EXPERIMENTS: Dict[str, ServeConfig] = {
    # vlp_tpu/config/experiments/__init__.py:35-40 (model nest_small) on
    # baseline_only_imaging_resnet34 (:17-32, crop_larger_dimension) and the
    # Config defaults (224x224, 3 channels, bf16)
    "baseline_only_imaging_nest_small": ServeConfig(model="nest_small",
                                                    crop=True),
    # the same with the half-block kernels off (config/core.py:57-60): the
    # unfused block path, attend_qkv and fused_mlp
    NEST_UNFUSED: ServeConfig(model="nest_small", crop=True,
                              megakernel=False),
    # :258-264 and :384-390 on baseline_only_imaging_resnet34
    "baseline_only_imaging_vit_base": ServeConfig(
        model="vit_base_patch16_224", crop=True),
    "baseline_only_imaging_vit_large": ServeConfig(
        model="vit_large_patch16_224", crop=True),
    # :16-32
    "baseline_only_imaging_resnet34": ServeConfig(model="resnet34",
                                                  crop=True),
    # :43-57: the torchxrayvision ResNet50 on 1-channel images with the
    # intensity scaling; the port runs it from random init (pretrained=True
    # needs weights that are not in the repository)
    "baseline_only_imaging_xrv_resnet50": ServeConfig(
        model="resnet50-res512-all", in_channels=1, scale_intensity=True),
}

_LR = 1.2925748253710286e-4

TRAIN_EXPERIMENTS: Dict[str, TrainConfig] = {
    # baseline_only_imaging_resnet34 (:17-32): batch 64, lr 1.29e-4,
    # cosine_warmup; nest_small sets coral_lambda 0 (:35-40); AdamW and the
    # 4 warmup of 10 epochs are the Config defaults (config/core.py:19-35,124)
    "baseline_only_imaging_nest_small": TrainConfig(
        serve=EXPERIMENTS["baseline_only_imaging_nest_small"],
        lr=_LR, scheduler="cosine_warmup", batch_size=64),
    NEST_UNFUSED: TrainConfig(serve=EXPERIMENTS[NEST_UNFUSED], lr=_LR,
                              scheduler="cosine_warmup", batch_size=64),
    # vit_base sets batch 32 (:263)
    "baseline_only_imaging_vit_base": TrainConfig(
        serve=EXPERIMENTS["baseline_only_imaging_vit_base"], lr=_LR,
        scheduler="cosine_warmup", batch_size=32),
    "baseline_only_imaging_vit_large": TrainConfig(
        serve=EXPERIMENTS["baseline_only_imaging_vit_large"], lr=_LR,
        scheduler="cosine_warmup", batch_size=64),
    # CORAL between dataset 0 and dataset 1 with weight 1000 (:22)
    "baseline_only_imaging_resnet34": TrainConfig(
        serve=EXPERIMENTS["baseline_only_imaging_resnet34"], lr=_LR,
        scheduler="cosine_warmup", batch_size=64, coral_lambda=1000.0),
    "baseline_only_imaging_xrv_resnet50": TrainConfig(
        serve=EXPERIMENTS["baseline_only_imaging_xrv_resnet50"],
        lr=9.142907e-4, scheduler="cosine_warmup", batch_size=32),
}
