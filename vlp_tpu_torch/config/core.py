"""The port's copy of the config system (``vlp_tpu/config/core.py``): the
typed dataclass tree, the experiment registry and the ``dotted.path=value``
command-line overrides, field for field and default for default, so that
an experiment resolves to the same values on both sides
(``tests/test_torch_port_experiments.py`` holds every registered
experiment's ``to_dict()`` against ``vlp_tpu.config.get_experiment``).
Pure Python: the machine with the card has no JAX package to read it from.
Fields that only the JAX package acts on (``trainer.scan_steps``'s K-step
dispatch) are kept so that every command line that resolves there
resolves here; the port's driver refuses the mesh values it cannot run.
"""
from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass
class OptimizerConfig:
    """Reference configs/optimizer/{adamw,adam}.yaml."""

    name: str = "adamw"  # adamw | adam | sgd
    lr: float = 1e-3
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


@dataclass
class SchedulerConfig:
    """Reference configs/scheduler/{cosine,cosine_warmup,no_scheduler}.yaml."""

    name: str = "cosine"  # cosine | cosine_warmup | none
    warmup_epochs: int = 4  # cosine_with_warmup: num_warmup_steps=4 (epochs)


@dataclass
class ModelConfig:
    """Covers the three task modules (reference src/models/).

    task selects between OnlyImaging / Fusion / VisionLanguage semantics
    (reference OnlyImagingModule.py:35, FusionModule.py:36,
    VisionLanguageModule.py:63).
    """

    task: str = "only_imaging"  # only_imaging | fusion | vision_language
    model: str = "resnet34"
    # Allowlist mirrors reference OnlyImagingModule.py:25-32 plus text towers.
    # resnet18|resnet34|resnet50|vit_base_patch16_224|vit_large_patch16_224|
    # nest_small|resnet50-res512-all (torchxrayvision)
    pretrained: bool = False  # torchxrayvision-style pretrained weights
    stem: str = "conv7"  # conv7 (weight-importable) | s2d (space-to-depth, faster from scratch)
    # ViT/NesT Pallas fused block-attention (ops/block_attention.py);
    # None = model default. Changes the attn param-tree structure.
    fused_attention: Optional[bool] = None
    # Half-block Pallas megakernels for ViT/NesT (ops/fused_block.py):
    # LN+attention+residual / LN+MLP+residual fused per program. Param-tree
    # compatible with the fused path; per-shape fallback when unsupported.
    megakernel: bool = True
    # Per-block rematerialization for ViT/NesT (torch.utils.checkpoint per
    # encoder block); a ResNet takes it and ignores it.
    remat: bool = False
    pretrained_ckpt: Optional[str] = None  # VLP checkpoint warm-start path
    freeze_encoder: bool = False
    vision_encoder_lr: Optional[float] = None  # split-LR param group
    coral_lambda: float = 0.0  # CORAL domain-adaptation loss weight
    num_classes: int = 1  # binary head
    # --- fusion (reference FusionModule.py:58-69,117) ---
    clinical_in_dim: int = 15  # one-hot site 13 + age bin 1 + sex 1
    clinical_hidden: Tuple[int, ...] = (32, 20, 10)
    image_feature_out: int = 10  # image-branch logits into fusion head
    # --- vision_language (reference VisionLanguageModule.py) ---
    text_model: str = "distilbert"  # distilbert | tinybert
    embedding_dim: int = 128
    image_dropout: float = 0.0
    logit_scale_init: float = 2.6592  # log(1/0.07)
    logit_scale_max: float = 100.0  # exp clamp (VisionLanguageModule.py:456)
    image_encoder_lr: Optional[float] = None  # lr=0 freezes the tower
    text_encoder_lr: Optional[float] = None
    projection_lr: Optional[float] = None
    loss_variant: str = "symmetric_infonce"  # | non_square | masked (deprecated in ref)
    retrieval_ks: Tuple[int, ...] = (3, 5, 10, 15)


@dataclass
class DataConfig:
    """Reference configs/data/{downstream,pretrain}.yaml + datamodule kwargs."""

    name: str = "downstream"  # downstream | pretrain | synthetic_downstream | synthetic_pretrain
    batch_size: int = 128
    eval_batch_size: int = 256
    image_size: int = 224
    crop_larger_dimension: bool = False  # CropLargerDimension on/off
    maximum_crop_ratio: float = 0.05
    disable_augmentations: bool = False
    gaussian_noise_augmentation: bool = True
    shear_augmentation: bool = False  # pretrain adds shear_range=[5,5]
    try_with_only_n_samples: Optional[int] = None
    scale_intensity_normalization: bool = False  # torchxrayvision path
    in_channels: int = 3  # 1 for torchxrayvision
    n_folds_downstream: int = 4
    n_folds_pretrain: int = 5
    seed: int = 42
    # pretrain only:
    tokenizer: str = "distilbert"  # distilbert | tinybert
    max_token_length: int = 40
    sampler_mode_train: str = "full"  # NoDuplicateCaptionSampler probabilistic_mode
    sampler_mode_val: str = "semi"
    captions_csv: Optional[str] = None  # defaults to res/data/pretrain/captions.csv
    # synthetic fixtures:
    synthetic_num_samples: int = 64
    # host pipeline:
    prefetch_depth: int = 2
    cache_dir: Optional[str] = None  # defaults to <output_dir>/datacache


@dataclass
class TrainerConfig:
    """Reference configs/trainer/default.yaml + callback bundles."""

    max_epochs: int = 10
    min_epochs: int = 1
    log_every_n_steps: int = 1
    precision: str = "bf16"  # bf16 | fp32 (compute dtype for the backbone)
    bn_dtype: str = "fp32"  # fp32 | bf16 BatchNorm compute (bf16 skips cast round trips)
    checkpoint_monitor: str = "val/combined/accuracy"
    checkpoint_mode: str = "max"
    early_stopping_monitor: Optional[str] = None
    early_stopping_mode: str = "max"
    early_stopping_patience: int = 35
    save_top_k: int = 1
    linear_probe_every_n_epochs: int = 5  # reference LinearProbeCallback.py:33
    # Cache train-step embeddings for train-epoch retrieval metrics
    # (reference logs them; off by default, enable when train-epoch
    # retrieval curves are needed).
    cache_train_embeddings: bool = False
    # Full-state 'last' checkpoint each epoch (params + opt_state + step +
    # RNG + loop counters) enabling exact resume via ckpt_path — the
    # analogue of Lightning's resume (reference src/train.py:171).
    save_last: bool = True
    # Write checkpoints (best + last) asynchronously: a background thread
    # writes a host copy of the state while the next epoch trains; the meta
    # sidecar and old-best deletion are deferred to the commit barrier, and
    # Trainer.fit() awaits all writes before returning. off gives the
    # reference's synchronous Lightning semantics.
    async_checkpointing: bool = True
    # K training steps per dispatch in the JAX package (lax.scan); the port
    # takes the value and runs one step a dispatch, with the same metrics.
    scan_steps: int = 8
    deterministic_data: bool = False  # cache val batches (sampler deterministic mode)
    profile: bool = False  # torch.profiler trace of the first epoch
    profile_dir: Optional[str] = None


@dataclass
class MeshConfig:
    """Device mesh of the JAX package. The port reads every field as the
    JAX package does (``parallel/mesh.py``): ``data_parallel`` (-1: the
    launcher's world over ``model_parallel``), ``model_parallel`` (the
    model axis of the 2-D mesh), ``infonce_impl`` and ``param_sharding``
    (``parallel/fsdp.py``, ``parallel/tp.py``), with the JAX driver's
    refusals; a mesh that does not tile the launcher's world raises
    (ROADMAP Queue 1 item 14)."""

    data_parallel: int = -1  # -1 => all visible devices (after model axis)
    axis_name: str = "data"
    # > 1 builds a 2-D (data, model) mesh; combine with param_sharding=tp.
    model_parallel: int = 1
    model_axis_name: str = "model"
    infonce_impl: str = "gspmd"  # gspmd | shard_map (shard_map: 1-D mesh)
    # replicated (plain DP) | fsdp (ZeRO-style: params + Adam moments
    # sharded over the data axis; GSPMD all-gather/reduce-scatter) |
    # tp (tensor parallel: weights + moments sharded over the MODEL axis
    # of a model_parallel>1 mesh; GSPMD partitions the matmuls/convs).
    param_sharding: str = "replicated"


@dataclass
class Config:
    """Root (reference configs/train.yaml)."""

    task_name: str = "train"
    experiment: Optional[str] = None
    tags: Tuple[str, ...] = ("dev",)
    seed: int = 42
    train: bool = True
    test: bool = False
    ckpt_path: Optional[str] = None
    k_fold_cross_validation: bool = False
    # Skip folds whose fold{i}.done.json completion marker (written by the
    # driver after every finished fold) matches this config. Safe by
    # construction: the marker embeds a config fingerprint, so changed
    # hyperparameters/data scales force a re-run instead of silently mixing
    # results (used by scripts/rehearse_matrix.py for unattended resume).
    resume_completed_folds: bool = False
    output_dir: str = "outputs"
    logger: str = "jsonl"  # jsonl | wandb (reference configs/logger/wandb.yaml)
    wandb_project: str = "vlp_tpu"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # VLP downstream eval datamodule (reference mounts /data@downstream_data).
    downstream_data: DataConfig = field(
        default_factory=lambda: DataConfig(name="downstream", batch_size=128)
    )

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# --------------------------------------------------------------------------
# Experiment registry (the configs/experiment/** analogue)
# --------------------------------------------------------------------------

_EXPERIMENTS: Dict[str, Callable[[Config], Config]] = {}


def register_experiment(name: str):
    def deco(fn: Callable[[Config], Config]):
        if name in _EXPERIMENTS:
            raise ValueError(f"experiment {name!r} already registered")
        _EXPERIMENTS[name] = fn
        return fn

    return deco


def get_experiment(name: str) -> Config:
    if name not in _EXPERIMENTS:
        raise KeyError(
            f"unknown experiment {name!r}; available: {sorted(_EXPERIMENTS)}"
        )
    cfg = Config()
    cfg = _EXPERIMENTS[name](cfg) or cfg
    cfg.experiment = name
    return cfg


def list_experiments() -> List[str]:
    return sorted(_EXPERIMENTS)


# --------------------------------------------------------------------------
# Overrides: hydra-style "a.b.c=value"
# --------------------------------------------------------------------------

def _parse_value(raw: str) -> Any:
    low = raw.lower()
    if low in ("null", "none"):
        return None
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    """Apply ``dotted.path=value`` overrides in place. ``experiment=<name>``
    swaps in the registered experiment config first (like hydra's
    ``experiment=`` group selection)."""
    exp = [o for o in overrides if o.startswith("experiment=")]
    rest = [o for o in overrides if not o.startswith("experiment=")]
    if exp:
        cfg = get_experiment(exp[-1].split("=", 1)[1])
    for item in rest:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        key, raw = item.split("=", 1)
        node: Any = cfg
        parts = key.split(".")
        for part in parts[:-1]:
            if not hasattr(node, part):
                raise AttributeError(f"config has no field {key!r} (at {part!r})")
            node = getattr(node, part)
        leaf = parts[-1]
        if not hasattr(node, leaf):
            raise AttributeError(f"config has no field {key!r}")
        current = getattr(node, leaf)
        value = _parse_value(raw)
        if isinstance(current, tuple) and isinstance(value, list):
            value = tuple(value)
        setattr(node, leaf, value)
    return cfg
