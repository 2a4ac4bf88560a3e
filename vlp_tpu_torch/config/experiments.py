"""Built-in experiment matrix: the port's copy of
``vlp_tpu/config/experiments/__init__.py``, registered under the same names
with the same values (``tests/test_torch_port_experiments.py``).

Mirrors the reference 9-experiment matrix + pretrain + ablations
(reference configs/experiment/**; results table reference README.md:138-150).
Best hyperparameters come from the reference's tuned final configs, e.g.
configs/experiment/baseline_only_imaging/
baseline_only_imaging_best_resnet_34_with_STOSOP_augmentations_and_coral_k_fold.yaml:25-31.
"""
from vlp_tpu_torch.config.core import Config, register_experiment


# --------------------------------------------------------------------------
# Supervised baselines — imaging only
# --------------------------------------------------------------------------

@register_experiment("baseline_only_imaging_resnet34")
def baseline_only_imaging_resnet34(cfg: Config) -> Config:
    """Imaging / Scratch ResNet34 (README row 1). Tuned: lr 1.2925748e-4,
    batch 64, coral_lambda 1000, cosine-with-warmup."""
    cfg.model.task = "only_imaging"
    cfg.model.model = "resnet34"
    cfg.model.coral_lambda = 1000.0
    cfg.data.name = "downstream"
    cfg.data.batch_size = 64
    cfg.data.crop_larger_dimension = True  # STOSOP augmentations variant
    cfg.optimizer.lr = 1.2925748253710286e-4
    cfg.scheduler.name = "cosine_warmup"
    cfg.trainer.checkpoint_monitor = "val/combined/accuracy"
    cfg.trainer.early_stopping_monitor = "val/combined/accuracy"
    cfg.trainer.early_stopping_patience = 35
    cfg.k_fold_cross_validation = True
    return cfg


@register_experiment("baseline_only_imaging_nest_small")
def baseline_only_imaging_nest_small(cfg: Config) -> Config:
    cfg = baseline_only_imaging_resnet34(cfg)
    cfg.model.model = "nest_small"
    cfg.model.coral_lambda = 0.0
    return cfg


@register_experiment("baseline_only_imaging_xrv_resnet50")
def baseline_only_imaging_xrv_resnet50(cfg: Config) -> Config:
    """Imaging / Torchxrayvision Finetune ResNet50. Tuned: lr 9.142907e-4,
    batch 32, 1-channel, scale-intensity normalization (−1024..1024)."""
    cfg.model.task = "only_imaging"
    cfg.model.model = "resnet50-res512-all"
    cfg.model.pretrained = True
    cfg.data.name = "downstream"
    cfg.data.batch_size = 32
    cfg.data.in_channels = 1
    cfg.data.scale_intensity_normalization = True
    cfg.optimizer.lr = 9.142907e-4
    cfg.scheduler.name = "cosine_warmup"
    cfg.k_fold_cross_validation = True
    return cfg


# --------------------------------------------------------------------------
# Supervised baselines — imaging + clinical late fusion
# --------------------------------------------------------------------------

@register_experiment("baseline_fusion_resnet34")
def baseline_fusion_resnet34(cfg: Config) -> Config:
    cfg = baseline_only_imaging_resnet34(cfg)
    cfg.model.task = "fusion"
    return cfg


@register_experiment("baseline_fusion_nest_small")
def baseline_fusion_nest_small(cfg: Config) -> Config:
    cfg = baseline_fusion_resnet34(cfg)
    cfg.model.model = "nest_small"
    cfg.model.coral_lambda = 0.0
    return cfg


@register_experiment("fusion_xrv_resnet50")
def fusion_xrv_resnet50(cfg: Config) -> Config:
    cfg = baseline_only_imaging_xrv_resnet50(cfg)
    cfg.model.task = "fusion"
    return cfg


# --------------------------------------------------------------------------
# VLP pretraining
# --------------------------------------------------------------------------

def _pretrain_common(cfg: Config) -> Config:
    cfg.model.task = "vision_language"
    cfg.model.embedding_dim = 128
    cfg.data.name = "pretrain"
    cfg.data.batch_size = 128
    cfg.data.shear_augmentation = True  # pretrain adds shear_range=[5,5]
    cfg.optimizer.lr = 1e-3
    cfg.scheduler.name = "cosine"
    cfg.trainer.checkpoint_monitor = (
        "downstream_validation/linear_probe_balanced_accuracy"
    )
    cfg.trainer.early_stopping_monitor = (
        "downstream_validation/linear_probe_balanced_accuracy"
    )
    cfg.trainer.early_stopping_patience = 26
    return cfg


@register_experiment("pretrain_resnet34_distilbert")
def pretrain_resnet34_distilbert(cfg: Config) -> Config:
    cfg = _pretrain_common(cfg)
    cfg.model.model = "resnet34"
    cfg.model.text_model = "distilbert"
    cfg.data.tokenizer = "distilbert"
    return cfg


@register_experiment("pretrain_resnet34_tinybert")
def pretrain_resnet34_tinybert(cfg: Config) -> Config:
    cfg = _pretrain_common(cfg)
    cfg.model.model = "resnet34"
    cfg.model.text_model = "tinybert"
    cfg.data.tokenizer = "tinybert"
    return cfg


@register_experiment("pretrain_resnet18_tinybert")
def pretrain_resnet18_tinybert(cfg: Config) -> Config:
    cfg = _pretrain_common(cfg)
    cfg.model.model = "resnet18"
    cfg.model.text_model = "tinybert"
    cfg.data.tokenizer = "tinybert"
    return cfg


@register_experiment("pretrain_resnet50_distilbert")
def pretrain_resnet50_distilbert(cfg: Config) -> Config:
    cfg = _pretrain_common(cfg)
    cfg.model.model = "resnet50"
    cfg.model.text_model = "distilbert"
    cfg.data.tokenizer = "distilbert"
    return cfg


@register_experiment("pretrain_resnet18_tinybert_overfit")
def pretrain_resnet18_tinybert_overfit(cfg: Config) -> Config:
    """Capacity check: 1 epoch cap, augmentations off (reference
    configs/experiment/pretrain/pretrain_resnet18_tinybert_overfit.yaml)."""
    cfg = pretrain_resnet18_tinybert(cfg)
    cfg.data.disable_augmentations = True
    cfg.trainer.max_epochs = 100
    cfg.data.try_with_only_n_samples = 100
    return cfg


# --------------------------------------------------------------------------
# Transfer: linear probe / fine-tune from VLP checkpoints
# --------------------------------------------------------------------------

@register_experiment("vlp_linear_probe_resnet34")
def vlp_linear_probe_resnet34(cfg: Config) -> Config:
    """Imaging / VLP Linear Probe: frozen encoder + logistic-regression probe
    (reference scripts/linear_probe_test_eval_downstream.py)."""
    cfg.model.task = "only_imaging"
    cfg.model.model = "resnet34"
    cfg.model.freeze_encoder = True
    cfg.model.pretrained_ckpt = "REQUIRED:path/to/vlp_checkpoint"
    cfg.data.name = "downstream"
    cfg.k_fold_cross_validation = True
    return cfg


@register_experiment("vlp_finetune_only_imaging_resnet34")
def vlp_finetune_only_imaging_resnet34(cfg: Config) -> Config:
    """Imaging / VLP Finetune. Tuned: lr 8.503173e-4, vision-encoder lr /10
    (reference configs/experiment/finetune_imaging_and_clinical/..._different_lr_vision_encoder.yaml:24-36)."""
    cfg.model.task = "only_imaging"
    cfg.model.model = "resnet34"
    cfg.model.pretrained_ckpt = "REQUIRED:path/to/vlp_checkpoint"
    cfg.optimizer.lr = 8.503173273116282e-4
    cfg.model.vision_encoder_lr = 8.503173273116282e-5
    cfg.data.name = "downstream"
    cfg.data.batch_size = 64
    cfg.scheduler.name = "cosine_warmup"
    cfg.k_fold_cross_validation = True
    return cfg


@register_experiment("vlp_finetune_fusion_resnet34")
def vlp_finetune_fusion_resnet34(cfg: Config) -> Config:
    """Reference finetune_imaging_and_clinical_best_resnet_34_k_fold.yaml:
    batch 8, coral 1000, single LR 8.503173273116282e-4 (the split-LR
    variant is vlp_finetune_fusion_resnet34_split_lr)."""
    cfg = vlp_finetune_only_imaging_resnet34(cfg)
    cfg.model.task = "fusion"
    cfg.data.batch_size = 8
    cfg.model.coral_lambda = 1000.0
    cfg.model.vision_encoder_lr = None
    return cfg


@register_experiment("vlp_finetune_fusion_resnet34_split_lr")
def vlp_finetune_fusion_resnet34_split_lr(cfg: Config) -> Config:
    """Reference finetune_imaging_and_clinical_resnet_34_different_lr_
    vision_encoder.yaml: vision-encoder LR = optimizer LR / 10, single
    split (no k-fold CV)."""
    cfg = vlp_finetune_fusion_resnet34(cfg)
    cfg.model.vision_encoder_lr = 8.503173273116282e-5
    cfg.k_fold_cross_validation = False
    return cfg


# --------------------------------------------------------------------------
# Ablations / smoke configs (reference only_20/only_100-sample variants)
# --------------------------------------------------------------------------

@register_experiment("baseline_only_imaging_resnet34_only_20_samples")
def baseline_only_imaging_resnet34_only_20(cfg: Config) -> Config:
    cfg = baseline_only_imaging_resnet34(cfg)
    cfg.data.try_with_only_n_samples = 20
    cfg.trainer.max_epochs = 1
    cfg.k_fold_cross_validation = False
    return cfg


@register_experiment("baseline_only_imaging_resnet34_only_100_samples")
def baseline_only_imaging_resnet34_only_100(cfg: Config) -> Config:
    cfg = baseline_only_imaging_resnet34(cfg)
    cfg.data.try_with_only_n_samples = 100
    cfg.trainer.max_epochs = 1
    cfg.k_fold_cross_validation = False
    return cfg


@register_experiment("baseline_only_imaging_resnet34_no_coral")
def baseline_only_imaging_resnet34_no_coral(cfg: Config) -> Config:
    """CORAL ablation (reference keeps both variants in the matrix)."""
    cfg = baseline_only_imaging_resnet34(cfg)
    cfg.model.coral_lambda = 0.0
    return cfg


@register_experiment("baseline_only_imaging_resnet34_no_stosop")
def baseline_only_imaging_resnet34_no_stosop(cfg: Config) -> Config:
    """Without the STOSOP augmentations (crop-larger-dimension off)."""
    cfg = baseline_only_imaging_resnet34(cfg)
    cfg.data.crop_larger_dimension = False
    return cfg


@register_experiment("baseline_only_imaging_resnet50")
def baseline_only_imaging_resnet50(cfg: Config) -> Config:
    cfg = baseline_only_imaging_resnet34(cfg)
    cfg.model.model = "resnet50"
    cfg.model.coral_lambda = 0.0
    return cfg


@register_experiment("baseline_only_imaging_vit_base")
def baseline_only_imaging_vit_base(cfg: Config) -> Config:
    cfg = baseline_only_imaging_resnet34(cfg)
    cfg.model.model = "vit_base_patch16_224"
    cfg.model.coral_lambda = 0.0
    cfg.data.batch_size = 32
    return cfg


@register_experiment("pretrain_resnet34_tinybert_masked_loss")
def pretrain_resnet34_tinybert_masked(cfg: Config) -> Config:
    """Deprecated duplicate-caption masked-logits loss variant (reference
    VisionLanguageModule.py:506-546, kept for the ablation)."""
    cfg = pretrain_resnet34_tinybert(cfg)
    cfg.model.loss_variant = "masked"
    return cfg


@register_experiment("pretrain_resnet34_tinybert_non_square_loss")
def pretrain_resnet34_tinybert_non_square(cfg: Config) -> Config:
    """Deprecated BCE-against-deduplicated-columns variant (reference
    VisionLanguageModule.py:464-504)."""
    cfg = pretrain_resnet34_tinybert(cfg)
    cfg.model.loss_variant = "non_square"
    return cfg


@register_experiment("pretrain_resnet34_tinybert_frozen_text")
def pretrain_resnet34_tinybert_frozen_text(cfg: Config) -> Config:
    """Frozen text tower (reference lr=0 removes the group,
    VisionLanguageModule.py:186-297)."""
    cfg = pretrain_resnet34_tinybert(cfg)
    cfg.model.text_encoder_lr = 0.0
    return cfg


@register_experiment("pretrain_resnet34_tinybert_split_lr")
def pretrain_resnet34_tinybert_split_lr(cfg: Config) -> Config:
    """Per-tower learning rates."""
    cfg = pretrain_resnet34_tinybert(cfg)
    cfg.model.image_encoder_lr = 1e-4
    cfg.model.text_encoder_lr = 1e-5
    cfg.model.projection_lr = 1e-3
    return cfg


@register_experiment("pretrain_resnet34_tinybert_no_augs")
def pretrain_resnet34_tinybert_no_augs(cfg: Config) -> Config:
    cfg = pretrain_resnet34_tinybert(cfg)
    cfg.data.disable_augmentations = True
    return cfg


@register_experiment("vlp_finetune_only_imaging_resnet34_frozen_encoder")
def vlp_finetune_frozen(cfg: Config) -> Config:
    """Frozen-encoder fine-tune variant (head-only training)."""
    cfg = vlp_finetune_only_imaging_resnet34(cfg)
    cfg.model.freeze_encoder = True
    cfg.model.vision_encoder_lr = None
    return cfg


@register_experiment("fusion_only_100_samples")
def fusion_only_100(cfg: Config) -> Config:
    cfg = baseline_fusion_resnet34(cfg)
    cfg.data.try_with_only_n_samples = 100
    cfg.trainer.max_epochs = 1
    cfg.k_fold_cross_validation = False
    return cfg


@register_experiment("smoke_synthetic_only_imaging")
def smoke_synthetic_only_imaging(cfg: Config) -> Config:
    """CI smoke: tiny synthetic downstream set, 1 epoch, small resnet."""
    cfg.model.task = "only_imaging"
    cfg.model.model = "resnet18"
    cfg.data.name = "synthetic_downstream"
    cfg.data.batch_size = 8
    cfg.data.eval_batch_size = 8
    cfg.data.image_size = 64  # small images: CI hosts compile serially
    cfg.data.synthetic_num_samples = 32
    cfg.trainer.max_epochs = 1
    cfg.trainer.precision = "fp32"
    return cfg


@register_experiment("smoke_synthetic_pretrain")
def smoke_synthetic_pretrain(cfg: Config) -> Config:
    cfg = _pretrain_common(cfg)
    cfg.model.model = "resnet18"
    cfg.model.text_model = "tinybert"
    cfg.data.name = "synthetic_pretrain"
    cfg.data.batch_size = 8
    cfg.data.eval_batch_size = 8
    cfg.data.image_size = 64
    cfg.data.max_token_length = 16
    cfg.data.synthetic_num_samples = 32
    cfg.downstream_data.name = "synthetic_downstream"
    cfg.downstream_data.batch_size = 8
    cfg.downstream_data.eval_batch_size = 8
    cfg.downstream_data.image_size = 64
    cfg.downstream_data.synthetic_num_samples = 32
    cfg.trainer.max_epochs = 1
    cfg.trainer.precision = "fp32"
    return cfg


# --------------------------------------------------------------------------
# Remaining reference experiment-file variants (configs/experiment/** has 57
# files; most are thin permutations of the same knobs). Registered here so
# every reference experiment name family has a 1:1 runnable counterpart —
# see STATUS.md for the full mapping table.
# --------------------------------------------------------------------------

def _subsampled(base, n: int):
    """Reference *_only_{20,100}_samples variants: subsample the train set,
    1 epoch, no CV (cheap capacity/overfit checks, SURVEY.md §4.4)."""
    def f(cfg: Config) -> Config:
        cfg = base(cfg)
        cfg.data.try_with_only_n_samples = n
        cfg.trainer.max_epochs = 1
        cfg.k_fold_cross_validation = False
        return cfg
    return f


@register_experiment("baseline_only_imaging_vit_large")
def baseline_only_imaging_vit_large(cfg: Config) -> Config:
    """Reference baseline_only_imaging_vit_large_16* family."""
    cfg = baseline_only_imaging_resnet34(cfg)
    cfg.model.model = "vit_large_patch16_224"
    cfg.model.coral_lambda = 0.0
    return cfg


register_experiment("baseline_only_imaging_nest_small_only_20_samples")(
    _subsampled(baseline_only_imaging_nest_small, 20))
register_experiment("baseline_only_imaging_nest_small_only_100_samples")(
    _subsampled(baseline_only_imaging_nest_small, 100))
register_experiment("baseline_only_imaging_resnet50_only_20_samples")(
    _subsampled(baseline_only_imaging_resnet50, 20))
register_experiment("baseline_only_imaging_resnet50_only_100_samples")(
    _subsampled(baseline_only_imaging_resnet50, 100))
register_experiment("baseline_only_imaging_vit_base_only_20_samples")(
    _subsampled(baseline_only_imaging_vit_base, 20))
register_experiment("baseline_only_imaging_vit_base_only_100_samples")(
    _subsampled(baseline_only_imaging_vit_base, 100))
register_experiment("baseline_only_imaging_vit_large_only_20_samples")(
    _subsampled(baseline_only_imaging_vit_large, 20))
register_experiment("baseline_only_imaging_vit_large_only_100_samples")(
    _subsampled(baseline_only_imaging_vit_large, 100))
register_experiment("baseline_fusion_resnet34_only_20_samples")(
    _subsampled(baseline_fusion_resnet34, 20))
register_experiment("pretrain_resnet34_distilbert_only_20_samples")(
    _subsampled(pretrain_resnet34_distilbert, 20))
register_experiment("pretrain_resnet34_distilbert_only_100_samples")(
    _subsampled(pretrain_resnet34_distilbert, 100))
register_experiment("pretrain_resnet34_tinybert_masked_only_20_samples")(
    _subsampled(pretrain_resnet34_tinybert_masked, 20))


@register_experiment("pretrain_resnet50_distilbert_overfit")
def pretrain_resnet50_distilbert_overfit(cfg: Config) -> Config:
    """Reference pretrain/pretrain_resnet50_distilbert_overfit.yaml."""
    cfg = pretrain_resnet50_distilbert(cfg)
    cfg.data.try_with_only_n_samples = 64
    cfg.data.disable_augmentations = True
    cfg.k_fold_cross_validation = False
    return cfg


@register_experiment("vlp_finetune_only_imaging_resnet34_no_scheduler")
def vlp_finetune_only_imaging_resnet34_no_scheduler(cfg: Config) -> Config:
    """Reference finetune_only_imaging_best_smooth_resnet_34_k_fold.yaml:
    the 'smooth' sweep pick — no LR scheduler, lr 1.216866e-5, batch 32,
    coral 1000, noise augmentation on."""
    cfg = vlp_finetune_only_imaging_resnet34(cfg)
    cfg.scheduler.name = "none"
    cfg.optimizer.lr = 1.216866591368529e-5
    cfg.data.batch_size = 32
    cfg.model.coral_lambda = 1000.0
    return cfg


# --------------------------------------------------------------------------
# File-level parity additions (round 3): every reference experiment yaml
# that was previously covered only at the family level gets a 1:1
# registered counterpart with the reference's tuned values.
# --------------------------------------------------------------------------

@register_experiment("baseline_fusion_resnet34_best_k_fold")
def baseline_fusion_resnet34_best_k_fold(cfg: Config) -> Config:
    """Reference baseline_imaging_and_clinical_best_resnet34_k_fold.yaml
    (and its rerun duplicate baseline_imaging_and_clinical_resnet34_
    rerun_best.yaml): tuned sweep pick as k-fold CV — batch 256,
    lr 6.220838565431242e-4, coral 1000, 300 epochs."""
    cfg = baseline_fusion_resnet34(cfg)
    cfg.data.batch_size = 256
    cfg.optimizer.lr = 6.220838565431242e-4
    cfg.model.coral_lambda = 1000.0
    cfg.trainer.max_epochs = 300
    return cfg


@register_experiment("baseline_fusion_nest_small_best_k_fold")
def baseline_fusion_nest_small_best_k_fold(cfg: Config) -> Config:
    """Reference baseline_imaging_and_clinical_best_nest_small_k_fold.yaml
    (and ..._nest_small_rerun_best.yaml): batch 16,
    lr 4.763841758111732e-5, coral 0, 300 epochs."""
    cfg = baseline_fusion_nest_small(cfg)
    cfg.data.batch_size = 16
    cfg.optimizer.lr = 4.763841758111732e-5
    cfg.trainer.max_epochs = 300
    return cfg


def _distilbert_emb32(cfg: Config) -> Config:
    """The reference distilbert pretrain line uses embedding_dim 32 and
    Adam lr 1e-5 with no scheduler (pretrain_resnet34_distilbert_*.yaml)."""
    cfg = pretrain_resnet34_distilbert(cfg)
    cfg.model.embedding_dim = 32
    cfg.optimizer.name = "adam"
    cfg.optimizer.lr = 1e-5
    cfg.scheduler.name = "none"
    cfg.trainer.max_epochs = 60
    return cfg


@register_experiment("pretrain_resnet34_distilbert_dedup")
def pretrain_resnet34_distilbert_dedup(cfg: Config) -> Config:
    """Reference pretrain_resnet34_distilbert_deduplicate_captions.yaml:
    caption-unique batches via the sampler (deduplicate=true), standard
    symmetric loss, embedding_dim 32, lr 1e-5, batch 128. Caption
    uniqueness is this repo's DEFAULT (NoDuplicateCaptionSampler mode
    'full'), so the knob is the tuned hparams."""
    cfg = _distilbert_emb32(cfg)
    cfg.data.disable_augmentations = True  # reference tags: NO augmentations
    return cfg


@register_experiment("pretrain_resnet34_distilbert_dedup_only_100_samples")
def pretrain_resnet34_distilbert_dedup_only_100(cfg: Config) -> Config:
    """Reference ..._deduplicate_captions_only_100_samples.yaml."""
    cfg = pretrain_resnet34_distilbert_dedup(cfg)
    cfg.data.try_with_only_n_samples = 100
    return cfg


@register_experiment("pretrain_resnet34_distilbert_dedup_only_20_samples")
def pretrain_resnet34_distilbert_dedup_only_20(cfg: Config) -> Config:
    """Reference ..._deduplicate_captions_only_20_samples.yaml."""
    cfg = pretrain_resnet34_distilbert_dedup(cfg)
    cfg.data.try_with_only_n_samples = 20
    return cfg


@register_experiment("pretrain_resnet34_distilbert_masked")
def pretrain_resnet34_distilbert_masked(cfg: Config) -> Config:
    """Reference pretrain_resnet34_distilbert_masked.yaml: duplicate
    captions allowed (no dedup sampler guarantees needed) with the MASKED
    InfoNCE variant, lr 1e-4, embedding_dim 32."""
    cfg = _distilbert_emb32(cfg)
    cfg.model.loss_variant = "masked"
    cfg.optimizer.lr = 1e-4
    return cfg


@register_experiment("pretrain_resnet34_distilbert_masked_only_100_samples")
def pretrain_resnet34_distilbert_masked_only_100(cfg: Config) -> Config:
    """Reference ..._masked_only_100_samples.yaml."""
    cfg = pretrain_resnet34_distilbert_masked(cfg)
    cfg.data.try_with_only_n_samples = 100
    return cfg


@register_experiment("pretrain_resnet34_distilbert_masked_only_20_samples")
def pretrain_resnet34_distilbert_masked_only_20(cfg: Config) -> Config:
    """Reference ..._masked_only_20_samples.yaml and
    ..._masked_only_20_samples_downstream_eval.yaml — the downstream-eval
    wiring (linear probe + precision@k over the downstream data) is ON by
    default in this repo's VLP driver, so the _downstream_eval duplicates
    collapse onto the same experiments."""
    cfg = pretrain_resnet34_distilbert_masked(cfg)
    cfg.data.try_with_only_n_samples = 20
    return cfg


@register_experiment("baseline_only_imaging_nest_small_coral")
def baseline_only_imaging_nest_small_coral(cfg: Config) -> Config:
    """Reference baseline_only_imaging_best_nest_small_with_STOSOP_
    augmentations_and_coral.yaml: the NesT variant WITH the CORAL domain
    loss (the tuned k-fold NesT run dropped it; this keeps the ablation
    runnable 1:1)."""
    cfg = baseline_only_imaging_nest_small(cfg)
    cfg.model.coral_lambda = 1000.0
    return cfg


# --------------------------------------------------------------------------
# Final file-level parity batch: the last reference yamls without a 1:1
# registered counterpart (tuned values cited per file).
# --------------------------------------------------------------------------

@register_experiment("baseline_only_imaging_nest_small_best_k_fold")
def baseline_only_imaging_nest_small_best_k_fold(cfg: Config) -> Config:
    """Reference baseline_only_imaging_best_nest_small_k_fold.yaml (and the
    single-run duplicate baseline_only_imaging_best_nest_small.yaml /
    ..._with_STOSOP_augmentations.yaml): tuned NesT pick — Adam,
    no scheduler, lr 5.480785862708334e-5, batch 16, coral 0, noise
    augmentation off, 300 epochs, k-fold CV."""
    cfg = baseline_only_imaging_nest_small(cfg)
    cfg.optimizer.name = "adam"
    cfg.scheduler.name = "none"
    cfg.optimizer.lr = 5.480785862708334e-5
    cfg.data.batch_size = 16
    cfg.data.gaussian_noise_augmentation = False
    cfg.trainer.max_epochs = 300
    return cfg


@register_experiment("baseline_only_imaging_nest_small_sweep_k_fold")
def baseline_only_imaging_nest_small_sweep_k_fold(cfg: Config) -> Config:
    """Reference baseline_only_imaging_nest_small_best_of_sweep_as_kfold_cv
    .yaml: same tuned pick rerun under the default callback bundle with
    noise augmentation on."""
    cfg = baseline_only_imaging_nest_small_best_k_fold(cfg)
    cfg.data.gaussian_noise_augmentation = True
    return cfg


@register_experiment("baseline_only_imaging_resnet34_sweep_k_fold")
def baseline_only_imaging_resnet34_sweep_k_fold(cfg: Config) -> Config:
    """Reference baseline_only_imaging_resnet_34_best_of_sweep_as_kfold_cv
    .yaml: the sweep pick as k-fold CV WITHOUT the coral/STOSOP additions
    (AdamW, cosine-with-warmup, lr 1.2925748253710286e-4, batch 64,
    300 epochs)."""
    cfg = baseline_only_imaging_resnet34(cfg)
    cfg.model.coral_lambda = 0.0
    cfg.data.crop_larger_dimension = False
    cfg.trainer.max_epochs = 300
    return cfg


@register_experiment("fusion_xrv_resnet50_best_k_fold")
def fusion_xrv_resnet50_best_k_fold(cfg: Config) -> Config:
    """Reference baseline_imaging_and_clinical_resnet50_pretrained_best_
    sweep_k_fold.yaml: xrv fusion sweep pick — cosine scheduler, batch 8,
    coral 1000, lr 5.066641484878657e-4, 300 epochs, k-fold CV."""
    cfg = fusion_xrv_resnet50(cfg)
    cfg.scheduler.name = "cosine"
    cfg.data.batch_size = 8
    cfg.model.coral_lambda = 1000.0
    cfg.optimizer.lr = 5.066641484878657e-4
    cfg.trainer.max_epochs = 300
    return cfg


@register_experiment("fusion_xrv_resnet50_setup_test")
def fusion_xrv_resnet50_setup_test(cfg: Config) -> Config:
    """Reference baseline_imaging_and_clinical_resnet50_pretrained.yaml
    (project 'setup-testing'): tiny smoke of the pretrained fusion path —
    batch 4, 100 samples, coral 0, lr 1e-3, 30 epochs, single split."""
    cfg = fusion_xrv_resnet50(cfg)
    cfg.scheduler.name = "none"
    cfg.data.batch_size = 4
    cfg.data.try_with_only_n_samples = 100
    cfg.model.coral_lambda = 0.0
    cfg.optimizer.lr = 1e-3
    cfg.trainer.max_epochs = 30
    cfg.k_fold_cross_validation = False
    return cfg


@register_experiment("vlp_finetune_fusion_resnet34_frozen_encoder")
def vlp_finetune_fusion_resnet34_frozen_encoder(cfg: Config) -> Config:
    """Reference finetune_imaging_and_clinical_resnet_34_frozen_vision_
    encoder.yaml: VLP-warm-started fusion with the vision tower FROZEN via
    vision_encoder_lr=0 (the reference's lr-0-removes-the-group mechanism),
    batch 8, coral 1000, lr 8.503173273116282e-4."""
    cfg = vlp_finetune_fusion_resnet34(cfg)  # batch 8, coral 1000
    cfg.model.vision_encoder_lr = 0.0
    cfg.k_fold_cross_validation = False
    return cfg


@register_experiment("pretrain_resnet34_tinybert_overfit")
def pretrain_resnet34_tinybert_overfit(cfg: Config) -> Config:
    """Reference pretrain_resnet34_tinybert_overfit.yaml: AdamW, no
    scheduler, augmentations off, no early stopping, 100 epochs."""
    cfg = pretrain_resnet34_tinybert(cfg)
    cfg.scheduler.name = "none"
    cfg.data.disable_augmentations = True
    cfg.trainer.early_stopping_monitor = None
    cfg.trainer.max_epochs = 100
    return cfg
