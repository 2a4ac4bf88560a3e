"""The imaging-only classifier and the vision-language pretraining tasks
(counterparts of ``OnlyImagingTask`` and ``VisionLanguageTask`` in
``vlp_tpu/models/tasks.py``).

``OnlyImagingTask``: augmentation or normalisation, backbone, a 1-logit
head, the weighted masked BCE of ``loss_fn`` with the CORAL term between
the features of dataset 0 (source) and dataset 1 (target) when
``coral_lambda > 0``, and the per-sample outputs of ``eval_fn``.
``VisionLanguageTask``: the same augmentation (``shear_rows`` and
``add_gaussian_noise``), the dual tower (``models/vlm.py``) and the CLIP
loss that ``loss_variant`` names (``symmetric_infonce``, ``masked`` or
``non_square``). Pretrain batches hold ``image_u8``, ``input_ids``,
``attention_mask``, ``caption_id`` and ``mask``. A task sets the model's
mode as the JAX task passes ``train=``: ``loss_fn`` in training mode
(BatchNorm on batch statistics, running statistics updated), the other
entry points in eval mode under ``inference_mode``. The fusion task is not
ported yet (ROADMAP.md)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vlp_tpu_torch.config import ServeConfig, TrainConfig, as_serve_config
from vlp_tpu_torch.models.registry import create_backbone
from vlp_tpu_torch.models.vit import Dense
from vlp_tpu_torch.models.vlm import VisionLanguageModel
from vlp_tpu_torch.ops import losses
from vlp_tpu_torch.ops.augment import (AugmentConfig, augment_and_normalize,
                                       normalize_only)


@dataclasses.dataclass
class TaskStatics:
    """Per-fold statics of the train and eval paths."""

    mean: float = 0.0
    std: float = 1.0
    class_weights: Tuple[float, float] = (1.0, 1.0)
    out_channels: int = 3
    scale_intensity: bool = False
    augment: AugmentConfig = AugmentConfig()


class OnlyImagingModel(nn.Module):
    """Backbone + 1-logit fp32 head; returns (logits [B], features).
    ``backbone_kw`` go to ``create_backbone`` (``fused_attention``,
    ``megakernel``, ``remat``, ``norm_dtype``, ``stem``)."""

    def __init__(self, backbone_name: str, dtype: torch.dtype,
                 in_chans: int = 3,
                 device: Optional[torch.device] = None,
                 **backbone_kw) -> None:
        super().__init__()
        self.backbone, self.feature_dim = create_backbone(
            backbone_name, dtype=dtype, in_chans=in_chans, device=device,
            **backbone_kw)
        self.head = Dense(self.feature_dim, 1, device)

    def forward(self, images: torch.Tensor):
        feats = self.backbone(images)
        return self.head(feats).squeeze(-1), feats


def _backbone_kw(cfg: ServeConfig) -> dict:
    return dict(fused_attention=cfg.fused_attention,
                megakernel=cfg.megakernel, remat=cfg.remat, stem=cfg.stem,
                norm_dtype=torch.bfloat16 if cfg.bn_dtype == "bf16"
                else torch.float32)


class _ImageTask:
    """The image preparation both tasks share."""

    def __init__(self, cfg: ServeConfig, statics: TaskStatics) -> None:
        self.dtype = torch.bfloat16 if cfg.precision == "bf16" \
            else torch.float32
        self.statics = statics

    def _prep_train(self, batch: Dict[str, torch.Tensor],
                    gen: torch.Generator) -> torch.Tensor:
        s = self.statics
        return augment_and_normalize(
            batch["image_u8"], gen, s.mean, s.std, s.augment,
            out_channels=s.out_channels, dtype=self.dtype,
            scale_intensity=s.scale_intensity)

    def _prep_eval(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        s = self.statics
        return normalize_only(batch["image_u8"], s.mean, s.std,
                              out_channels=s.out_channels, dtype=self.dtype,
                              scale_intensity=s.scale_intensity)


class OnlyImagingTask(_ImageTask):
    def __init__(self, cfg: ServeConfig, statics: TaskStatics,
                 device: Optional[torch.device] = None,
                 coral_lambda: float = 0.0) -> None:
        super().__init__(cfg, statics)
        self.coral_lambda = float(coral_lambda)
        self.model = OnlyImagingModel(
            cfg.model, self.dtype, statics.out_channels, device,
            **_backbone_kw(cfg))

    def loss_fn(self, batch: Dict[str, torch.Tensor], gen: torch.Generator
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Train-mode loss with the aux keys of the JAX ``loss_fn``:
        augment (advancing ``gen``) -> backbone (training mode) -> head ->
        weighted masked BCE, plus ``coral_lambda`` times the CORAL loss
        between the features of dataset 0 and dataset 1. Returns (loss,
        {logits, labels, mask, bce, [coral,] loss})."""
        self.model.train()
        logits, feats = self.model(self._prep_train(batch, gen))
        labels = batch["label"].float()
        mask = batch.get("mask", torch.ones_like(labels))
        w = losses.per_sample_class_weights(labels,
                                            self.statics.class_weights)
        loss = losses.bce_with_logits(logits, labels, w, mask)
        aux = {"bce": loss}
        if self.coral_lambda > 0:
            domain = batch["dataset_id"]
            cl = losses.coral_loss(feats, feats, mask * (domain == 0),
                                   mask * (domain == 1))
            loss = loss + self.coral_lambda * cl
            aux["coral"] = cl
        return loss, {"logits": logits, "labels": labels, "mask": mask,
                      **aux, "loss": loss}

    @torch.inference_mode()
    def eval_fn(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Eval mode (running statistics, nothing updated)."""
        self.model.eval()
        logits, _ = self.model(self._prep_eval(batch))
        labels = batch["label"].float()
        mask = batch.get("mask", torch.ones_like(labels))
        w = losses.per_sample_class_weights(labels,
                                            self.statics.class_weights)
        loss = losses.bce_with_logits(logits, labels, w, mask)
        return {"logits": logits, "labels": labels, "mask": mask,
                "dataset_id": batch["dataset_id"], "loss": loss}

    @torch.inference_mode()
    def features_fn(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Pooled backbone features, in eval mode."""
        self.model.eval()
        _, feats = self.model(self._prep_eval(batch))
        return feats


LOSS_VARIANTS = ("symmetric_infonce", "masked", "non_square")


class VisionLanguageTask(_ImageTask):
    """The dual tower and its CLIP loss. ``infonce_impl`` takes the JAX
    task's two values; on one device both compute the dense [B, B] loss,
    as the JAX task does without a multi-device mesh."""

    def __init__(self, cfg: ServeConfig, statics: TaskStatics,
                 device: Optional[torch.device] = None) -> None:
        super().__init__(cfg, statics)
        if cfg.infonce_impl not in ("gspmd", "shard_map"):
            raise ValueError(f"mesh.infonce_impl={cfg.infonce_impl!r} "
                             "(expected 'gspmd' or 'shard_map')")
        if cfg.loss_variant not in LOSS_VARIANTS:
            raise ValueError(f"model.loss_variant={cfg.loss_variant!r} "
                             f"(expected one of {LOSS_VARIANTS})")
        self.scale_max = float(cfg.logit_scale_max)
        self.loss_variant = cfg.loss_variant
        self.infonce_impl = cfg.infonce_impl
        self.model = VisionLanguageModel(
            cfg.model, cfg.text_model, cfg.embedding_dim, cfg.image_dropout,
            cfg.logit_scale_init, self.dtype, statics.out_channels, device,
            **_backbone_kw(cfg))

    def _embed(self, images, batch):
        return self.model(images, batch["input_ids"],
                          batch["attention_mask"])

    def loss_fn(self, batch: Dict[str, torch.Tensor], gen: torch.Generator
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Train-mode loss: augment (advancing ``gen``) -> both towers ->
        the variant's loss. Returns (loss, {loss, logit_scale, img_emb,
        txt_emb, mask})."""
        self.model.train()
        img_emb, txt_emb, logit_scale = self._embed(
            self._prep_train(batch, gen), batch)
        mask = batch.get("mask", torch.ones(img_emb.shape[0],
                                            device=img_emb.device))
        logits = losses.clip_logits(img_emb, txt_emb, logit_scale,
                                    self.scale_max)
        if self.loss_variant == "masked":
            loss = losses.masked_infonce(logits, batch["caption_id"], mask)
        elif self.loss_variant == "non_square":
            loss = losses.non_square_infonce(logits, batch["caption_id"],
                                             mask)
        else:
            loss = losses.symmetric_infonce(logits, mask)
        # logit_scale is the parameter itself, which the optimizer updates
        # in place: aux keeps the value this loss used
        return loss, {"loss": loss,
                      "logit_scale": logit_scale.detach().clone(),
                      "img_emb": img_emb, "txt_emb": txt_emb, "mask": mask}

    @torch.inference_mode()
    def eval_fn(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Eval mode: both embeddings and the symmetric loss."""
        self.model.eval()
        img_emb, txt_emb, logit_scale = self._embed(self._prep_eval(batch),
                                                    batch)
        logits = losses.clip_logits(img_emb, txt_emb, logit_scale,
                                    self.scale_max)
        mask = batch.get("mask", torch.ones(logits.shape[0],
                                            device=logits.device))
        return {"img_emb": img_emb, "txt_emb": txt_emb, "mask": mask,
                "loss": losses.symmetric_infonce(logits, mask)}

    @torch.inference_mode()
    def embed_images_fn(self, batch: Dict[str, torch.Tensor]
                        ) -> torch.Tensor:
        """Projected image embeddings (retrieval, precision@k)."""
        self.model.eval()
        return self.model.encode_image(self._prep_eval(batch))

    @torch.inference_mode()
    def features_fn(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Un-projected backbone features (the linear probe)."""
        self.model.eval()
        return self.model.image_features(self._prep_eval(batch))


def build_task(cfg, statics: TaskStatics,
               device: Optional[torch.device] = None):
    """``cfg``: a ``ServeConfig``, a ``TrainConfig`` or a
    ``vlp_tpu.config.Config``."""
    coral = cfg.coral_lambda if isinstance(cfg, TrainConfig) else 0.0
    cfg = as_serve_config(cfg)
    if cfg.task == "only_imaging":
        return OnlyImagingTask(cfg, statics, device, coral)
    if cfg.task == "vision_language":
        return VisionLanguageTask(cfg, statics, device)
    if cfg.task == "fusion":
        raise NotImplementedError(
            f"task {cfg.task!r} is not ported to vlp_tpu_torch yet; "
            "see ROADMAP.md")
    raise ValueError(f"unknown task {cfg.task!r}")
