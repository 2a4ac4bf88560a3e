"""The imaging-only classifier task (counterpart of the ``OnlyImaging``
parts of ``vlp_tpu/models/tasks.py``): augmentation or normalisation,
backbone, a 1-logit head, the weighted masked BCE of ``loss_fn`` with the
CORAL term between the features of dataset 0 (source) and dataset 1
(target) when ``coral_lambda > 0``, and the per-sample outputs of
``eval_fn``. The task sets the model's mode as the JAX task passes
``train=``: ``loss_fn`` in training mode (BatchNorm on batch statistics,
running statistics updated), ``eval_fn`` and ``features_fn`` in eval mode.
Fusion and vision-language tasks are not ported yet (ROADMAP.md)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vlp_tpu_torch.config import ServeConfig, TrainConfig, as_serve_config
from vlp_tpu_torch.models.registry import create_backbone
from vlp_tpu_torch.models.vit import Dense
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


class OnlyImagingTask:
    def __init__(self, cfg: ServeConfig, statics: TaskStatics,
                 device: Optional[torch.device] = None,
                 coral_lambda: float = 0.0) -> None:
        self.dtype = torch.bfloat16 if cfg.precision == "bf16" \
            else torch.float32
        self.statics = statics
        self.coral_lambda = float(coral_lambda)
        self.model = OnlyImagingModel(
            cfg.model, self.dtype, statics.out_channels, device,
            fused_attention=cfg.fused_attention, megakernel=cfg.megakernel,
            remat=cfg.remat, stem=cfg.stem,
            norm_dtype=torch.bfloat16 if cfg.bn_dtype == "bf16"
            else torch.float32)

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


def build_task(cfg, statics: TaskStatics,
               device: Optional[torch.device] = None) -> OnlyImagingTask:
    """``cfg``: a ``ServeConfig``, a ``TrainConfig`` or a
    ``vlp_tpu.config.Config``."""
    coral = cfg.coral_lambda if isinstance(cfg, TrainConfig) else 0.0
    cfg = as_serve_config(cfg)
    if cfg.task == "only_imaging":
        return OnlyImagingTask(cfg, statics, device, coral)
    if cfg.task in ("fusion", "vision_language"):
        raise NotImplementedError(
            f"task {cfg.task!r} is not ported to vlp_tpu_torch yet; "
            "see ROADMAP.md")
    raise ValueError(f"unknown task {cfg.task!r}")
