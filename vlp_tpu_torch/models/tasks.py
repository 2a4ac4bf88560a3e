"""The imaging-only classifier task (counterpart of the ``OnlyImaging``
parts of ``vlp_tpu/models/tasks.py``): normalisation, backbone, a 1-logit
head, and the per-sample outputs of ``eval_fn``. Fusion and
vision-language tasks are not ported yet (ROADMAP.md)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vlp_tpu_torch.config import ServeConfig, as_serve_config
from vlp_tpu_torch.models.registry import create_backbone
from vlp_tpu_torch.models.vit import Dense
from vlp_tpu_torch.ops import losses
from vlp_tpu_torch.ops.augment import normalize_only


@dataclasses.dataclass
class TaskStatics:
    """Per-fold statics of the eval path."""

    mean: float = 0.0
    std: float = 1.0
    class_weights: Tuple[float, float] = (1.0, 1.0)
    out_channels: int = 3
    scale_intensity: bool = False


class OnlyImagingModel(nn.Module):
    """Backbone + 1-logit fp32 head; returns (logits [B], features)."""

    def __init__(self, backbone_name: str, dtype: torch.dtype,
                 in_chans: int = 3,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.backbone, self.feature_dim = create_backbone(
            backbone_name, dtype=dtype, in_chans=in_chans, device=device)
        self.head = Dense(self.feature_dim, 1, device)

    def forward(self, images: torch.Tensor):
        feats = self.backbone(images)
        return self.head(feats).squeeze(-1), feats


class OnlyImagingTask:
    def __init__(self, cfg: ServeConfig, statics: TaskStatics,
                 device: Optional[torch.device] = None) -> None:
        self.dtype = torch.bfloat16 if cfg.precision == "bf16" \
            else torch.float32
        self.statics = statics
        self.model = OnlyImagingModel(cfg.model, self.dtype,
                                      statics.out_channels, device)

    def _prep_eval(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        s = self.statics
        return normalize_only(batch["image_u8"], s.mean, s.std,
                              out_channels=s.out_channels, dtype=self.dtype,
                              scale_intensity=s.scale_intensity)

    @torch.inference_mode()
    def eval_fn(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
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
        """Pooled backbone features."""
        _, feats = self.model(self._prep_eval(batch))
        return feats


def build_task(cfg, statics: TaskStatics,
               device: Optional[torch.device] = None) -> OnlyImagingTask:
    """``cfg``: a ``ServeConfig`` or a ``vlp_tpu.config.Config``."""
    cfg = as_serve_config(cfg)
    if cfg.task == "only_imaging":
        return OnlyImagingTask(cfg, statics, device)
    if cfg.task in ("fusion", "vision_language"):
        raise NotImplementedError(
            f"task {cfg.task!r} is not ported to vlp_tpu_torch yet; "
            "see ROADMAP.md")
    raise ValueError(f"unknown task {cfg.task!r}")
