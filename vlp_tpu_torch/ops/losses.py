"""The losses ``OnlyImagingTask.eval_fn`` reports (counterparts of
``vlp_tpu/ops/losses.py:per_sample_class_weights`` and
``bce_with_logits``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    weights: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample-weighted binary cross entropy with logits, the mean of
    ``w * loss`` over the (masked) batch, as torch ``BCEWithLogitsLoss(
    weight=w, reduction='mean')`` with the reference's per-sample weights."""
    logits = logits.float().reshape(-1)
    labels = labels.float().reshape(-1)
    per = logits.clamp(min=0) - logits * labels + torch.log1p(
        torch.exp(-logits.abs()))
    if weights is not None:
        per = per * weights.reshape(-1)
    if mask is None:
        return per.mean()
    mask = mask.reshape(-1)
    return (per * mask).sum() / mask.sum().clamp(min=1.0)


def per_sample_class_weights(labels: torch.Tensor,
                             class_weights: Tuple[float, float]
                             ) -> torch.Tensor:
    """w_i = w1 if label_i == 1 else w0."""
    labels = labels.reshape(-1).float()
    return labels * class_weights[1] + (1.0 - labels) * class_weights[0]
