"""The losses of ``OnlyImagingTask`` (counterparts of
``vlp_tpu/ops/losses.py:per_sample_class_weights``, ``bce_with_logits``,
``_masked_covariance`` and ``coral_loss``)."""
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


def _masked_covariance(x: torch.Tensor, mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Covariance over the masked rows of x [N, D], Bessel-corrected, in
    the reference's form ``(X^T X - n mu mu^T) / max(n - 1, 1)`` (not
    ``torch.cov``: the cancellation is part of what is computed)."""
    mask = mask.reshape(-1, 1).to(x.dtype)
    n = mask.sum()
    xm = x * mask
    mean = xm.sum(0, keepdim=True) / n.clamp(min=1.0)  # [1, D]
    c = (xm.T @ xm - n * (mean.T @ mean)) / (n - 1.0).clamp(min=1.0)
    return c, n


def coral_loss(source: torch.Tensor, target: torch.Tensor,
               source_mask: Optional[torch.Tensor] = None,
               target_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sum((Cov_s - Cov_t)^2) / (4 d^2)`` in fp32 over the masked rows;
    0 unless both domains have at least 2 samples. The unselected branch is
    finite (n is clamped before it divides), so its zero gradient stays
    zero."""
    source, target = source.float(), target.float()
    d = source.shape[1]
    sm = torch.ones(source.shape[0], device=source.device) \
        if source_mask is None else source_mask
    tm = torch.ones(target.shape[0], device=target.device) \
        if target_mask is None else target_mask
    cs, ns = _masked_covariance(source, sm)
    ct, nt = _masked_covariance(target, tm)
    loss = ((cs - ct) ** 2).sum() / (4.0 * d * d)
    return torch.where((ns >= 2) & (nt >= 2), loss, torch.zeros_like(loss))
