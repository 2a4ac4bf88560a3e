"""The losses of ``OnlyImagingTask`` and ``VisionLanguageTask``
(counterparts of ``vlp_tpu/ops/losses.py``): the weighted masked BCE and
CORAL, and the CLIP losses, all in fp32 over fixed-shape batches whose
padded rows carry ``mask`` 0."""
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


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(
        min=eps)


def clip_logits(image_emb: torch.Tensor, text_emb: torch.Tensor,
                logit_scale: torch.Tensor,
                scale_max: float = 100.0) -> torch.Tensor:
    """Both towers L2-normalised in fp32, ``scale = min(exp(logit_scale),
    scale_max)`` (exp, then the clamp), ``img @ txt^T * scale`` [B, B]."""
    img = l2_normalize(image_emb.float())
    txt = l2_normalize(text_emb.float())
    scale = torch.exp(logit_scale).clamp(max=scale_max)
    return img @ txt.T * scale


def _masked_softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean cross entropy over the valid rows; invalid columns become -1e9
    so that a padded sample is no negative."""
    if mask is not None:
        logits = torch.where(mask.reshape(1, -1) > 0, logits,
                             torch.full_like(logits, -1e9))
    logp = torch.log_softmax(logits, dim=-1)
    per = -logp.gather(1, labels.reshape(-1, 1)).reshape(-1)
    if mask is None:
        return per.mean()
    m = mask.reshape(-1)
    return (per * m).sum() / m.sum().clamp(min=1.0)


def symmetric_infonce(logits: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(CE(logits) + CE(logits^T)) / 2 with the diagonal as targets."""
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (_masked_softmax_xent(logits, labels, mask)
            + _masked_softmax_xent(logits.T, labels, mask)) / 2.0


def duplicate_caption_mask(caption_ids: torch.Tensor) -> torch.Tensor:
    """[B, B]: 0 where j != i holds i's caption, 1 elsewhere."""
    same = caption_ids.reshape(-1, 1) == caption_ids.reshape(1, -1)
    eye = torch.eye(caption_ids.shape[0], dtype=torch.bool,
                    device=caption_ids.device)
    return (~(same & ~eye)).float()


def masked_infonce(logits: torch.Tensor, caption_ids: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The deprecated duplicate-tolerant variant as the reference computes
    it: the logits of another image's duplicate caption are multiplied by
    0 (they stay in the softmax as zeros), then the symmetric loss; ``mask``
    drops padded rows and columns."""
    masked = logits * duplicate_caption_mask(caption_ids)
    return symmetric_infonce(masked, mask)


def non_square_infonce(logits: torch.Tensor, caption_ids: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The deprecated BCE against de-duplicated columns, in the JAX
    package's fixed-shape form: only the first column of each caption
    group counts (weight 1, the others 0), target[i, u] = 1 iff image i's
    caption is u's, and the weighted BCE grid is averaged over
    valid rows x first-occurrence columns."""
    cid = caption_ids.reshape(-1)
    n = cid.shape[0]
    same = cid.reshape(1, -1) == cid.reshape(-1, 1)
    idx = torch.arange(n, device=cid.device)
    # the first True of each row (argmax returns the first maximum)
    is_first = (same.int().argmax(1) == idx).float()
    row_w = torch.ones(n, device=cid.device) if mask is None \
        else mask.reshape(-1).float()
    is_first = is_first * row_w
    target = same.float()
    per = logits.clamp(min=0) - logits * target + torch.log1p(
        torch.exp(-logits.abs()))
    u = is_first.sum().clamp(min=1.0)
    rows = row_w.sum().clamp(min=1.0)
    return (per * is_first.reshape(1, -1)
            * row_w.reshape(-1, 1)).sum() / (rows * u)
