"""Epoch-level retrieval metrics: label precision@k and image->text
recall@k (counterpart of ``vlp_tpu/ops/retrieval.py``).

Same semantics as the reference (VisionLanguageModule.py:364-439):
- precision@k: cosine top-(k+1) over image-image sims, drop the first hit
  (self), fraction of remaining k sharing the query's label, averaged.
- recall@k: aligned image->text sims; fraction of rows whose own index is
  in the top-k.

The masked forms leave out padded rows (``mask == 0``) as queries and as
gallery columns (their sims set to ``finfo(float32).min``), equal to the
unmasked forms on the compacted rows. Ties rank as ``jax.lax.top_k`` ranks
them, the lower index first: duplicate captions give bit-identical text
embeddings, so exact ties are common. ``torch.topk`` promises no order for
ties, so the ranking is a stable descending sort. The values are 0-d
tensors on the embeddings' device; nothing reaches the host.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from vlp_tpu_torch.ops.losses import l2_normalize


def _top(sims: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices of each row's ``k`` largest, ties lower index first."""
    return torch.sort(sims, dim=1, descending=True, stable=True)[1][:, :k]


def _image_sims(image_embeddings: torch.Tensor) -> torch.Tensor:
    emb = l2_normalize(image_embeddings.float())
    return emb @ emb.T


def _pair_sims(image_embeddings: torch.Tensor,
               text_embeddings: torch.Tensor) -> torch.Tensor:
    return l2_normalize(image_embeddings.float()) \
        @ l2_normalize(text_embeddings.float()).T


def _masked(sims: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid[None, :], sims,
                       torch.finfo(torch.float32).min)


def label_precision_at_k(image_embeddings: torch.Tensor,
                         labels: torch.Tensor,
                         ks: Sequence[int] = (3, 5, 10, 15)
                         ) -> Dict[int, torch.Tensor]:
    n = image_embeddings.shape[0]
    assert all(k + 1 <= n for k in ks), "k+1 must be <= number of samples"
    idx = _top(_image_sims(image_embeddings), max(ks) + 1)  # col 0 ~ self
    match = (labels[idx[:, 1:]] == labels.reshape(-1, 1)).float()
    return {k: match[:, :k].mean(dim=1).mean() for k in ks}


def masked_label_precision_at_k(image_embeddings: torch.Tensor,
                                labels: torch.Tensor, mask: torch.Tensor,
                                ks: Sequence[int] = (3, 5, 10, 15)
                                ) -> Dict[int, torch.Tensor]:
    """Padding-aware precision@k; the caller ensures at least max(ks) + 1
    valid rows."""
    valid = mask.reshape(-1) > 0
    sims = _masked(_image_sims(image_embeddings), valid)
    idx = _top(sims, max(ks) + 1)
    match = (labels[idx[:, 1:]] == labels.reshape(-1, 1)).float()
    row_w = valid.float()
    denom = torch.clamp(row_w.sum(), min=1.0)
    return {k: (match[:, :k].mean(dim=1) * row_w).sum() / denom for k in ks}


def masked_image_text_recall_at_k(image_embeddings: torch.Tensor,
                                  text_embeddings: torch.Tensor,
                                  mask: torch.Tensor,
                                  ks: Sequence[int] = (3, 5, 10, 15)
                                  ) -> Dict[int, torch.Tensor]:
    """Padding-aware recall@k over aligned (image_i, text_i) pairs."""
    valid = mask.reshape(-1) > 0
    sims = _masked(_pair_sims(image_embeddings, text_embeddings), valid)
    n = sims.shape[0]
    targets = torch.arange(n, device=sims.device).reshape(-1, 1)
    idx = _top(sims, max(ks))
    row_w = valid.float()
    denom = torch.clamp(row_w.sum(), min=1.0)
    return {k: ((idx[:, :k] == targets).any(dim=1).float() * row_w).sum()
            / denom for k in ks}


def image_text_recall_at_k(image_embeddings: torch.Tensor,
                           text_embeddings: torch.Tensor,
                           ks: Sequence[int] = (3, 5, 10, 15)
                           ) -> Dict[int, torch.Tensor]:
    sims = _pair_sims(image_embeddings, text_embeddings)
    n = sims.shape[0]
    targets = torch.arange(n, device=sims.device).reshape(-1, 1)
    idx = _top(sims, max(ks))
    return {k: (idx[:, :k] == targets).any(dim=1).float().mean()
            for k in ks}
