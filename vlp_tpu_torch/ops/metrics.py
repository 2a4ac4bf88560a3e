"""Streaming binary-classification metrics as additive counters
(counterpart of ``vlp_tpu/ops/metrics.py``).

The state is a few counters and two 4096-bin score histograms (of the
sigmoid, per class) on the device; a batch updates it without a host sync,
the states of several loaders add (``merge_states``), and
``compute_metrics`` gives accuracy, precision, recall, F1, balanced
accuracy, the binned AUROC and the mean loss: the metric set the reference
logs per dataloader. The arithmetic is the JAX package's in fp32, so the
same logits give the same counters and histograms. ``auroc_exact`` and
``binary_report`` are the exact host-side versions (rank AUROC with average
ties, as sklearn's ``roc_auc_score``). On a data mesh each rank adds its
own rows and ``reduce_state`` sums the states over the ranks before
``compute_metrics`` (the JAX package's ``psum_state``): the counters and
histograms hold integer counts, so the sum is exact and the same on every
rank.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from vlp_tpu_torch.parallel.collectives import all_reduce_

DEFAULT_BINS = 4096


class BinaryMetricState(NamedTuple):
    tp: torch.Tensor
    fp: torch.Tensor
    tn: torch.Tensor
    fn: torch.Tensor
    pos_hist: torch.Tensor  # [bins] score histogram of positives
    neg_hist: torch.Tensor
    loss_sum: torch.Tensor
    count: torch.Tensor


def init_state(bins: int = DEFAULT_BINS, device=None) -> BinaryMetricState:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return BinaryMetricState(
        tp=z, fp=z, tn=z, fn=z,
        pos_hist=torch.zeros(bins, dtype=torch.float32, device=device),
        neg_hist=torch.zeros(bins, dtype=torch.float32, device=device),
        loss_sum=z, count=z)


def update_state(state: BinaryMetricState, logits: torch.Tensor,
                 labels: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 loss: Optional[torch.Tensor] = None) -> BinaryMetricState:
    """The state with one batch added; ``loss`` (the batch's mean over its
    real rows) counts once per real row."""
    logits = logits.reshape(-1).float()
    labels = labels.reshape(-1).float()
    m = torch.ones_like(labels) if mask is None \
        else mask.reshape(-1).float()
    probs = torch.sigmoid(logits)
    pred = (probs >= 0.5).float()
    bins = state.pos_hist.shape[0]
    idx = torch.clamp((probs * bins).to(torch.int32), 0, bins - 1).long()
    n = m.sum()
    loss_sum = state.loss_sum if loss is None \
        else state.loss_sum + loss.float() * n
    return BinaryMetricState(
        tp=state.tp + (pred * labels * m).sum(),
        fp=state.fp + (pred * (1 - labels) * m).sum(),
        tn=state.tn + ((1 - pred) * (1 - labels) * m).sum(),
        fn=state.fn + ((1 - pred) * labels * m).sum(),
        pos_hist=state.pos_hist.index_add(0, idx, labels * m),
        neg_hist=state.neg_hist.index_add(0, idx, (1 - labels) * m),
        loss_sum=loss_sum, count=state.count + n)


def merge_states(a: BinaryMetricState, b: BinaryMetricState
                 ) -> BinaryMetricState:
    return BinaryMetricState(*(x + y for x, y in zip(a, b)))


def reduce_state(state: BinaryMetricState, mesh) -> BinaryMetricState:
    """The sum of every rank's state (the state itself without a mesh), in
    one all-reduce."""
    if mesh is None:
        return state
    flat = all_reduce_(torch.cat([t.reshape(-1) for t in state]), mesh)
    sizes = [t.numel() for t in state]
    return BinaryMetricState(*(part.reshape(t.shape) for part, t in zip(
        flat.split(sizes), state)))


def _auroc_from_hists(pos_hist: torch.Tensor, neg_hist: torch.Tensor
                      ) -> torch.Tensor:
    """P(score_pos > score_neg) + 0.5 P(tie) from the histograms: the
    positives of a bin beat the negatives of every lower bin and tie with
    those of their own."""
    neg_cum_below = torch.cat([neg_hist.new_zeros(1),
                               torch.cumsum(neg_hist, 0)[:-1]])
    wins = (pos_hist * neg_cum_below).sum()
    ties = (pos_hist * neg_hist).sum()
    p, n = pos_hist.sum(), neg_hist.sum()
    return torch.where((p > 0) & (n > 0), (wins + 0.5 * ties) / (p * n),
                       torch.zeros_like(p))


def compute_metrics(state: BinaryMetricState, prefix: str = ""
                    ) -> Dict[str, torch.Tensor]:
    """acc/precision/recall/f1/auroc/balanced_accuracy/loss, the metric set
    the reference logs per dataloader (OnlyImagingModule.py:386-430); 0-d
    tensors on the state's device."""
    tp, fp, tn, fn = state.tp, state.fp, state.tn, state.fn
    one = torch.ones_like(tp)
    acc = (tp + tn) / torch.maximum(tp + fp + tn + fn, one)
    precision = tp / torch.maximum(tp + fp, one)
    recall = tp / torch.maximum(tp + fn, one)
    specificity = tn / torch.maximum(tn + fp, one)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    return {
        f"{prefix}accuracy": acc,
        f"{prefix}precision": precision,
        f"{prefix}recall": recall,
        f"{prefix}f1": f1,
        f"{prefix}auroc": _auroc_from_hists(state.pos_hist, state.neg_hist),
        f"{prefix}balanced_accuracy": (recall + specificity) / 2.0,
        f"{prefix}loss": state.loss_sum / torch.maximum(state.count, one),
    }


# --------------------------------------------------------------------------
# Exact host-side metrics (offline eval parity)
# --------------------------------------------------------------------------

def auroc_exact(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUROC with average ties (== sklearn.roc_auc_score); nan
    when a class is absent."""
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    # average rank of each run of equal scores
    starts = np.flatnonzero(np.r_[True, sorted_scores[1:]
                                  != sorted_scores[:-1]])
    ends = np.r_[starts[1:], scores.size]
    r = np.repeat((starts + 1 + ends) / 2.0, ends - starts)
    ranks = np.empty_like(scores)
    ranks[order] = r
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def binary_report(scores: np.ndarray, labels: np.ndarray,
                  threshold: float = 0.5) -> Dict[str, float]:
    """Exact acc/balanced-acc/auroc/precision/recall/f1 — the per-subgroup
    metric set of the offline eval CLI (reference
    scripts/test_eval_downstream.py:244-278)."""
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(int)
    pred = (scores >= threshold).astype(int)
    tp = int(((pred == 1) & (labels == 1)).sum())
    fp = int(((pred == 1) & (labels == 0)).sum())
    tn = int(((pred == 0) & (labels == 0)).sum())
    fn = int(((pred == 0) & (labels == 1)).sum())
    total = max(tp + fp + tn + fn, 1)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    specificity = tn / max(tn + fp, 1)
    return {
        "accuracy": (tp + tn) / total,
        "balanced_accuracy": (recall + specificity) / 2,
        "auroc": auroc_exact(scores, labels),
        "precision": precision,
        "recall": recall,
        "f1": 2 * precision * recall / max(precision + recall, 1e-12),
        "support": float(total),
    }
