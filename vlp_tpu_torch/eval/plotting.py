"""t-SNE, silhouette scores and confusion counts on the device, and their
figures (counterpart of ``vlp_tpu/eval/plotting.py``; reference
src/utils/plotting/plot_tsne_and_calculate_silhouette.py:15-130 and
plot_confusion_matrix.py:14-93).

The numbers are plain PyTorch on the tensors' device:

- ``silhouette_score(features, labels)``: scikit-learn's
  ``silhouette_score`` (Euclidean), in fp64, the distances formed a block
  of rows at a time so that N of several thousand fits;
- ``tsne(features)``: scikit-learn 1.9's ``TSNE(n_components=2,
  perplexity=min(30, max(2, N // 4)))`` (``joint_probabilities_nn``: the P
  matrix over ``min(N - 1, int(3 perplexity + 1))`` nearest neighbours,
  a per-row binary search on squared distances, symmetrised and
  normalised; PCA init scaled to std 1e-4 on column 0; learning rate
  ``max(N / 12 / 4, 50)``; early exaggeration 12 for 250 iterations at
  momentum 0.5, then momentum 0.8 up to 1000; gains with ``min_gain``
  0.01, one degree of freedom, the error checked every 50 iterations,
  stops at ``min_grad_norm`` 1e-7 and after 300 iterations without
  progress). The gradient is the exact N x N one, where scikit-learn's
  Barnes-Hut tree approximates it (ROADMAP, "Reference behaviours");
- ``confusion_counts(probs, labels)``: the 2 x 2 counts, ``>=`` at the
  threshold.

``plot_tsne_and_silhouette`` and ``plot_confusion_matrix`` keep the JAX
signatures, file names and return values and draw with matplotlib (Agg),
which is imported only inside them. Where it is not installed they log
one line naming the figure that is not drawn and skip the t-SNE (the JAX
package computes it only to draw it); the silhouettes and the counts are
returned all the same, so a summary's numbers never depend on a plotting
library.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from vlp_tpu_torch.train.step import collect_over_loader
from vlp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

MACHINE_EPSILON = float(np.finfo(np.float64).eps)
# sklearn/manifold/_utils.pyx: the binary search's limits
PERPLEXITY_TOLERANCE = 1e-5
SEARCH_STEPS = 100
EPSILON_DBL = 1e-8
# sklearn/manifold/_t_sne.py: TSNE's defaults and schedule
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITERS = 250
MAX_ITER = 1000
CHECK_EVERY = 50
ITERS_WITHOUT_PROGRESS = 300
MIN_GAIN = 0.01
MIN_GRAD_NORM = 1e-7
ROW_BLOCK = 1024


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _flat(features) -> torch.Tensor:
    """[N, ...] features as an [N, F] tensor (numpy arrays onto the CPU);
    more than two dimensions are flattened, as the JAX function does."""
    x = torch.as_tensor(features)
    return x.reshape(x.shape[0], -1) if x.ndim > 2 else x


def _codes(labels, device) -> Tuple[torch.Tensor, int]:
    """(integer codes [N] on ``device``, number of distinct labels) of a
    label tensor, array or list (strings too)."""
    if isinstance(labels, torch.Tensor):
        _, codes = torch.unique(labels.reshape(-1), return_inverse=True)
        codes = codes.to(device)
    else:
        _, codes = np.unique(np.asarray(labels), return_inverse=True)
        codes = torch.as_tensor(codes.reshape(-1), device=device)
    n = int(codes.max()) + 1 if codes.numel() else 0
    return codes, n


def silhouette_score(features, labels, block: int = ROW_BLOCK) -> float:
    """The mean silhouette coefficient over the samples (Euclidean
    distances, fp64, ``block`` rows at a time): a sample's mean distance to
    its own cluster a (itself left out) and to the nearest other cluster b
    give (b - a) / max(a, b), 0 in a cluster of one. Raises, as
    scikit-learn does, unless 2 <= labels <= N - 1."""
    x = _flat(features).to(torch.float64)
    codes, k = _codes(labels, x.device)
    n = x.shape[0]
    if not 2 <= k <= n - 1:
        raise ValueError(f"Number of labels is {k}. Valid values are 2 to "
                         "n_samples - 1 (inclusive)")
    onehot = torch.nn.functional.one_hot(codes, k).to(torch.float64)
    counts = onehot.sum(0)
    sil = torch.empty(n, dtype=torch.float64, device=x.device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        rows = torch.arange(stop - start, device=x.device)
        dist = torch.cdist(x[start:stop], x)
        dist[rows, rows + start] = 0.0
        sums = dist @ onehot  # [rows, clusters]
        own = codes[start:stop, None]
        a = sums.gather(1, own).squeeze(1) / (counts[own.squeeze(1)] - 1)
        b = (sums / counts).scatter(1, own, math.inf).min(1).values
        sil[start:stop] = torch.nan_to_num((b - a) / torch.maximum(a, b))
    return float(sil.mean())


def _binary_search_perplexity(sqd: torch.Tensor, perplexity: float
                              ) -> torch.Tensor:
    """Each row's conditional probabilities over its neighbours' squared
    distances ``sqd`` [N, k] (fp32, as scikit-learn casts them), the
    precision found by bisection to the entropy log(perplexity) within
    1e-5 in at most 100 steps; fp64, every row's steps in lockstep, a row
    frozen once it has converged (``_utils._binary_search_perplexity``)."""
    d = sqd.to(torch.float64)
    n = d.shape[0]
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    beta_min = torch.full_like(beta, -math.inf)
    beta_max = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=d.device)
    probs = torch.zeros_like(d)
    desired = math.log(float(np.float32(perplexity)))
    for _ in range(SEARCH_STEPS):
        p = torch.exp(-d * beta[:, None])
        total = p.sum(1)
        total = torch.where(total == 0.0, EPSILON_DBL, total)
        p = p / total[:, None]
        entropy = torch.log(total) + beta * (d * p).sum(1)
        diff = entropy - desired
        probs = torch.where(done[:, None], probs, p)
        active = ~done & ~(diff.abs() <= PERPLEXITY_TOLERANCE)
        up = active & (diff > 0.0)
        down = active & ~(diff > 0.0)
        b0 = beta
        beta = torch.where(up, torch.where(torch.isinf(beta_max), b0 * 2.0,
                                           (b0 + beta_max) / 2.0), beta)
        beta = torch.where(down, torch.where(torch.isinf(beta_min), b0 / 2.0,
                                             (b0 + beta_min) / 2.0), beta)
        beta_min = torch.where(up, b0, beta_min)
        beta_max = torch.where(down, b0, beta_max)
        done = ~active
        if bool(done.all()):
            break
    return probs


def default_perplexity(n: int) -> int:
    """The JAX function's perplexity for ``n`` samples (``plotting.py:42``)."""
    return min(30, max(2, n // 4))


def joint_probabilities_nn(features, perplexity: Optional[float] = None,
                           block: int = ROW_BLOCK) -> torch.Tensor:
    """t-SNE's input similarities P [N, N] (fp64, on the features' device):
    each sample's ``min(N - 1, int(3 perplexity + 1))`` nearest neighbours
    (squared Euclidean distances in fp64, then fp32), their conditional
    probabilities, P + P^T normalised to sum 1
    (``_t_sne._joint_probabilities_nn``)."""
    x = _flat(features).to(torch.float64)
    n = x.shape[0]
    perplexity = default_perplexity(n) if perplexity is None else perplexity
    if perplexity >= n:
        raise ValueError("perplexity must be less than n_samples")
    k = min(n - 1, int(3.0 * perplexity + 1))
    sq = (x * x).sum(1)
    dists, neighbours = [], []
    for start in range(0, n, block):
        stop = min(start + block, n)
        rows = torch.arange(stop - start, device=x.device)
        d2 = (sq[start:stop, None] + sq[None, :]
              - 2.0 * x[start:stop] @ x.T).clamp_min_(0.0)
        d2[rows, rows + start] = math.inf
        d, idx = torch.topk(d2, k, dim=1, largest=False)
        dists.append(d)
        neighbours.append(idx)
    cond = _binary_search_perplexity(torch.cat(dists).to(torch.float32),
                                     perplexity)
    p = torch.zeros(n, n, dtype=torch.float64, device=x.device)
    p.scatter_(1, torch.cat(neighbours), cond)
    p = p + p.T
    return p / max(float(p.sum()), MACHINE_EPSILON)


def _pca_init(x: torch.Tensor) -> torch.Tensor:
    """The first two principal components' scores (fp32), signs as
    scikit-learn's ``svd_flip`` (each component's largest entry positive),
    scaled so that column 0 has std 1e-4."""
    xc = x - x.mean(0)
    if xc.shape[0] >= xc.shape[1]:
        _, vecs = torch.linalg.eigh(xc.T @ xc)
        comps = vecs[:, -2:].flip(1)
    else:
        _, vecs = torch.linalg.eigh(xc @ xc.T)
        comps = xc.T @ vecs[:, -2:].flip(1)
        comps = comps / comps.norm(dim=0)
    cols = torch.arange(2, device=x.device)
    comps = comps * torch.sign(comps[comps.abs().argmax(0), cols])
    emb = (xc @ comps).to(torch.float32)
    return emb / emb[:, 0].std(correction=0) * 1e-4


def _kl_gradient(y: torch.Tensor, p: torch.Tensor, error: bool):
    """(KL(P || Q) or None, dKL/dy) at the embedding ``y`` [N, 2] (fp32):
    Student-t similarities with one degree of freedom, the exact sums over
    every pair."""
    dx = y[:, 0:1] - y[:, 0]
    dy = y[:, 1:2] - y[:, 1]
    w = 1.0 / (1.0 + dx * dx + dy * dy)
    w.fill_diagonal_(0.0)
    q = w / w.sum()
    pq = (p - q) * w
    grad = 4.0 * torch.stack([(pq * dx).sum(1), (pq * dy).sum(1)], 1)
    kl = None
    if error:
        tiny = torch.finfo(torch.float32).tiny
        kl = torch.where(p > 0, p * torch.log(p.clamp_min(tiny)
                                              / q.clamp_min(tiny)),
                         0.0).sum(dtype=torch.float64)
    return kl, grad


def _gradient_descent(y: torch.Tensor, p: torch.Tensor, it: int,
                      max_iter: int, momentum: float, learning_rate: float,
                      without_progress: int):
    """scikit-learn's ``_gradient_descent`` with its gains, the error and
    the gradient's norm read every ``CHECK_EVERY`` iterations; returns
    (y, error, last iteration)."""
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % CHECK_EVERY == 0
        kl, grad = _kl_gradient(y, p, check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_min_(
            MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        y = y + update
        if kl is not None:
            error = float(kl)
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > without_progress:
                break
            if grad_norm <= MIN_GRAD_NORM:
                break
    return y, error, i


def tsne(features, perplexity: Optional[float] = None, seed: int = 42
         ) -> Tuple[torch.Tensor, float]:
    """(embedding [N, 2] fp32, final KL divergence) of scikit-learn 1.9's
    ``TSNE(n_components=2, random_state=seed, perplexity=perplexity)`` with
    the exact gradient, on the features' device. The PCA init makes it
    deterministic: ``seed`` is kept for the JAX signature."""
    del seed
    x = _flat(features).to(torch.float64)
    n = x.shape[0]
    perplexity = default_perplexity(n) if perplexity is None else perplexity
    p = joint_probabilities_nn(x, perplexity)
    y = _pca_init(x)
    lr = max(n / EARLY_EXAGGERATION / 4.0, 50.0)
    y, _, it = _gradient_descent(
        y, (p * EARLY_EXAGGERATION).to(torch.float32), 0, EXPLORATION_ITERS,
        0.5, lr, EXPLORATION_ITERS)
    y, kl, _ = _gradient_descent(y, p.to(torch.float32), it + 1, MAX_ITER,
                                 0.8, lr, ITERS_WITHOUT_PROGRESS)
    return y, kl


def confusion_counts(probs, labels, threshold: float = 0.5) -> torch.Tensor:
    """[2, 2] counts (rows the true label, columns the prediction ``probs
    >= threshold``), int64 on the probabilities' device."""
    probs = torch.as_tensor(probs).reshape(-1)
    labels = torch.as_tensor(labels, device=probs.device).reshape(-1).long()
    preds = (probs >= threshold).long()
    return torch.bincount(labels * 2 + preds, minlength=4).reshape(2, 2)


def _not_drawn(out_path: str) -> None:
    logger.warning("matplotlib is not installed: %s is not drawn", out_path)


def plot_tsne_and_silhouette(features, tumor_labels, dataset_labels,
                             out_path: str, seed: int = 42,
                             title: str = "t-SNE of features",
                             draw: bool = True) -> Dict[str, float]:
    """Silhouette scores by tumor label and by dataset label (a key only
    where its labels take more than one value and fewer than N); with
    ``draw`` and matplotlib, the two-panel t-SNE scatter at ``out_path``."""
    x = _flat(features)
    scores: Dict[str, float] = {}
    for name, labels in (("tumor", tumor_labels),
                         ("dataset", dataset_labels)):
        if 1 < _codes(labels, x.device)[1] < x.shape[0]:
            scores[f"silhouette_{name}"] = silhouette_score(x, labels)
    if not draw:
        return scores
    plt = _pyplot()
    if plt is None:
        _not_drawn(out_path)
        return scores
    emb = tsne(x, seed=seed)[0].cpu().numpy()
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    for ax, labels, name in (
            (axes[0], torch.as_tensor(tumor_labels).cpu().numpy(), "tumor"),
            (axes[1], np.asarray(dataset_labels), "dataset")):
        for v in sorted(set(labels.tolist())):
            m = labels == v
            ax.scatter(emb[m, 0], emb[m, 1], s=8, alpha=0.7, label=str(v))
        ax.set_title(f"{title} by {name}")
        ax.legend()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    logger.info("Saved t-SNE plot to %s (%s)", out_path, scores)
    return scores


def plot_confusion_matrix(probs, labels, out_path: str,
                          threshold: float = 0.5, normalize: bool = True
                          ) -> np.ndarray:
    """The [2, 2] counts as floats; with matplotlib, the (row-normalised)
    heatmap at ``out_path``."""
    cm = confusion_counts(probs, labels, threshold).cpu().numpy().astype(
        float)
    plt = _pyplot()
    if plt is None:
        _not_drawn(out_path)
        return cm
    plot = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1) if normalize \
        else cm
    fig, ax = plt.subplots(figsize=(4, 4))
    im = ax.imshow(plot, cmap="Blues", vmin=0, vmax=plot.max() or 1)
    for i in range(2):
        for j in range(2):
            ax.text(j, i, f"{plot[i, j]:.2f}", ha="center", va="center")
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    ax.set_xticks([0, 1], ["no tumor", "tumor"])
    ax.set_yticks([0, 1], ["no tumor", "tumor"])
    fig.colorbar(im)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return cm


def plot_val_outputs(task, val_loaders, plot_dir: str, suffix: str = "",
                     draw: bool = True) -> Dict[str, float]:
    """One pass of ``task.plot_outputs_fn`` (features and logit from one
    eval-mode forward) over each non-empty loader of ``val_loaders``,
    named by their keys (the dataset labels): the silhouette scores and,
    with ``draw``, ``tsne_val<suffix>.png`` and ``confusion_val<suffix>.png``
    under ``plot_dir``. On a mesh every rank gathers the global rows in
    order, so every rank gets the same scores."""
    outs, labels, datasets = [], [], []
    for name, loader in val_loaders.items():
        if len(loader) == 0:
            continue
        out, y = collect_over_loader(task.plot_outputs_fn, loader)
        outs.append(out)
        labels.append(y)
        datasets.extend([name] * len(y))
    if not datasets:
        return {}
    out, y = torch.cat(outs), torch.cat(labels)
    scores = plot_tsne_and_silhouette(
        out[:, :-1], y, datasets,
        os.path.join(plot_dir, f"tsne_val{suffix}.png"), draw=draw)
    if draw:
        plot_confusion_matrix(
            torch.sigmoid(out[:, -1]), y,
            os.path.join(plot_dir, f"confusion_val{suffix}.png"))
    return scores
