"""Trainer callbacks: early stopping, best-metric snapshot, the downstream
precision@k and the linear probe (counterpart of
``vlp_tpu/train/callbacks.py``).

- ``EarlyStopping`` (configs/callbacks/early_stopping_*.yaml, patience
  35/15/26).
- ``MetricSnapshot`` (SnapshotAllMetricsOnBestCallback,
  src/utils/MetricSnapshotCallback.py:10): when the monitored metric
  improves, every current metric goes into the run summary as
  ``{monitor}_best_{metric}``; the k-fold driver harvests each fold's
  metrics at its best epoch from there (src/train.py:173-177).
- ``DownstreamPrecisionAtK``: label precision@k of the VLP image tower over
  the downstream validation data at every validation epoch.
- ``LinearProbeCallback`` (src/utils/LinearProbeCallback.py:17): every 5th
  epoch, frozen image-tower features of the downstream train and val sets,
  and a logistic-regression probe fitted on them; balanced accuracy and
  AUROC are logged for checkpointing and early stopping to monitor. The JAX
  package fits sklearn's ``LogisticRegression()``; the machine with the card
  has no scikit-learn, so ``fit_logistic_regression`` solves the same
  problem, L2 with C = 1 and an unpenalised intercept, in fp64 by Newton's
  method to a gradient of 1e-10 (sklearn's lbfgs stops at 1e-4: the two
  probabilities agree to that, ``tests/test_torch_port_callbacks.py``), and
  the metrics are computed in numpy.

On a data mesh the driver's feature and embedding closures gather every
rank's rows (``train/step.collect_over_loader``): every rank fits the same
Newton problem on the same fp64 data and computes the same precision@k,
so the metrics, and the branches taken on them, agree across ranks.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vlp_tpu_torch.ops.metrics import auroc_exact
from vlp_tpu_torch.ops.retrieval import label_precision_at_k
from vlp_tpu_torch.utils.logging import MetricSink, get_logger

logger = get_logger(__name__)


class EarlyStopping:
    def __init__(self, monitor: str, mode: str = "max", patience: int = 35,
                 min_epochs: int = 1) -> None:
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_epochs = min_epochs
        self.best: Optional[float] = None
        self.wait = 0
        self.should_stop = False

    def on_validation_end(self, epoch: int, metrics: Dict[str, float]) -> None:
        if self.monitor not in metrics:
            return
        value = float(metrics[self.monitor])
        improved = (self.best is None or (value > self.best
                                          if self.mode == "max"
                                          else value < self.best))
        if improved:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience and epoch + 1 >= self.min_epochs:
                self.should_stop = True
                logger.info("EarlyStopping: stop at epoch %d (%s plateaued "
                            "for %d epochs)", epoch, self.monitor, self.wait)


class MetricSnapshot:
    """Copies all current metrics into the sink's summary on improvement.
    The snapshot also rides in the checkpoint's sidecar: a resumed process
    starts with an empty summary, and ``restore`` logs it again."""

    def __init__(self, sink: MetricSink, monitor: str, mode: str = "max") -> None:
        self.sink = sink
        self.monitor = monitor
        self.mode = mode
        self.best: Optional[float] = None
        self.snapshot: Optional[Dict[str, float]] = None

    def on_validation_end(self, epoch: int, metrics: Dict[str, float]) -> None:
        if self.monitor not in metrics:
            return
        value = float(metrics[self.monitor])
        if self.best is not None and not (value > self.best
                                          if self.mode == "max"
                                          else value < self.best):
            return
        self.best = value
        snapshot = {f"{self.monitor}_best_{name}": v
                    for name, v in metrics.items()}
        snapshot[f"{self.monitor}_best_epoch"] = epoch
        self.snapshot = snapshot
        self.sink.log_summary(snapshot)

    def restore(self, best: Optional[float],
                snapshot: Optional[Dict[str, float]]) -> None:
        self.best = best
        if snapshot:
            self.snapshot = dict(snapshot)
            self.sink.log_summary(self.snapshot)


class DownstreamPrecisionAtK:
    """Label precision@k of the VLP image tower over the downstream
    validation data at every validation epoch end (reference
    VisionLanguageModule.py:702-705). ``embed() -> (embeddings [N, E],
    labels [N])`` on the device is supplied by the driver, which owns the
    downstream loaders."""

    def __init__(self, embed: Callable, ks=(3, 5, 10, 15),
                 every_n_epochs: int = 1) -> None:
        self.embed = embed
        self.ks = tuple(ks)
        self.every_n_epochs = max(1, every_n_epochs)

    def on_validation_end(self, epoch: int) -> Dict[str, float]:
        if epoch % self.every_n_epochs != 0:
            return {}
        emb, labels = self.embed()
        ks = tuple(k for k in self.ks if k + 1 <= emb.shape[0])
        if not ks:
            return {}
        p = label_precision_at_k(emb, labels, ks=ks)
        values = torch.stack([p[k] for k in ks]).tolist()
        return {f"downstream_validation/label_precision_at_{k}": v
                for k, v in zip(ks, values)}


def fit_logistic_regression(x: np.ndarray, y: np.ndarray, c: float = 1.0,
                            tol: float = 1e-10, max_iter: int = 100
                            ) -> Tuple[np.ndarray, float]:
    """(w, b) minimising C * sum_i logloss(y_i, x_i.w + b) + ||w||^2 / 2,
    sklearn's ``LogisticRegression(C=c)`` objective (the intercept
    unpenalised), in fp64 by Newton's method with a backtracking line
    search, to a gradient max-norm of ``tol``."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64).ravel()
    n, d = x.shape
    xa = np.concatenate([x, np.ones((n, 1))], axis=1)
    reg = np.ones(d + 1)
    reg[-1] = 0.0  # the intercept is not penalised
    theta = np.zeros(d + 1)

    def objective(t):
        z = xa @ t
        # logloss(y, z) = log(1 + e^z) - y z, stably
        return c * np.sum(np.logaddexp(0.0, z) - y * z) + 0.5 * np.sum(
            reg * t * t)

    f = objective(theta)
    for _ in range(max_iter):
        p = 1.0 / (1.0 + np.exp(-(xa @ theta)))
        grad = c * xa.T @ (p - y) + reg * theta
        if np.max(np.abs(grad)) <= tol:
            break
        hess = c * (xa.T * (p * (1 - p))) @ xa + np.diag(reg)
        hess[-1, -1] += 1e-12 * n  # keeps a saturated intercept solvable
        step = np.linalg.solve(hess, grad)
        t, f_new = 1.0, objective(theta - step)
        while f_new > f and t > 1e-10:
            t *= 0.5
            f_new = objective(theta - t * step)
        theta, f = theta - t * step, f_new
    return theta[:-1], float(theta[-1])


def predict_proba(x: np.ndarray, w: np.ndarray, b: float) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-(np.asarray(x, np.float64) @ w + b)))


def balanced_accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """The mean over the classes present in ``y_true`` of their recall
    (sklearn's ``balanced_accuracy_score``)."""
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    return float(np.mean([np.mean(y_pred[y_true == c] == c)
                          for c in np.unique(y_true)]))


class LinearProbeCallback:
    """Fits a logistic-regression probe on frozen image features every N
    validation epochs. ``extract_features() -> (X_train, y_train, X_val,
    y_val)`` in numpy is supplied by the driver."""

    def __init__(self, extract_features: Callable, every_n_epochs: int = 5,
                 max_iter: int = 100) -> None:
        self.extract_features = extract_features
        self.every_n_epochs = max(1, every_n_epochs)
        self.max_iter = max_iter
        # True when the last probe epoch skipped (single-class data): the
        # trainer's missing-monitor rule then warns instead of raising
        self.skipped_last = False

    def on_validation_start(self, epoch: int) -> Dict[str, float]:
        if epoch % self.every_n_epochs != 0:
            return {}
        x_tr, y_tr, x_va, y_va = self.extract_features()
        if len(np.unique(y_tr)) < 2 or len(np.unique(y_va)) < 2:
            # tiny subsampled/synthetic folds can be single-class; a probe
            # is undefined there
            self.skipped_last = True
            logger.warning(
                "LinearProbe epoch %d skipped: single-class data "
                "(train classes %s, val classes %s)", epoch,
                np.unique(y_tr), np.unique(y_va))
            return {}
        self.skipped_last = False
        w, b = fit_logistic_regression(x_tr, y_tr, max_iter=self.max_iter)
        probs = predict_proba(x_va, w, b)
        metrics = {
            "downstream_validation/linear_probe_balanced_accuracy":
                balanced_accuracy(y_va, (probs >= 0.5).astype(int)),
            "downstream_validation/linear_probe_auroc":
                auroc_exact(probs, y_va),
        }
        logger.info("LinearProbe epoch %d: %s", epoch, metrics)
        return metrics
