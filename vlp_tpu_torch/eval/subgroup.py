"""Per-subgroup metric evaluation -> long-format CSV (counterpart of
``vlp_tpu/eval/subgroup.py``), in numpy and the ``csv`` module.

Columns [level, group, fold, metric, value]; the levels are overall,
dataset, entity, anatomy_site, sex, age_encoded and age_group (0-18 /
19-39 / 40+); the metrics accuracy, balanced_accuracy, roc_auc,
precision, recall and f1_score, the last four NaN for a single-class
subgroup. A prediction frame is a dict of equal-length columns in the JAX
frame's order. The CSV is byte-equal to the one pandas writes there:
groups in ``groupby``'s order (strings lexicographic, ``age_encoded`` as
integers), floats by ``repr`` and NaN as ``NaN``, no index, lines ending
in ``\\n``, written to a temporary file that is then renamed.
``aggregate_across_folds`` is pandas' grouped mean (Kahan-summed), std
(Welford, ddof 1) and count, NaN skipped.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from vlp_tpu_torch.data import tables
from vlp_tpu_torch.ops.metrics import auroc_exact

SUBGROUP_LEVELS = ("dataset", "entity", "anatomy_site", "sex",
                   "age_encoded", "age_group")
COLUMNS = ("level", "group", "fold", "metric", "value")
FRAME_COLUMNS = ("prob", "tumor", "dataset", "entity", "anatomy_site",
                 "sex", "age", "age_encoded", "image_path", "age_group")

Frame = Dict[str, list]


def age_group(age) -> str:
    """0-18 / 19-39 / 40+ (reference test_eval_downstream.py age_group)."""
    age = int(age)
    if age <= 18:
        return "0-18"
    if age <= 39:
        return "19-39"
    return "40+"


def calculate_metrics(y_true, y_probs) -> Dict[str, float]:
    y_true = np.asarray(y_true, float).ravel()
    y_probs = np.asarray(y_probs, float).ravel()
    y_pred = (y_probs >= 0.5).astype(int)
    tp = float(((y_pred == 1) & (y_true == 1)).sum())
    fp = float(((y_pred == 1) & (y_true == 0)).sum())
    tn = float(((y_pred == 0) & (y_true == 0)).sum())
    fn = float(((y_pred == 0) & (y_true == 1)).sum())
    total = max(tp + fp + tn + fn, 1.0)
    recall = tp / max(tp + fn, 1.0)
    specificity = tn / max(tn + fp, 1.0)
    precision = tp / max(tp + fp, 1.0)
    out = {"accuracy": (tp + tn) / total,
           "balanced_accuracy": (recall + specificity) / 2.0}
    if len(set(y_true.tolist())) < 2:
        out.update({"roc_auc": float("nan"), "precision": float("nan"),
                    "recall": float("nan"), "f1_score": float("nan")})
    else:
        out.update({
            "roc_auc": auroc_exact(y_probs, y_true),
            "precision": precision,
            "recall": recall,
            "f1_score": 2 * precision * recall
            / max(precision + recall, 1e-12),
        })
    return out


def predictions_frame(probs, samples: Sequence[dict]) -> Frame:
    """The per-sample prediction columns the evaluator reads (reference
    collect_probs, test_eval_downstream.py:26-117)."""
    ages = [int(s["age"]) for s in samples]
    return {
        "prob": np.asarray(probs, float),
        "tumor": np.array([int(s["tumor"]) for s in samples], np.int64),
        "dataset": [str(s["dataset"]) for s in samples],
        "entity": [str(s.get("entity", "undefined")) for s in samples],
        "anatomy_site": [str(s["anatomy_site"]) for s in samples],
        "sex": [str(s["sex"]) for s in samples],
        "age": np.array(ages, np.int64),
        "age_encoded": np.array([int(s["age_encoded"]) for s in samples],
                                np.int64),
        "image_path": [str(s["image_path"]) for s in samples],
        "age_group": [age_group(a) for a in ages],
    }


def _groups(column) -> Dict[object, np.ndarray]:
    """Sorted group value -> the row indices holding it (``groupby``'s
    order: integers numerically, strings lexicographically)."""
    values = [v.item() if isinstance(v, np.generic) else v for v in column]
    out: Dict[object, List[int]] = {}
    for i, v in enumerate(values):
        out.setdefault(v, []).append(i)
    return {k: np.asarray(out[k]) for k in sorted(out)}


def write_csv(path: str, columns: Sequence[str], rows: Sequence[tuple]
              ) -> None:
    """``rows`` under a ``columns`` header as pandas' ``to_csv(index=False,
    na_rep="NaN")`` writes them, through a temporary file and a rename."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tables.write_csv(path, columns, rows, na_rep="NaN")


def evaluate_results(output_file: Optional[str], frames: Sequence[Frame]
                     ) -> Dict[str, list]:
    """Per-fold overall + per-subgroup metrics -> the long table's columns
    (``COLUMNS``), also written to ``output_file`` when given."""
    rows = []

    def emit(level, group, fold, idx, frame):
        metrics = calculate_metrics(np.asarray(frame["tumor"])[idx],
                                    np.asarray(frame["prob"])[idx])
        rows.extend((level, group, fold, m, float(v))
                    for m, v in metrics.items())

    for fold, frame in enumerate(frames):
        missing = {"tumor", "prob", "entity", "anatomy_site", "dataset",
                   "sex", "age", "age_encoded", "age_group"} - set(frame)
        if missing:
            raise ValueError(f"prediction frame missing columns {missing}")
        emit("overall", "overall", fold, slice(None), frame)
        for level in SUBGROUP_LEVELS:
            for group, idx in _groups(frame[level]).items():
                emit(level, group, fold, idx, frame)
    if output_file:
        write_csv(output_file, COLUMNS, rows)
    return {c: [r[i] for r in rows] for i, c in enumerate(COLUMNS)}


def _mean_std(values: Sequence[float]):
    """pandas' grouped mean (Kahan sum), std (Welford, ddof 1) and count
    over the values that are not NaN."""
    total = comp = mean = m2 = 0.0
    n = 0
    for v in values:
        if math.isnan(v):
            continue
        n += 1
        y = v - comp
        t = total + y
        comp = t - total - y
        total = t
        old = mean
        mean += (v - old) / n
        m2 += (v - old) * (v - mean)
    nan = float("nan")
    return (total / n if n else nan,
            math.sqrt(m2 / (n - 1)) if n > 1 else nan, n)


def aggregate_across_folds(results: Dict[str, list]) -> Dict[str, list]:
    """mean/std/count per (level, group, metric), the 4-fold CV aggregate
    of the reference README's results table; columns level, group,
    metric, mean, std, count, rows in ``groupby``'s order."""
    cells: Dict[tuple, List[float]] = {}
    for level, group, metric, value in zip(
            results["level"], results["group"], results["metric"],
            results["value"]):
        cells.setdefault((level, group, metric), []).append(float(value))
    # groupby sorts each key's values: the integer groups before the
    # strings, each kind in its own order
    keys = sorted(cells, key=lambda k: (k[0], isinstance(k[1], str), k[1],
                                        k[2]))
    out: Dict[str, list] = {c: [] for c in ("level", "group", "metric",
                                            "mean", "std", "count")}
    for key in keys:
        mean, std, count = _mean_std(cells[key])
        for c, v in zip(("level", "group", "metric", "mean", "std",
                         "count"), (*key, mean, std, count)):
            out[c].append(v)
    return out
