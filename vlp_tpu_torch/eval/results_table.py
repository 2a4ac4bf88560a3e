"""The README's Acc/Prec/Rec/AUROC table from finished runs (counterpart
of ``vlp_tpu/eval/results_table.py``; reference README.md:138-150).

Input: a YAML spec whose ``rows`` each name a run directory (the driver's
``output_dir``) holding ``test_eval.csv`` (the frozen test split's long
CSV, one row per fold and metric) or else ``cv_summary.json`` (the
validation metrics). Output: the markdown table, with each section's best
value in bold and arrows against the section's first "scratch" row,
byte-equal to the JAX package's; and the tidy CSV, byte-equal to pandas'
``to_csv(index=False)`` of its frame. Numpy, ``csv`` (``data/tables.py``)
and ``utils/yaml_subset``; no pandas, no PyYAML.

Spec example::

    title: Bone-tumor detection, frozen INTERNAL+BTXRD test set (4-fold CV)
    rows:
      - section: Imaging
        experiment: Scratch Baseline
        model: ResNet34
        run_dir: outputs/baseline_only_imaging_resnet34

Usage: python -m vlp_tpu_torch.eval.results_table spec.yaml
    [--out results_table.md] [--csv tidy.csv]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from vlp_tpu_torch.data import tables
from vlp_tpu_torch.utils.logging import get_logger
from vlp_tpu_torch.utils.yaml_subset import safe_load

logger = get_logger(__name__)

# (display column, test_eval metric name, cv_summary metric suffix)
METRIC_COLUMNS: Tuple[Tuple[str, str, str], ...] = (
    ("Acc", "accuracy", "accuracy"),
    ("Prec", "precision", "precision"),
    ("Rec", "recall", "recall"),
    ("AUROC", "roc_auc", "auroc"),
)
TIDY_COLUMNS = ("section", "experiment", "model", "metric", "mean", "std",
                "source")


def metrics_from_test_eval(csv_path: str) -> Dict[str, Tuple[float, float]]:
    """Mean and std (ddof 0) across folds of the overall frozen-test
    metrics, NaN left out."""
    df = tables.read_csv(csv_path)
    overall = [(m, v) for level, m, v in zip(df["level"], df["metric"],
                                             df["value"])
               if level == "overall"]
    out: Dict[str, Tuple[float, float]] = {}
    for disp, metric, _ in METRIC_COLUMNS:
        vals = np.array([float(v) for m, v in overall if m == metric],
                        np.float64)
        vals = vals[~np.isnan(vals)]
        if len(vals):
            out[disp] = (float(vals.mean()), float(vals.std(ddof=0)))
    return out


def metrics_from_cv_summary(json_path: str
                            ) -> Dict[str, Tuple[float, float]]:
    """Fallback: the best epoch's val/combined metrics from
    ``cv_summary.json`` (keys ``<monitor>_best_val/combined/<metric>_
    {mean,std}``)."""
    with open(json_path) as fh:
        agg = json.load(fh)
    out: Dict[str, Tuple[float, float]] = {}
    for disp, _, suffix in METRIC_COLUMNS:
        means = [k for k in agg
                 if k.endswith(f"val/combined/{suffix}_mean")]
        if not means:
            continue
        k = sorted(means)[0]
        out[disp] = (float(agg[k]), float(agg.get(k[:-5] + "_std", 0.0)))
    return out


def collect_row_metrics(run_dir: str
                        ) -> Tuple[Dict[str, Tuple[float, float]], str]:
    """({column: (mean, std)}, source): the frozen test CSV where the run
    has one, else its validation summary."""
    test_csv = os.path.join(run_dir, "test_eval.csv")
    if os.path.exists(test_csv):
        return metrics_from_test_eval(test_csv), "test"
    cv_json = os.path.join(run_dir, "cv_summary.json")
    if os.path.exists(cv_json):
        return metrics_from_cv_summary(cv_json), "val"
    raise FileNotFoundError(
        f"{run_dir} has neither test_eval.csv nor cv_summary.json")


def _fmt(mean: float, std: float, bold: bool, arrow: str) -> str:
    cell = f"{mean:.2f}±{std:.3f}"
    if bold:
        cell = f"**{cell}**"
    return f"{arrow}{cell}"


def render_markdown(spec: Dict) -> Tuple[str, List[Dict]]:
    """(markdown, tidy rows): the table and one dict a row and metric with
    ``TIDY_COLUMNS``' keys."""
    rows: List[Dict] = []
    for row in spec["rows"]:
        metrics, source = collect_row_metrics(row["run_dir"])
        rows.append({**row, "metrics": metrics, "source": source})

    tidy: List[Dict] = []
    lines = []
    if spec.get("title"):
        lines.append(f"### {spec['title']}")
        lines.append("")
    header = ["**Experiment**", "**Model**"] + [
        f"**{d}**" for d, _, _ in METRIC_COLUMNS]
    lines.append("| " + " | ".join(header) + " |")
    lines.append("|" + "---|" * len(header))

    sections: Dict[str, List[Dict]] = {}
    for r in rows:
        sections.setdefault(r.get("section", ""), []).append(r)

    for section, srows in sections.items():
        if section:
            lines.append(
                "| " + " | ".join([f"**{section}**", ""] +
                                  [""] * len(METRIC_COLUMNS)) + " |")
        # per-column best (bold) and baseline (arrows) within the section
        best: Dict[str, float] = {}
        for r in srows:
            for d, (m, _s) in r["metrics"].items():
                if not math.isnan(m):
                    best[d] = max(best.get(d, -math.inf), m)
        baseline = next(
            (r for r in srows
             if "scratch" in str(r.get("experiment", "")).lower()), None)
        for r in srows:
            cells = [str(r.get("experiment", "")), str(r.get("model", ""))]
            for d, _, _ in METRIC_COLUMNS:
                if d not in r["metrics"]:
                    cells.append("—")
                    continue
                m, s = r["metrics"][d]
                arrow = ""
                if baseline is not None and r is not baseline and \
                        d in baseline["metrics"]:
                    bm = baseline["metrics"][d][0]
                    arrow = "↑" if round(m, 2) > round(bm, 2) else (
                        "↓" if round(m, 2) < round(bm, 2) else "")
                cells.append(_fmt(m, s, bold=(round(m, 6) == round(
                    best.get(d, math.nan), 6)), arrow=arrow))
                tidy.append({"section": section,
                             "experiment": r.get("experiment"),
                             "model": r.get("model"), "metric": d,
                             "mean": m, "std": s, "source": r["source"]})
            lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n", tidy


def write_tidy_csv(path: str, tidy: List[Dict]) -> None:
    """The tidy rows as pandas' ``DataFrame(tidy).to_csv(path,
    index=False)`` writes them (a missing value, None, as an empty
    cell)."""
    columns = TIDY_COLUMNS if tidy else ()
    tables.write_csv(path, columns, [
        tuple(math.nan if r[c] is None else r[c] for c in columns)
        for r in tidy])


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m vlp_tpu_torch.eval.results_table",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("spec", help="YAML row spec (see above)")
    parser.add_argument("--out", default="results_table.md")
    parser.add_argument("--csv", default=None,
                        help="also write the tidy CSV here")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    with open(args.spec) as fh:
        spec = safe_load(fh.read())
    md, tidy = render_markdown(spec)
    with open(args.out, "w") as fh:
        fh.write(md)
    if args.csv:
        write_tidy_csv(args.csv, tidy)
    print(md)
    logger.info("results table -> %s", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
