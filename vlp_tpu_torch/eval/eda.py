"""Dataset reports: label balance, anatomy sites, sex, entities, age and
caption reuse, and their bar charts (counterpart of
``vlp_tpu/eval/eda.py``; the reference keeps them in notebooks).

``dataset_report`` gives the JAX package's JSON: each count in pandas'
``value_counts`` order (descending count, ties in order of first
appearance; missing values left out), a column with a missing value typed
as pandas types it (integers become floats). ``plot_distributions`` draws
the stacked bars with matplotlib where it is installed (imported there
only), else logs one line a figure.

Usage: python -m vlp_tpu_torch.eval.eda [--out-dir outputs/eda]
    [experiment=... data.*=... overrides]

It reads the data module's samples (``data.name`` ``downstream`` or
``synthetic_downstream``: train/val and the frozen test split; otherwise
the pretrain corpus) and touches no device.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Dict, List, Optional

from vlp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

COUNTED = ("dataset", "anatomy_site", "sex", "entity", "age_encoded")
PLOTTED = ("anatomy_site", "sex", "age_encoded", "dataset")


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _columns(samples: List[dict]) -> List[str]:
    """``DataFrame(samples).columns``: every key, in order of first
    appearance."""
    return list(dict.fromkeys(k for s in samples for k in s))


def _column(samples: List[dict], col: str) -> list:
    """The column's values as pandas holds them: a missing key is NaN, and
    integers beside a missing value become floats."""
    values = [s.get(col) for s in samples]
    values = [v.item() if hasattr(v, "item") and not isinstance(v, str)
              else v for v in values]
    present = [v for v in values if not _missing(v)]
    if len(present) < len(values) and present and all(
            isinstance(v, int) and not isinstance(v, bool) for v in present):
        values = [float(v) if not _missing(v) else v for v in values]
    return values


def value_counts(values: list) -> Dict:
    """pandas' ``Series(values).value_counts().to_dict()``."""
    counts: Dict = {}
    for v in values:
        if not _missing(v):
            counts[v] = counts.get(v, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def dataset_report(samples: List[dict]) -> Dict:
    columns = _columns(samples)
    report: Dict = {"num_samples": len(samples)}
    for label in ("tumor", "label"):
        if label in columns:
            report["label_balance"] = value_counts(_column(samples, label))
    for col in COUNTED:
        if col in columns:
            report[f"{col}_counts"] = {
                str(k): int(v)
                for k, v in value_counts(_column(samples, col)).items()}
    if "caption_id" in columns:
        dup = list(value_counts(_column(samples, "caption_id")).values())
        report["caption_stats"] = {
            "unique_captions": len(dup),
            "max_samples_per_caption": int(max(dup)),
            "mean_samples_per_caption": float(sum(dup) / len(dup)),
        }
    return report


def plot_distributions(samples: List[dict], out_dir: str) -> List[str]:
    """``dist_<column>.png`` under ``out_dir``: each column's counts by
    label as stacked bars (``groupby([column, label]).size()``: values and
    labels sorted, missing ones left out). Returns the files written."""
    columns = _columns(samples)
    os.makedirs(out_dir, exist_ok=True)
    label_col = "tumor" if "tumor" in columns else "label"
    wanted = [c for c in PLOTTED if c in columns]
    if not wanted:
        return []
    try:
        import matplotlib
    except ImportError:
        for col in wanted:
            logger.warning("matplotlib is not installed: %s is not drawn",
                           os.path.join(out_dir, f"dist_{col}.png"))
        return []
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = _column(samples, label_col)
    written = []
    for col in wanted:
        pairs = [(v, y) for v, y in zip(_column(samples, col), labels)
                 if not _missing(v) and not _missing(y)]
        keys = sorted({v for v, _ in pairs})
        ys = sorted({y for _, y in pairs})
        fig, ax = plt.subplots(figsize=(8, 4))
        bottom = [0] * len(keys)
        for y in ys:
            heights = [sum(1 for v, t in pairs if v == k and t == y)
                       for k in keys]
            ax.bar([str(k) for k in keys], heights, bottom=bottom,
                   label=str(y))
            bottom = [b + h for b, h in zip(bottom, heights)]
        ax.set_xlabel(col)
        ax.tick_params(axis="x", labelrotation=90)
        ax.legend(title=label_col)
        ax.set_title(f"{col} distribution by {label_col}")
        path = os.path.join(out_dir, f"dist_{col}.png")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    return written


def main(argv: Optional[List[str]] = None) -> int:
    from vlp_tpu_torch.config import Config, apply_overrides

    parser = argparse.ArgumentParser(
        prog="python -m vlp_tpu_torch.eval.eda", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out-dir", default="outputs/eda")
    args, overrides = parser.parse_known_args(
        argv if argv is not None else sys.argv[1:])
    cfg = apply_overrides(Config(), overrides)
    if cfg.data.name in ("synthetic_downstream", "downstream"):
        from vlp_tpu_torch.data.datamodule import DownstreamData

        dm = DownstreamData(cfg, "cpu")
        groups = {"train_val": dm.train_val, "test": dm.test}
    else:
        from vlp_tpu_torch.data.datamodule import PretrainData

        dm = PretrainData(cfg, "cpu")
        groups = {"train_val": dm.train_val}
    os.makedirs(args.out_dir, exist_ok=True)
    for name, samples in groups.items():
        report = dataset_report(samples)
        with open(os.path.join(args.out_dir, f"report_{name}.json"),
                  "w") as fh:
            json.dump(report, fh, indent=2)
        plots = plot_distributions(samples, os.path.join(args.out_dir, name))
        logger.info("%s: %d samples, %d plots, report written", name,
                    report["num_samples"], len(plots))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
