"""Retrospective t-SNE and confusion figures of finished runs (counterpart
of ``vlp_tpu/eval/replot.py``; reference
src/helper_scripts/plot_tsne_for_all_runs_retrospectively.py:19-60).

For each run under ``outputs_root`` (a directory holding ``checkpoints/``,
or the root itself) and each ``checkpoints/fold<k>/``, the last of its
``epoch*.pt`` files in sorted order is loaded with the fold's
normalisation; one eval-mode pass over the fold's val loaders gives the
features and the logit, and ``plots/fold<k>/tsne_val_retro.png`` and
``confusion_val_retro.png`` are drawn (``eval/plotting.py``; without
matplotlib one line names each figure not drawn, and the silhouettes are
logged).

Usage: python -m vlp_tpu_torch.eval.replot <outputs_root>
    [--device cuda|cpu] [experiment=... overrides]

It runs on ``cuda`` unless ``--device cpu`` is given; there is no
fallback to the CPU.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List, Optional

import torch

from vlp_tpu_torch.config import Config, apply_overrides
from vlp_tpu_torch.data.datamodule import DownstreamData
from vlp_tpu_torch.eval.plotting import plot_val_outputs
from vlp_tpu_torch.models.tasks import build_task
from vlp_tpu_torch.utils.checkpoint import restore_raw
from vlp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def replot_run(run_dir: str, cfg: Config, device) -> List[str]:
    """The figures of every fold of ``run_dir`` with a checkpoint; returns
    the files written."""
    written = []
    dm = DownstreamData(cfg, device)
    for fold_dir in sorted(glob.glob(os.path.join(run_dir, "checkpoints",
                                                  "fold*"))):
        fold = int(os.path.basename(fold_dir)[len("fold"):])
        ckpts = sorted(p for p in glob.glob(os.path.join(fold_dir,
                                                         "epoch*.pt"))
                       if os.path.isfile(p))
        if not ckpts:
            continue
        task = build_task(cfg, dm.fold_statics(fold), torch.device(device))
        task.model.load_state_dict(restore_raw(ckpts[-1])["model"],
                                   strict=True)
        fold_obj = next(f for f in dm.folds() if f.index == fold)
        plot_dir = os.path.join(run_dir, "plots", f"fold{fold}")
        scores = plot_val_outputs(task, fold_obj.val_loaders, plot_dir,
                                  "_retro")
        logger.info("%s fold %d (%s): silhouettes %s", run_dir, fold,
                    os.path.basename(ckpts[-1]), scores)
        written += [p for p in (os.path.join(plot_dir, f"{k}_val_retro.png")
                                for k in ("tsne", "confusion"))
                    if os.path.exists(p)]
    return written


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m vlp_tpu_torch.eval.replot",
        description="t-SNE and confusion figures of every fold's last "
                    "checkpoint under a run directory; overrides are "
                    "dotted.path=value, experiment=<name> first.")
    parser.add_argument("outputs_root")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args, overrides = parser.parse_known_args(
        argv if argv is not None else sys.argv[1:])
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; --device cpu runs on the CPU")
    cfg = apply_overrides(Config(), overrides)
    root = args.outputs_root
    runs = [d for d in sorted(glob.glob(os.path.join(root, "*")))
            if os.path.isdir(os.path.join(d, "checkpoints"))] or [root]
    for run in runs:
        cfg.output_dir = run
        written = replot_run(run, cfg, device)
        logger.info("%s: wrote %d plots", run, len(written))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
