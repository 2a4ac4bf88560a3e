"""Frozen test-set evaluation of the port's checkpoints, and its command
line (counterpart of ``vlp_tpu/eval/test_eval.py``; reference
scripts/test_eval_downstream.py:364-445).

Given one ``.pt`` per CV fold (written by ``python -m vlp_tpu_torch.train``),
each is evaluated on the frozen combined INTERNAL+BTXRD test split with its
fold's normalisation; the sigmoid probabilities and the samples' metadata
become the per-subgroup long CSV of ``eval.subgroup``. Raw predictions
and the first misclassified images (cv2; skipped with a log line where it
is not installed) can be saved too.

Usage:
  python -m vlp_tpu_torch.eval.test_eval --output-file out.csv \\
      --checkpoints ck_fold0.pt ck_fold1.pt ... [--device cuda|cpu] \\
      [--save-predictions dir] [--save-failures dir] [--torchxrayvision] \\
      [experiment=... data.*=... overrides]

It runs on ``cuda`` unless ``--device cpu`` is given; there is no fallback
to the CPU.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
from typing import List, Optional

import numpy as np
import torch

from vlp_tpu_torch.config import Config, apply_overrides
from vlp_tpu_torch.data.datamodule import DownstreamData
from vlp_tpu_torch.eval.subgroup import (FRAME_COLUMNS, Frame,
                                         evaluate_results, predictions_frame,
                                         write_csv)
from vlp_tpu_torch.models.tasks import build_task
from vlp_tpu_torch.parallel.collectives import gather_rows
from vlp_tpu_torch.utils.checkpoint import restore_raw
from vlp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def collect_probs(cfg: Config, checkpoint_path: str, dm: DownstreamData,
                  fold: int, device, save_failures: Optional[str] = None,
                  max_failures: int = 10) -> Frame:
    """Sigmoid probabilities of the checkpoint's model over the frozen test
    split, with fold ``fold``'s normalisation, and the samples' metadata;
    on the data module's mesh each rank evaluates its rows and gathers
    every rank's."""
    task = build_task(cfg, dm.fold_statics(fold), torch.device(device))
    task.model.load_state_dict(restore_raw(checkpoint_path)["model"],
                               strict=True)
    mesh = getattr(dm, "mesh", None)
    probs = []
    for batch in dm.test_loader(fold):
        out = task.eval_fn(batch)
        logits = gather_rows(out["logits"].float(), mesh).cpu().numpy()
        mask = gather_rows(out["mask"], mesh).cpu().numpy() > 0
        logits = logits.ravel()
        probs.append(1.0 / (1.0 + np.exp(-logits[mask])))
    frame = predictions_frame(np.concatenate(probs), dm.test)
    if save_failures:
        _save_failures(frame, dm, save_failures, max_failures)
    return frame


def _save_failures(frame: Frame, dm: DownstreamData, out_dir: str,
                   n: int) -> None:
    """The first ``n`` misclassified images (reference :91-112)."""
    os.makedirs(out_dir, exist_ok=True)
    probs, tumor = frame["prob"], frame["tumor"]
    wrong = np.flatnonzero((probs >= 0.5).astype(int) != tumor)[:n]
    try:
        import cv2
    except ImportError:
        logger.warning("cv2 unavailable; skipping failure-image dump")
        return
    for i, row in enumerate(wrong):
        idx = dm._cache_index.get(frame["image_path"][row])
        if idx is None:
            continue
        cv2.imwrite(os.path.join(
            out_dir, f"fail{i}_true{tumor[row]}_p{probs[row]:.2f}.png"),
            np.asarray(dm.cache.data[idx]))


def save_predictions(path: str, frame: Frame) -> None:
    """One fold's prediction frame as CSV (pandas' ``to_csv(index=False)``
    of the JAX frame)."""
    cols = [frame[c] for c in FRAME_COLUMNS]
    rows = [tuple(v.item() if isinstance(v, np.generic) else v
                  for v in row) for row in zip(*cols)]
    write_csv(path, FRAME_COLUMNS, rows)


_OVERRIDE_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_.]*=")


def split_overrides(argv: List[str]) -> tuple:
    """(cli_args, config_overrides): ``dotted.key=value`` tokens are config
    overrides, everything else is argparse's. Split before argparse, so
    the greedy ``--checkpoints`` never swallows ``experiment=...``; only a
    dotted-identifier key counts, so a checkpoint path such as
    ``outputs/sweep/lr=0.001/fold0.pt`` stays an argument."""
    overrides = [a for a in argv if _OVERRIDE_RE.match(a)]
    return [a for a in argv if a not in overrides], overrides


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    parser = argparse.ArgumentParser(
        prog="python -m vlp_tpu_torch.eval.test_eval",
        description="Per-subgroup metrics of one checkpoint per CV fold on "
                    "the frozen test split; overrides are dotted.path=value,"
                    " experiment=<name> first.")
    parser.add_argument("--output-file", required=True)
    parser.add_argument("--checkpoints", nargs="+", required=True,
                        help="one .pt per CV fold, in fold order")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--save-predictions", default=None)
    parser.add_argument("--save-failures", default=None)
    parser.add_argument("--torchxrayvision", action="store_true",
                        help="1-channel scale-intensity normalization path")
    cli, overrides = split_overrides(argv)
    args = parser.parse_args(cli)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; --device cpu runs on the CPU")
    cfg = apply_overrides(Config(), overrides)
    if args.torchxrayvision:
        cfg.data.in_channels = 1
        cfg.data.scale_intensity_normalization = True
    dm = DownstreamData(cfg, device)
    frames = []
    for fold, path in enumerate(args.checkpoints):
        frame = collect_probs(cfg, path, dm, fold, device,
                              save_failures=args.save_failures)
        if args.save_predictions:
            save_predictions(os.path.join(args.save_predictions,
                                          f"predictions_fold{fold}.csv"),
                             frame)
        frames.append(frame)
    evaluate_results(args.output_file, frames)
    logger.info("Wrote %s", args.output_file)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
