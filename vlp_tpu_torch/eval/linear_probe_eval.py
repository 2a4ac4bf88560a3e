"""Offline linear-probe evaluation of a VLP checkpoint (counterpart of
``vlp_tpu/eval/linear_probe_eval.py``; reference
scripts/linear_probe_test_eval_downstream.py:421-494).

One checkpoint of the port's VLP trainer is frozen; for each downstream CV
fold its image tower's pooled features (with the fold's normalisation)
over the fold's train loader fit a logistic-regression probe
(``train/callbacks.fit_logistic_regression``: scikit-learn's
``LogisticRegression(C=1)`` objective, by Newton's method in fp64), and
the probe's probabilities on the frozen test split become the same
per-subgroup long CSV as ``test_eval`` writes. The downstream data is the
config's ``downstream_data`` (``synthetic_downstream`` where the config
pretrains on a synthetic corpus), as the JAX CLI reads it.

Usage:
  python -m vlp_tpu_torch.eval.linear_probe_eval --output-file out.csv \\
      --checkpoint ckpt.pt [--max-iter N] [--device cuda|cpu] \\
      [experiment=... overrides]

It runs on ``cuda`` unless ``--device cpu`` is given; there is no
fallback to the CPU.
"""
from __future__ import annotations

import argparse
import copy
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from vlp_tpu_torch.config import Config, apply_overrides
from vlp_tpu_torch.data.datamodule import DownstreamData, downstream_config
from vlp_tpu_torch.eval.subgroup import evaluate_results, predictions_frame
from vlp_tpu_torch.models.tasks import build_task
from vlp_tpu_torch.train.callbacks import (fit_logistic_regression,
                                           predict_proba)
from vlp_tpu_torch.train.step import collect_over_loader
from vlp_tpu_torch.utils.checkpoint import restore_raw
from vlp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _features(task, loader):
    x, y = collect_over_loader(task.features_fn, loader)
    return x.float().cpu().numpy(), y.cpu().numpy()


def probe_fold(vlp_cfg: Config, model_state: Dict[str, torch.Tensor],
               dm: DownstreamData, fold: int, device,
               max_iter: int = 1000) -> Dict:
    """Fold ``fold``'s probe: ``{"w", "b", "probs", "n_train"}``, the
    weights fitted on the train loader's features and the probabilities of
    the frozen test split."""
    task = build_task(vlp_cfg, dm.fold_statics(fold), torch.device(device))
    task.model.load_state_dict(model_state, strict=True)
    fold_obj = next(f for f in dm.folds() if f.index == fold)
    x_tr, y_tr = _features(task, fold_obj.train_loader)
    w, b = fit_logistic_regression(x_tr, y_tr, c=1.0, max_iter=max_iter)
    x_te, _ = _features(task, dm.test_loader(fold))
    return {"w": w, "b": b, "probs": predict_proba(x_te, w, b),
            "n_train": len(y_tr)}


def probe_frames(cfg: Config, checkpoint: str, device,
                 max_iter: int = 1000) -> List[Dict[str, list]]:
    """One prediction frame a downstream fold (``eval/subgroup``)."""
    vlp_cfg = copy.deepcopy(cfg)
    vlp_cfg.model.task = "vision_language"
    dm = DownstreamData(downstream_config(cfg), device)
    state = restore_raw(checkpoint)["model"]
    frames = []
    for fold in [f.index for f in dm.folds()]:
        probe = probe_fold(vlp_cfg, state, dm, fold, device, max_iter)
        frames.append(predictions_frame(probe["probs"], dm.test))
        logger.info("fold %d probe fitted on %d samples", fold,
                    probe["n_train"])
    return frames


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m vlp_tpu_torch.eval.linear_probe_eval",
        description="A logistic-regression probe a downstream fold on a VLP "
                    "checkpoint's frozen image features, scored on the "
                    "frozen test split; overrides are dotted.path=value, "
                    "experiment=<name> first.")
    parser.add_argument("--output-file", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="a .pt of the port's VLP trainer")
    parser.add_argument("--max-iter", type=int, default=1000)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args, overrides = parser.parse_known_args(
        argv if argv is not None else sys.argv[1:])
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; --device cpu runs on the CPU")
    cfg = apply_overrides(Config(), overrides)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    evaluate_results(args.output_file,
                     probe_frames(cfg, args.checkpoint, device,
                                  args.max_iter))
    logger.info("Wrote %s", args.output_file)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
