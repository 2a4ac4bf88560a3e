"""Batch inference / serving entry point of the port (counterpart of
``vlp_tpu/serve.py``).

Loads a checkpoint that the port's trainer wrote (``--checkpoint``, a
``.pt``) or weights exported from a JAX checkpoint (``--weights``, the
``.npz`` of ``scripts/export_flax_params.py``), preprocesses raw images
with the port's copy of the deterministic host pipeline
(``vlp_tpu_torch.data.preprocess_host``), and runs fixed-shape batches on
one device: a directory of images through the CLI, or arrays through
``Predictor`` for embedding in a server. It serves the classifiers, the
imaging-only and the late-fusion task; the fusion model's clinical vectors
come from the caller (``predict_arrays(images, clinical)``), zeros where
none is given, as the JAX ``Predictor`` fills them. The vision-language
task has no logits and is refused.

Usage:
  python -m vlp_tpu_torch.serve (--checkpoint ck.pt | --weights w.npz) \
      --images dir/ --output preds.csv [experiment=<name>] [overrides] \
      [--mean M --std S]

``experiment`` names an entry of ``vlp_tpu_torch.config.EXPERIMENTS``
(every registered experiment: ``baseline_only_imaging_nest_small``,
``baseline_fusion_resnet34``, ...); the overrides are those of the serving
fields
(``config.SERVE_OVERRIDES``: ``model.megakernel=false``,
``model.fused_attention=...``, ``data.image_size=...``, ...). Any other
override raises rather than being ignored.
"""
from __future__ import annotations

import argparse
import sys
import csv
import glob
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from vlp_tpu_torch.config import as_serve_config, serve_config
from vlp_tpu_torch.convert import load_weights
from vlp_tpu_torch.data.encoding import CLINICAL_DIM
from vlp_tpu_torch.data.preprocess_host import preprocess_image
from vlp_tpu_torch.models.tasks import TaskStatics, build_task
from vlp_tpu_torch.models.vit import flax_init_
from vlp_tpu_torch.utils.checkpoint import restore_raw

CLASSIFIER_TASKS = ("only_imaging", "fusion")


class Predictor:
    """Model + batched predict with a fixed batch shape (ragged tails are
    padded, so every call runs the same shapes).

    ``cfg``: a ``vlp_tpu_torch.config.ServeConfig`` or a ``Config``.
    ``weights``: a ``.npz`` from ``scripts/export_flax_params.py``;
    ``checkpoint``: a ``.pt`` the port's trainer wrote (its ``model``
    entry, loaded strictly); neither initialises random weights at the
    flax initializers' scales from a generator seeded with 0."""

    def __init__(self, cfg, weights: Optional[str], mean: float,
                 std: float, batch_size: int = 64,
                 device: Union[str, torch.device] = "cuda",
                 checkpoint: Optional[str] = None) -> None:
        self.cfg = cfg = as_serve_config(cfg)
        if cfg.task not in CLASSIFIER_TASKS:
            raise ValueError(f"Predictor serves the classifiers "
                             f"{CLASSIFIER_TASKS}; task {cfg.task!r} has "
                             "no logits")
        if weights is not None and checkpoint is not None:
            raise ValueError("give weights (.npz) or checkpoint (.pt), "
                             "not both")
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.statics = TaskStatics(
            mean=mean, std=std, out_channels=cfg.in_channels,
            scale_intensity=cfg.scale_intensity)
        self.task = build_task(cfg, self.statics, self.device)
        if checkpoint is not None:
            self.task.model.load_state_dict(restore_raw(checkpoint)["model"],
                                            strict=True)
        elif weights is not None:
            load_weights(self.task.model, weights)
        else:
            flax_init_(self.task.model,
                       torch.Generator(device=self.device).manual_seed(0))

    def _batch(self, images_u8: np.ndarray,
               clinical: Optional[np.ndarray]) -> Dict[str, torch.Tensor]:
        b, s = self.batch_size, self.cfg.image_size
        m = len(images_u8)
        img = np.zeros((b, s, s), np.uint8)
        img[:m] = images_u8
        cl = np.zeros((b, CLINICAL_DIM), np.float32)
        if clinical is not None:
            cl[:m] = clinical
        dev = self.device
        return {
            "image_u8": torch.from_numpy(img).to(dev),
            "label": torch.zeros(b, dtype=torch.int32, device=dev),
            "dataset_id": torch.zeros(b, dtype=torch.int32, device=dev),
            "clinical": torch.from_numpy(cl).to(dev),
            "mask": torch.ones(b, dtype=torch.float32, device=dev),
        }

    def predict_logits(self, images_u8: np.ndarray,
                       clinical: Optional[np.ndarray] = None) -> np.ndarray:
        """[N, S, S] uint8 (already deterministically preprocessed) and,
        for the fusion task, [N, 15] clinical vectors (zeros when None) ->
        [N] fp32 logits."""
        n = images_u8.shape[0]
        logits = np.zeros(n, np.float32)
        for start in range(0, n, self.batch_size):
            stop = min(start + self.batch_size, n)
            batch = self._batch(
                images_u8[start:stop],
                None if clinical is None else clinical[start:stop])
            out = self.task.eval_fn(batch)["logits"]
            logits[start:stop] = out.float().cpu().numpy()[:stop - start]
        return logits

    def predict_arrays(self, images_u8: np.ndarray,
                       clinical: Optional[np.ndarray] = None) -> np.ndarray:
        """[N, S, S] uint8 -> [N] tumor probabilities."""
        logits = self.predict_logits(images_u8, clinical)
        return 1.0 / (1.0 + np.exp(-logits))

    def predict_files(self, paths: Sequence[str]) -> np.ndarray:
        """Image files -> [N] tumor probabilities (decoding needs cv2 or
        PIL; ``predict_arrays`` needs neither)."""
        imgs = np.stack([
            preprocess_image(p, image_size=self.cfg.image_size,
                             crop=self.cfg.crop)
            for p in paths])
        return self.predict_arrays(imgs)


def parse_args(argv: Optional[List[str]] = None):
    """(arguments, the ``ServeConfig`` of ``experiment=`` and the
    overrides) of a command line."""
    parser = argparse.ArgumentParser(description=__doc__)
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--checkpoint",
                        help=".pt written by python -m vlp_tpu_torch.train")
    source.add_argument("--weights",
                        help=".npz from scripts/export_flax_params.py")
    parser.add_argument("--images", required=True,
                        help="directory of PNGs (recursive) or one file")
    parser.add_argument("--output", default="predictions.csv")
    parser.add_argument("--mean", type=float, default=128.0,
                        help="fold-train normalization mean")
    parser.add_argument("--std", type=float, default=64.0)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--device", default="cuda")
    args, overrides = parser.parse_known_args(
        argv if argv is not None else sys.argv[1:])
    return args, serve_config(overrides)


def main(argv: Optional[List[str]] = None) -> int:
    args, cfg = parse_args(argv)
    if os.path.isdir(args.images):
        paths = sorted(
            glob.glob(os.path.join(args.images, "**", "*.png"),
                      recursive=True)
            + glob.glob(os.path.join(args.images, "**", "*.jpg"),
                        recursive=True))
    else:
        paths = [args.images]
    if not paths:
        raise FileNotFoundError(f"no images under {args.images}")
    predictor = Predictor(cfg, args.weights, args.mean, args.std,
                          args.batch_size, args.device,
                          checkpoint=args.checkpoint)
    probs = predictor.predict_files(paths)
    with open(args.output, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["image_path", "tumor_prob"])
        writer.writerows(zip(paths, probs.tolist()))
    print(f"Wrote {len(paths)} predictions to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
