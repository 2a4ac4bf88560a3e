"""Where the device time of a ported experiment's serving or training goes,
on one CUDA card.

``--experiment`` names an entry of ``vlp_tpu_torch.config
.TRAIN_EXPERIMENTS`` (default ``baseline_only_imaging_nest_small``; also
``baseline_only_imaging_vit_base`` and the NesT-Small entry with
``model.megakernel=false``), at that entry's batch. ``--mode serve``
(default) drives ``vlp_tpu_torch.serve.Predictor`` (224x224, bf16, random
weights) with full-batch requests; ``--mode train`` drives the
experiment's training step (``vlp_tpu_torch.train.step.make_train_step``:
augmentation, forward, weighted BCE, backward, AdamW under cosine_warmup)
on seeded uint8 batches. Under ``torch.profiler``: ``--warmup``
iterations first, then ``--requests`` profiled ones. Prints, per iteration,
the device time of each kernel (summed over its launches), the busy time
(the union of all device intervals: kernels, copies, memsets) and the
window (host clock from the first profiled iteration's start to the last
one's end, after a synchronize), and the idle share 1 - busy / window.
``--output`` also writes the table as JSON.

Usage:
  python scripts/profile_slice.py [--mode serve|train] [--requests 5] \
      [--warmup 3] [--experiment NAME] [--output profile.json]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vlp_tpu_torch.config import EXPERIMENTS, TRAIN_EXPERIMENTS  # noqa: E402
from vlp_tpu_torch.serve import Predictor  # noqa: E402
from vlp_tpu_torch.train.setup import build_training, random_batch  # noqa: E402
from vlp_tpu_torch.train.step import train_steps  # noqa: E402

EXPERIMENT = "baseline_only_imaging_nest_small"
STEPS_PER_EPOCH = 10      # the schedule's epoch length, as in chip_smoke.py


def _serve_iteration(key: str, batch: int):
    pred = Predictor(EXPERIMENTS[key], None, mean=128.0, std=64.0,
                     batch_size=batch, device="cuda")
    images = np.random.default_rng(0).integers(0, 256, (batch, 224, 224),
                                               dtype=np.uint8)
    return lambda: pred.predict_arrays(images)


def _train_iteration(key: str, batch: int):
    """One training step per call, on seeded uint8 batches (four in turn),
    random weights, the experiment's augmentation: the run of
    chip_smoke.py's training phases."""
    tcfg = TRAIN_EXPERIMENTS[key]
    _, state, step = build_training(tcfg, torch.device("cuda"),
                                    STEPS_PER_EPOCH)
    rng = np.random.default_rng(1)
    batches = itertools.cycle([random_batch(rng, batch, tcfg.serve.image_size)
                               for _ in range(4)])
    return lambda: train_steps(step, state, [next(batches)])


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--mode", choices=("serve", "train"),
                        default="serve")
    parser.add_argument("--requests", type=int, default=5)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--experiment", default=EXPERIMENT,
                        choices=sorted(TRAIN_EXPERIMENTS))
    parser.add_argument("--output", default=None)
    args = parser.parse_args(argv)
    batch = TRAIN_EXPERIMENTS[args.experiment].batch_size
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    run = (_train_iteration if args.mode == "train" else _serve_iteration)(
        args.experiment, batch)
    for _ in range(args.warmup):
        run()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            run()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3 / args.requests

    per_kernel = defaultdict(float)
    intervals = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        per_kernel[e.name] += (e.time_range.end - e.time_range.start) / 1e3
        intervals.append((e.time_range.start, e.time_range.end))
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = _union_us(intervals) / 1e3 / args.requests
    rows = sorted(((name, ms / args.requests)
                   for name, ms in per_kernel.items()),
                  key=lambda r: -r[1])
    print(f"card: {card}")
    print(f"{args.experiment} {args.mode}: per batch-{batch} iteration, "
          f"mean of "
          f"{args.requests}: window "
          f"{window_ms:.4f} ms, device busy {busy_ms:.4f} ms, idle "
          f"{1 - busy_ms / window_ms:.4f}")
    for name, ms in rows:
        print(f"{ms:10.4f} ms  {ms / busy_ms:7.2%}  {name[:140]}")
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)),
                    exist_ok=True)
        with open(args.output, "w") as fh:
            json.dump({"card": card, "experiment": args.experiment,
                       "mode": args.mode, "batch": batch,
                       "requests": args.requests, "window_ms": window_ms,
                       "busy_ms": busy_ms,
                       "per_kernel_ms": dict(rows)}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
