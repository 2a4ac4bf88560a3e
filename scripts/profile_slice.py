"""Where the device time of NesT-Small serving goes, on one CUDA card.

Drives ``vlp_tpu_torch.serve.Predictor`` (experiment
``baseline_only_imaging_nest_small``: 224x224, bf16, random weights) with
batch-64 requests under ``torch.profiler``: ``--warmup`` requests first,
then ``--requests`` profiled ones. Prints, per batch, the device time of
each kernel (summed over its launches), the busy time (the union of all
device intervals: kernels, copies, memsets) and the window (host clock from
the first profiled request's start to the last one's end, after a
synchronize), and the idle share 1 - busy / window. ``--output`` also
writes the table as JSON.

Usage:
  python scripts/profile_slice.py [--requests 5] [--warmup 3] \
      [--output profile.json]
"""
from __future__ import annotations

import argparse
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

from vlp_tpu_torch.config import EXPERIMENTS  # noqa: E402
from vlp_tpu_torch.serve import Predictor  # noqa: E402

BATCH = 64


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
    parser.add_argument("--requests", type=int, default=5)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--output", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    pred = Predictor(EXPERIMENTS["baseline_only_imaging_nest_small"], None,
                     mean=128.0, std=64.0, batch_size=BATCH, device="cuda")
    images = np.random.default_rng(0).integers(0, 256, (BATCH, 224, 224),
                                               dtype=np.uint8)
    for _ in range(args.warmup):
        pred.predict_arrays(images)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            pred.predict_arrays(images)
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
    print(f"per batch-{BATCH} request, mean of {args.requests}: window "
          f"{window_ms:.4f} ms, device busy {busy_ms:.4f} ms, idle "
          f"{1 - busy_ms / window_ms:.4f}")
    for name, ms in rows:
        print(f"{ms:10.4f} ms  {ms / busy_ms:7.2%}  {name[:140]}")
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)),
                    exist_ok=True)
        with open(args.output, "w") as fh:
            json.dump({"card": card, "batch": BATCH,
                       "requests": args.requests, "window_ms": window_ms,
                       "busy_ms": busy_ms,
                       "per_kernel_ms": dict(rows)}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
