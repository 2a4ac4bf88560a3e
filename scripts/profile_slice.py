"""Where the device time of a ported experiment's serving or training goes,
on one CUDA card.

``--experiment`` names an entry of ``vlp_tpu_torch.config
.TRAIN_EXPERIMENTS`` (default ``baseline_only_imaging_nest_small``; also
``baseline_only_imaging_vit_base``, the NesT-Small entry with
``model.megakernel=false``, ``baseline_only_imaging_resnet34``,
``baseline_only_imaging_xrv_resnet50`` and the pretrain experiments, such
as ``pretrain_resnet34_tinybert``), at that entry's batch; imaging
training batches hold datasets 0 and 1 in turn, so CORAL runs where the
experiment sets it, and pretrain batches hold ragged 8-40-token captions,
each twice. ``--mode serve`` (default; imaging experiments) drives
``vlp_tpu_torch.serve.Predictor`` (224x224, bf16, random weights) with
full-batch requests; ``--mode train`` drives the experiment's training
step (``vlp_tpu_torch.train.step.make_train_step``: augmentation, forward,
the task's loss, backward, the experiment's optimizer and schedule) on
seeded batches. Under ``torch.profiler``: ``--warmup``
iterations first, then ``--requests`` profiled ones. Prints, per iteration,
the device time of each kernel (summed over its launches), the busy time
(the union of all device intervals: kernels, copies, memsets; the
GPU-side ranges of ``record_function`` annotations such as the optimizer
step are printed as spans and left out, since they cover idle gaps) and the
window (host clock from the first profiled iteration's start to the last
one's end, after a synchronize), the idle share 1 - busy / window, and the
kernel time by group (``GROUPS``: the port's hand-written kernels, cuDNN
and cuBLAS convolutions and GEMMs, the optimizer, reductions, elementwise
passes and copies; the first pattern that a kernel's name matches).
``--output`` also writes the table as JSON. For a pretrain experiment
``--mode train`` also profiles each part of the step run alone,
``--requests`` times after one warm-up: the augmentation (#11/#12), the
image tower's and the text tower's forward and backward (on a sum of their
embeddings), the CLIP loss forward and backward on fixed embeddings, and
the optimizer step; per call, its device busy time (the union of its
device intervals) and its window on the host clock.

Usage:
  python scripts/profile_slice.py [--mode serve|train] [--requests 5] \
      [--warmup 3] [--experiment NAME] [--output profile.json]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import re
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
from vlp_tpu_torch.ops import losses  # noqa: E402
from vlp_tpu_torch.serve import Predictor  # noqa: E402
from vlp_tpu_torch.train.setup import batch_for, build_training  # noqa: E402
from vlp_tpu_torch.train.step import to_device, train_steps  # noqa: E402

EXPERIMENT = "baseline_only_imaging_nest_small"
# (group, pattern searched in a kernel's name), first match wins
GROUPS = (
    ("hand-written", r"vlp::|shear_\w*kernel|noise_kernel|philox_kernel"),
    ("attention (SDPA)", r"flash|fmha|sdpa|[Aa]ttention"),
    ("conv and GEMM (cuDNN, cuBLAS)",
     r"cudnn|xmma|cutlass|gemm|Gemm|conv|Conv|wgrad|dgrad|sm90_|sm80_"),
    ("optimizer", r"multi_tensor|[Aa]dam"),
    ("reductions", r"[Rr]educe"),
    ("elementwise and copies",
     r"elementwise|[Cc]opy|Memcpy|Memset|index|fill|cat|pool|max_pool"),
    ("other", r""))
STEPS_PER_EPOCH = 10      # the schedule's epoch length, as in chip_smoke.py


def _serve_iteration(key: str, batch: int):
    pred = Predictor(EXPERIMENTS[key], None, mean=128.0, std=64.0,
                     batch_size=batch, device="cuda")
    images = np.random.default_rng(0).integers(0, 256, (batch, 224, 224),
                                               dtype=np.uint8)
    return lambda: pred.predict_arrays(images)


def _train_iteration(key: str, batch: int):
    """One training step per call, on seeded batches (four in turn),
    random weights, the experiment's augmentation: the run of
    chip_smoke.py's training phases. Returns (the call, task, state, the
    first batch)."""
    tcfg = TRAIN_EXPERIMENTS[key]
    task, state, step = build_training(tcfg, torch.device("cuda"),
                                       STEPS_PER_EPOCH)
    rng = np.random.default_rng(1)
    host = [batch_for(tcfg, rng, batch) for _ in range(4)]
    batches = itertools.cycle(host)
    return (lambda: train_steps(step, state, [next(batches)]), task, state,
            host[0])


def _profiled(fn, reps: int):
    """(the profiler's events of ``reps`` calls of ``fn`` after one more
    warm-up call, the window per call in ms: host clock, ending in a
    synchronize)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3 / reps
    return prof.events(), window_ms


def _device_intervals(events):
    """(kernel name, start, end) of the device work among ``events``,
    leaving out the annotated ranges."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def _vlp_parts(task, state, host_batch, reps: int) -> dict:
    """{part: (device busy ms, window ms)} per call of each part of a
    pretrain step run alone."""
    model = task.model
    model.train()
    batch = to_device(host_batch, next(model.parameters()).device)
    images = task._prep_train(batch, state.generator)
    ids, mask = batch["input_ids"], batch["attention_mask"]
    with torch.no_grad():
        img = model.encode_image(images)
        txt = model.encode_text(ids, mask)
    img.requires_grad_(True)
    txt.requires_grad_(True)

    def loss():
        losses.symmetric_infonce(losses.clip_logits(
            img, txt, model.logit_scale, task.scale_max),
            batch["mask"]).backward()

    parts = {
        "augmentation (#11, #12)": lambda: task._prep_train(
            batch, state.generator),
        "image tower fwd+bwd": lambda: model.encode_image(
            images).sum().backward(),
        "text tower fwd+bwd": lambda: model.encode_text(
            ids, mask).sum().backward(),
        "CLIP loss fwd+bwd": loss,
        "optimizer step": state.optimizer.step}
    out = {}
    for name, fn in parts.items():
        events, window_ms = _profiled(fn, reps)
        busy = _union_us([(a, b) for _, a, b in _device_intervals(events)])
        out[name] = (busy / 1e3 / reps, window_ms)
    model.zero_grad(set_to_none=True)
    return out


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

    vlp = TRAIN_EXPERIMENTS[args.experiment].serve.task == "vision_language"
    if args.mode == "serve" and vlp:
        parser.error("--mode serve drives the imaging Predictor; "
                     f"{args.experiment} is a pretrain experiment")
    if args.mode == "train":
        run, task, state, first = _train_iteration(args.experiment, batch)
    else:
        run = _serve_iteration(args.experiment, batch)
    for _ in range(args.warmup - 1):
        run()
    events, window_ms = _profiled(run, args.requests)

    per_kernel = defaultdict(float)
    spans = defaultdict(float)  # annotated ranges, not device work
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.is_user_annotation:
            spans[e.name] += (e.time_range.end - e.time_range.start) / 1e3 \
                / args.requests
    intervals = []
    for name, start, end in _device_intervals(events):
        per_kernel[name] += (end - start) / 1e3
        intervals.append((start, end))
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
    groups = defaultdict(float)
    for name, ms in rows:
        groups[next(g for g, pat in GROUPS if re.search(pat, name))] += ms
    for group, ms in sorted(groups.items(), key=lambda r: -r[1]):
        print(f"group {group}: {ms:.4f} ms, {ms / busy_ms:.2%} of busy")
    for name, ms in spans.items():
        print(f"span {name} (annotated range, outside busy and the "
              f"groups): {ms:.4f} ms")
    parts = _vlp_parts(task, state, first, args.requests) \
        if args.mode == "train" and vlp else {}
    for name, (ms, win) in parts.items():
        print(f"part {name}, run alone: device busy {ms:.4f} ms "
              f"({ms / busy_ms:.2%} of the step's busy time), window "
              f"{win:.4f} ms")
    for name, ms in rows:
        print(f"{ms:10.4f} ms  {ms / busy_ms:7.2%}  {name[:140]}")
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)),
                    exist_ok=True)
        with open(args.output, "w") as fh:
            json.dump({"card": card, "experiment": args.experiment,
                       "mode": args.mode, "batch": batch,
                       "requests": args.requests, "window_ms": window_ms,
                       "busy_ms": busy_ms, "group_ms": dict(groups),
                       "annotated_span_ms": dict(spans),
                       "parts_alone_ms": parts,
                       "per_kernel_ms": dict(rows)}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
