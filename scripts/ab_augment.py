"""Before and after of the augmentation kernels #11 ``shear_rows`` and #12
``add_gaussian_noise`` in one process on one CUDA card.

``--parent DIR`` is a second checkout of the repository (for example an
earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). Its library is built from its own
``vlp_tpu_torch/csrc`` by its own ``_build.py`` into its own build
directory (``scripts/ab_attention.py``'s ``_load_parent_build``). In the
parent's turns this tree's ``shear_rows`` and ``add_gaussian_noise``
wrappers launch that library's ``vlp_shear_rows`` and
``vlp_add_gaussian_noise`` (their C signatures must be this tree's); every
other kernel and all the code around them are this tree's. The turns
alternate (parent, change, change, parent, ...) after one warm-up turn of
each, and each turn times, on the cases of ``probes/augment_probe.py``
(shear on both axes at the warp's ramps and at random shifts, the noise at
the step's sigmas) at batch 64 and 128 of [B, 224, 224] fp32:

  <case>_b<B>_warm_ms   device time alone per call: 20 calls back to back
                        behind a spin kernel (``_timing.device_ms``)
  <case>_b<B>_cold_ms   the same with the L2 flushed before each call
                        (``_timing.device_cold_ms``)
  <case>_b<B>_event_ms  a CUDA event pair around each call, median of 10
                        (``_timing.median_ms``), the wrapper's host time
                        included where it is longer than the kernel
  resnet34_train_ms, nest_train_ms
                        one ResNet34 and one NesT-Small training step at
                        batch 64 (the experiments' ``train_steps``, 3
                        ``shear_rows`` and 1 ``add_gaussian_noise`` launch
                        each; host clock to a synchronize, median of --reps)
  launches              the shear and noise launches of those steps

Random inputs, weights and batches from fixed seeds, the same on both sides.
Prints one JSON line per turn, then one with each side's median of every
metric over its turns and the card's name and power limit
(``nvidia-smi``). Exits with code 2 without a CUDA device.

Usage:
  python scripts/ab_augment.py --parent DIR [--rounds 5] [--reps 10] \\
      [--output ab_augment.json]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ab_attention import (_Library, _Mixed, _host_ms,  # noqa: E402
                          _load_parent_build)
from vlp_tpu_torch.config import TRAIN_EXPERIMENTS  # noqa: E402
from vlp_tpu_torch.ops import _build  # noqa: E402
from vlp_tpu_torch.ops import noise as NZ  # noqa: E402
from vlp_tpu_torch.ops import shear as SH  # noqa: E402
from vlp_tpu_torch.probes import augment_probe  # noqa: E402
from vlp_tpu_torch.probes._timing import (device_cold_ms,  # noqa: E402
                                          device_ms, median_ms, require_cuda)
from vlp_tpu_torch.train.setup import build_training, random_batch  # noqa: E402
from vlp_tpu_torch.train.step import train_steps  # noqa: E402

PARENT_ENTRY_POINTS = ("vlp_shear_rows", "vlp_add_gaussian_noise")
STEPS = (("resnet34_train_ms", "baseline_only_imaging_resnet34"),
         ("nest_train_ms", "baseline_only_imaging_nest_small"))
STEP_BATCH = 64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    smi = require_cuda("ab_augment")
    parent_build = _load_parent_build(os.path.abspath(args.parent))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = [pool.submit(_build.load_library),
                pool.submit(parent_build.load_library)]
        parent_lib = libs[1].result()
        own_lib = libs[0].result()
    sides = {"change": _build,
             "parent": _Library(_Mixed(own_lib, parent_lib,
                                       PARENT_ENTRY_POINTS))}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {b: augment_probe.cases(b, gen) for b in augment_probe.BATCHES}
    rng = np.random.default_rng(0)
    runs = {}
    for label, key in STEPS:
        task, state, step = build_training(TRAIN_EXPERIMENTS[key], cuda, 10)
        batches = [random_batch(rng, STEP_BATCH, 224) for _ in range(4)]
        runs[label] = (step, state, batches)

    def use(side):
        SH._build = NZ._build = sides[side]

    def turn(side):
        use(side)
        out = {"side": side}
        for b, by_name in cases.items():
            for name, case in by_name.items():
                out[f"{name}_b{b}_warm_ms"] = device_ms(case.kernel)
                out[f"{name}_b{b}_cold_ms"] = device_cold_ms(case.kernel)
                out[f"{name}_b{b}_event_ms"] = median_ms(case.kernel)
        counted = (SH.shear_rows, NZ.add_gaussian_noise)
        before = [k.launches for k in counted]
        for label, (step, state, batches) in runs.items():
            it = iter(range(args.reps))
            out[label] = _host_ms(lambda: train_steps(
                step, state, [batches[next(it) % len(batches)]]), args.reps)
        out["launches"] = [k.launches - n for k, n in zip(counted, before)]
        return out

    for side in ("parent", "change"):  # warm-up: plans, allocator, caches
        turn(side)
    records = []
    for r in range(args.rounds):
        for side in (("parent", "change") if r % 2 == 0
                     else ("change", "parent")):
            rec = turn(side)
            records.append(rec)
            print(json.dumps(rec), flush=True)
    metrics = [k for k in records[0] if k.endswith("_ms")]
    median = {side: {m: statistics.median(x[m] for x in records
                                          if x["side"] == side)
                     for m in metrics}
              for side in ("parent", "change")}
    # pairs of one round in which the change's step was the faster
    won = {label: sum(a[label] > b[label] for a, b in zip(
        [x for x in records if x["side"] == "parent"],
        [x for x in records if x["side"] == "change"]))
        for label, _ in STEPS}
    summary = {"card": smi, "rounds": args.rounds, "reps": args.reps,
               "median": median, "change_step_faster_in_rounds": won}
    print(json.dumps(summary), flush=True)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"turns": records, "summary": summary}, f, indent=1)
    use("change")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
