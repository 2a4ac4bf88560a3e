"""Before and after of the packed-qkv attention kernels (#7 ``attend_qkv``,
#8 ``attend_qkv_bwd``) on the paths that launch them, in one process on one
CUDA card.

``--parent DIR`` is a second checkout of the repository, for example an
earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. Its kernels are built from its own
``vlp_tpu_torch/csrc`` by its own ``_build.py`` into its own build
directory. In the parent's turns this tree's ``attend_qkv`` and
``attend_qkv_bwd`` wrappers launch that library's ``vlp_attend_qkv`` and
``vlp_attend_qkv_bwd`` (whose C signatures must be this tree's); every
other kernel and all the code around them are this tree's. The turns
alternate (parent, change, change, parent, ...) after one warm-up turn of
each, and each turn times:

  vit_serve_ms        a request of 32 images to the ViT-B/16 ``Predictor``
                      (host clock to a synchronize, median of --reps)
  vit_train_ms        one ViT-B/16 training step at batch 32 (the
                      experiment's ``train_steps``, host clock to a
                      synchronize, median of --reps)
  nest_unfused_train_ms  one NesT-Small ``model.megakernel=false`` training
                      step at batch 64, the same way
  <shape>_attend_ms, <shape>_attend_bwd_ms, <shape>_sdpa_ms  the device
                      time per call of #7, #8 and SDPA's forward (on the
                      same q, k, v views, the yardstick) at ViT-B's shape
                      (N 32, S 197, 12 heads of 64) and NesT-Small's three
                      levels at batch 64 (heads of 32): 20 back-to-back
                      calls queued behind a spin kernel, so that the host's
                      launch time does not show, between CUDA events

Random weights and batches from fixed seeds, the same on both sides. Prints
one JSON line per turn, then one with each side's median of every metric
over its turns and the card's name and power limit (``nvidia-smi``). Exits
with code 2 without a CUDA device.

Usage:
  python scripts/ab_attention.py --parent DIR [--rounds 3] [--reps 5] \
      [--output ab.json]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vlp_tpu_torch.config import EXPERIMENTS, TRAIN_EXPERIMENTS  # noqa: E402
from vlp_tpu_torch.ops import _build  # noqa: E402
from vlp_tpu_torch.ops import block_attention as BA  # noqa: E402
from vlp_tpu_torch.probes._timing import (  # noqa: E402
    device_ms, require_cuda)
from vlp_tpu_torch.serve import Predictor  # noqa: E402
from vlp_tpu_torch.train.setup import build_training, random_batch  # noqa: E402
from vlp_tpu_torch.train.step import train_steps  # noqa: E402

VIT = "baseline_only_imaging_vit_base"
NEST_UNFUSED = "baseline_only_imaging_nest_small model.megakernel=false"
# (N, S, D, heads) of #7/#8 on the two paths
KERNEL_SHAPES = {"vit_b": (32, 197, 768, 12), "nest_l0": (1024, 196, 96, 3),
                 "nest_l1": (256, 196, 192, 6), "nest_l2": (64, 196, 384, 12)}


def _load_parent_build(root: str):
    """The parent checkout's ``_build`` module, loaded from its file, so
    that its sources and build directory are the parent's own."""
    path = os.path.join(root, "vlp_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Library:
    """What ``block_attention`` reads of ``_build`` (``load_library``,
    ``check``), serving another build's library."""

    def __init__(self, lib):
        self.lib = lib

    def load_library(self):
        return self.lib

    check = staticmethod(_build.check)


def _host_ms(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    smi = require_cuda("ab_attention")
    parent_build = _load_parent_build(os.path.abspath(args.parent))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = [pool.submit(_build.load_library),
                pool.submit(parent_build.load_library)]
        parent_lib = libs[1].result()
        libs[0].result()
    sides = {"change": _build, "parent": _Library(parent_lib)}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")

    rng = np.random.default_rng(0)
    pred = Predictor(EXPERIMENTS[VIT], None, mean=128.0, std=64.0,
                     batch_size=32, device="cuda")
    request = rng.integers(0, 256, (32, 224, 224), dtype=np.uint8)
    runs = {}
    for key, batch in ((VIT, 32), (NEST_UNFUSED, 64)):
        tcfg = TRAIN_EXPERIMENTS[key]
        _, state, step = build_training(tcfg, cuda, 10)
        batches = [random_batch(rng, batch, 224) for _ in range(4)]
        runs[key] = (step, state, batches)
    gen = torch.Generator(device="cuda").manual_seed(2)
    inputs = {}
    for shape, (n, s, d, heads) in KERNEL_SHAPES.items():
        qkv = (torch.randn(n, s, 3 * d, generator=gen, device="cuda")
               * 1.5).bfloat16()
        do = torch.randn(n, s, d, generator=gen, device="cuda").bfloat16()
        q, k, v = qkv.view(n, s, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        inputs[shape] = (qkv, do, heads, (q, k, v))

    def turn(side):
        BA._build = sides[side]
        out = {"side": side}
        before = (BA.attend_qkv.launches, BA.attend_qkv_bwd.launches)
        out["vit_serve_ms"] = _host_ms(lambda: pred.predict_arrays(request),
                                       args.reps)
        for key, label in ((VIT, "vit_train_ms"),
                           (NEST_UNFUSED, "nest_unfused_train_ms")):
            step, state, batches = runs[key]
            it = iter(range(args.reps))
            out[label] = _host_ms(lambda: train_steps(
                step, state, [batches[next(it) % len(batches)]]), args.reps)
        # #7 and #8 launches of the serving and training steps above
        out["launches"] = [BA.attend_qkv.launches - before[0],
                           BA.attend_qkv_bwd.launches - before[1]]
        for shape, (qkv, do, heads, qkv_views) in inputs.items():
            out[f"{shape}_attend_ms"] = device_ms(
                lambda: BA.attend_qkv(qkv, heads))
            out[f"{shape}_attend_bwd_ms"] = device_ms(
                lambda: BA.attend_qkv_bwd(qkv, do, heads))
            with torch.no_grad():
                out[f"{shape}_sdpa_ms"] = device_ms(
                    lambda: F.scaled_dot_product_attention(*qkv_views))
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
    sides_of = {side: [x for x in records if x["side"] == side]
                for side in ("parent", "change")}
    metrics = [k for k in records[0] if k.endswith("_ms")]
    summary = {"card": smi, "rounds": args.rounds, "reps": args.reps,
               "median": {side: {m: statistics.median(x[m] for x in recs)
                                 for m in metrics}
                          for side, recs in sides_of.items()}}
    print(json.dumps(summary), flush=True)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"turns": records, "summary": summary}, f, indent=1)
    BA._build = _build
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
