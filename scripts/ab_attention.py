"""Before and after of the attention kernels (#7 ``attend_qkv``, #8
``attend_qkv_bwd``, the half-block forwards #1 ``ln_attention`` and #5
``ln_attention_windows`` and their backwards #3 ``ln_attention_bwd`` and
#6 ``ln_attention_windows_bwd``), the MLP forwards (#2 ``ln_mlp``, #9
``fused_mlp``) and the MLP backwards (#4 ``ln_mlp_bwd``, #10
``fused_mlp_bwd``) on the paths that launch them, in one process on one
CUDA card.

``--parent DIR`` is a second checkout of the repository, for example an
earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. Its kernels are built from its own
``vlp_tpu_torch/csrc`` by its own ``_build.py`` into its own build
directory. In the parent's turns this tree's ``attend_qkv``,
``attend_qkv_bwd``, ``ln_attention``, ``ln_attention_windows``,
``ln_attention_bwd``, ``ln_attention_windows_bwd``, ``ln_mlp``,
``fused_mlp``, ``ln_mlp_bwd`` and ``fused_mlp_bwd`` wrappers launch that
library's entry points of the same names (``vlp_attend_qkv``, ...), with
its own workspace queries (their C signatures must be this tree's); every
other kernel and all the code around them are this tree's. The turns
alternate (parent, change, change, parent, ...) after one warm-up turn of
each, and each turn times:

  vit_serve_ms        a request of 32 images to the ViT-B/16 ``Predictor``
                      (host clock to a synchronize, median of --reps)
  nest_serve_ms       a request of 64 images to the NesT-Small
                      ``Predictor`` (24 #1 and 24 #2 launches), the same
                      way, and
                      nest_serve_peak_mib its peak device memory above what
                      was allocated before it
  vit_train_ms        one ViT-B/16 training step at batch 32 (the
                      experiment's ``train_steps``, host clock to a
                      synchronize, median of --reps)
  nest_unfused_train_ms  one NesT-Small ``model.megakernel=false`` training
                      step at batch 64, the same way
  nest_train_ms       one NesT-Small training step at batch 64 (24 each
                      of #1-#4), the same way
  nest_nhwc_train_ms  the same with the backbone's ``nhwc_windows`` set (24
                      each of #5, #6, #2 and #4)
  <step>_peak_mib     each training step's peak device memory above what
                      was allocated before it (``max_memory_allocated``)
  <shape>_attend_ms, <shape>_attend_bwd_ms, <shape>_sdpa_ms  the device
                      time per call of #7, #8 and SDPA's forward (on the
                      same q, k, v views, the yardstick) at ViT-B's shape
                      (N 32, S 197, 12 heads of 64) and NesT-Small's three
                      levels at batch 64 (heads of 32): 20 back-to-back
                      calls queued behind a spin kernel, so that the host's
                      launch time does not show, between CUDA events
  nest_l<i>_ln_attention_ms, nest_l<i>_ln_attention_windows_ms
                      the device time per call of #1 at NesT-Small's level
                      i at batch 64 ([64 * 16 / 4 / 1, 196, D]) and of #5 on
                      that level's map ([64, 56 / 28 / 14, .., D], windows
                      of 14), the same way
  nest_l<i>_ln_attention_bwd_ms, nest_l<i>_ln_attention_windows_bwd_ms
                      the same of #3 and #6, on this tree's forward
                      kernels' qkv and o
  nest_l<i>_ln_attention_bwd_host_ms  the host time per call of #3 there:
                      20 calls issued while a spin kernel holds the card,
                      so that the host never waits for it (the wrapper's
                      Python, the library's launches and, on this tree's
                      side, the eight tensor maps it encodes)
  nest_l<i>_ln_mlp_ms, nest_l<i>_fused_mlp_ms, nest_l<i>_ln_mlp_bwd_ms,
  nest_l<i>_fused_mlp_bwd_ms
                      the device time per call of #2, #9, #4 and #10 at
                      level i's rows at batch 64 ([64 * 56^2 / 28^2 / 14^2,
                      D], F = 4D), the same way

After the turns, each side's #1, #5, #3, #6, #2, #9, #4 and #10 run once
more per level under ``torch.profiler``: the device time of every kernel
of the call, summed by name and weighted by the level's blocks per
NesT-Small step (2, 2, 20), is the ``split`` of the summary (ms per
training step), with the kernels grouped into the LN rows, the qkv
product, the attention core and the out-projection (#1, #5; two launches
of one instance split by their order in the call), into the attention
core, the four products and the row passes (#3, #6), into the LN rows,
fc1 + GELU and fc2 + bias or residual (#2, #9), or into the dual tile (on
the parent's side its two products with gelu' between them), the weight
gradients, dln or dx and the row passes (#4, #10).

Random weights and batches from fixed seeds, the same on both sides. Prints
one JSON line per turn, then one with each side's median of every metric
over its turns, the splits, and the card's name and power limit
(``nvidia-smi``). Exits with code 2 without a CUDA device.

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
import re
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
from vlp_tpu_torch.ops import fused_block as FB  # noqa: E402
from vlp_tpu_torch.ops import fused_mlp as FM  # noqa: E402
from vlp_tpu_torch.probes._timing import device_ms, require_cuda  # noqa: E402
from vlp_tpu_torch.serve import Predictor  # noqa: E402
from vlp_tpu_torch.train.setup import build_training, random_batch  # noqa: E402
from vlp_tpu_torch.train.step import train_steps  # noqa: E402

VIT = "baseline_only_imaging_vit_base"
NEST = "baseline_only_imaging_nest_small"
NEST_UNFUSED = "baseline_only_imaging_nest_small model.megakernel=false"
# (N, S, D, heads) of #7/#8 on the two paths
KERNEL_SHAPES = {"vit_b": (32, 197, 768, 12), "nest_l0": (1024, 196, 96, 3),
                 "nest_l1": (256, 196, 192, 6), "nest_l2": (64, 196, 384, 12)}
# NesT-Small's levels at batch 64: (map side, D, heads, blocks per step)
NEST_LEVELS = ((56, 96, 3, 2), (28, 192, 6, 2), (14, 384, 12, 20))
WINDOW = 14
# the entry points that the parent's library serves in its turns, beside
# #7/#8 (whose module reads a library of its own)
PARENT_HALF_BLOCK = ("vlp_ln_attention", "vlp_ln_attention_windows",
                     "vlp_ln_attention_bwd", "vlp_ln_attention_windows_bwd",
                     "vlp_ln_attention_bwd_workspace")
PARENT_MLP_FWD = ("vlp_ln_mlp", "vlp_fused_mlp")
PARENT_MLP_BWD = ("vlp_ln_mlp_bwd", "vlp_ln_mlp_bwd_workspace",
                  "vlp_fused_mlp_bwd", "vlp_fused_mlp_bwd_workspace")
PARENT_ENTRY_POINTS = PARENT_HALF_BLOCK + PARENT_MLP_FWD + PARENT_MLP_BWD
# (part, pattern searched in a kernel's name) of the split, first match
# wins: the old engines' names (gemm.cuh's <LN, TA, TB, epilogue>,
# mhsa_bwd.cuh) and the new ones (wgmma_gemm.cuh's forms, mhsa_reg_bwd.cuh)
SPLIT_PARTS = (
    ("attention core", r"mhsa"),
    ("do GEMM", r"gemm_kernel<false, false, true, 4>|RowsNT, 128, 3, 2, "
                r"__nv_bfloat16"),
    ("dWout + dWqkv GEMMs", r"gemm_kernel<false, true, false, 3>|ColsTN"),
    ("dln GEMM", r"gemm_kernel<false, false, true, 3>|RowsNT, 128, 3, 2, "
                 r"float"),
    ("row passes", r"ln_rows|ln_bwd_rows|reduce_rows"),
    ("other", r""))
# the same for #4 and #10: the parent's gemm.cuh epilogues 5 (bias + GELU
# and its derivative) and 6 (the product with it), this tree's dual tile
MLP_SPLIT_PARTS = (
    ("dual tile", r"gemm_kernel<false, false, false, 5>|"
                  r"gemm_kernel<false, false, true, 6>|DualMlp"),
    ("dW1 + dW2 GEMMs", r"gemm_kernel<false, true, false, 3>|ColsTN"),
    ("dln / dx GEMM", r"gemm_kernel<false, false, true, [34]>|RowsNT"),
    ("row passes", r"ln_rows|ln_bwd_rows|reduce_rows|col_partials"),
    ("other", r""))
# the same for #2 and #9: the parent's gemm.cuh epilogues 1 (bias + GELU,
# with the LN prologue for #2), 2 (bias + residual) and 0 (bias), this
# tree's DenseEpi<true> (bias + GELU) and <false> (bias, + residual for #2)
# after ln_rows (DenseEpi<true, false> and <false, false> where the name
# carries the second parameter, kErf, the probes' accurate GELU)
MLP_FWD_SPLIT_PARTS = (
    ("LN rows", r"ln_rows"),
    ("fc1 + GELU", r"gemm_kernel<(true|false), false, false, 1>|"
                   r"DenseEpi<true[,>]"),
    ("fc2 + bias or residual", r"gemm_kernel<false, false, false, [02]>|"
                               r"DenseEpi<false[,>]"),
    ("other", r""))
# the same for #1 and #5: the parent's gemm.cuh LN-prologue qkv GEMM
# (epilogue 0, bias), mhsa.cuh's core and the residual out-projection
# (epilogue 2); this tree's ln_rows, DenseEpi<false> (qkv), mhsa_reg.cuh's
# core and DenseEpi<false> (+ residual). A part of ONCE_A_CALL takes one
# kernel a call, so two launches of one instance split by their order.
ATTN_FWD_SPLIT_PARTS = (
    ("LN rows", r"ln_rows"),
    ("qkv product", r"gemm_kernel<true, false, false, 0>|"
                    r"DenseEpi<false[,>]"),
    ("attention core", r"mhsa"),
    ("out-projection", r"gemm_kernel<false, false, false, 2>|"
                       r"DenseEpi<false[,>]"),
    ("other", r""))
ONCE_A_CALL = frozenset({"qkv product"})


def _load_parent_build(root: str):
    """The parent checkout's ``_build`` module, loaded from its file, so
    that its sources and build directory are the parent's own."""
    path = os.path.join(root, "vlp_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Library:
    """What ``block_attention``, ``fused_block`` and ``fused_mlp`` read of
    ``_build``
    (``load_library``, ``check``), serving another build's library."""

    def __init__(self, lib):
        self.lib = lib

    def load_library(self):
        return self.lib

    check = staticmethod(_build.check)


class _Mixed:
    """A library whose entry points ``names`` are another build's."""

    def __init__(self, own, other, names):
        self._own, self._other, self._names = own, other, names

    def __getattr__(self, name):
        return getattr(self._other if name in self._names else self._own,
                       name)


def _host_call_ms(fn, calls=20):
    """Host ms per call of ``calls`` calls of ``fn`` issued behind a spin
    kernel (the card busy, so no call waits for it)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def _call_parts(names, parts_of):
    """The part of each kernel of one call, in launch order: the first part
    of ``parts_of`` whose pattern the name matches, passing over a part of
    ``ONCE_A_CALL`` that an earlier kernel of the call took."""
    taken, parts = set(), []
    for name in names:
        part = next(p for p, pat in parts_of
                    if p not in taken and re.search(pat, name))
        if part in ONCE_A_CALL:
            taken.add(part)
        parts.append(part)
    return parts


def _call_kernels(fn):
    """[(kernel name, device ms)] of one call of ``fn`` (after one untimed
    call) under torch.profiler, in launch order."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted(
        (e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA and
         not e.is_user_annotation),
        key=lambda e: e.time_range.start)
    return [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
            for e in kernels]


def _split(fns_per_level, parts_of=SPLIT_PARTS):
    """{part: ms per NesT-Small step} and {kernel: ms per step} of one call
    of each level's function under torch.profiler, weighted by the level's
    blocks per step; ``parts_of`` groups the kernels (``_call_parts``)."""
    per_kernel, parts = {}, {}
    for fn, blocks in fns_per_level:
        kernels = _call_kernels(fn)
        for (name, ms), part in zip(kernels, _call_parts(
                [n for n, _ in kernels], parts_of)):
            ms *= blocks
            per_kernel[name] = per_kernel.get(name, 0.0) + ms
            parts[part] = parts.get(part, 0.0) + ms
    return parts, {k[:120]: v for k, v in per_kernel.items()}


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
    own_lib = _build.load_library()
    sides = {"change": (_build, _build),
             "parent": (_Library(parent_lib),
                        _Library(_Mixed(own_lib, parent_lib,
                                        PARENT_ENTRY_POINTS)))}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")

    rng = np.random.default_rng(0)
    pred = Predictor(EXPERIMENTS[VIT], None, mean=128.0, std=64.0,
                     batch_size=32, device="cuda")
    request = rng.integers(0, 256, (32, 224, 224), dtype=np.uint8)
    nest_pred = Predictor(EXPERIMENTS[NEST], None, mean=128.0, std=64.0,
                          batch_size=64, device="cuda")
    nest_request = rng.integers(0, 256, (64, 224, 224), dtype=np.uint8)
    runs = {}
    for label, key, batch, nhwc in (
            ("vit_train_ms", VIT, 32, False),
            ("nest_unfused_train_ms", NEST_UNFUSED, 64, False),
            ("nest_train_ms", NEST, 64, False),
            ("nest_nhwc_train_ms", NEST, 64, True)):
        tcfg = TRAIN_EXPERIMENTS[key]
        task, state, step = build_training(tcfg, cuda, 10)
        if nhwc:
            task.model.backbone.nhwc_windows = True
        batches = [random_batch(rng, batch, 224) for _ in range(4)]
        runs[label] = (step, state, batches)
    gen = torch.Generator(device="cuda").manual_seed(2)
    inputs = {}
    for shape, (n, s, d, heads) in KERNEL_SHAPES.items():
        qkv = (torch.randn(n, s, 3 * d, generator=gen, device="cuda")
               * 1.5).bfloat16()
        do = torch.randn(n, s, d, generator=gen, device="cuda").bfloat16()
        q, k, v = qkv.view(n, s, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        inputs[shape] = (qkv, do, heads, (q, k, v))
    half = {}  # level -> (#3, #6, #4, #10, #2, #9, #1 and #5 calls)
    for i, (width, d, heads, _) in enumerate(NEST_LEVELS):
        mp = torch.randn(64, width, width, d, generator=gen,
                         device="cuda").bfloat16()
        dy = torch.randn(64, width, width, d, generator=gen,
                         device="cuda").bfloat16()
        (g, b, bq, bo), (wq, wo) = FB._cast(torch.bfloat16, vectors=(
            1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda"),
            0.1 * torch.randn(d, generator=gen, device="cuda"),
            0.02 * torch.randn(3 * d, generator=gen, device="cuda"),
            0.02 * torch.randn(d, generator=gen, device="cuda")), matrices=(
            torch.randn(d, 3 * d, generator=gen, device="cuda") * d ** -0.5,
            torch.randn(d, d, generator=gen, device="cuda") * d ** -0.5))
        x, tdy = FB._windows(mp, WINDOW), FB._windows(dy, WINDOW)
        _, qkv, o = FB._ln_attention_cuda(x, g, b, wq, bq, wo, bo, heads)
        _, mqkv, mo = FB._ln_attention_windows_cuda(mp, WINDOW, g, b, wq, bq,
                                                    wo, bo, heads)
        rows, drows = mp.reshape(-1, d), dy.reshape(-1, d)
        (b1, b2), (w1, w2) = FB._cast(torch.bfloat16, vectors=(
            0.02 * torch.randn(4 * d, generator=gen, device="cuda"),
            0.02 * torch.randn(d, generator=gen, device="cuda")), matrices=(
            torch.randn(d, 4 * d, generator=gen, device="cuda") * d ** -0.5,
            torch.randn(4 * d, d, generator=gen, device="cuda")
            * (4 * d) ** -0.5))
        half[i] = (
            lambda x=x, tdy=tdy, g=g, b=b, wq=wq, bq=bq, wo=wo, h=heads,
            qkv=qkv, o=o: FB.ln_attention_bwd(x, g, b, wq, bq, wo, tdy, h,
                                              qkv, o),
            lambda mp=mp, dy=dy, g=g, b=b, wq=wq, bq=bq, wo=wo, h=heads,
            qkv=mqkv, o=mo: FB.ln_attention_windows_bwd(
                mp, WINDOW, g, b, wq, bq, wo, dy, h, qkv, o),
            lambda x=rows, dy=drows, g=g, b=b, w1=w1, b1=b1, w2=w2:
            FB.ln_mlp_bwd(x, g, b, w1, b1, w2, dy),
            lambda x=rows, dy=drows, w1=w1, b1=b1, w2=w2:
            FM.fused_mlp_bwd(x, w1, b1, w2, dy),
            lambda x=rows, g=g, b=b, w1=w1, b1=b1, w2=w2, b2=b2:
            FB.ln_mlp(x, g, b, w1, b1, w2, b2),
            lambda x=rows, w1=w1, b1=b1, w2=w2, b2=b2:
            FM.fused_mlp(x, w1, b1, w2, b2),
            lambda x=x, g=g, b=b, wq=wq, bq=bq, wo=wo, bo=bo, h=heads:
            FB.ln_attention(x, g, b, wq, bq, wo, bo, h),
            lambda mp=mp, g=g, b=b, wq=wq, bq=bq, wo=wo, bo=bo, h=heads:
            FB.ln_attention_windows(mp, WINDOW, g, b, wq, bq, wo, bo, h))

    def use(side):
        BA._build, FB._build = sides[side]
        FM._build = FB._build

    def turn(side):
        use(side)
        out = {"side": side}
        counted = (BA.attend_qkv, BA.attend_qkv_bwd, FB.ln_attention,
                   FB.ln_attention_windows, FB.ln_attention_bwd,
                   FB.ln_attention_windows_bwd, FB.ln_mlp, FM.fused_mlp,
                   FB.ln_mlp_bwd, FM.fused_mlp_bwd)
        before = [k.launches for k in counted]
        out["vit_serve_ms"] = _host_ms(lambda: pred.predict_arrays(request),
                                       args.reps)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out["nest_serve_ms"] = _host_ms(
            lambda: nest_pred.predict_arrays(nest_request), args.reps)
        out["nest_serve_peak_mib"] = (
            torch.cuda.max_memory_allocated() - base) / 2 ** 20
        for label, (step, state, batches) in runs.items():
            it = iter(range(args.reps))
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out[label] = _host_ms(lambda: train_steps(
                step, state, [batches[next(it) % len(batches)]]), args.reps)
            out[label[:-3] + "_peak_mib"] = (
                torch.cuda.max_memory_allocated() - base) / 2 ** 20
        # #7, #8, #1, #5, #3, #6, #2, #9, #4 and #10 launches of the
        # serving and training steps above
        out["launches"] = [k.launches - n for k, n in zip(counted, before)]
        for shape, (qkv, do, heads, qkv_views) in inputs.items():
            out[f"{shape}_attend_ms"] = device_ms(
                lambda: BA.attend_qkv(qkv, heads))
            out[f"{shape}_attend_bwd_ms"] = device_ms(
                lambda: BA.attend_qkv_bwd(qkv, do, heads))
            with torch.no_grad():
                out[f"{shape}_sdpa_ms"] = device_ms(
                    lambda: F.scaled_dot_product_attention(*qkv_views))
        for i, (bwd, windows_bwd, mlp_bwd, fused_bwd, mlp, fused, fwd,
                windows) in half.items():
            out[f"nest_l{i}_ln_attention_ms"] = device_ms(fwd)
            out[f"nest_l{i}_ln_attention_windows_ms"] = device_ms(windows)
            out[f"nest_l{i}_ln_attention_bwd_ms"] = device_ms(bwd)
            out[f"nest_l{i}_ln_attention_bwd_host_ms"] = _host_call_ms(bwd)
            out[f"nest_l{i}_ln_attention_windows_bwd_ms"] = device_ms(
                windows_bwd)
            out[f"nest_l{i}_ln_mlp_ms"] = device_ms(mlp)
            out[f"nest_l{i}_fused_mlp_ms"] = device_ms(fused)
            out[f"nest_l{i}_ln_mlp_bwd_ms"] = device_ms(mlp_bwd)
            out[f"nest_l{i}_fused_mlp_bwd_ms"] = device_ms(fused_bwd)
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
    metrics = [k for k in records[0] if k.endswith(("_ms", "_mib"))]
    splits = {}
    for side in ("parent", "change"):
        use(side)
        for which, name, parts_of in (
                (0, "ln_attention_bwd", SPLIT_PARTS),
                (1, "ln_attention_windows_bwd", SPLIT_PARTS),
                (2, "ln_mlp_bwd", MLP_SPLIT_PARTS),
                (3, "fused_mlp_bwd", MLP_SPLIT_PARTS),
                (4, "ln_mlp", MLP_FWD_SPLIT_PARTS),
                (5, "fused_mlp", MLP_FWD_SPLIT_PARTS),
                (6, "ln_attention", ATTN_FWD_SPLIT_PARTS),
                (7, "ln_attention_windows", ATTN_FWD_SPLIT_PARTS)):
            parts, kernels = _split(
                [(half[i][which], blocks)
                 for i, (_, _, _, blocks) in enumerate(NEST_LEVELS)],
                parts_of)
            splits[f"{side} {name}"] = {"parts": parts, "kernels": kernels}
    summary = {"card": smi, "rounds": args.rounds, "reps": args.reps,
               "median": {side: {m: statistics.median(x[m] for x in recs)
                                 for m in metrics}
                          for side, recs in sides_of.items()},
               "split_ms_per_step": splits}
    print(json.dumps(summary), flush=True)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"turns": records, "summary": summary}, f, indent=1)
    use("change")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
