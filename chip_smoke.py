"""Smoke run of the PyTorch/CUDA port (``vlp_tpu_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each printing its lines before the last line:

1. device: torch/CUDA versions and the card's name and power limit
   (``nvidia-smi``); exits nonzero when no CUDA device is present.
2. build: compiles ``vlp_tpu_torch/csrc`` with nvcc (sm_90a) and loads it.
3. kernels: ``ln_attention`` and ``ln_mlp`` against their plain PyTorch
   versions at the shapes serving gives them, NesT-Small's three levels at
   batch 64 (bf16 inputs from a seeded CUDA generator), against the plain
   version in bf16 and in fp32; then the median time of kernel and plain
   version at the same shapes.
4. slice: ``Predictor`` for ``experiment=baseline_only_imaging_nest_small``
   (NesT-Small, 224x224, bf16, batch 64, random weights at the flax
   initializers' scales) answers requests of 64, 64 and 37 images; the
   launch counters must show 24 launches of each kernel per forward; the
   first 8 logits are held against the same weights run on the CPU in
   fp32; per-batch latency and images/s are timed.

5. training kernels: the backward kernels ``ln_attention_bwd`` and
   ``ln_mlp_bwd`` against their plain versions (bf16 and fp32) at
   NesT-Small's three levels at batch 64, every cotangent; ``shear_rows``
   at [64, 224, 224] along rows and columns; ``add_gaussian_noise``: the
   Philox words against Random123's known answers and the plain version's
   words, values within a stated bound, sigma 0 the identity, the moments
   of one sigma-1 draw; then the median time of kernel and plain version.
6. training slice: ``make_train_step`` for
   ``experiment=baseline_only_imaging_nest_small`` (NesT-Small, 224x224
   uint8 batches of 64, bf16, AdamW under cosine_warmup, the experiment's
   augmentation) with random weights: 3 warm-up steps, then 10 timed steps
   whose launch counters must show 24 + 24 + 24 + 24 + 3 + 1 kernel
   launches per step; finite loss and gradients, parameters moving from
   step 1 on, the lr the optimizer used equal to cosine_warmup's linear
   warmup written out (0 at step 0); the bf16 gradients of a 4-image batch
   (augmentation off) held against fp32 on the CPU; step latency, images/s,
   device step time and peak memory.

Then one JSON line with every kernel's launches in the training slice's
timed steps, its error and times (``ms`` and ``plain_ms``: the kernel's
and the plain version's time per training step, the sum over levels of
depth x median time per call for the half-block kernels, calls per step x
median time for shear and noise; the forward kernels add their launches in
the serving phase as ``serve_launches``), and last ``{"ok": true,
"device": {...}}``. Any failed check raises.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from vlp_tpu_torch.config import EXPERIMENTS, TRAIN_EXPERIMENTS
from vlp_tpu_torch.models.tasks import build_task
from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops import fused_block as FB
from vlp_tpu_torch.ops import noise as NZ
from vlp_tpu_torch.ops import shear as SH
from vlp_tpu_torch.ops.warp import default_max_shift
from vlp_tpu_torch.serve import Predictor
from vlp_tpu_torch.train.setup import build_training, random_batch
from vlp_tpu_torch.train.step import train_steps

# (blocks per image, D, heads, depth) of NesT-Small's levels at 224x224
LEVELS = ((16, 96, 3, 2), (4, 192, 6, 2), (1, 384, 12, 20))
SEQ = 196
# Kernel vs plain version, as a share of the reference's largest |value|.
# Both round to bf16 at the same five points and differ only in fp32
# summation order, which can flip one rounding (one bf16 ulp is 2^-8 of the
# value at most): two ulps at the largest output.
BOUND_VS_PLAIN_BF16 = 2.0 ** -6
# Against fp32 the five bf16 roundings (each <= 2^-9 relative) add up;
# twice their sum, rounded up to a power of two.
BOUND_VS_PLAIN_FP32 = 2.0 ** -5
# NesT-Small bf16 logits vs fp32 on the CPU: 48 half-blocks each round the
# residual stream to bf16 (2^-9 relative), sqrt(48) * 2^-9 ~ 1.4% if
# uncorrelated; allow 5% of max(1, max|logit|).
BOUND_LOGITS = 0.05
REQUESTS = (64, 64, 37)
BATCH = 64
# Backward kernel vs plain backward, each of the seven cotangents, as a
# share of the reference's largest |value|. Against plain bf16: both round
# at the same points (ln, qkv, p, do/l, ds, dqkv; h, dh; dx and the weight
# gradients) and differ in fp32 summation order, which can flip one bf16
# rounding of an intermediate (2^-8 relative) and then moves the sums
# downstream of it by about as much; the final casts add one ulp: 2^-6, four
# ulps of the largest output. Against plain fp32: six bf16 roundings on the
# way (each <= 2^-9 relative) add up to ~1.2%; 2^-4 leaves a factor 5.
BOUND_BWD_BF16 = 2.0 ** -6
BOUND_BWD_FP32 = 2.0 ** -4
# shear_rows: the kernel rounds a * (1 - f), b * f and their sum separately
# (no FMA), as the plain version's three tensor ops do, and reads the same
# clamped elements: exact.
BOUND_SHEAR = 0.0
# add_gaussian_noise, x in [0, 256) and sigma 1: the words are equal, so the
# values differ only by logf/sqrtf/cosf/sinf against torch's log/sqrt/cos/
# sin (each within 2 ulps: <= 16 ulps of |z| < 8 in all, 2^-17) and by the
# one rounding of x + sigma * z that this can flip (one ulp of |out| < 512,
# 2^-14): 2^-14 + 2^-17 < 2^-13.
BOUND_NOISE = 2.0 ** -13
# training slice
STEPS_PER_EPOCH = 10      # the schedule's epoch length for this run
WARMUP_STEPS = 3
TIMED_STEPS = 10
GRAD_BATCH = 4
# NesT-Small gradients, bf16 on the card vs fp32 on the CPU (same weights,
# augmentation off): each of the 48 half-blocks rounds the residual stream
# to bf16 on the way forward and dx on the way back (2^-9 relative each),
# sqrt(96) * 2^-9 ~ 1.9% if uncorrelated, and every weight gradient is cast
# to bf16 once (2^-9): allow 10% of the gradient's L2 norm, and a cosine of
# at least 0.98 (a 20% error) for every tensor.
BOUND_GRAD_REL = 0.1
BOUND_GRAD_COS = 0.98


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(f"nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")


def _inputs(gen, n, d):
    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = rand(n, SEQ, d).bfloat16()
    attn = (1.0 + rand(d, scale=0.1), rand(d, scale=0.1),
            rand(d, 3 * d, scale=d ** -0.5).bfloat16(),
            rand(3 * d, scale=0.02), rand(d, d, scale=d ** -0.5).bfloat16(),
            rand(d, scale=0.02))
    mlp = (1.0 + rand(d, scale=0.1), rand(d, scale=0.1),
           rand(d, 4 * d, scale=d ** -0.5).bfloat16(), rand(4 * d, scale=0.02),
           rand(4 * d, d, scale=(4 * d) ** -0.5).bfloat16(),
           rand(d, scale=0.02))
    return x, attn, mlp


def _err(out, ref):
    diff = (out.float() - ref.float()).abs().max().item()
    return diff, diff / ref.float().abs().max().item()


def _median_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _timed_pair(plain, kern):
    """Median ms of plain and kernel, taken as plain, kernel, kernel,
    plain so that both see the same card state."""
    p1, k1, k2, p2 = (_median_ms(fn) for fn in (plain, kern, kern, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def _calls(n, d, heads, x, attn, mlp):
    """(name, kernel fn, plain fn, fp32 plain fn) of one level's shapes."""
    f32 = [t.float() for t in attn]
    f32m = [t.float() for t in mlp]
    rows = x.reshape(n * SEQ, d)
    return (
        ("ln_attention",
         lambda: FB.ln_attention(x, *attn, heads),
         lambda: FB.ln_attention_plain(x, *attn, heads),
         lambda: FB.ln_attention_plain(x.float(), *f32, heads)),
        ("ln_mlp",
         lambda: FB.ln_mlp(rows, *mlp),
         lambda: FB.ln_mlp_plain(rows, *mlp),
         lambda: FB.ln_mlp_plain(rows.float(), *f32m)),
    )


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
             for name in ("ln_attention", "ln_mlp")}
    for nb, d, heads, depth in LEVELS:
        n = BATCH * nb
        x, attn, mlp = _inputs(gen, n, d)
        for name, kern, plain, plain32 in _calls(n, d, heads, x, attn, mlp):
            out = kern()
            torch.cuda.synchronize()
            ref, ref32 = plain(), plain32()
            check(bool(torch.isfinite(out.float()).all()),
                  f"{name} D={d}: non-finite output")
            a, r = _err(out, ref)
            a32, r32 = _err(out, ref32)
            print(f"kernel {name} N={n} S={SEQ} D={d}: vs plain bf16 "
                  f"max_abs {a:.6g} rel {r:.6g} "
                  f"(bound {BOUND_VS_PLAIN_BF16:g}); "
                  f"vs plain fp32 max_abs {a32:.6g} rel {r32:.6g} "
                  f"(bound {BOUND_VS_PLAIN_FP32:g})")
            check(r <= BOUND_VS_PLAIN_BF16,
                  f"{name} D={d}: {r:.3g} > {BOUND_VS_PLAIN_BF16}")
            check(r32 <= BOUND_VS_PLAIN_FP32,
                  f"{name} D={d}: {r32:.3g} > {BOUND_VS_PLAIN_FP32}")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], a)
            del out, ref, ref32
            k_ms, p_ms = _timed_pair(plain, kern)
            print(f"time {name} N={n} S={SEQ} D={d} (batch {BATCH}): kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms per call")
            stats[name]["ms"] += depth * k_ms
            stats[name]["plain_ms"] += depth * p_ms
        del x, attn, mlp
        torch.cuda.empty_cache()
    return stats


def phase_slice(smi: str):
    cfg = EXPERIMENTS["baseline_only_imaging_nest_small"]
    check(cfg.model == "nest_small" and cfg.precision == "bf16"
          and cfg.image_size == 224, "unexpected experiment config")
    pred = Predictor(cfg, None, mean=128.0, std=64.0, batch_size=BATCH,
                     device="cuda")
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, 256, (k, 224, 224), dtype=np.uint8)
                for k in REQUESTS]
    pred.predict_arrays(requests[2][:1])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    FB.reset_launch_counts()
    probs = [pred.predict_arrays(r) for r in requests]
    launches = {k.__name__: k.launches for k in FB.FORWARD_KERNELS}
    forwards = sum(-(-k // BATCH) for k in REQUESTS)
    depth = sum(level[3] for level in LEVELS)
    print(f"slice: answered requests of {list(REQUESTS)} images in "
          f"{forwards} batch-{BATCH} forwards; launches {launches}")
    for name, count in launches.items():
        check(count == depth * forwards,
              f"{name}: {count} launches, expected {depth} x {forwards}")
    for p, k in zip(probs, REQUESTS):
        check(p.shape == (k,) and bool(np.all(np.isfinite(p)))
              and bool(np.all((p >= 0) & (p <= 1))),
              "probabilities must be finite and in [0, 1]")

    logits = pred.predict_logits(requests[0][:8])
    ref = Predictor(dataclasses.replace(cfg, precision="fp32"), None, mean=128.0, std=64.0, batch_size=8,
                    device="cpu")
    ref.task.model.load_state_dict(pred.task.model.state_dict())
    ref_logits = ref.predict_logits(requests[0][:8])
    err = float(np.abs(logits - ref_logits).max())
    bound = BOUND_LOGITS * max(1.0, float(np.abs(ref_logits).max()))
    print(f"slice: logits[:8] bf16 on GPU vs fp32 on CPU: max_abs {err:.6g} "
          f"(bound {bound:.6g}); gpu {np.round(logits, 4).tolist()} cpu "
          f"{np.round(ref_logits, 4).tolist()}")
    check(err <= bound, f"logits differ by {err:.4g} > {bound:.4g}")

    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        pred.predict_arrays(requests[0])
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    batch = pred._batch(requests[0], None)
    fwd_ms = _median_ms(lambda: pred.task.eval_fn(batch))
    print(f"slice: batch-{BATCH} request latency median {med * 1e3:.3f} ms "
          f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}, n=10), "
          f"{BATCH / med:.1f} images/s; device forward {fwd_ms:.3f} ms; "
          f"on {smi}")
    return launches


def _reset_counts() -> None:
    FB.reset_launch_counts()
    SH.shear_rows.launches = 0
    NZ.add_gaussian_noise.launches = 0


def _counts() -> dict:
    return {**{k.__name__: k.launches for k in FB.KERNELS},
            "shear_rows": SH.shear_rows.launches,
            "add_gaussian_noise": NZ.add_gaussian_noise.launches}


BWD_NAMES = {"ln_attention_bwd": ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv",
                                  "dwout", "dbout"),
             "ln_mlp_bwd": ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2",
                            "db2")}


def _bwd_calls(n, d, heads, x, attn, mlp, dy):
    """(name, kernel fn, plain fn, fp32 plain fn) of one level's backward
    shapes; the attention kernel reads the forward launch's qkv and o."""
    (g, b, bq, bo), (wq, wo) = FB._cast(
        torch.bfloat16, vectors=(attn[0], attn[1], attn[3], attn[5]),
        matrices=(attn[2], attn[4]))
    _, qkv, o = FB._ln_attention_cuda(x, g, b, wq, bq, wo, bo, heads)
    rows, drows = x.reshape(n * SEQ, d), dy.reshape(n * SEQ, d)
    (g2, b2, b1, _), (w1, w2) = FB._cast(
        torch.bfloat16, vectors=(mlp[0], mlp[1], mlp[3], mlp[5]),
        matrices=(mlp[2], mlp[4]))
    return (
        ("ln_attention_bwd",
         lambda: FB.ln_attention_bwd(x, g, b, wq, bq, wo, dy, heads, qkv, o),
         lambda: FB.ln_attention_bwd_plain(x, g, b, wq, bq, wo, dy, heads),
         lambda: FB.ln_attention_bwd_plain(x.float(), g, b, wq.float(), bq,
                                           wo.float(), dy.float(), heads)),
        ("ln_mlp_bwd",
         lambda: FB.ln_mlp_bwd(rows, g2, b2, w1, b1, w2, drows),
         lambda: FB.ln_mlp_bwd_plain(rows, g2, b2, w1, b1, w2, drows),
         lambda: FB.ln_mlp_bwd_plain(rows.float(), g2, b2, w1.float(), b1,
                                     w2.float(), drows.float())),
    )


def phase_train_kernels():
    gen = torch.Generator(device="cuda").manual_seed(1)
    stats = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
             for name in ("ln_attention_bwd", "ln_mlp_bwd", "shear_rows",
                          "add_gaussian_noise")}
    for nb, d, heads, depth in LEVELS:
        n = BATCH * nb
        x, attn, mlp = _inputs(gen, n, d)
        dy = torch.randn(n, SEQ, d, generator=gen, device="cuda").bfloat16()
        for name, kern, plain, plain32 in _bwd_calls(n, d, heads, x, attn,
                                                     mlp, dy):
            outs = kern()
            torch.cuda.synchronize()
            refs, refs32 = plain(), plain32()
            worst, worst32 = 0.0, 0.0
            for label, out, ref, ref32 in zip(BWD_NAMES[name], outs, refs,
                                              refs32):
                check(out.shape == ref.shape and out.dtype == ref.dtype,
                      f"{name} {label}: {out.dtype}{tuple(out.shape)} vs "
                      f"{ref.dtype}{tuple(ref.shape)}")
                check(bool(torch.isfinite(out.float()).all()),
                      f"{name} D={d} {label}: non-finite")
                a, r = _err(out, ref)
                a32, r32 = _err(out, ref32)
                print(f"kernel {name} N={n} D={d} {label}: vs plain bf16 "
                      f"max_abs {a:.6g} rel {r:.6g}; vs plain fp32 rel "
                      f"{r32:.6g}")
                check(r <= BOUND_BWD_BF16, f"{name} D={d} {label}: {r:.3g} "
                      f"> {BOUND_BWD_BF16}")
                check(r32 <= BOUND_BWD_FP32, f"{name} D={d} {label}: "
                      f"{r32:.3g} > {BOUND_BWD_FP32} vs fp32")
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                                 a)
                worst, worst32 = max(worst, r), max(worst32, r32)
            print(f"kernel {name} N={n} S={SEQ} D={d}: worst rel vs plain "
                  f"bf16 {worst:.6g} (bound {BOUND_BWD_BF16:g}), vs plain "
                  f"fp32 {worst32:.6g} (bound {BOUND_BWD_FP32:g})")
            del outs, refs, refs32
            k_ms, p_ms = _timed_pair(plain, kern)
            print(f"time {name} N={n} S={SEQ} D={d} (batch {BATCH}): kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms per call")
            stats[name]["ms"] += depth * k_ms
            stats[name]["plain_ms"] += depth * p_ms
        del x, attn, mlp, dy
        torch.cuda.empty_cache()

    # shear_rows at the warp's shapes, rows and columns
    img = torch.randint(0, 256, (BATCH, 224, 224), generator=gen,
                        device="cuda").float()
    shift = torch.randn(BATCH, 224, generator=gen, device="cuda") * 60.0
    ms = default_max_shift(224, 224)
    for axis in (1, 0):
        out = SH.shear_rows(img, shift, ms, axis)
        ref = SH.shear_rows_plain(img, shift, ms, axis)
        a = (out - ref).abs().max().item()
        print(f"kernel shear_rows [64, 224, 224] axis {axis} max_shift {ms}: "
              f"max_abs vs plain {a:.6g} (bound {BOUND_SHEAR:g})")
        check(a <= BOUND_SHEAR, f"shear_rows axis {axis}: {a:.3g}")
        stats["shear_rows"]["max_abs_err"] = max(
            stats["shear_rows"]["max_abs_err"], a)
    k_ms, p_ms = _timed_pair(lambda: SH.shear_rows_plain(img, shift, ms),
                             lambda: SH.shear_rows(img, shift, ms))
    print(f"time shear_rows [64, 224, 224]: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms per call")
    stats["shear_rows"].update(ms=3 * k_ms, plain_ms=3 * p_ms)

    # add_gaussian_noise: Philox known answers, words, values, moments
    kat = ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"), \
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         "408f276d 41c83b0e a20bc7c6 6d5451fd"), \
        ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         (0xa4093822, 0x299f31d0), "d16cfe09 94fdcceb 5001e420 24126ea1")
    for ctr, key, want in kat:
        got = NZ.philox4x32(torch.tensor([ctr], device="cuda"),
                            torch.tensor([key], device="cuda"))
        got = " ".join(f"{int(v):08x}" for v in got[0].tolist())
        check(got == want, f"philox4x32 {ctr} {key}: {got} != {want}")
    print("kernel philox4x32: Random123 known-answer vectors equal")
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (BATCH, 2), generator=gen,
                          device="cuda", dtype=torch.int32)
    groups = 224 * 112 // 4
    ctr = torch.zeros(BATCH * groups, 4, dtype=torch.long, device="cuda")
    ctr[:, 0] = torch.arange(groups, device="cuda").repeat(BATCH)
    key = (seeds.long() & 0xFFFFFFFF).repeat_interleave(groups, 0)
    words = NZ.philox4x32(ctr, key).reshape(BATCH, 224, 112)
    check(torch.equal(words, NZ.noise_words_plain(seeds, 224, 224)),
          "noise words differ from the plain version's")
    print(f"kernel philox4x32: the {words.numel()} words of a [64, 224, 224] "
          "draw equal the plain version's")
    x = torch.rand(BATCH, 224, 224, generator=gen, device="cuda") * 256.0
    ones = torch.ones(BATCH, device="cuda")
    out = NZ.add_gaussian_noise(x, seeds, ones)
    a = (out - NZ.add_gaussian_noise_plain(x, seeds, ones)).abs().max().item()
    print(f"kernel add_gaussian_noise [64, 224, 224] sigma 1: max_abs vs "
          f"plain {a:.6g} (bound {BOUND_NOISE:g})")
    check(a <= BOUND_NOISE, f"add_gaussian_noise: {a:.3g} > {BOUND_NOISE}")
    stats["add_gaussian_noise"]["max_abs_err"] = a
    check(torch.equal(NZ.add_gaussian_noise(x, seeds, torch.zeros_like(ones)),
                      x), "sigma 0 must leave x unchanged")
    z = NZ.add_gaussian_noise(torch.zeros_like(x), seeds, ones).double()
    mean, var = z.mean().item(), z.var().item()
    # 3.2M draws: the mean within 4 standard errors; the variance within
    # 1% (its standard error is sqrt(2 / n) = 0.08%)
    print(f"kernel add_gaussian_noise sigma 1: mean {mean:.6g}, var "
          f"{var:.6g} over {z.numel()} draws")
    check(abs(mean) < 4 / z.numel() ** 0.5 and abs(var - 1) < 0.01,
          "noise moments off")
    sig = torch.rand(BATCH, generator=gen, device="cuda") * 0.01
    k_ms, p_ms = _timed_pair(
        lambda: NZ.add_gaussian_noise_plain(x, seeds, sig),
        lambda: NZ.add_gaussian_noise(x, seeds, sig))
    print(f"time add_gaussian_noise [64, 224, 224]: kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms per call")
    stats["add_gaussian_noise"].update(ms=k_ms, plain_ms=p_ms)
    del img, shift, x, out, z, words, ctr, key
    torch.cuda.empty_cache()
    return stats


def _grads(task, batch, device):
    task.model.zero_grad(set_to_none=True)
    loss, _ = task.loss_fn({k: torch.from_numpy(v).to(device)
                            for k, v in batch.items()},
                           torch.Generator(device=device))
    loss.backward()
    return [p.grad.detach().float().cpu() for p in task.model.parameters()]


def phase_train_slice(smi: str):
    tcfg = TRAIN_EXPERIMENTS["baseline_only_imaging_nest_small"]
    aug = tcfg.augment()
    check(tcfg.serve.model == "nest_small" and tcfg.serve.precision == "bf16"
          and tcfg.serve.image_size == 224 and tcfg.batch_size == BATCH
          and tcfg.optimizer == "adamw" and tcfg.scheduler == "cosine_warmup"
          and tcfg.coral_lambda == 0 and aug.enabled
          and aug.noise_prob == 0.5 and aug.shear_deg == 0.0,
          "unexpected training config")
    cuda = torch.device("cuda")
    task, state, step = build_training(tcfg, cuda, STEPS_PER_EPOCH)
    rng = np.random.default_rng(1)
    batches = [random_batch(rng, BATCH, tcfg.serve.image_size)
               for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    auxes, used_lrs = [], []

    def run(batch):
        auxes.extend(train_steps(step, state, [batch]))
        # the lr the optimizer's update read
        used_lrs.append(state.optimizer.param_groups[0]["lr"])

    def params():
        return torch.cat([p.detach().reshape(-1) for p in
                          task.model.parameters()]).clone()

    p0 = params()
    run(batches[0])
    p1 = params()
    for batch in batches[1:WARMUP_STEPS]:
        run(batch)
    p_warm = params()
    check(torch.equal(p0, p1), "lr 0 at step 0 must leave the parameters")
    check(not torch.equal(p1, p_warm), "parameters did not move at step 1")
    torch.cuda.synchronize()

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    times, events = [], []
    for batch in batches[WARMUP_STEPS:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run(batch)
        end.record()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        events.append((start, end))
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / TIMED_STEPS for k, v in launches.items()}
    print(f"train: {TIMED_STEPS} timed steps, launches {launches}")
    want = {"ln_attention": 24, "ln_mlp": 24, "ln_attention_bwd": 24,
            "ln_mlp_bwd": 24, "shear_rows": 3, "add_gaussian_noise": 1}
    check(per_step == want, f"launches per step {per_step}, expected {want}")
    check(not torch.equal(p_warm, params()),
          "parameters did not move in the timed steps")
    losses = torch.stack([a["loss"] for a in auxes]).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite loss {losses}")
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in task.model.parameters()), "non-finite gradient")
    # cosine_warmup's lr at step i < warmup_epochs * steps_per_epoch (40
    # here; all 13 steps are inside) is base_lr * (i / steps_per_epoch) /
    # warmup_epochs, 0 at step 0: written out, not read from make_schedule
    warm = tcfg.warmup_epochs * STEPS_PER_EPOCH
    check(len(used_lrs) <= warm, "the steps must lie inside the warmup")
    want_lrs = [tcfg.lr * i / warm for i in range(len(used_lrs))]
    check(all(math.isclose(u, w, rel_tol=1e-12)
              for u, w in zip(used_lrs, want_lrs)),
          f"lr used per step {used_lrs}, expected {want_lrs}")
    check([a["lr"] for a in auxes] == used_lrs,
          "aux lr differs from the optimizer's")
    print(f"train: losses {[round(v, 5) for v in losses.tolist()]}; lr used "
          f"{used_lrs[0]:.6g} -> {used_lrs[-1]:.6g} = base_lr x step / "
          f"{warm} (steps_per_epoch {STEPS_PER_EPOCH}, cosine_warmup over "
          f"{tcfg.warmup_epochs} of {tcfg.max_epochs} epochs)")

    med = statistics.median(times)
    dev_ms = statistics.median(s.elapsed_time(e) for s, e in events)
    print(f"train: batch-{BATCH} step latency median {med * 1e3:.3f} ms "
          f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}, "
          f"n={TIMED_STEPS}), {BATCH / med:.1f} images/s; device step span "
          f"median {dev_ms:.3f} ms; peak memory {peak / 2 ** 30:.3f} GiB; "
          f"on {smi}")

    # bf16 gradients on the card vs fp32 on the CPU, augmentation off
    noaug = dataclasses.replace(
        task.statics, augment=task.statics.augment._replace(enabled=False))
    gtask = build_task(tcfg, noaug, cuda)
    ctask = build_task(dataclasses.replace(tcfg, serve=dataclasses.replace(
        tcfg.serve, precision="fp32")), noaug, torch.device("cpu"))
    gtask.model.load_state_dict(task.model.state_dict())
    ctask.model.load_state_dict(task.model.state_dict())
    gbatch = random_batch(np.random.default_rng(2), GRAD_BATCH,
                          tcfg.serve.image_size)
    g_gpu = _grads(gtask, gbatch, cuda)
    g_cpu = _grads(ctask, gbatch, torch.device("cpu"))
    flat_g = torch.cat([g.reshape(-1) for g in g_gpu]).double()
    flat_c = torch.cat([g.reshape(-1) for g in g_cpu]).double()
    rel = ((flat_g - flat_c).norm() / flat_c.norm()).item()
    cos = [torch.nn.functional.cosine_similarity(
        a.reshape(1, -1).double(), b.reshape(1, -1).double()).item()
        for a, b in zip(g_gpu, g_cpu)]
    names = [n for n, _ in task.model.named_parameters()]
    worst = int(np.argmin(cos))
    print(f"train: {GRAD_BATCH}-image gradients bf16 on GPU vs fp32 on CPU: "
          f"relative L2 {rel:.6g} (bound {BOUND_GRAD_REL:g}); per-tensor "
          f"cosine min {cos[worst]:.6g} at {names[worst]} (bound "
          f"{BOUND_GRAD_COS:g}), median {statistics.median(cos):.6g}")
    check(rel <= BOUND_GRAD_REL, f"gradient relative L2 {rel:.4g}")
    check(min(cos) >= BOUND_GRAD_COS, f"gradient cosine {min(cos):.4g}")
    return launches


def main() -> int:
    smi = phase_device()
    phase_build()
    stats = phase_kernels()
    FB.reset_launch_counts()
    serve_launches = phase_slice(smi)
    stats.update(phase_train_kernels())
    launches = phase_train_slice(smi)
    sources = {
        "ln_attention": ("vlp_tpu_torch/csrc/ln_attention.cu",
                         "vlp_tpu/ops/fused_block.py:493"),
        "ln_mlp": ("vlp_tpu_torch/csrc/ln_mlp.cu",
                   "vlp_tpu/ops/fused_block.py:786"),
        "ln_attention_bwd": ("vlp_tpu_torch/csrc/ln_attention_bwd.cu",
                             "vlp_tpu/ops/fused_block.py:522"),
        "ln_mlp_bwd": ("vlp_tpu_torch/csrc/ln_mlp_bwd.cu",
                       "vlp_tpu/ops/fused_block.py:813"),
        "shear_rows": ("vlp_tpu_torch/csrc/shear.cu",
                       "vlp_tpu/ops/pallas_shear.py:45"),
        "add_gaussian_noise": ("vlp_tpu_torch/csrc/noise.cu",
                               "vlp_tpu/ops/pallas_noise.py:64")}
    kernels = []
    for name, (source, replaces) in sources.items():
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 **stats[name]}
        if name in serve_launches:
            entry["serve_launches"] = serve_launches[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
