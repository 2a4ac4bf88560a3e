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

Then one JSON line with every kernel's launches, error and times (``ms``
and ``plain_ms`` are the kernel's and the plain version's time in one
batch-64 forward: the sum over levels of depth x median time per call),
and last ``{"ok": true, "device": {...}}``. Any failed check raises.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from vlp_tpu_torch.config import EXPERIMENTS
from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops import fused_block as FB
from vlp_tpu_torch.serve import Predictor

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
            # plain, kernel, kernel, plain: both see the same card state
            p1, k1, k2, p2 = (_median_ms(fn) for fn in (plain, kern, kern,
                                                        plain))
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
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
    launches = {k.__name__: k.launches for k in FB.KERNELS}
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


def main() -> int:
    smi = phase_device()
    phase_build()
    stats = phase_kernels()
    FB.reset_launch_counts()
    launches = phase_slice(smi)
    sources = {"ln_attention": ("vlp_tpu_torch/csrc/ln_attention.cu",
                                "vlp_tpu/ops/fused_block.py:493"),
               "ln_mlp": ("vlp_tpu_torch/csrc/ln_mlp.cu",
                          "vlp_tpu/ops/fused_block.py:786")}
    print(json.dumps({"kernels": [
        {"name": k.__name__, "route": "cuda",
         "source": sources[k.__name__][0],
         "replaces": sources[k.__name__][1],
         "launches": launches[k.__name__], **stats[k.__name__]}
        for k in FB.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
