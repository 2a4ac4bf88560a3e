"""CUDA-event timing and the card's peak rates, shared by the probes,
``chip_smoke.py`` and ``scripts/ab_attention.py``."""
from __future__ import annotations

import statistics
import subprocess
import sys
from typing import Callable, Dict

import torch

# Peak rates of one H100 SXM (NVIDIA's data sheet): device memory and dense
# bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def require_cuda(prog: str) -> str:
    """The card's name and power limit as nvidia-smi gives them; exits with
    code 2 when there is no CUDA device (a probe does not time the CPU)."""
    if not torch.cuda.is_available():
        print(f"{prog}: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn: Callable[[], object], iters: int = 10,
              warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms over ``iters`` calls, each between
    two CUDA events, after ``warmup`` calls."""
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


def in_turns(**fns: Callable[[], object]) -> Dict[str, float]:
    """Median ms of each function, taken in the order of ``fns`` and then
    reversed (plain, kernel, library, library, kernel, plain), averaged, so
    that all see the same card state."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(median_ms(fns[n]))
    return {n: statistics.mean(t) for n, t in times.items()}


def device_ms(fn: Callable[[], object], calls: int = 20) -> float:
    """Device ms per call of ``calls`` back-to-back calls of ``fn``, queued
    behind a spin kernel so that the card never waits for the host: the
    kernels' time without the wrappers' host time."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms: the host queues the calls
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def device_in_turns(**fns: Callable[[], object]) -> Dict[str, float]:
    """``device_ms`` of each function, taken in the order of ``fns`` and
    then reversed, averaged (kernel, library, library, kernel)."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(device_ms(fns[n]))
    return {n: statistics.mean(t) for n, t in times.items()}


def bound_ms(flops: float, nbytes: float) -> Dict[str, object]:
    """The least time of the work on one H100: the larger of its bytes over
    3.35 TB/s and its operations over 989 TFLOP/s bf16."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
