"""Profiling and step timing (counterpart of ``vlp_tpu/utils/profiling.py``).

``trace(log_dir)`` records a ``torch.profiler`` trace of the CPU and, where
the device is CUDA, of its kernels, and writes it as a Chrome/Perfetto JSON
into ``log_dir`` (``trainer.profile=true``: the first epoch, into
``trainer.profile_dir``). ``StepTimer`` keeps per-step wall times; the
trainer's steps run asynchronously, so a step's stop without ``block_on``
is the host's dispatch time, and the epoch wall time is the authoritative
throughput number.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from vlp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """A torch.profiler trace of the block, saved to
    ``<log_dir>/trace.json``."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logger.info("profiler: tracing to %s", log_dir)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler: trace saved to %s", path)


class StepTimer:
    """Streaming per-step wall-time stats; ``block_on`` (a tensor of the
    step's output) synchronises its device first, so the time includes the
    device's work."""

    def __init__(self, warmup: int = 2) -> None:
        self.warmup = warmup
        self._times: List[float] = []
        self._count = 0
        self._last: Optional[float] = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def stop(self, block_on: Optional[torch.Tensor] = None) -> float:
        if block_on is not None and block_on.device.type == "cuda":
            torch.cuda.synchronize(block_on.device)
        dt = time.perf_counter() - (self._last or time.perf_counter())
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return dt

    def stats(self, batch_size: Optional[int] = None) -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        out = {"step_time_ms_mean": float(arr.mean() * 1e3),
               "step_time_ms_p50": float(np.percentile(arr, 50) * 1e3),
               "step_time_ms_p95": float(np.percentile(arr, 95) * 1e3)}
        if batch_size:
            out["images_per_sec"] = batch_size / float(arr.mean())
        return out
