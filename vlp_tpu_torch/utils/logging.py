"""Logging and metric sinks (the port's copy of ``vlp_tpu/utils/logging.py``).

The reference logs through Python ``logging`` (repo-wide ``project`` logger,
reference logging.conf) and wandb (reference configs/logger/wandb.yaml).
Here: stdlib logging plus a pluggable ``MetricSink`` abstraction — a JSONL
sink that always works offline, an in-memory sink for tests/aggregation, and
no wandb adapter: ``logger=wandb`` warns and keeps the JSONL sink, as the
JAX driver does where wandb cannot be imported (the machine with the card
has no wandb and no network).
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

_LOGGER_NAME = "vlp_tpu_torch"
# the level of every logger of the port's on a rank that is not global
# rank 0 (``quiet_unless_main``), None elsewhere
_QUIET: Optional[int] = None


def get_logger(name: str = _LOGGER_NAME) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(_QUIET or os.environ.get("VLP_TPU_LOGLEVEL", "INFO"))
        logger.propagate = False
    return logger


def quiet_unless_main(mesh) -> None:
    """On a mesh only global rank 0 logs at INFO; the others keep warnings
    and errors, in every logger of the port's (each module's has its own
    level), those made later too."""
    global _QUIET
    if mesh is None or mesh.is_main:
        return
    _QUIET = logging.WARNING
    for name, logger in logging.Logger.manager.loggerDict.items():
        if name.split(".")[0] == _LOGGER_NAME and isinstance(
                logger, logging.Logger) and logger.handlers:
            logger.setLevel(_QUIET)


class MetricSink:
    """Interface for metric consumers (wandb-equivalent)."""

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        raise NotImplementedError

    def log_summary(self, metrics: Dict[str, Any]) -> None:
        """Run-level summary values (wandb.run.summary equivalent)."""
        raise NotImplementedError

    def finish(self) -> None:
        pass


class MemorySink(MetricSink):
    """Keeps everything in memory. Used by tests and by the k-fold driver to
    harvest per-fold best-epoch snapshots (reference src/train.py:173-177
    reads them from wandb.run.summary)."""

    def __init__(self) -> None:
        self.history: List[Dict[str, Any]] = []
        self.summary: Dict[str, Any] = {}

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = dict(metrics)
        if step is not None:
            rec["_step"] = step
        self.history.append(rec)

    def log_summary(self, metrics: Dict[str, Any]) -> None:
        self.summary.update(metrics)


class JsonlSink(MetricSink):
    """Appends one JSON object per log call; offline-first wandb replacement."""

    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.summary_path = path + ".summary.json"
        self.summary: Dict[str, Any] = {}
        self._fh = open(path, "a", buffering=1)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = {"_time": time.time()}
        if step is not None:
            rec["_step"] = step
        rec.update({k: _to_jsonable(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")

    def log_summary(self, metrics: Dict[str, Any]) -> None:
        self.summary.update({k: _to_jsonable(v) for k, v in metrics.items()})
        with open(self.summary_path, "w") as fh:
            json.dump(self.summary, fh, indent=2)

    def finish(self) -> None:
        self._fh.close()


class MultiSink(MetricSink):
    def __init__(self, sinks: List[MetricSink]) -> None:
        self.sinks = list(sinks)

    def log(self, metrics, step=None):
        for s in self.sinks:
            s.log(metrics, step=step)

    def log_summary(self, metrics):
        for s in self.sinks:
            s.log_summary(metrics)

    def finish(self):
        for s in self.sinks:
            s.finish()


def _to_jsonable(v: Any) -> Any:
    try:
        import numpy as np

        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, np.ndarray):
            return v.tolist()
    except ImportError:
        pass
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:  # 0-d tensor
        return v.item()
    return v
