"""Hyperparameter and parameter-count logging (counterpart of
``vlp_tpu/utils/hparams.py``, reference src/utils/hyperparam_logging.py:
13-58): the config and the total, trainable and non-trainable parameter
counts, sent to every sink. Non-trainable counts the parameters of frozen
groups (lr 0: ``make_optimizer`` turns their ``requires_grad`` off) and the
buffers (BatchNorm's running statistics), as the JAX package counts frozen
groups and ``batch_stats``.
"""
from __future__ import annotations

from typing import Any, Dict

from torch import nn

from vlp_tpu_torch.config import Config
from vlp_tpu_torch.utils.logging import MetricSink


def count_params(tensors) -> int:
    return int(sum(t.numel() for t in tensors))


def log_hyperparameters(cfg: Config, model: nn.Module,
                        sink: MetricSink) -> Dict[str, Any]:
    params = list(model.parameters())
    total = count_params(params)
    frozen = count_params(p for p in params if not p.requires_grad)
    record = {
        "model/params/total": total,
        "model/params/trainable": total - frozen,
        "model/params/non_trainable": frozen + count_params(model.buffers()),
        "config": cfg.to_dict(),
    }
    sink.log_summary(record)
    return record
