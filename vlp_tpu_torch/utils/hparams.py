"""Hyperparameter and parameter-count logging (counterpart of
``vlp_tpu/utils/hparams.py``, reference src/utils/hyperparam_logging.py:
13-58): the config and the total, trainable and non-trainable parameter
counts, sent to every sink. Non-trainable counts the parameters of frozen
groups (lr 0: ``make_optimizer`` turns their ``requires_grad`` off) and the
buffers (BatchNorm's running statistics), as the JAX package counts frozen
groups and ``batch_stats``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

from torch import nn

from vlp_tpu_torch.config import Config
from vlp_tpu_torch.parallel.tp import full_shapes
from vlp_tpu_torch.utils.logging import MetricSink


def log_hyperparameters(cfg: Config, model: nn.Module,
                        sink: MetricSink) -> Dict[str, Any]:
    """The counts are the replicated model's, also of a model split over
    the model ranks (``parallel/tp.py``)."""
    sizes = {k: math.prod(s) for k, s in full_shapes(model).items()}
    params = dict(model.named_parameters())
    total = sum(sizes[n] for n in params)
    frozen = sum(sizes[n] for n, p in params.items() if not p.requires_grad)
    record = {
        "model/params/total": total,
        "model/params/trainable": total - frozen,
        "model/params/non_trainable": frozen + sum(
            sizes[n] for n, _ in model.named_buffers()),
        "config": cfg.to_dict(),
    }
    sink.log_summary(record)
    return record
