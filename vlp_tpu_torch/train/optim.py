"""Optimizers and learning-rate schedules (counterpart of
``vlp_tpu/train/optim.py``).

The schedules are per-step functions quantised as the reference's
Lightning schedulers step per epoch: ``cosine`` is CosineAnnealingLR over
``max_epochs`` on whole epochs; ``cosine_warmup`` is linear warmup over
``warmup_epochs`` then a cosine, on the fractional epoch, so its lr at step
0 is 0 (ROADMAP.md Queue 3). The train step writes ``schedule(step)`` into
the optimizer's group before each update, which is where optax reads its
schedule. ``adamw`` is ``torch.optim.AdamW``, the same update as
``optax.adamw`` (``tests/test_torch_trajectory.py`` pins that), ``adam``
and ``sgd`` likewise. Parameter groups (``vision_encoder_lr``) and lr-0
freezing raise until a ported path needs them.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch

from vlp_tpu_torch.config import TrainConfig

Schedule = Callable[[int], float]


def make_schedule(base_lr: float, cfg: TrainConfig,
                  steps_per_epoch: int) -> Schedule:
    name = cfg.scheduler
    max_epochs = max(cfg.max_epochs, 1)
    if name in (None, "none", "no_scheduler"):
        return lambda step: base_lr
    if name == "cosine":
        def cosine(step: int) -> float:
            epoch = min(step // steps_per_epoch, max_epochs)
            return base_lr * 0.5 * (1 + math.cos(math.pi * epoch
                                                 / max_epochs))

        return cosine
    if name == "cosine_warmup":
        warmup = cfg.warmup_epochs

        def cosine_warmup(step: int) -> float:
            epoch = step / steps_per_epoch
            if epoch < warmup:
                return base_lr * min(epoch / max(warmup, 1e-8), 1.0)
            progress = min(max((epoch - warmup)
                               / max(max_epochs - warmup, 1e-8), 0.0), 1.0)
            return base_lr * 0.5 * (1 + math.cos(math.pi * progress))

        return cosine_warmup
    raise ValueError(f"unknown scheduler {name!r}")


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int
                   ) -> Tuple[torch.optim.Optimizer, Schedule]:
    """(optimizer over one group, schedule); the group's lr starts at
    ``schedule(0)``."""
    if cfg.vision_encoder_lr is not None or cfg.freeze_encoder:
        raise NotImplementedError(
            "parameter groups (vision_encoder_lr, freeze_encoder) are not "
            "ported yet (ROADMAP.md Queue 1 item 2)")
    schedule = make_schedule(cfg.lr, cfg, steps_per_epoch)
    lr = schedule(0)
    if cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(cfg.b1, cfg.b2),
                                eps=cfg.eps, weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(cfg.b1, cfg.b2),
                               eps=cfg.eps)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return opt, schedule
