"""Optimizers and learning-rate schedules (counterpart of
``vlp_tpu/train/optim.py``).

The schedules are per-step functions quantised as the reference's
Lightning schedulers step per epoch: ``cosine`` is CosineAnnealingLR over
``max_epochs`` on whole epochs; ``cosine_warmup`` is linear warmup over
``warmup_epochs`` then a cosine, on the fractional epoch, so its lr at step
0 is 0 (ROADMAP.md Queue 3). ``adamw`` is ``torch.optim.AdamW``, the same
update as ``optax.adamw`` (``tests/test_torch_trajectory.py`` pins that),
``adam`` and ``sgd`` likewise.

Parameter groups, as ``vlp_tpu/train/optim.py:param_group_label_fn``
labels them: for the dual tower, when any of ``image_encoder_lr``,
``text_encoder_lr`` and ``projection_lr`` is set, three groups
(``image_encoder.*``, ``text_encoder.*``, and the rest: the projections
and ``logit_scale``), each at its own lr (the base lr where unset); for the
other tasks, when ``vision_encoder_lr`` or ``freeze_encoder`` is set, two
(``backbone.*`` at ``vision_encoder_lr``, 0 when frozen, and the head at
the base lr). Each group has its own schedule, the same schedule of its
own base lr, and the train step writes each group's value into that group
before each update, where optax's ``multi_transform`` evaluates each
group's schedule. A group at lr 0 gets no update at all, weight decay
included (``optax.set_to_zero``): it is left out of the optimizer and its
parameters stop requiring gradients, so the backward skips what only they
need, as XLA drops the gradients that ``set_to_zero`` discards.
"""
from __future__ import annotations

import math
from typing import Callable, List, Tuple

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


def param_groups(cfg: TrainConfig, model: torch.nn.Module
                 ) -> List[Tuple[str, float, List[torch.nn.Parameter]]]:
    """(label, base lr, parameters) of each group, in the order of the
    model's parameters; one group ``all`` at the base lr when no group
    field is set."""
    if cfg.serve.task == "vision_language":
        lrs = {"image": cfg.image_encoder_lr, "text": cfg.text_encoder_lr,
               "projection": cfg.projection_lr}
        if all(lr is None for lr in lrs.values()):
            lrs = None

        def label(name: str) -> str:
            for prefix, group in (("image_encoder.", "image"),
                                  ("text_encoder.", "text")):
                if name.startswith(prefix):
                    return group
            return "projection"
    elif cfg.vision_encoder_lr is not None or cfg.freeze_encoder:
        lrs = {"backbone": 0.0 if cfg.freeze_encoder
               else cfg.vision_encoder_lr, "head": None}

        def label(name: str) -> str:
            return "backbone" if name.startswith("backbone.") else "head"
    else:
        lrs = None
    if lrs is None:
        return [("all", cfg.lr, list(model.parameters()))]
    groups = {g: [] for g in lrs}
    for name, p in model.named_parameters():
        groups[label(name)].append(p)
    return [(g, cfg.lr if lrs[g] is None else lrs[g], ps)
            for g, ps in groups.items() if ps]


def make_optimizer(cfg: TrainConfig, model: torch.nn.Module,
                   steps_per_epoch: int
                   ) -> Tuple[torch.optim.Optimizer, Tuple[Schedule, ...]]:
    """(optimizer, one schedule per param group, in the optimizer's
    order); each group's lr starts at its schedule's value at step 0 and
    carries its label under ``"name"``. The parameters of an lr-0 group
    are frozen: outside the optimizer, ``requires_grad`` off."""
    groups, schedules = [], []
    for name, base_lr, params in param_groups(cfg, model):
        if base_lr == 0.0:
            for p in params:
                p.requires_grad_(False)
            continue
        schedule = make_schedule(base_lr, cfg, steps_per_epoch)
        groups.append({"params": params, "lr": schedule(0), "name": name})
        schedules.append(schedule)
    if not groups:
        raise ValueError("every parameter group has lr 0: nothing to train")
    if cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(groups, betas=(cfg.b1, cfg.b2), eps=cfg.eps,
                                weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "adam":
        opt = torch.optim.Adam(groups, betas=(cfg.b1, cfg.b2), eps=cfg.eps)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(groups)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return opt, tuple(schedules)
