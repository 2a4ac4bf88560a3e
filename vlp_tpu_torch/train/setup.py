"""A training run of one ported experiment from random weights, on seeded
uint8 batches: the run that ``chip_smoke.py`` (phases 6, 9, 10, 13, 16
and 17) times and
``scripts/profile_slice.py --mode train`` profiles, built here once so that
both drive the same step.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from vlp_tpu_torch.config import TrainConfig
from vlp_tpu_torch.models.tasks import OnlyImagingTask, TaskStatics, build_task
from vlp_tpu_torch.models.vit import flax_init_
from vlp_tpu_torch.train.optim import make_optimizer
from vlp_tpu_torch.train.state import TrainState
from vlp_tpu_torch.train.step import make_train_step

# the normalisation of uniform uint8 images: centre 128, spread 64
MEAN, STD = 128.0, 64.0


def build_training(tcfg: TrainConfig, device: torch.device,
                   steps_per_epoch: int, seed: int = 0
                   ) -> Tuple[OnlyImagingTask, TrainState, Callable]:
    """(task, state, step) of ``tcfg`` on ``device``: the task with
    ``MEAN``/``STD``, the serving fields' channels and intensity scaling and
    ``tcfg``'s augmentation, flax-scaled random weights from ``seed``, the
    optimizer and schedule of ``make_optimizer``, a ``TrainState`` whose
    generator is seeded with ``seed``, and ``make_train_step``'s step."""
    statics = TaskStatics(mean=MEAN, std=STD,
                          out_channels=tcfg.serve.in_channels,
                          scale_intensity=tcfg.serve.scale_intensity,
                          augment=tcfg.augment())
    task = build_task(tcfg, statics, device)
    flax_init_(task.model, torch.Generator(device=device).manual_seed(seed))
    opt, schedule = make_optimizer(tcfg, task.model.parameters(),
                                   steps_per_epoch)
    state = TrainState.create(task.model, opt, schedule, seed=seed)
    return task, state, make_train_step(task, opt, schedule)


def random_batch(rng: np.random.Generator, batch: int,
                 image_size: int) -> Dict[str, np.ndarray]:
    """``batch`` uint8 images with random binary labels, all unmasked, of
    datasets 0 and 1 in turn (CORAL's source and target each hold half the
    batch)."""
    return {"image_u8": rng.integers(0, 256, (batch, image_size, image_size),
                                     dtype=np.uint8),
            "label": rng.integers(0, 2, batch).astype(np.int32),
            "mask": np.ones(batch, np.float32),
            "dataset_id": (np.arange(batch) % 2).astype(np.int32)}
