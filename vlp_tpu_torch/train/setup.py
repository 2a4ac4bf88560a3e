"""A training run of one ported experiment from random weights, on seeded
batches: the run that ``chip_smoke.py`` (phases 6, 9, 10, 13, 16, 17 and
20) times and ``scripts/profile_slice.py --mode train`` profiles, built
here once so that both drive the same step. ``random_batch`` gives the
imaging tasks' batches, ``random_pretrain_batch`` the vision-language
task's (``batch_for`` picks the one an experiment takes).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from vlp_tpu_torch.config import TrainConfig
from vlp_tpu_torch.data.tokenize import CLS_ID, FIRST_WORD_ID, PAD_ID, SEP_ID
from vlp_tpu_torch.models.bert import TEXT_CONFIGS
from vlp_tpu_torch.models.tasks import TaskStatics, build_task
from vlp_tpu_torch.models.vit import flax_init_
from vlp_tpu_torch.train.optim import make_optimizer
from vlp_tpu_torch.train.state import TrainState
from vlp_tpu_torch.train.step import make_train_step

# the normalisation of uniform uint8 images: centre 128, spread 64
MEAN, STD = 128.0, 64.0


def build_training(tcfg: TrainConfig, device: torch.device,
                   steps_per_epoch: int, seed: int = 0
                   ) -> Tuple[object, TrainState, Callable]:
    """(task, state, step) of ``tcfg`` on ``device``: the task of its
    ``model.task`` (imaging-only or vision-language) with ``MEAN``/``STD``,
    the serving fields' channels and intensity scaling and ``tcfg``'s
    augmentation, flax-scaled random weights from ``seed``, the optimizer
    and per-group schedules of ``make_optimizer``, a ``TrainState`` whose
    generator is seeded with ``seed``, and ``make_train_step``'s step."""
    statics = TaskStatics(mean=MEAN, std=STD,
                          out_channels=tcfg.serve.in_channels,
                          scale_intensity=tcfg.serve.scale_intensity,
                          augment=tcfg.augment())
    task = build_task(tcfg, statics, device)
    flax_init_(task.model, torch.Generator(device=device).manual_seed(seed))
    opt, schedules = make_optimizer(tcfg, task.model, steps_per_epoch)
    state = TrainState.create(task.model, opt, schedules, seed=seed)
    return task, state, make_train_step(task, opt, schedules)


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


def random_pretrain_batch(rng: np.random.Generator, batch: int,
                          image_size: int, max_length: int = 40,
                          text_model: str = "tinybert",
                          full_length: bool = False
                          ) -> Dict[str, np.ndarray]:
    """A vision-language batch: uint8 images; ``batch // 2`` captions, each
    of ``[CLS]``, words from the hash tokenizer's id range, ``[SEP]`` and
    padding, with 8 to ``max_length`` valid tokens (all ``max_length``
    with ``full_length``, as ``bench.py`` feeds), drawn so that every
    caption repeats (``caption_id`` with duplicates, which the masked and
    non-square losses act on; duplicates carry the same ids); all rows
    valid (``mask``)."""
    vocab = TEXT_CONFIGS[text_model].vocab_size
    n_captions = max(batch // 2, 1)
    lengths = np.full(n_captions, max_length) if full_length else \
        rng.integers(min(8, max_length), max_length + 1, n_captions)
    pos = np.arange(max_length)[None, :]
    words = rng.integers(FIRST_WORD_ID, vocab, (n_captions, max_length))
    ids = np.where(pos < lengths[:, None] - 1, words, PAD_ID)
    ids[np.arange(n_captions), lengths - 1] = SEP_ID
    ids[:, 0] = CLS_ID
    caption_id = rng.permutation(np.arange(batch) % n_captions)
    return {"image_u8": rng.integers(0, 256, (batch, image_size, image_size),
                                     dtype=np.uint8),
            "input_ids": ids[caption_id].astype(np.int32),
            "attention_mask": (pos < lengths[caption_id, None]).astype(
                np.int32),
            "caption_id": caption_id.astype(np.int32),
            "mask": np.ones(batch, np.float32)}


def batch_for(tcfg: TrainConfig, rng: np.random.Generator,
              batch: int) -> Dict[str, np.ndarray]:
    """The seeded batch that ``tcfg``'s task takes."""
    s = tcfg.serve
    if s.task == "vision_language":
        return random_pretrain_batch(rng, batch, s.image_size,
                                     tcfg.max_token_length, s.text_model)
    return random_batch(rng, batch, s.image_size)
