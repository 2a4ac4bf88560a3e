"""A training run of one ported experiment from random weights, on seeded
batches: the run that ``chip_smoke.py`` (phases 6, 9, 10, 13, 16, 17, 20
and 22) times and ``scripts/profile_slice.py --mode train`` profiles,
built here once so that both drive the same step. ``random_batch`` gives
the imaging tasks' batches (with ``random_clinical``'s vectors for the
fusion task), ``random_pretrain_batch`` the vision-language task's
(``batch_for`` picks the one an experiment takes).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from vlp_tpu_torch.config import TrainConfig
from vlp_tpu_torch.data.encoding import NUM_ANATOMY_SITES
from vlp_tpu_torch.data.tokenize import CLS_ID, FIRST_WORD_ID, PAD_ID, SEP_ID
from vlp_tpu_torch.models.bert import TEXT_CONFIGS
from vlp_tpu_torch.models.tasks import TaskStatics, build_task
from vlp_tpu_torch.models.vit import flax_init_
from vlp_tpu_torch.parallel.collectives import broadcast_module
from vlp_tpu_torch.parallel.fsdp import shard_model
from vlp_tpu_torch.parallel.tp import shard_model_tp
from vlp_tpu_torch.train.optim import make_optimizer
from vlp_tpu_torch.train.state import TrainState
from vlp_tpu_torch.train.step import make_train_step

# the normalisation of uniform uint8 images: centre 128, spread 64
MEAN, STD = 128.0, 64.0


def init_training(task, tcfg: TrainConfig, steps_per_epoch: int,
                  seed: int, state_seed: int
                  ) -> Tuple[TrainState, Callable]:
    """(state, step) of a built ``task``: flax-scaled random weights from
    ``seed``, the optimizer and per-group schedules of ``make_optimizer``,
    a ``TrainState`` whose generator is seeded with ``state_seed``, and
    ``make_train_step``'s step. ``build_training`` and the ``Trainer``
    both build through it. On the task's mesh every rank then takes rank
    0's weights and running statistics, and with ``param_sharding`` fsdp
    the model is sharded over the ranks (``parallel/fsdp.py``), with tp
    split over the model ranks (``parallel/tp.py``), before the optimizer
    is built on its shards; the generators start in the same state on
    every rank."""
    device = next(task.model.parameters()).device
    mesh = getattr(task, "mesh", None)
    flax_init_(task.model, torch.Generator(device=device).manual_seed(seed))
    broadcast_module(task.model, mesh)
    if mesh is not None and tcfg.param_sharding == "fsdp":
        shard_model(task.model, mesh)
    elif tcfg.param_sharding == "tp":
        shard_model_tp(task.model, mesh)
    opt, schedules = make_optimizer(tcfg, task.model, steps_per_epoch)
    state = TrainState.create(task.model, opt, schedules, seed=state_seed)
    return state, make_train_step(task, opt, schedules)


def build_training(tcfg: TrainConfig, device: torch.device,
                   steps_per_epoch: int, seed: int = 0, mesh=None
                   ) -> Tuple[object, TrainState, Callable]:
    """(task, state, step) of ``tcfg`` on ``device``: the task of its
    ``model.task`` (imaging-only, fusion or vision-language) with
    ``MEAN``/``STD``, the serving fields' channels and intensity scaling
    and ``tcfg``'s augmentation, then ``init_training`` with weights and
    generator both from ``seed``; on ``mesh`` the step takes this rank's
    rows of each global batch (``parallel.mesh.shard_batch``)."""
    statics = TaskStatics(mean=MEAN, std=STD,
                          out_channels=tcfg.serve.in_channels,
                          scale_intensity=tcfg.serve.scale_intensity,
                          augment=tcfg.augment())
    task = build_task(tcfg, statics, device, mesh)
    state, step = init_training(task, tcfg, steps_per_epoch, seed, seed)
    return task, state, step


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


def random_clinical(rng: np.random.Generator, batch: int) -> np.ndarray:
    """[batch, 15] clinical vectors as ``encoding.clinical_vector`` forms
    them: a one-hot anatomy site, the age's ten-year bin (1-7) and the
    sex (0 or 1)."""
    out = np.zeros((batch, NUM_ANATOMY_SITES + 2), np.float32)
    out[np.arange(batch), rng.integers(0, NUM_ANATOMY_SITES, batch)] = 1.0
    out[:, -2] = np.minimum(rng.integers(5, 90, batch) // 10 + 1, 7)
    out[:, -1] = rng.integers(0, 2, batch)
    return out


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
    out = random_batch(rng, batch, s.image_size)
    if s.task == "fusion":
        out["clinical"] = random_clinical(rng, batch)
    return out
