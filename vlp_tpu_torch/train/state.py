"""Train state (counterpart of ``vlp_tpu/train/state.py``): what one step
reads and advances. PyTorch updates the model and the optimizer's moments
in place, so the state holds references, and the step counter, which picks
the learning rates (one schedule per param group), and the generator of the
augmentation draws, which live on the model's device."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from vlp_tpu_torch.train.optim import Schedule


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedules: Tuple[Schedule, ...]
    generator: torch.Generator

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               schedules: Tuple[Schedule, ...], seed: int
               ) -> "TrainState":
        device = next(model.parameters()).device
        return cls(step=0, model=model, optimizer=optimizer,
                   schedules=schedules,
                   generator=torch.Generator(device=device).manual_seed(seed))
