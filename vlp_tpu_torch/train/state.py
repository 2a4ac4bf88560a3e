"""Train state (counterpart of ``vlp_tpu/train/state.py``): what one step
reads and advances. PyTorch updates the model and the optimizer's moments
in place, so the state holds references, and the step counter, which picks
the learning rate, and the generator of the augmentation draws, which live
on the model's device."""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vlp_tpu_torch.train.optim import Schedule


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    generator: torch.Generator

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               schedule: Schedule, seed: int) -> "TrainState":
        device = next(model.parameters()).device
        return cls(step=0, model=model, optimizer=optimizer,
                   schedule=schedule,
                   generator=torch.Generator(device=device).manual_seed(seed))
