"""The training step (counterpart of ``vlp_tpu/train/step.py:19-53``):
augment -> forward -> loss -> backward -> optimizer step -> schedule step.

``make_train_step(task, optimizer, schedule)`` returns ``step(state,
batch) -> aux``. The step sets the group's lr to ``schedule(state.step)``,
as optax evaluates its schedule at the update count, runs the task's
``loss_fn`` on the state's generator, backpropagates through the half-block
backward kernels and steps the optimizer; ``aux`` holds the loss terms, the
logits and the lr used, on the device (nothing synchronises).
``train_steps`` feeds it host batches: uint8 images and labels go host ->
pinned -> device without blocking.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List

import numpy as np
import torch

from vlp_tpu_torch.train.optim import Schedule
from vlp_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def make_train_step(task, optimizer: torch.optim.Optimizer,
                    schedule: Schedule) -> Callable[[TrainState, Batch],
                                                    Dict]:
    def train_step(state: TrainState, batch: Batch) -> Dict:
        lr = schedule(state.step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        loss, aux = task.loss_fn(batch, state.generator)
        loss.backward()
        optimizer.step()
        state.step += 1
        return {**{k: v.detach() for k, v in aux.items()}, "lr": lr}

    return train_step


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Batch:
    """numpy batch -> tensors on ``device`` (through pinned memory, without
    blocking, for a CUDA device)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def train_steps(step: Callable[[TrainState, Batch], Dict],
                state: TrainState, batches: Iterable[Dict[str, np.ndarray]]
                ) -> List[Dict]:
    """Runs ``step`` over host batches; returns each step's aux."""
    device = next(state.model.parameters()).device
    return [step(state, to_device(b, device)) for b in batches]
