"""The training step (counterpart of ``vlp_tpu/train/step.py:19-53``):
augment -> forward -> loss -> backward -> optimizer step -> schedule step.

``make_train_step(task, optimizer, schedules)`` returns ``step(state,
batch) -> aux``. The step sets each param group's lr to its own
``schedules[i](state.step)``, as optax evaluates each group's schedule at
the update count, runs the task's ``loss_fn`` on the state's generator,
backpropagates (through the half-block backward kernels where the model
has them) and steps the optimizer; ``aux`` holds the task's outputs (loss
terms, logits or embeddings) on the device (nothing synchronises), the
first group's lr as ``lr`` and every group's by name as ``group_lrs``.
``train_steps`` feeds it host batches: uint8 images and labels go host ->
pinned -> device without blocking.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence

import numpy as np
import torch

from vlp_tpu_torch.train.optim import Schedule
from vlp_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def make_train_step(task, optimizer: torch.optim.Optimizer,
                    schedules: Sequence[Schedule]
                    ) -> Callable[[TrainState, Batch], Dict]:
    if len(schedules) != len(optimizer.param_groups):
        raise ValueError(f"{len(schedules)} schedules for "
                         f"{len(optimizer.param_groups)} param groups")

    def train_step(state: TrainState, batch: Batch) -> Dict:
        lrs = {}
        for group, schedule in zip(optimizer.param_groups, schedules):
            group["lr"] = lrs[group.get("name")] = schedule(state.step)
        optimizer.zero_grad(set_to_none=True)
        loss, aux = task.loss_fn(batch, state.generator)
        loss.backward()
        optimizer.step()
        state.step += 1
        return {**{k: v.detach() for k, v in aux.items()},
                "lr": optimizer.param_groups[0]["lr"], "group_lrs": lrs}

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
