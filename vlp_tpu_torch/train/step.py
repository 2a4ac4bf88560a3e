"""The training step (counterpart of ``vlp_tpu/train/step.py:19-53``):
augment -> forward -> loss -> backward -> optimizer step -> schedule step;
and the eval step and ``collect_over_loader`` (``:107-245``).

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

``make_eval_step(task)`` is the task's ``eval_fn`` (eval mode, no autograd:
running statistics, nothing updated); ``collect_over_loader(fn, loader)``
runs ``fn`` (``features_fn``, ``embed_images_fn``) over a loader's batches
and keeps the outputs and labels on the device, the padded rows dropped;
nothing reaches the host per batch. The JAX package scans K batches a
dispatch there; here each batch is one call, with the same outputs.

On a data mesh (the task's ``mesh``) the step is the JAX step on a
``('data',)`` mesh: the batch is this rank's rows, ``loss_fn`` gives the
global loss, and after ``backward`` one bucketed all-reduce per dtype
averages the gradients (``parallel/collectives.reduce_gradients``), so the
optimizer applies the single-process gradient of the global batch on every
rank: BatchNorm's running statistics come from the global statistics and
``logit_scale`` is a parameter like the others; a group frozen at lr 0 is
reduced with the rest. On a model sharded by ``parallel/fsdp.py`` FSDP2
has reduce-scattered the sharded parameters' gradients inside the
backward (overlapped with it), and the all-reduce takes only the
replicated ones. ``collect_over_loader`` gathers the outputs, labels and
masks in global row order before it drops the padded rows.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from vlp_tpu_torch.parallel.collectives import gather_rows, reduce_gradients
from vlp_tpu_torch.parallel.fsdp import reduce_scatter_timer, replicated
from vlp_tpu_torch.train.optim import Schedule
from vlp_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def make_train_step(task, optimizer: torch.optim.Optimizer,
                    schedules: Sequence[Schedule]
                    ) -> Callable[[TrainState, Batch], Dict]:
    """The step; on a mesh ``step.reduce_events`` may be set to a list, to
    which each step appends the list of (start, end) CUDA events around
    each of its gradient reductions: a sharded model's reduce-scatters
    (one a unit, inside the backward) and the all-reduce; the step's
    reduction device time is the sum of their spans."""
    if len(schedules) != len(optimizer.param_groups):
        raise ValueError(f"{len(schedules)} schedules for "
                         f"{len(optimizer.param_groups)} param groups")
    mesh = getattr(task, "mesh", None)
    params = replicated(p for g in optimizer.param_groups
                        for p in g["params"])
    scatter = None if mesh is None else reduce_scatter_timer(task.model)

    def train_step(state: TrainState, batch: Batch) -> Dict:
        lrs = {}
        for group, schedule in zip(optimizer.param_groups, schedules):
            group["lr"] = lrs[group.get("name")] = schedule(state.step)
        optimizer.zero_grad(set_to_none=True)
        spans = None if mesh is None or train_step.reduce_events is None \
            else []
        if scatter is not None:
            scatter.events = spans
        loss, aux = task.loss_fn(batch, state.generator)
        loss.backward()
        if mesh is not None:
            if spans is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            reduce_gradients(params, mesh)
            if spans is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                spans.append((start, end))
                train_step.reduce_events.append(spans)
        optimizer.step()
        state.step += 1
        return {**{k: v.detach() for k, v in aux.items()},
                "lr": optimizer.param_groups[0]["lr"], "group_lrs": lrs}

    train_step.reduce_events = None
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


def make_eval_step(task) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    def eval_step(batch: Batch) -> Dict[str, torch.Tensor]:
        return task.eval_fn(batch)

    return eval_step


def collect_over_loader(fn: Callable[[Batch], torch.Tensor], loader
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(outputs [N, ...], labels [N]) of ``fn`` over every real row of
    ``loader``'s batches, in order, on the loader's device; on the
    loader's mesh every rank's rows, gathered in global row order."""
    mesh = getattr(loader, "mesh", None)
    outs, labels, masks = [], [], []
    with torch.no_grad():
        for batch in loader:
            outs.append(gather_rows(fn(batch), mesh))
            labels.append(gather_rows(batch["label"].reshape(-1), mesh))
            masks.append(gather_rows(batch["mask"].reshape(-1), mesh) > 0)
    keep = torch.cat(masks)
    return torch.cat(outs)[keep], torch.cat(labels)[keep]
