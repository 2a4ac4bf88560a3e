"""Checkpoints and the encoder transfer (counterpart of
``vlp_tpu/utils/checkpoint.py``), written with ``torch.save``.

A checkpoint is one file holding the full training state: the model's
``state_dict`` (parameters and BatchNorm's running statistics), the
optimizer's ``state_dict`` (moments, step counts, group lrs), the step and
the ``TrainState`` generator's state, all on the host, so a file is the same
whichever device wrote it and loads onto any. A JSON sidecar
(``<path>.meta.json``) holds the loop counters that make it resumable (the
epoch, early stopping, the best metric and its snapshot, the train
sampler's RNG). The JAX package's Orbax directories are not read (no Orbax
on the card's machine); weights come across from JAX through
``vlp_tpu_torch.convert``'s npz route.

``Checkpointer`` keeps the best state by a monitored metric (save_top_k 1);
``LastStateSaver`` writes ``last`` every epoch. With ``async_write`` the
state is copied to the host and a background thread writes it while the
next epoch trains; the meta sidecar and the deletion of the previous best
wait for that write's commit (the next write or ``wait()``); without it
the same files are written before ``save`` returns. Against three faults of
the JAX package's ``Checkpointer`` and ``LastStateSaver``
(``vlp_tpu/utils/checkpoint.py:25-161``) and its trainer's commit:

- every file is written to ``<path>.tmp`` and ``os.replace``d onto its
  path, so a write that fails midway leaves the previous ``last`` (and its
  sidecar) whole;
- a new best whose path equals the old one is never deleted at commit;
- the trainer runs the commit barrier in a ``finally``, also when ``fit``
  raises.

On a data mesh only rank 0 writes: the other ranks' ``Checkpointer``
and ``LastStateSaver`` (``write=False``) keep the same best metric and
paths, so that every rank takes the same branches and reads rank 0's
files after a barrier. On a model sharded by ``parallel/fsdp.py``
``model_state`` and ``optimizer_state`` gather the full state to rank 0's
host (``torch.distributed.checkpoint.state_dict``, a collective: every
rank calls them, from the training thread, before any write starts), and
on a model split by ``parallel/tp.py`` to every rank's (over the model
ranks, ``tp.gather_state``), so a file has the replicated run's format
and resumes, serves and warm-starts whichever way the next run holds its
model; ``load_model_state`` and ``load_optimizer_state`` give each rank
its shards of a full state.

``extract_image_encoder`` and ``graft_backbone`` move the dual tower's
``image_encoder.*`` entries onto a classifier's ``backbone.*`` (BatchNorm's
running statistics included; reference OnlyImagingModule.py:75-98); a key
or shape that does not match raises.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, Optional

import torch

from vlp_tpu_torch.parallel import tp
from vlp_tpu_torch.parallel.fsdp import is_sharded
from vlp_tpu_torch.train.optim import merged_state, split_state
from vlp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor on the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _full_options(**kw):
    from torch.distributed.checkpoint.state_dict import StateDictOptions

    return StateDictOptions(full_state_dict=True, **kw)


def model_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's full ``state_dict`` on the host; of a sharded model
    gathered to rank 0 (every rank must call it; the others get an empty
    dict), of a split one to every rank (every rank calls it)."""
    if tp.is_split(model):
        return _to_host(tp.gather_state(model))
    if not is_sharded(model):
        return _to_host(model.state_dict())
    from torch.distributed.checkpoint.state_dict import get_model_state_dict

    return get_model_state_dict(model, options=_full_options(
        cpu_offload=True))


def load_model_state(model: torch.nn.Module, state: Dict[str, torch.Tensor],
                     strict: bool = True) -> None:
    """Loads a full ``state_dict`` (``strict=False``: a part of one) into
    ``model``; a sharded or split model's ranks each take their
    shards."""
    if tp.is_split(model):
        state = tp.scatter_state(model, state)
    if not is_sharded(model):
        model.load_state_dict(state, strict=strict)
        return
    from torch.distributed.checkpoint.state_dict import set_model_state_dict

    set_model_state_dict(model, state, options=_full_options(strict=strict))


def optimizer_state(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` on the host; of a sharded model's
    optimizer gathered to rank 0 in the replicated run's format
    (``optim.merged_state``; every rank must call it, the others get
    None); of a split model's gathered to every rank."""
    if tp.is_split(model):
        return _to_host(tp.gather_optimizer_state(model, optimizer))
    if not is_sharded(model):
        return _to_host(optimizer.state_dict())
    from torch.distributed.checkpoint.state_dict import (
        get_optimizer_state_dict)

    full = get_optimizer_state_dict(model, optimizer, options=_full_options(
        cpu_offload=True))
    return merged_state(model, full) if full else None


def load_optimizer_state(model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer,
                         state: Dict[str, Any]) -> None:
    """Loads ``optimizer_state``'s format into ``optimizer``; a sharded
    model's ranks each take their shards of the moments, its groups their
    label's settings (``optim.split_state``); a split model's ranks their
    shares of the moments."""
    if tp.is_split(model):
        state = tp.scatter_optimizer_state(model, optimizer, state)
    if not is_sharded(model):
        optimizer.load_state_dict(state)
        return
    from torch.distributed.checkpoint.state_dict import (
        set_optimizer_state_dict)

    set_optimizer_state_dict(model, optimizer,
                             split_state(model, optimizer, state),
                             options=_full_options())


def state_to_tree(state) -> Optional[Dict[str, Any]]:
    """TrainState -> the checkpoint's tree, on the host. Of a sharded
    model every rank must call it; ranks other than 0 get None."""
    model = model_state(state.model)
    optimizer = optimizer_state(state.model, state.optimizer)
    if optimizer is None:
        return None
    return {"model": model, "optimizer": optimizer, "step": int(state.step),
            "generator": _to_host(state.generator.get_state())}


def _tree_to_write(state, write: bool) -> Optional[Dict[str, Any]]:
    """``state_to_tree`` where this rank writes; a sharded or split
    model's ranks all join its gather."""
    if write or is_sharded(state.model) or tp.is_split(state.model):
        tree = state_to_tree(state)
        return tree if write else None
    return None


def _write_file(path: str, write: Callable[[str], None]) -> None:
    """``write(tmp)`` then ``os.replace(tmp, path)``: the file at ``path``
    is the old one or the new one, never a part."""
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _write_json(path: str, obj: Dict) -> None:
    def write(tmp):
        with open(tmp, "w") as fh:
            json.dump(obj, fh)
    _write_file(path, write)


def save(path: str, tree: Dict[str, Any]) -> str:
    path = os.path.abspath(path)
    _write_file(path, lambda tmp: torch.save(tree, tmp))
    return path


class _Writer:
    """One write in flight: on a background thread (``async_write``) or
    at once; ``wait`` joins it and raises its error."""

    def __init__(self, async_write: bool) -> None:
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def start(self, fn: Callable[[], None]) -> None:
        if not self.async_write:
            fn()
            return

        def run():
            try:
                fn()
            except BaseException as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


class Checkpointer:
    """save_top_k=1 best-metric checkpointing (reference ModelCheckpoint,
    configs/callbacks/model_checkpoint_*.yaml)."""

    def __init__(self, directory: str, monitor: str, mode: str = "max",
                 async_write: bool = True, write: bool = True) -> None:
        self.directory = os.path.abspath(directory)
        self.write = write
        if write:
            os.makedirs(self.directory, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.best: Optional[float] = None
        self.best_path: Optional[str] = None
        self._writer = _Writer(async_write)
        self._pending_meta: Optional[Dict] = None
        self._pending_delete: Optional[str] = None

    def improved(self, value: float) -> bool:
        if self.best is None:
            return True
        return value > self.best if self.mode == "max" else value < self.best

    def _commit(self) -> None:
        """Await the write in flight, then its sidecar and the deletion of
        the best it replaced, in that order."""
        try:
            self._writer.wait()
        except BaseException:
            self._pending_meta = self._pending_delete = None
            raise
        if self._pending_meta is not None:
            _write_json(self.best_path + ".meta.json", self._pending_meta)
            self._pending_meta = None
        old, self._pending_delete = self._pending_delete, None
        if old is not None and old != self.best_path:
            for p in (old, old + ".meta.json"):
                if os.path.exists(p):
                    os.remove(p)

    def wait(self) -> None:
        """Barrier: returns when the last write, its sidecar and the old
        best's deletion are on disk."""
        self._commit()

    def maybe_save(self, metrics: Dict[str, float], state, epoch: int,
                   meta: Optional[Dict] = None) -> bool:
        """Saves ``state`` when the monitored metric improved, keeping only
        the best; ``meta`` becomes its sidecar."""
        if self.monitor not in metrics:
            return False
        value = float(metrics[self.monitor])
        if not self.improved(value):
            return False
        self._commit()  # one write in flight
        tree = _tree_to_write(state, self.write)
        old = self.best_path
        self.best = value
        safe = self.monitor.replace("/", "_")
        self.best_path = os.path.join(
            self.directory, f"epoch{epoch:03d}_{safe}{value:.4f}.pt")
        if not self.write:
            return True
        if meta is not None:
            self._pending_meta = {**meta, "checkpoint_best": value,
                                  "checkpoint_best_path": self.best_path}
        self._pending_delete = old
        path = self.best_path
        self._writer.start(lambda: save(path, tree))
        if not self._writer.async_write:
            self._commit()
        logger.info("Checkpoint: new best %s=%.4f -> %s%s", self.monitor,
                    value, self.best_path,
                    " (async)" if self._writer.async_write else "")
        return True

    def restore_best(self) -> Dict[str, Any]:
        if self.best_path is None:
            raise RuntimeError("no checkpoint saved yet")
        self._commit()
        return restore_raw(self.best_path)


class LastStateSaver:
    """The full state as ``last`` every epoch (exact resume; reference
    ``save_last``, src/train.py:171); its sidecar is written only after
    the body has replaced the previous one."""

    def __init__(self, path: str, async_write: bool = True,
                 write: bool = True) -> None:
        self.path = os.path.abspath(path)
        self.write = write
        self._writer = _Writer(async_write)
        self._pending_meta: Optional[Dict] = None

    def _commit(self) -> None:
        try:
            self._writer.wait()
        except BaseException:
            self._pending_meta = None
            raise
        if self._pending_meta is not None:
            _write_json(self.path + ".meta.json", self._pending_meta)
            self._pending_meta = None

    def wait(self) -> None:
        self._commit()

    def save(self, state, meta: Optional[Dict] = None) -> str:
        if not self.write:
            _tree_to_write(state, False)  # a sharded model's gather
            return self.path
        self._commit()
        tree = state_to_tree(state)
        self._pending_meta = dict(meta) if meta is not None else None
        self._writer.start(lambda: save(self.path, tree))
        if not self._writer.async_write:
            self._commit()
        return self.path


# --------------------------------------------------------------------------
# Full training-state checkpoints (exact resume)
# --------------------------------------------------------------------------

def save_train_state(path: str, state, meta: Optional[Dict] = None) -> str:
    """The full training state and, with ``meta``, its loop-counter
    sidecar (the analogue of Lightning's resumable ckpt)."""
    path = save(path, state_to_tree(state))
    if meta is not None:
        _write_json(path + ".meta.json", meta)
    return path


def load_meta(path: str) -> Optional[Dict]:
    """The loop-counter sidecar of a checkpoint; None for one without (it
    then warm-starts instead of resuming)."""
    meta_path = os.path.abspath(path) + ".meta.json"
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as fh:
        return json.load(fh)


def restore_raw(path: str) -> Dict[str, Any]:
    """The checkpoint's tree as saved, on the host."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def restore_train_state(path: str, state) -> None:
    """Loads a full-state checkpoint into ``state`` (same model and
    optimizer configuration): weights, running statistics, moments, step
    and generator."""
    tree = restore_raw(path)
    load_model_state(state.model, tree["model"])
    load_optimizer_state(state.model, state.optimizer, tree["optimizer"])
    state.step = int(tree["step"])
    state.generator.set_state(tree["generator"])


# --------------------------------------------------------------------------
# VLP -> classifier transfer
# --------------------------------------------------------------------------

def extract_image_encoder(state_dict: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """A dual tower's ``state_dict`` -> its image tower's entries, the
    ``image_encoder.`` prefix stripped (reference OnlyImagingModule.py:
    76-80)."""
    prefix = "image_encoder."
    out = {k[len(prefix):]: v for k, v in state_dict.items()
           if k.startswith(prefix)}
    if not out:
        raise KeyError("checkpoint has no image_encoder entries")
    return out


def graft_backbone(classifier_state: Dict[str, torch.Tensor],
                   encoder: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The classifier's ``state_dict`` with every ``backbone.*`` entry taken
    from ``encoder`` (the head keeps its own). Every backbone key must be in
    the encoder with its shape, and the encoder may hold no other key."""
    prefix = "backbone."
    target = {k[len(prefix):]: v for k, v in classifier_state.items()
              if k.startswith(prefix)}
    if not target:
        raise KeyError("classifier has no 'backbone' entries")
    for key, value in target.items():
        if key not in encoder:
            raise KeyError(f"transfer mismatch: {prefix}{key} missing in "
                           "source")
        if tuple(value.shape) != tuple(encoder[key].shape):
            raise ValueError(
                f"transfer shape mismatch at {prefix}{key}: "
                f"{tuple(value.shape)} vs {tuple(encoder[key].shape)}")
    extra = sorted(set(encoder) - set(target))
    if extra:
        raise KeyError(f"transfer mismatch: source entries {extra[:5]} have "
                       "no place in the classifier's backbone")
    out = dict(classifier_state)
    out.update({prefix + k: v for k, v in encoder.items()})
    return out
