"""The Trainer: epoch loop, validation, callbacks, checkpointing
(counterpart of ``vlp_tpu/train/loop.py``).

Lightning's ``Trainer.fit`` over one CV fold (reference src/train.py:171
and the LightningModule hooks): per epoch, the train steps over the fold's
train loader, validation over its named val loaders, the callbacks, the
best and ``last`` checkpoints. Metrics are streaming counters on the device
(``ops/metrics.py``), merged across the val loaders for ``val/combined``;
the VLP epoch keeps every embedding on the device and computes the masked
top-k metrics there. Losses, mask sums and cached embeddings stay on the
device until the epoch ends: one host transfer an epoch, none a step.

Metric names are the JAX loop's, so that monitors carry over:
  train/loss, train/images_per_sec, val/internal/accuracy,
  val/btxrd/auroc, val/combined/accuracy, val/combined/loss, ...
Pretrain adds val/{lera,mura}/loss, .../label_precision_at_k,
.../recall_at_k, val/combined/loss, downstream_validation/linear_probe_*
from the probe callback and downstream_validation/label_precision_at_k.

The model's shapes are fixed when it is built, so the trainer initialises
its weights (flax's initializers, ``cfg.seed``) without a batch and never
touches the sampler; the step's generator is seeded with ``cfg.seed + 1``,
as the JAX trainer splits its key. ``trainer.scan_steps`` is taken and the
steps run one a call: the JAX package's K-step scan gives the same numbers
(a CUDA-graph K-step is ROADMAP's "CUDA graphs" item).

On a data mesh (the task's ``mesh``) every rank runs the same loop on its
rows: the step's loss is the global one; validation reduces each loader's
metric state over the ranks (``metrics.reduce_state``) and computes
retrieval@k and the linear probe on the gathered embeddings and features;
the epoch's metrics are then rank 0's on every rank, so early stopping and
the checkpoint monitor take the same branch everywhere (a rank that
stopped alone would hang the others in their next collective). Only rank 0
writes checkpoints and profiles; the driver gives the other ranks an
in-memory sink.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vlp_tpu_torch.config import Config, TrainConfig
from vlp_tpu_torch.data.pipeline import DeviceLoader
from vlp_tpu_torch.models.tasks import VisionLanguageTask
from vlp_tpu_torch.ops import metrics as M
from vlp_tpu_torch.ops.retrieval import (masked_image_text_recall_at_k,
                                         masked_label_precision_at_k)
from vlp_tpu_torch.parallel.collectives import (all_reduce_,
                                                broadcast_object, gather_rows)
from vlp_tpu_torch.train.callbacks import (EarlyStopping, LinearProbeCallback,
                                           MetricSnapshot)
from vlp_tpu_torch.train.setup import init_training
from vlp_tpu_torch.train.step import collect_over_loader, make_eval_step
from vlp_tpu_torch.utils import checkpoint as ckpt
from vlp_tpu_torch.utils.logging import MemorySink, MetricSink, get_logger
from vlp_tpu_torch.utils.profiling import trace

logger = get_logger(__name__)


def _floats(values: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """0-d device tensors -> Python floats, in one transfer."""
    if not values:
        return {}
    host = torch.stack([v.float() for v in values.values()]).cpu().tolist()
    return dict(zip(values, host))


class Trainer:
    def __init__(
        self,
        cfg: Config,
        task,
        train_loader: DeviceLoader,
        val_loaders: Dict[str, DeviceLoader],
        sink: Optional[MetricSink] = None,
        checkpoint_dir: Optional[str] = None,
        linear_probe: Optional[LinearProbeCallback] = None,
        downstream_pak=None,  # DownstreamPrecisionAtK
        retrieval_ks: Sequence[int] = (3, 5, 10, 15),
    ) -> None:
        self.cfg = cfg
        self.task = task
        self.train_loader = train_loader
        self.val_loaders = val_loaders
        self.sink = sink or MemorySink()
        self.retrieval_ks = tuple(retrieval_ks)
        self.linear_probe = linear_probe
        self.downstream_pak = downstream_pak
        self.device = next(task.model.parameters()).device
        self.is_vlp = isinstance(task, VisionLanguageTask)
        self.mesh = getattr(task, "mesh", None)
        main = self.mesh is None or self.mesh.is_main

        self.state, self.train_step = init_training(
            task, TrainConfig.from_config(cfg), max(len(train_loader), 1),
            seed=cfg.seed, state_seed=cfg.seed + 1)
        self.eval_step = make_eval_step(task)
        self.cache_train_emb = (self.is_vlp
                                and cfg.trainer.cache_train_embeddings)
        t = cfg.trainer
        self.checkpoint_dir = checkpoint_dir
        self.checkpointer = (
            ckpt.Checkpointer(checkpoint_dir, t.checkpoint_monitor,
                              t.checkpoint_mode,
                              async_write=t.async_checkpointing, write=main)
            if checkpoint_dir else None)
        self._last_saver = (
            ckpt.LastStateSaver(f"{checkpoint_dir}/last.pt",
                                async_write=t.async_checkpointing,
                                write=main)
            if t.save_last and checkpoint_dir else None)
        self.early_stopping = (
            EarlyStopping(t.early_stopping_monitor, t.early_stopping_mode,
                          t.early_stopping_patience, t.min_epochs)
            if t.early_stopping_monitor else None)
        self.snapshot = MetricSnapshot(self.sink, t.checkpoint_monitor,
                                       t.checkpoint_mode)
        self.start_epoch = 0
        # wall seconds of the last fit: train steps, validation (the
        # callbacks' feature passes included), checkpoint saves
        self.times: Dict[str, float] = {}

    # -- exact resume ----------------------------------------------------
    def _loop_meta(self, epoch: int) -> Dict:
        """Host-side loop counters for the checkpoint's sidecar."""
        meta: Dict = {"epoch": int(epoch)}
        if self.early_stopping:
            meta["early_stopping"] = {
                "best": self.early_stopping.best,
                "wait": self.early_stopping.wait,
                "should_stop": self.early_stopping.should_stop}
        meta["snapshot_best"] = self.snapshot.best
        meta["snapshot_metrics"] = self.snapshot.snapshot
        if self.checkpointer:
            meta["checkpoint_best"] = self.checkpointer.best
            meta["checkpoint_best_path"] = self.checkpointer.best_path
        sampler = getattr(self.train_loader, "sampler", None)
        if sampler is not None and hasattr(sampler, "rng_state"):
            meta["sampler_rng"] = sampler.rng_state()
        return meta

    def load_resume_state(self, path: str) -> None:
        """Restores a full-state checkpoint: weights, running statistics,
        optimizer moments, step, generator, loop counters and the train
        sampler's RNG, so training continues exactly where it stopped
        (Lightning's ckpt_path resume, reference src/train.py:171)."""
        meta = ckpt.load_meta(path)
        if meta is None:
            raise ValueError(
                f"{path} is a weights-only checkpoint (no .meta.json); "
                "use the warm-start path instead")
        ckpt.restore_train_state(path, self.state)
        self.start_epoch = int(meta["epoch"]) + 1
        if self.early_stopping and meta.get("early_stopping"):
            es = meta["early_stopping"]
            self.early_stopping.best = es["best"]
            self.early_stopping.wait = int(es["wait"])
            self.early_stopping.should_stop = bool(es["should_stop"])
        self.snapshot.restore(meta.get("snapshot_best"),
                              meta.get("snapshot_metrics"))
        if self.checkpointer and meta.get("checkpoint_best") is not None:
            self.checkpointer.best = meta["checkpoint_best"]
            self.checkpointer.best_path = meta.get("checkpoint_best_path")
        sampler = getattr(self.train_loader, "sampler", None)
        if sampler is not None and meta.get("sampler_rng") is not None \
                and hasattr(sampler, "set_rng_state"):
            sampler.set_rng_state(meta["sampler_rng"])
        logger.info("Resumed full training state from %s (next epoch %d)",
                    path, self.start_epoch)

    def _commit(self) -> None:
        """The barrier: every checkpoint write durable."""
        try:
            if self.checkpointer:
                self.checkpointer.wait()
        finally:
            if self._last_saver is not None:
                self._last_saver.wait()

    def fit(self, max_epochs: Optional[int] = None) -> Dict[str, float]:
        """``max_epochs`` bounds the loop only (the schedule keeps
        ``cfg.trainer.max_epochs``), so a run stopped early resumes on the
        same schedule. The checkpoint barrier runs also when an epoch
        raises."""
        try:
            return self._fit(max_epochs)
        except BaseException:
            try:
                self._commit()
            except Exception as e:  # the epoch's error is the one to see
                logger.error("checkpoint commit after a failed epoch: %s", e)
            raise

    def _fit(self, max_epochs: Optional[int]) -> Dict[str, float]:
        cfg = self.cfg
        last_metrics: Dict[str, float] = {}
        end_epoch = cfg.trainer.max_epochs if max_epochs is None \
            else max_epochs
        # A monitor absent from the metrics would leave the checkpointer
        # and the snapshot idle for the whole run; the probe's metrics come
        # every linear_probe_every_n_epochs, so the monitor gets that long.
        monitor = cfg.trainer.checkpoint_monitor
        monitor_seen = self.snapshot.best is not None  # resumed runs
        monitor_grace = max(1, cfg.trainer.linear_probe_every_n_epochs)
        self.times = {"train_s": 0.0, "validate_s": 0.0, "checkpoint_s": 0.0}
        for epoch in range(self.start_epoch, end_epoch):
            t0 = time.perf_counter()
            train_loss, images_seen = self._train_epoch(epoch)
            dt = time.perf_counter() - t0
            self.times["train_s"] += dt
            if train_loss != train_loss:  # NaN guard
                best = self.checkpointer.best_path if self.checkpointer \
                    else None
                raise FloatingPointError(
                    f"training loss became NaN at epoch {epoch}; best "
                    f"checkpoint: {best}")
            metrics = {"train/loss": train_loss, "epoch": epoch,
                       "train/images_per_sec": images_seen / max(dt, 1e-9)}
            t0 = time.perf_counter()
            metrics.update(self._validate(epoch))
            # one decision for every rank: rank 0's numbers
            metrics = broadcast_object(metrics, self.mesh)
            self.times["validate_s"] += time.perf_counter() - t0
            if monitor in metrics:
                monitor_seen = True
            elif not monitor_seen:
                if epoch == self.start_epoch:
                    logger.warning(
                        "checkpoint monitor %r not in epoch metrics "
                        "(available: %s): best-checkpoint/snapshot tracking "
                        "is idle until it appears", monitor,
                        sorted(metrics))
                if epoch >= self.start_epoch + monitor_grace:
                    self._missing_monitor(
                        monitor, epoch - self.start_epoch + 1, metrics)
            self.sink.log(metrics, step=int(self.state.step))
            self.snapshot.on_validation_end(epoch, metrics)
            if self.early_stopping:
                self.early_stopping.on_validation_end(epoch, metrics)
            t0 = time.perf_counter()
            if self.checkpointer:
                self.checkpointer.maybe_save(metrics, self.state, epoch,
                                             meta=self._loop_meta(epoch))
            if self._last_saver is not None:
                self._last_saver.save(self.state,
                                      meta=self._loop_meta(epoch))
            self.times["checkpoint_s"] += time.perf_counter() - t0
            last_metrics = metrics
            if self.early_stopping and self.early_stopping.should_stop:
                break
        t0 = time.perf_counter()
        self._commit()
        self.times["checkpoint_s"] += time.perf_counter() - t0
        if not monitor_seen and last_metrics:
            # runs shorter than the grace window still fail on a wrong
            # monitor instead of completing with no checkpoint
            self._missing_monitor(monitor, end_epoch - self.start_epoch,
                                  last_metrics)
        return last_metrics

    def _missing_monitor(self, monitor: str, n_epochs: int,
                         metrics: Dict[str, float]) -> None:
        """The checkpoint monitor never appeared: raise, unless a linear
        probe is attached and its last probe epoch skipped (single-class
        downstream data), which leaves the monitor legitimately absent."""
        if self.linear_probe is not None and \
                getattr(self.linear_probe, "skipped_last", False):
            logger.warning(
                "checkpoint monitor %r absent after %d epoch(s), but the "
                "linear probe skipped (single-class downstream data): "
                "continuing with best-checkpoint tracking idle",
                monitor, n_epochs)
            return
        raise ValueError(
            f"checkpoint monitor {monitor!r} never appeared in {n_epochs} "
            f"epoch(s) of metrics (available: {sorted(metrics)}); fix "
            "trainer.checkpoint_monitor for this task")

    # ------------------------------------------------------------------
    def _train_epoch(self, epoch: int) -> Tuple[float, int]:
        losses: List[torch.Tensor] = []
        mask_sums: List[torch.Tensor] = []
        self._train_cache = {"img": [], "txt": [], "label": [], "mask": []}
        profile = contextlib.nullcontext()
        # the first epoch of a fresh fit only, as the JAX trainer: a
        # resumed fit opens no trace
        if self.cfg.trainer.profile and epoch == 0 and (
                self.mesh is None or self.mesh.is_main):
            profile = trace(self.cfg.trainer.profile_dir
                            or f"{self.cfg.output_dir}/profile")
        with profile:
            for batch in self.train_loader:
                aux = self.train_step(self.state, batch)
                losses.append(aux["loss"].reshape(1).float())
                # real samples only: padded rows carry mask 0
                mask_sums.append(aux["mask"].sum())
                if self.cache_train_emb:
                    for key, value in (("img", aux["img_emb"]),
                                       ("txt", aux["txt_emb"]),
                                       ("label", batch["label"]),
                                       ("mask", aux["mask"])):
                        self._train_cache[key].append(
                            gather_rows(value.detach(), self.mesh))
        if not losses:
            return float("nan"), 0
        # the losses are the global batches'; the image count is summed
        seen = all_reduce_(torch.stack(mask_sums).sum().reshape(1).float(),
                           self.mesh)
        host = torch.cat([torch.cat(losses), seen]).cpu().numpy()
        return float(np.mean(host[:-1])), int(host[-1])

    def _retrieval(self, prefix: str, img: torch.Tensor, txt: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        """The masked precision/recall@k of the ks that the valid rows
        allow (k + 1 <= their count, the unmasked forms' contract)."""
        n_valid = int((mask > 0).sum())
        ks = tuple(k for k in self.retrieval_ks if k + 1 <= n_valid)
        out: Dict[str, torch.Tensor] = {}
        if ks:
            p = masked_label_precision_at_k(img, labels, mask, ks=ks)
            r = masked_image_text_recall_at_k(img, txt, mask, ks=ks)
            for k in ks:
                out[f"{prefix}label_precision_at_{k}"] = p[k]
                out[f"{prefix}recall_at_{k}"] = r[k]
        return out

    def _train_retrieval_metrics(self) -> Dict[str, float]:
        """Epoch-level retrieval metrics over the cached train embeddings
        (reference VisionLanguageModule.py:685-700)."""
        cache = getattr(self, "_train_cache", None)
        if not cache or not cache["img"]:
            return {}
        out = self._retrieval("train/", *(torch.cat(cache[k]) for k in
                                          ("img", "txt", "label", "mask")))
        self._train_cache = {"img": [], "txt": [], "label": [], "mask": []}
        return _floats(out)

    # ------------------------------------------------------------------
    def _validate(self, epoch: int) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self.linear_probe is not None:
            out.update(self.linear_probe.on_validation_start(epoch))
        if self.is_vlp:
            out.update(self._train_retrieval_metrics())
            out.update(self._validate_vlp())
            if self.downstream_pak is not None:
                out.update(self.downstream_pak.on_validation_end(epoch))
        else:
            out.update(self._validate_classifier())
        return out

    def _validate_classifier(self) -> Dict[str, float]:
        values: Dict[str, torch.Tensor] = {}
        combined = M.init_state(device=self.device)
        for name, loader in self.val_loaders.items():
            st = M.init_state(device=self.device)
            for batch in loader:
                o = self.eval_step(batch)
                st = M.update_state(st, o["logits"], o["labels"], o["mask"],
                                    o["loss"])
            st = M.reduce_state(st, self.mesh)
            combined = M.merge_states(combined, st)
            values.update(M.compute_metrics(st, prefix=f"val/{name}/"))
        values.update(M.compute_metrics(combined, prefix="val/combined/"))
        return _floats(values)

    def _validate_vlp(self) -> Dict[str, float]:
        """Per-loader InfoNCE loss (the mean of its batches') and the
        epoch-level retrieval metrics over the whole epoch's embeddings,
        padded rows masked (reference VisionLanguageModule.py:556-636,
        :664-706); the combined loss is the loaders' mean."""
        values: Dict[str, torch.Tensor] = {}
        for name, loader in self.val_loaders.items():
            chunks = {"img": [], "txt": [], "label": [], "mask": []}
            losses = []
            for batch in loader:
                o = self.eval_step(batch)
                for key, value in (("img", o["img_emb"]),
                                   ("txt", o["txt_emb"]),
                                   ("label", batch["label"]),
                                   ("mask", o["mask"])):
                    chunks[key].append(gather_rows(value, self.mesh))
                losses.append(o["loss"].reshape(1).float())
            if not losses:
                continue  # an empty val loader is skipped
            values[f"val/{name}/loss"] = torch.cat(losses).mean()
            values.update(self._retrieval(
                f"val/{name}/", *(torch.cat(chunks[k]) for k in
                                  ("img", "txt", "label", "mask"))))
        out = _floats(values)
        if all(f"val/{n}/loss" in out for n in self.val_loaders):
            out["val/combined/loss"] = float(np.mean(
                [out[f"val/{n}/loss"] for n in self.val_loaders]))
        return out

    # ------------------------------------------------------------------
    def extract_features(self, loader: DeviceLoader
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Frozen-model pooled features and labels over a loader (linear
        probe / transfer eval), on the host; every rank's rows on a
        mesh."""
        feats, labels = collect_over_loader(self.task.features_fn, loader)
        return feats.float().cpu().numpy(), labels.cpu().numpy()
