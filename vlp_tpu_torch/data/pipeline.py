"""Host -> device input pipeline (counterpart of ``vlp_tpu/data/pipeline.py``).

``ArrayBundle`` holds a split's columns on the host: the cache rows of its
images, labels, dataset ids (CORAL's domains), clinical vectors or caption
tokens. ``DeviceLoader`` iterates fixed-size batches of it on one device:

- **resident** (the corpus within ``VLP_DEVICE_RESIDENT_MB``, default 4096
  MB, as the JAX package's local mode): the uint8 corpus and the metadata
  columns are uploaded once, shared by every loader of the cache on that
  device, and a batch is ``index_select`` of the columns by its sample
  indices on the device. Only the indices cross the link (one pinned,
  non-blocking copy); the mask is made on the device from the count of
  real rows.
- **host** (over budget): a background thread assembles each batch from the
  memory-mapped cache into pinned memory of its own, ``prefetch_depth``
  batches ahead, and the consumer copies it to the device without blocking.
  A batch's pinned buffer is never reused while a copy may read it: each
  batch has its own, and the caching host allocator keeps a freed block
  until the copies that read it have finished.

Both give the same batches (``tests/test_torch_port_data.py``). Every batch
holds exactly ``batch_size`` rows: a ragged last batch repeats real rows
with mask 0 (``pad_batch_indices``), and the step takes the padded batch as
it is, so the padded rows enter BatchNorm's batch statistics as in the JAX
step while losses and metrics weight by the mask. ``init_batch`` never
touches the sampler. The JAX package's K-batch chunks
(``iter_scan_chunks``) feed its scanned step; the port's trainer runs one
step a batch and takes batches one at a time. The sharded and replicated
corpora of a multi-device mesh wait for ROADMAP Queue 1 item 14.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from vlp_tpu_torch.data.preprocess_host import ImageCache
from vlp_tpu_torch.data.sampler import pad_batch_indices

DATASET_IDS = {"INTERNAL": 0, "BTXRD": 1, "MURA": 0, "LERA": 1}
RESIDENT_LIMIT_MB = "VLP_DEVICE_RESIDENT_MB"  # the budget; 0 disables


class ArrayBundle:
    """Columnar host arrays for a split, built once from sample dicts."""

    def __init__(self, samples: Sequence[dict], cache: ImageCache,
                 cache_indices: Optional[Sequence[int]] = None,
                 token_ids: Optional[np.ndarray] = None,
                 token_mask: Optional[np.ndarray] = None) -> None:
        self.samples = list(samples)
        if not self.samples:
            raise ValueError(
                "empty sample list: the split has no samples (check the "
                "frozen-split files / subsampling options)")
        self.cache = cache
        n = len(self.samples)
        self.cache_indices = np.asarray(
            cache_indices if cache_indices is not None else np.arange(n),
            dtype=np.int64)
        assert len(self.cache_indices) == n
        self.is_pretrain = "caption_id" in self.samples[0]
        if self.is_pretrain:
            self.labels = np.array([s["label"] for s in self.samples],
                                   np.int32)
            self.caption_ids = np.array(
                [s["caption_id"] for s in self.samples], np.int32)
            assert token_ids is not None and token_mask is not None
            self.token_ids = token_ids
            self.token_mask = token_mask
        else:
            self.labels = np.array([s["tumor"] for s in self.samples],
                                   np.int32)
            self.clinical = np.stack(
                [np.asarray(s["clinical"], np.float32) for s in self.samples])
        unknown = {str(s["dataset"]) for s in self.samples} - set(DATASET_IDS)
        if unknown:
            raise ValueError(
                f"unknown dataset name(s) {sorted(unknown)}; CORAL domain "
                f"ids are derived from {sorted(DATASET_IDS)}")
        self.dataset_ids = np.array(
            [DATASET_IDS[str(s["dataset"])] for s in self.samples], np.int32)

    def __len__(self) -> int:
        return len(self.samples)

    def assemble(self, indices: List[int], batch_size: int
                 ) -> Dict[str, np.ndarray]:
        """The host batch of ``indices``, padded to ``batch_size``."""
        idx, mask = pad_batch_indices(list(indices), batch_size)
        idx = np.asarray(idx, np.int64)
        batch = {"label": self.labels[idx],
                 "dataset_id": self.dataset_ids[idx], "mask": mask}
        if self.is_pretrain:
            batch["input_ids"] = self.token_ids[idx]
            batch["attention_mask"] = self.token_mask[idx]
            batch["caption_id"] = self.caption_ids[idx]
        else:
            batch["clinical"] = self.clinical[idx]
        batch["image_u8"] = self.cache.gather(self.cache_indices[idx])
        return batch

    def columns(self) -> Dict[str, np.ndarray]:
        """Per-sample metadata columns for the resident path, with the cache
        row of each sample."""
        cols = {"label": self.labels, "dataset_id": self.dataset_ids,
                "cache_idx": self.cache_indices}
        if self.is_pretrain:
            cols.update(input_ids=self.token_ids,
                        attention_mask=self.token_mask,
                        caption_id=self.caption_ids)
        else:
            cols["clinical"] = self.clinical
        return cols


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory of its own and a
    non-blocking copy for a CUDA device."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def resident_corpus(cache: ImageCache, device: torch.device
                    ) -> Optional[torch.Tensor]:
    """The cache's uint8 images on ``device`` (uploaded once per device and
    shared by the loaders of that cache), or None over the
    ``VLP_DEVICE_RESIDENT_MB`` budget."""
    limit_mb = float(os.environ.get(RESIDENT_LIMIT_MB, "4096"))
    if cache.data.nbytes > limit_mb * 1e6:
        return None
    cached = getattr(cache, "_resident_torch", None)
    if cached is not None and cached[0] == device:
        return cached[1]
    images = torch.from_numpy(np.array(cache.data, copy=True)).to(device)
    cache._resident_torch = (device, images)
    return images


def _prefetch(items: Iterator, depth: int) -> Iterator:
    """``items`` produced on a background thread at most ``depth`` ahead.
    The producer gives up when the consumer is gone (the generator dropped
    mid-epoch), so no thread is left blocked on a full queue; an error in
    the producer is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()
    err: List[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in items:
                if not put(item):
                    return
        except BaseException as e:  # raised again in the consumer
            err.append(e)
        finally:
            put(done)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        t.join()


class DeviceLoader:
    """Fixed-size batches of a bundle on ``device``, in the sampler's order
    (resident or host-assembled, see the module docstring)."""

    def __init__(self, bundle: ArrayBundle, sampler, batch_size: int,
                 device, prefetch_depth: int = 2) -> None:
        self.bundle = bundle
        self.sampler = sampler
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.prefetch_depth = max(1, prefetch_depth)
        self._images = resident_corpus(bundle.cache, self.device)
        self._cols = None
        if self._images is not None:
            self._cols = {k: torch.from_numpy(np.array(v)).to(self.device)
                          for k, v in bundle.columns().items()}

    @property
    def resident(self) -> bool:
        return self._images is not None

    def __len__(self) -> int:
        return len(self.sampler)

    def init_batch(self) -> Dict[str, torch.Tensor]:
        """A shape-representative batch (the first rows) without touching
        the sampler, whose RNG is the run's."""
        return self._batch(list(range(min(self.batch_size,
                                          len(self.bundle)))))

    def _batch(self, indices: List[int]) -> Dict[str, torch.Tensor]:
        if self._images is None:
            return self._upload(self.bundle.assemble(indices,
                                                     self.batch_size))
        idx, _ = pad_batch_indices(list(indices), self.batch_size)
        idx = _to_device(np.asarray(idx, np.int64), self.device)
        out = {k: v.index_select(0, idx) for k, v in self._cols.items()
               if k != "cache_idx"}
        out["image_u8"] = self._images.index_select(
            0, self._cols["cache_idx"].index_select(0, idx))
        out["mask"] = (torch.arange(self.batch_size, device=self.device)
                       < len(indices)).float()
        return out

    def _upload(self, host: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: _to_device(v, self.device) for k, v in host.items()}

    def _pinned_batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        pin = self.device.type == "cuda"
        for indices in self.sampler:
            host = self.bundle.assemble(indices, self.batch_size)
            yield {k: (torch.from_numpy(v).pin_memory() if pin
                       else torch.from_numpy(v)) for k, v in host.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        if self._images is not None:
            for indices in self.sampler:
                yield self._batch(indices)
            return
        for host in _prefetch(self._pinned_batches(), self.prefetch_depth):
            yield {k: v.to(self.device, non_blocking=True)
                   for k, v in host.items()}
