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
step a batch and takes batches one at a time.

On a data mesh (``mesh``, ``parallel/mesh.py``) ``batch_size`` is the
global batch and must divide by the world. Every rank walks the same
sampler, pads the same global batch, and takes its rows ``[r b, (r + 1)
b)``: the padded tail lies on the last ranks, as on the JAX mesh. The
resident corpus then takes one of the JAX package's three modes
(``resident_corpus``, under the same per-device budget):

- ``local``: one rank (or no mesh), the corpus on its device;
- ``replicated``: the whole uint8 corpus on every rank's device; a rank
  gathers its own rows, no collective;
- ``sharded``: the corpus's rows padded to a multiple of N and split over
  the ranks. For each global batch every rank writes the rows it owns into
  a zeroed uint8 ``[B_g, H, W]`` buffer and one reduce-scatter hands every
  rank its slice. Each row has one owner, so the uint8 sum is exact.
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
from vlp_tpu_torch.parallel.collectives import reduce_scatter
from vlp_tpu_torch.parallel.mesh import axis_size, pad_to_multiple

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

    def assemble(self, indices: List[int], batch_size: int,
                 rows: slice = slice(None)) -> Dict[str, np.ndarray]:
        """The host batch of ``indices``, padded to ``batch_size``; its
        ``rows`` (a rank's slice of the global batch)."""
        idx, mask = pad_batch_indices(list(indices), batch_size)
        idx, mask = np.asarray(idx, np.int64)[rows], mask[rows]
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


class ResidentCorpus:
    """The uint8 corpus on this rank's device in one of three modes (the
    module docstring); ``take(idx_global, rows)`` gives this rank's
    ``rows`` of the images of the global batch's cache rows
    ``idx_global`` [B_g] (a device tensor)."""

    def __init__(self, cache: ImageCache, device: torch.device, mesh,
                 mode: str) -> None:
        self.mode = mode
        self.mesh = mesh
        self.device = device
        data = cache.data
        if mode != "sharded":
            self.images = torch.from_numpy(np.array(data, copy=True)).to(
                device)
            return
        # only this rank's rows are read off the (memory-mapped) cache
        n = mesh.world
        self.rows_per_rank = pad_to_multiple(len(data), n) // n
        start = mesh.rank * self.rows_per_rank
        stop = min(start + self.rows_per_rank, len(data))
        local = np.zeros((self.rows_per_rank, *data.shape[1:]), data.dtype)
        if stop > start:
            local[:stop - start] = data[start:stop]
        self.images = torch.from_numpy(local).to(device)

    def take(self, idx_global: torch.Tensor, rows: slice) -> torch.Tensor:
        if self.mode != "sharded":
            return self.images.index_select(0, idx_global[rows])
        first = self.mesh.rank * self.rows_per_rank
        local = idx_global - first
        owned = (local >= 0) & (local < self.rows_per_rank)
        got = self.images.index_select(
            0, local.clamp(0, self.rows_per_rank - 1))
        got = got * owned.to(got.dtype).reshape(-1, *(1,) * (got.dim() - 1))
        return reduce_scatter(got, self.mesh)


def resident_corpus(cache: ImageCache, device: torch.device, mesh=None
                    ) -> Optional[ResidentCorpus]:
    """The cache's resident corpus on ``device`` (built once per device and
    mode and shared by the loaders of that cache), or None over the
    ``VLP_DEVICE_RESIDENT_MB`` budget: ``local`` on one rank,
    ``replicated`` where the corpus fits a device, ``sharded`` where its
    1/N share does (the JAX package's ``_resident_images``)."""
    limit = float(os.environ.get(RESIDENT_LIMIT_MB, "4096")) * 1e6
    nbytes = cache.data.nbytes
    world = axis_size(mesh)
    if world == 1:
        mode = "local" if nbytes <= limit else None
    elif nbytes <= limit:
        mode = "replicated"
    elif nbytes / world <= limit:
        mode = "sharded"
    else:
        mode = None
    if mode is None:
        return None
    key = (device, mode, mesh)
    cached = getattr(cache, "_resident_torch", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    corpus = ResidentCorpus(cache, device, mesh, mode)
    cache._resident_torch = (key, corpus)
    return corpus


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
    (resident or host-assembled, see the module docstring); on ``mesh``
    this rank's rows of each global batch of ``batch_size``."""

    def __init__(self, bundle: ArrayBundle, sampler, batch_size: int,
                 device, prefetch_depth: int = 2, mesh=None) -> None:
        self.bundle = bundle
        self.sampler = sampler
        self.batch_size = batch_size
        self.mesh = mesh
        self.device = torch.device(device)
        self.prefetch_depth = max(1, prefetch_depth)
        world = axis_size(mesh)
        if batch_size % world:
            raise ValueError(
                f"batch_size={batch_size} must be divisible by the "
                f"{world}-shard data axis (every data shard gets an "
                "equal slice; adjust data.batch_size/eval_batch_size or "
                "mesh.data_parallel)")
        self.rows = slice(None) if mesh is None else mesh.rows(batch_size)
        self._corpus = resident_corpus(bundle.cache, self.device, mesh)
        self._cols = None
        if self._corpus is not None:
            self._cols = {k: torch.from_numpy(np.array(v)).to(self.device)
                          for k, v in bundle.columns().items()}

    @property
    def resident(self) -> bool:
        return self._corpus is not None

    @property
    def resident_mode(self) -> Optional[str]:
        return None if self._corpus is None else self._corpus.mode

    def __len__(self) -> int:
        return len(self.sampler)

    def init_batch(self) -> Dict[str, torch.Tensor]:
        """A shape-representative batch (the first rows) without touching
        the sampler, whose RNG is the run's."""
        return self._batch(list(range(min(self.batch_size,
                                          len(self.bundle)))))

    def _batch(self, indices: List[int]) -> Dict[str, torch.Tensor]:
        if self._corpus is None:
            return self._upload(self.bundle.assemble(
                indices, self.batch_size, self.rows))
        idx, _ = pad_batch_indices(list(indices), self.batch_size)
        idx = _to_device(np.asarray(idx, np.int64), self.device)
        mine = idx[self.rows]
        out = {k: v.index_select(0, mine) for k, v in self._cols.items()
               if k != "cache_idx"}
        out["image_u8"] = self._corpus.take(
            self._cols["cache_idx"].index_select(0, idx), self.rows)
        out["mask"] = (torch.arange(self.batch_size, device=self.device)
                       < len(indices)).float()[self.rows]
        return out

    def _upload(self, host: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: _to_device(v, self.device) for k, v in host.items()}

    def _pinned_batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        pin = self.device.type == "cuda"
        for indices in self.sampler:
            host = self.bundle.assemble(indices, self.batch_size, self.rows)
            yield {k: (torch.from_numpy(v).pin_memory() if pin
                       else torch.from_numpy(v)) for k, v in host.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        if self._corpus is not None:
            for indices in self.sampler:
                yield self._batch(indices)
            return
        for host in _prefetch(self._pinned_batches(), self.prefetch_depth):
            yield {k: v.to(self.device, non_blocking=True)
                   for k, v in host.items()}
