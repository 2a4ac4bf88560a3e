"""Caption-unique batch sampler (the port's copy of
``vlp_tpu/data/sampler.py``: the same index sequences for a seed).

Host-side index bookkeeping (framework-agnostic — no torch Sampler base
class) with the same semantics as the reference NoDuplicateCaptionSampler
(src/data/sampler/UniqueCaptionSampler.py:15-172): best-effort caption-unique
batches so that the InfoNCE diagonal labels are valid, probabilistic ("full")
or greedy ("semi") caption selection, tail batches that may contain
duplicates, and a deterministic mode that caches batches for reproducible
validation epochs (with sanity-check-aware cache invalidation).

Because every step takes one fixed batch shape, this implementation
additionally supports ``drop_remainder``/padding so every batch has exactly
``batch_size`` entries; padded entries repeat real samples and carry a mask
(they still enter BatchNorm's batch statistics, as in the JAX step).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class NoDuplicateCaptionSampler:
    def __init__(
        self,
        num_samples: int,
        caption_ids: Sequence[int],
        batch_size: int,
        probabilistic_mode: str = "full",
        deterministic: bool = False,
        seed: Optional[int] = None,
    ) -> None:
        if len(caption_ids) != num_samples:
            raise AssertionError(
                f"caption_ids must have the same length as the dataset "
                f"({len(caption_ids)} != {num_samples})"
            )
        if probabilistic_mode not in ("full", "semi"):
            raise AssertionError(
                f"probabilistic_mode must be 'full' or 'semi', got {probabilistic_mode!r}"
            )
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.probabilistic_mode = probabilistic_mode
        self.deterministic = deterministic
        self._rng = np.random.default_rng(seed)

        # Remap arbitrary caption ids to dense 0..K-1 ids
        # (reference UniqueCaptionSampler.py:55-60).
        unique = sorted(set(int(c) for c in caption_ids))
        id_map = {orig: i for i, orig in enumerate(unique)}
        self.caption_ids = [id_map[int(c)] for c in caption_ids]
        self.number_of_unique_captions = len(unique)
        self._cached_batches: List[List[int]] = []

    def __len__(self) -> int:
        return math.ceil(len(self.caption_ids) / self.batch_size)

    def __iter__(self) -> Iterator[List[int]]:
        if self.deterministic and len(self._cached_batches) == len(self):
            yield from self._cached_batches
            return
        if self.deterministic:
            # Reset a partially-built cache (sanity checks inflate it before
            # the first full epoch — reference UniqueCaptionSampler.py:81).
            self._cached_batches = []

        available: Dict[int, List[int]] = {}
        for i, cid in enumerate(self.caption_ids):
            available.setdefault(cid, []).append(i)

        # Main phase: while enough unique captions remain, pick batch_size
        # distinct captions, one random sample each.
        while len(available) >= self.batch_size:
            cids = list(available.keys())
            if self.probabilistic_mode == "full":
                weights = np.array([len(available[c]) for c in cids], dtype=np.float64)
                probs = weights / weights.sum()
                selected = self._rng.choice(cids, size=self.batch_size,
                                            replace=False, p=probs)
            else:
                cids.sort(key=lambda c: len(available[c]), reverse=True)
                selected = cids[: self.batch_size]
            batch = [self._take(available, int(c)) for c in selected]
            if self.deterministic:
                self._cached_batches.append(batch)
            yield batch

        # Tail phase: drain remaining captions; pad final batches with
        # duplicate captions if necessary (reference :131-169).
        while available:
            batch = [self._take(available, c) for c in list(available.keys())]
            while len(batch) < self.batch_size and available:
                cid = max(available.keys(), key=lambda c: len(available[c]))
                batch.append(self._take(available, cid))
            if batch:
                if self.deterministic:
                    self._cached_batches.append(batch)
                yield batch

    def rng_state(self) -> dict:
        return self._rng.bit_generator.state

    def set_rng_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state

    def _take(self, available: Dict[int, List[int]], cid: int) -> int:
        pool = available[cid]
        j = int(self._rng.integers(len(pool)))
        sample = pool.pop(j)
        if not pool:
            del available[cid]
        return sample


class ShuffleBatchSampler:
    """Plain shuffled fixed-size batch sampler for supervised training.

    Replaces the reference's default DataLoader shuffling; yields index lists
    of exactly ``batch_size`` (padding the final batch by wrapping around so
    the step never sees a ragged shape — padded entries are marked via
    the returned mask from :func:`pad_batch_indices`)."""

    def __init__(self, num_samples: int, batch_size: int, shuffle: bool = True,
                 seed: Optional[int] = None, drop_remainder: bool = False) -> None:
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.drop_remainder:
            return self.num_samples // self.batch_size
        return math.ceil(self.num_samples / self.batch_size)

    def rng_state(self) -> dict:
        return self._rng.bit_generator.state

    def set_rng_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state

    def __iter__(self) -> Iterator[List[int]]:
        order = np.arange(self.num_samples)
        if self.shuffle:
            self._rng.shuffle(order)
        n_full = self.num_samples // self.batch_size
        for b in range(n_full):
            yield order[b * self.batch_size : (b + 1) * self.batch_size].tolist()
        rem = self.num_samples - n_full * self.batch_size
        if rem and not self.drop_remainder:
            yield order[n_full * self.batch_size :].tolist()


def pad_batch_indices(indices: List[int], batch_size: int) -> (List[int], np.ndarray):
    """Pad a ragged final batch to ``batch_size`` by repeating entries;
    returns (padded_indices, valid_mask[batch_size] float32). The mask
    zeroes padded samples out of losses and metric updates."""
    mask = np.zeros(batch_size, dtype=np.float32)
    mask[: len(indices)] = 1.0
    padded = list(indices)
    while len(padded) < batch_size:
        padded.append(indices[len(padded) % len(indices)])
    return padded, mask
