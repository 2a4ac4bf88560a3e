"""Caption pool loading + cycling assignment (the port's copy of
``vlp_tpu/data/captions.py``, reading the CSV with the ``csv`` module).

The reference pairs every MURA/LERA radiograph with an LLM-generated caption
from a static pool keyed by (anatomy_site, abnormality_label)
(res/data/pretrain/captions.csv: 880 rows, 11 sites x 2 labels). Captions
are assigned by cycling through the pool per key so the pool is used evenly
(reference MURADataset.py:70-109, LERADataset.py:73-112). The global caption
row index is recorded per sample: it becomes the caption id the
NoDuplicateCaptionSampler keys on. Row indices count the CSV's data rows
from 0, blank lines skipped, as ``pandas.read_csv`` numbers them; quoted
fields may hold commas and quotes.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence, Tuple

DEFAULT_CAPTIONS_CSV = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "res", "data", "pretrain", "captions.csv")

_COLUMNS = ("anatomy_site", "abnormality_label", "caption")


class CaptionPool:
    """Static caption pool with per-(site,label) cycling state."""

    def __init__(self, captions_csv: str = DEFAULT_CAPTIONS_CSV) -> None:
        with open(captions_csv, newline="", encoding="utf-8") as fh:
            reader = csv.DictReader(fh)
            if not set(_COLUMNS).issubset(reader.fieldnames or ()):
                raise ValueError(
                    f"Caption CSV {captions_csv} must have columns "
                    f"{set(_COLUMNS)}")
            self.rows = [{k: row[k] for k in _COLUMNS} for row in reader]
        # (site, label) -> list of (global_row_idx, caption)
        self._by_key: Dict[Tuple[str, int], List[Tuple[int, str]]] = {}
        for idx, row in enumerate(self.rows):
            key = (row["anatomy_site"], int(row["abnormality_label"]))
            self._by_key.setdefault(key, []).append((idx, row["caption"]))
        self._cycle_state: Dict[Tuple[str, int], int] = {}

    @property
    def num_captions(self) -> int:
        return len(self.rows)

    def all_captions(self) -> List[str]:
        return [row["caption"] for row in self.rows]

    def sites(self) -> List[str]:
        return sorted({k[0] for k in self._by_key})

    def assign(self, anatomy_site: str, label: int) -> Tuple[str, int]:
        """Return (caption, global_caption_row_index), cycling through the
        pool for this (site, label). First call for a key returns entry 0,
        subsequent calls 1, 2, ..., wrapping (reference MURADataset.py:79-88)."""
        key = (anatomy_site, int(label))
        if key not in self._by_key:
            raise KeyError(
                f"No captions for anatomy_site={anatomy_site!r} label={label}; "
                f"available sites: {self.sites()}")
        pool = self._by_key[key]
        index = (self._cycle_state[key] + 1) % len(pool) \
            if key in self._cycle_state else 0
        self._cycle_state[key] = index
        row_idx, caption = pool[index]
        return caption, row_idx

    def assign_all(self, sites_and_labels: Sequence[Tuple[str, int]]
                   ) -> List[Tuple[str, int]]:
        return [self.assign(site, label) for site, label in sites_and_labels]
