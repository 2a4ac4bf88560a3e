"""Caption tokenization (counterpart of ``vlp_tpu/data/tokenize.py``).

The port's own copy of the JAX package's offline tokenizer: a deterministic
hash vocabulary over lowercased words and punctuation, with BERT's special
ids, so the same caption gives the same ids and mask on both sides. Only
the hash path is here: the HF tokenizers need a local HF cache and the
``transformers`` package, and neither is in the repository or on the
machine with the card, where the JAX package's ``get_tokenizer`` also
falls back to this tokenizer. Captions are tokenized once, jointly over
every split, so the padding length is shared (``tokenize_all_captions``).
"""
from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

CLS_ID, SEP_ID, PAD_ID, UNK_ID = 101, 102, 0, 100
_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")
# the first id of the hash range: ids below it are BERT's reserved ones
FIRST_WORD_ID = 999


class HashTokenizer:
    """Lowercase, split into words and punctuation marks, hash each into
    ``[999, vocab_size)``; ``[CLS] words [SEP]``, padded with 0 and
    truncated to ``max_length`` (the words to ``max_length - 2``)."""

    def __init__(self, vocab_size: int = 30522) -> None:
        self.vocab_size = vocab_size

    def _word_id(self, w: str) -> int:
        h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
        return FIRST_WORD_ID + (h % (self.vocab_size - FIRST_WORD_ID))

    def __call__(self, texts: Sequence[str], max_length: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [N, max_length] int32, attention mask [N, max_length]
        int32, 1 on the CLS, word and SEP positions)."""
        n = len(texts)
        ids = np.full((n, max_length), PAD_ID, np.int32)
        mask = np.zeros((n, max_length), np.int32)
        for i, t in enumerate(texts):
            words = _WORD_RE.findall(t.lower())[: max_length - 2]
            row = [CLS_ID] + [self._word_id(w) for w in words] + [SEP_ID]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask


def get_tokenizer(name: str) -> HashTokenizer:
    """The tokenizer of ``data.tokenizer=name``: the hash tokenizer for every
    name, which is what the JAX package's ``get_tokenizer`` returns when no
    HF tokenizer files are cached locally (the case on every machine this
    repository runs on). Pairing its ids with pretrained BERT weights would
    be meaningless; the port's text towers start from random weights."""
    del name
    return HashTokenizer()


def tokenize_all_captions(
    samples_by_split: Dict[str, List[dict]],
    tokenizer_name: str,
    max_length: int = 40,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Joint tokenization of every split's ``caption`` fields (one shared
    padding length); per split, (ids, mask) aligned with its samples."""
    tokenize = get_tokenizer(tokenizer_name)
    all_texts: List[str] = []
    spans: Dict[str, Tuple[int, int]] = {}
    for split, samples in samples_by_split.items():
        start = len(all_texts)
        all_texts.extend(str(s["caption"]) for s in samples)
        spans[split] = (start, len(all_texts))
    ids, mask = tokenize(all_texts, max_length)
    return {split: (ids[a:b], mask[a:b]) for split, (a, b) in spans.items()}
