"""Caption tokenization (counterpart of ``vlp_tpu/data/tokenize.py``).

``get_tokenizer(name)`` gives the tokenizer the JAX package's gives: the
pretrained tower's WordPiece tokenizer where its ``vocab.txt`` is in the
local HF hub cache (``utils/hf_files.py``; ``distilbert`` and ``tinybert``
name their HF repos, any other name is a repo id itself), else the
deterministic hash tokenizer over lowercased words and punctuation, with
BERT's special ids. ``WordPieceTokenizer`` is the port's own copy of the
``BertTokenizerFast`` that ``AutoTokenizer`` builds from a ``vocab.txt``
(no ``transformers`` or ``tokenizers`` needed); hash ids paired with
pretrained BERT weights are meaningless, which the driver refuses
(``tokenizer_is_hash_fallback``). Captions are tokenized once, jointly
over every split, so the padding length is shared
(``tokenize_all_captions``).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from vlp_tpu_torch.utils import hf_files
from vlp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

TOKENIZER_HF_NAMES = {
    "distilbert": "distilbert-base-uncased",
    "tinybert": "huawei-noah/TinyBERT_General_4L_312D",
}
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


# the CJK Unified Ideographs blocks, which BERT pads with spaces
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
MAX_WORD_CHARS = 100


def _is_punctuation(ch: str) -> bool:
    """BERT's punctuation: ASCII's non-alphanumeric printables and every
    Unicode P* character."""
    cp = ord(ch)
    return 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 \
        or 123 <= cp <= 126 or unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    """BERT's tokenizer over a ``vocab.txt`` (one token a line, its id the
    line's index), as ``BertTokenizerFast`` computes it: the normaliser
    drops NUL, U+FFFD and control characters (every C* category but tab,
    newline and carriage return) and turns whitespace into spaces, pads
    CJK ideographs with spaces, strips accents (NFD, then no Mn character)
    where ``strip_accents`` is true or, being None, ``do_lower_case`` is,
    then lowercases; the text splits on whitespace and around each
    punctuation character; each word is then split greedily into the
    longest pieces in the vocabulary, every piece but the first with the
    ``##`` prefix, and a word with no such split, or of more than 100
    characters, becomes ``[UNK]``. A row is ``[CLS] pieces [SEP]``, the
    pieces truncated to ``max_length - 2``, padded with ``[PAD]``'s id
    (``tok(texts, padding="max_length", truncation=True)``). Special-token
    strings inside a text are not matched as special tokens."""

    def __init__(self, vocab: Union[str, Sequence[str]],
                 do_lower_case: bool = True,
                 strip_accents: Optional[bool] = None,
                 tokenize_chinese_chars: bool = True) -> None:
        if isinstance(vocab, str):
            with open(vocab, encoding="utf-8") as fh:
                vocab = [line.rstrip("\n") for line in fh]
        # a token listed twice takes its last line, as HF's reader does
        self.vocab = {token: i for i, token in enumerate(vocab)}
        self.do_lower_case = do_lower_case
        self.strip_accents = do_lower_case if strip_accents is None \
            else strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.unk_id, self.cls_id, self.sep_id, self.pad_id = (
            self.vocab[t] for t in ("[UNK]", "[CLS]", "[SEP]", "[PAD]"))

    @classmethod
    def from_dir(cls, path: str) -> "WordPieceTokenizer":
        """The tokenizer of a snapshot directory: its ``vocab.txt`` and,
        where present, ``tokenizer_config.json``'s case, accent and CJK
        settings."""
        kw = {}
        config = os.path.join(path, "tokenizer_config.json")
        if os.path.isfile(config):
            with open(config) as fh:
                conf = json.load(fh)
            kw = {k: conf[k] for k in ("do_lower_case", "strip_accents",
                                       "tokenize_chinese_chars")
                  if isinstance(conf.get(k), bool)}
        return cls(os.path.join(path, "vocab.txt"), **kw)

    def normalize(self, text: str) -> str:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or (
                    ch not in "\t\n\r"
                    and unicodedata.category(ch).startswith("C")):
                continue
            if ch.isspace():
                chars.append(" ")
            elif self.tokenize_chinese_chars and any(
                    lo <= cp <= hi for lo, hi in _CJK):
                chars += [" ", ch, " "]
            else:
                chars.append(ch)
        text = "".join(chars)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        return text.lower() if self.do_lower_case else text

    def words(self, text: str) -> List[str]:
        """The normalised text split on whitespace and around each
        punctuation character."""
        out: List[str] = []
        for chunk in self.normalize(text).split():
            word = ""
            for ch in chunk:
                if _is_punctuation(ch):
                    if word:
                        out.append(word)
                    out.append(ch)
                    word = ""
                else:
                    word += ch
            if word:
                out.append(word)
        return out

    def word_ids(self, word: str) -> List[int]:
        """Greedy longest-match-first WordPiece of one word."""
        if len(word) > MAX_WORD_CHARS:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 \
                    else "##" + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                end -= 1
            if end == start:
                return [self.unk_id]
            start = end
        return ids

    def __call__(self, texts: Sequence[str], max_length: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [N, max_length] int32, attention mask [N, max_length]
        int32)."""
        n = len(texts)
        ids = np.full((n, max_length), self.pad_id, np.int32)
        mask = np.zeros((n, max_length), np.int32)
        for i, t in enumerate(texts):
            pieces = [p for w in self.words(t) for p in self.word_ids(w)]
            row = [self.cls_id] + pieces[:max(max_length - 2, 0)] \
                + [self.sep_id]
            ids[i, : len(row)] = row[:max_length]
            mask[i, : len(row)] = 1
        return ids, mask


# successful loads, by the vocabulary file they read
_TOKENIZER_CACHE: Dict[str, WordPieceTokenizer] = {}


def get_tokenizer(name: str) -> Union[WordPieceTokenizer, HashTokenizer]:
    """fn(texts, max_length) -> (ids [N, L] int32, mask [N, L] int32) of
    ``data.tokenizer=name``: the WordPiece tokenizer of the HF repo it
    names where the snapshot's ``vocab.txt`` is in the hub cache, else the
    hash tokenizer with a warning. A successful load is cached per
    vocabulary file; a failure is not, so a later call sees files staged
    since."""
    hf_name = TOKENIZER_HF_NAMES.get(name, name)
    vocab = hf_files.cached_file(hf_name, "vocab.txt")
    if vocab in _TOKENIZER_CACHE:
        return _TOKENIZER_CACHE[vocab]
    try:
        if vocab is None:
            raise FileNotFoundError(
                f"no vocab.txt in the hub cache {hf_files.hub_cache_dir()}")
        tok = WordPieceTokenizer.from_dir(os.path.dirname(vocab))
    except Exception as e:
        logger.warning(
            "HF tokenizer %s unavailable locally (%s: %s); using "
            "deterministic hash tokenizer (incompatible with pretrained "
            "BERT weights).", hf_name, type(e).__name__, e)
        return HashTokenizer()
    logger.info("Using HF tokenizer %s (%s)", hf_name, vocab)
    _TOKENIZER_CACHE[vocab] = tok
    return tok


def tokenizer_is_hash_fallback(name: str) -> bool:
    """True where ``name`` resolves to the hash tokenizer rather than the HF
    vocabulary: callers that import pretrained text towers must refuse that
    pairing (hash ids into a pretrained BERT are garbage)."""
    return isinstance(get_tokenizer(name), HashTokenizer)


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
