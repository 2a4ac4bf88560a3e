"""The port's WordPiece tokenizer (``vlp_tpu_torch/data/tokenize.py``)
against ``transformers``' ``BertTokenizerFast`` (what the JAX package's
``AutoTokenizer`` builds from a ``vocab.txt``) and ``BertTokenizer``, and
``get_tokenizer``/``tokenize_all_captions`` against the JAX package's own
on the same staged HF hub cache.

Every comparison is exact: equal ids and masks, ``[N, max_length]``
int32.
"""
import json
import os
import subprocess
import sys

# no HF code path may reach for the network, and transformers loads its
# PyTorch side only (all read at their import)
HF_OFFLINE = {"HF_HUB_OFFLINE": "1", "TRANSFORMERS_OFFLINE": "1",
              "HF_HUB_DISABLE_TELEMETRY": "1", "USE_TF": "0",
              "USE_FLAX": "0", "USE_TORCH": "1"}
os.environ.update(HF_OFFLINE)

import numpy as np
import pytest

import chip_smoke_weights as W
from vlp_tpu_torch.data import tokenize as ttok
from vlp_tpu_torch.data.caption_generator import generate_captions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPTIONS = [r["caption"] for r in generate_captions()]
EDGE_CASES = [
    "",
    "   ",
    "Osteosarcoma of the distal FEMUR, lateral view.",
    "Ünïcödé wörds, café résumé naïve façade",
    "ÉCOLE Ångström ÑANDÚ",
    "12 cm lesion, 3/4 of the shaft; 2.5mm at 10:30",
    "giant-cell tumour... (AP)!!! ?!?! --- ''\"\"",
    "x-ray; non-ossifying fibroma/fibrous cortical-defect",
    "zzqxv unknownword qqq",
    "a" * 100,
    "b" * 101,
    "中国 骨 肿瘤 x中y",
    "tab\tnew\nline\rcr ctrl\x07bell\x00nul\u200bzw\ufffdrep\x85nel",
    "nbsp\u00a0thin\u2009ideo\u3000sep\u2028end\x0bvt",
    "SHOULDER WRIST Hip knee",
]
# tokens the caption corpus lacks, so the cases above reach them
EXTRA = ["é", "中", "国", "##ö", "cafe", "##sume", "Osteo", "##SARCOMA",
         "FEMUR", "É", "##COLE", "a" * 100, "1", "##0"]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    """A BERT-shaped ``vocab.txt`` over the caption corpus (phase 29's
    writer at 6000 lines, ``EXTRA`` in its filler's place)."""
    tokens = W.vocab_tokens(CAPTIONS + EDGE_CASES,
                            np.random.default_rng(0), size=6000)
    assert all(t.startswith("[unused") for t in tokens[-len(EXTRA):])
    tokens[-len(EXTRA):] = EXTRA
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(tokens) + "\n", encoding="utf-8")
    return str(path)


def _hf(kind, vocab, **kw):
    import transformers

    cls = getattr(transformers, kind)
    tok = cls(vocab_file=vocab, **kw)

    def call(texts, max_length):
        out = tok(list(texts), padding="max_length", truncation=True,
                  max_length=max_length, return_tensors="np")
        return (out["input_ids"].astype(np.int32),
                out["attention_mask"].astype(np.int32))
    return call


@pytest.mark.parametrize("max_length", [40, 8])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("kind", ["BertTokenizerFast", "BertTokenizer"])
def test_wordpiece_equals_hf(vocab, kind, lower, max_length):
    """Every caption the caption generator writes and the edge cases:
    accents, upper case, digits, runs of punctuation, hyphens, unknown
    words, words of 100 and 101 characters, CJK, control characters and
    other whitespace, the empty string."""
    texts = CAPTIONS + EDGE_CASES
    ours = ttok.WordPieceTokenizer(vocab, do_lower_case=lower)
    ids, mask = ours(texts, max_length)
    want_ids, want_mask = _hf(kind, vocab, do_lower_case=lower)(texts,
                                                                 max_length)
    assert ids.dtype == mask.dtype == np.int32
    assert ids.shape == mask.shape == (len(texts), max_length)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    pieces = {i for t, i in ours.vocab.items() if t.startswith("##")}
    assert np.isin(ids, list(pieces)).any()  # real WordPiece splits
    assert (ids == ours.unk_id).any()


def test_tokenizer_config_settings(vocab, tmp_path):
    """``from_dir`` takes ``tokenizer_config.json``'s case, accent and CJK
    settings."""
    snap = tmp_path / "snap"
    snap.mkdir()
    (snap / "vocab.txt").write_text(open(vocab, encoding="utf-8").read(),
                                    encoding="utf-8")
    for conf in ({"do_lower_case": False, "strip_accents": True},
                 {"do_lower_case": True, "strip_accents": False},
                 {"tokenize_chinese_chars": False}):
        (snap / "tokenizer_config.json").write_text(json.dumps(conf))
        ours = ttok.WordPieceTokenizer.from_dir(str(snap))
        want = _hf("BertTokenizerFast", vocab, **conf)(EDGE_CASES, 40)
        got = ours(EDGE_CASES, 40)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=str(conf))


def _stage_vocab(cache, repo, vocab):
    W.stage_hf_repo(cache, repo, {
        "config.json": {"model_type": "distilbert"},
        "vocab.txt": open(vocab, encoding="utf-8").read().splitlines()})


def test_get_tokenizer_caches_success_and_retries_failure(
        vocab, tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    monkeypatch.setattr(ttok, "_TOKENIZER_CACHE", {})
    _stage_vocab(tmp_path / "hub", W.DISTILBERT_REPO, vocab)
    tok = ttok.get_tokenizer("distilbert")
    assert isinstance(tok, ttok.WordPieceTokenizer)
    assert ttok.get_tokenizer("distilbert") is tok
    assert not ttok.tokenizer_is_hash_fallback("distilbert")
    assert isinstance(ttok.get_tokenizer("tinybert"), ttok.HashTokenizer)
    assert ttok.tokenizer_is_hash_fallback("tinybert")
    # a failure is not cached: files staged later are found
    _stage_vocab(tmp_path / "hub", W.TINYBERT_REPO, vocab)
    assert isinstance(ttok.get_tokenizer("tinybert"),
                      ttok.WordPieceTokenizer)
    # another cache root is another vocabulary file
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "other"))
    assert ttok.tokenizer_is_hash_fallback("distilbert")


def test_jax_get_tokenizer_and_tokenize_all_captions_end_to_end(
        vocab, tmp_path, monkeypatch):
    """The JAX package's ``tokenize_all_captions`` through its own
    ``get_tokenizer`` (``AutoTokenizer`` from the staged cache), in a
    process of its own with ``HF_HUB_CACHE`` set (``huggingface_hub`` reads
    it at import), against the port's on the same cache."""
    cache = tmp_path / "hub"
    _stage_vocab(cache, W.DISTILBERT_REPO, vocab)
    samples = {"train": [{"caption": c} for c in CAPTIONS[:600]],
               "lera": [{"caption": c} for c in CAPTIONS[600:]],
               "mura": [{"caption": c} for c in EDGE_CASES]}
    (tmp_path / "samples.json").write_text(json.dumps(samples))
    code = (
        "import json, sys\nimport numpy as np\n"
        "from vlp_tpu.data import tokenize as t\n"
        f"samples = json.load(open({str(tmp_path / 'samples.json')!r}))\n"
        "out = t.tokenize_all_captions(samples, 'distilbert', 40)\n"
        "assert not t.tokenizer_is_hash_fallback('distilbert')\n"
        f"np.savez({str(tmp_path / 'jax.npz')!r}, "
        "**{f'{k}_{i}': v[i] for k, v in out.items() for i in (0, 1)})\n")
    # the tokenizers need none of transformers' frameworks
    env = dict(os.environ, **dict(HF_OFFLINE, USE_TORCH="0"),
               HF_HUB_CACHE=str(cache), JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=300, capture_output=True)
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setattr(ttok, "_TOKENIZER_CACHE", {})
    ours = ttok.tokenize_all_captions(samples, "distilbert", 40)
    with np.load(tmp_path / "jax.npz") as z:
        for split, (ids, mask) in ours.items():
            np.testing.assert_array_equal(ids, z[f"{split}_0"])
            np.testing.assert_array_equal(mask, z[f"{split}_1"])
            assert ids.dtype == z[f"{split}_0"].dtype == np.int32
    hashed, _ = ttok.HashTokenizer()(CAPTIONS[:600], 40)
    assert not np.array_equal(ours["train"][0], hashed)
