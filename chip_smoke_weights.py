"""Phase 29 of ``chip_smoke.py``: the pretrained-weight imports through the
training entry point on the card, from files this phase writes from a seed
at full width. ``chip_smoke.py`` runs ``phase_weights`` after phase 28.

The files (``write_files``), in a temporary directory:
- an HF hub cache (``HF_HUB_CACHE``) holding ``distilbert-base-uncased``
  (``model.safetensors`` with the ``distilbert.`` prefix and the MLM head,
  which the import drops) and ``huawei-noah/TinyBERT_General_4L_312D``
  (``pytorch_model.bin`` with the ``bert.`` prefix, TensorFlow's
  ``LayerNorm.gamma``/``.beta`` names, the pooler, the ``position_ids``
  buffer and the pretraining heads), each with its ``config.json``;
- one 30522-line ``vocab.txt`` in both snapshots: BERT's special tokens at
  their ids (``[PAD]`` 0, ``[UNK]`` 100, ``[CLS]`` 101, ``[SEP]`` 102,
  ``[MASK]`` 103), ASCII characters and their ``##`` pieces, and the
  caption corpus's words, some whole and some only as pieces, so that real
  WordPiece splits occur;
- the torchxrayvision ResNet50 as xrv saves it: a torchvision-layout state
  dict under ``model.``, a 1-channel conv1 and an 18-class ``fc``
  (``XRV_WEIGHTS_PATH``); and one whose conv1 has 3 channels.

29a. ``python -m vlp_tpu_torch.train experiment=pretrain_resnet50_
     distilbert`` (``driver.main``; ResNet50 + DistilBERT, batch 128, 224,
     bf16) for one epoch on the synthetic pretrain corpus: the captions'
     ids equal an independent CPU WordPiece tokenizer's on the same
     ``vocab.txt`` (pieces with ``##`` among them) and differ from the hash
     tokenizer's; the text tower's state right after the import bit-equal
     to the file's tensors converted here (q, k, v packed, ``Linear``
     weights transposed); its CLS embeddings on the card (bf16) against
     fp32 on the CPU of the same weights within phase 20's ``BOUND_EMB``;
     3 + 1 launches of #11/#12 a train step; the step's latency, images/s
     and peak memory.
29b. The same for ``pretrain_resnet18_tinybert`` on the ``.bin`` route.
29c. ``experiment=baseline_only_imaging_xrv_resnet50`` (``model.
     pretrained=true``) on the synthetic downstream corpus, one fold: the
     3-channel file first gives the warning and leaves the backbone at its
     init, then ``XRV_WEIGHTS_PATH``'s file loads: every backbone parameter
     and running statistic bit-equal to the file's, the 1-logit head at its
     init, eval-mode features on the card (bf16) against CPU fp32 of the
     same weights within phases 16-17's ``BOUND_LOGITS``; 3 + 1 launches a
     train step.
29d. The refusal, in a process of its own beside 29a-29c: the TinyBERT
     weights staged without ``vocab.txt``; the command line exits nonzero
     with the JAX package's ``RuntimeError``.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from vlp_tpu_torch.utils.hf_files import DTYPES

SEED = 29
VOCAB_SIZE = 30522
SPECIAL_IDS = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]",
               103: "[MASK]"}
DISTILBERT_REPO = "distilbert-base-uncased"
TINYBERT_REPO = "huawei-noah/TinyBERT_General_4L_312D"
PRETRAINS = (("29a", "pretrain_resnet50_distilbert", "distilbert"),
             ("29b", "pretrain_resnet18_tinybert", "tinybert"))
XRV_EXPERIMENT = "baseline_only_imaging_xrv_resnet50"
SAMPLES = 640
EMB_ROWS = 16
FEATURE_IMAGES = 4
REFUSAL_TIMEOUT = 300
REFUSAL_TEXT = "fell back to the hash tokenizer"
# the snapshot's commit, as the hub names it
REVISION = hashlib.sha1(b"chip_smoke_weights").hexdigest()

# each HF layout's key names: embeddings, then per layer the modules of
# q, k, v, the out-projection, the attention LayerNorm, the FFN's two
# Linears and its LayerNorm
HF_NAMES = {
    "distilbert": ("transformer.layer", (
        "attention.q_lin", "attention.k_lin", "attention.v_lin",
        "attention.out_lin", "sa_layer_norm", "ffn.lin1", "ffn.lin2",
        "output_layer_norm")),
    "bert": ("encoder.layer", (
        "attention.self.query", "attention.self.key",
        "attention.self.value", "attention.output.dense",
        "attention.output.LayerNorm", "intermediate.dense", "output.dense",
        "output.LayerNorm")),
}


# --------------------------------------------------------------------------
# the files
# --------------------------------------------------------------------------

def hf_base_state(layout: str, hidden: int, layers: int, ffn: int,
                  vocab: int, positions: int, gen: torch.Generator
                  ) -> Dict[str, torch.Tensor]:
    """A base model's HF state (``BertModel``'s or ``DistilBertModel``'s
    keys, no prefix), fp32: embeddings N(0, 0.1), Linear weights N(0,
    1/in), biases N(0, 0.02), LayerNorm weights 1 + N(0, 0.1), their biases
    N(0, 0.05)."""
    def randn(*shape, std):
        return torch.randn(shape, generator=gen) * std

    def ln(key):
        sd[f"{key}.weight"] = 1.0 + randn(hidden, std=0.1)
        sd[f"{key}.bias"] = randn(hidden, std=0.05)

    def linear(key, n_in, n_out):
        sd[f"{key}.weight"] = randn(n_out, n_in, std=n_in ** -0.5)
        sd[f"{key}.bias"] = randn(n_out, std=0.02)

    sd = {"embeddings.word_embeddings.weight": randn(vocab, hidden, std=0.1),
          "embeddings.position_embeddings.weight": randn(positions, hidden,
                                                         std=0.1)}
    if layout == "bert":
        sd["embeddings.token_type_embeddings.weight"] = randn(2, hidden,
                                                              std=0.1)
    ln("embeddings.LayerNorm")
    stack, names = HF_NAMES[layout]
    q, k, v, out, attn_ln, lin1, lin2, ffn_ln = names
    for i in range(layers):
        pre = f"{stack}.{i}"
        for name in (q, k, v, out):
            linear(f"{pre}.{name}", hidden, hidden)
        ln(f"{pre}.{attn_ln}")
        linear(f"{pre}.{lin1}", hidden, ffn)
        linear(f"{pre}.{lin2}", ffn, hidden)
        ln(f"{pre}.{ffn_ln}")
    if layout == "bert":
        linear("pooler.dense", hidden, hidden)
    return sd


def hf_file_state(layout: str, base: Dict[str, torch.Tensor],
                  gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """``base`` as a checkpoint with heads holds it: DistilBERT's under
    ``distilbert.`` with the MLM head (``vocab_transform``,
    ``vocab_layer_norm``, ``vocab_projector``); BERT's under ``bert.``
    with ``LayerNorm.gamma``/``.beta``, the ``position_ids`` buffer and the
    pretraining heads (``cls.*``)."""
    vocab, hidden = base["embeddings.word_embeddings.weight"].shape
    positions = base["embeddings.position_embeddings.weight"].shape[0]
    if layout == "distilbert":
        sd = {f"distilbert.{k}": v for k, v in base.items()}
        sd.update({
            "vocab_transform.weight": torch.randn(hidden, hidden,
                                                  generator=gen),
            "vocab_transform.bias": torch.zeros(hidden),
            "vocab_layer_norm.weight": torch.ones(hidden),
            "vocab_layer_norm.bias": torch.zeros(hidden),
            "vocab_projector.weight":
                base["embeddings.word_embeddings.weight"].clone(),
            "vocab_projector.bias": torch.zeros(vocab)})
        return sd
    sd = {}
    for k, v in base.items():
        if k.endswith("LayerNorm.weight"):
            k = k[:-len("weight")] + "gamma"
        elif k.endswith("LayerNorm.bias"):
            k = k[:-len("bias")] + "beta"
        sd[f"bert.{k}"] = v
    sd.update({
        "bert.embeddings.position_ids": torch.arange(positions)[None],
        "cls.predictions.bias": torch.zeros(vocab),
        "cls.predictions.transform.dense.weight": torch.randn(
            hidden, hidden, generator=gen),
        "cls.predictions.transform.dense.bias": torch.zeros(hidden),
        "cls.predictions.transform.LayerNorm.gamma": torch.ones(hidden),
        "cls.predictions.transform.LayerNorm.beta": torch.zeros(hidden),
        "cls.seq_relationship.weight": torch.randn(2, hidden, generator=gen),
        "cls.seq_relationship.bias": torch.zeros(2)})
    return sd


def hf_config(layout: str, hidden: int, layers: int, heads: int, ffn: int,
              vocab: int, positions: int) -> dict:
    """The ``config.json`` ``transformers`` reads for the layout."""
    if layout == "distilbert":
        return {"model_type": "distilbert",
                "architectures": ["DistilBertForMaskedLM"], "dim": hidden,
                "n_layers": layers, "n_heads": heads, "hidden_dim": ffn,
                "vocab_size": vocab, "max_position_embeddings": positions,
                "activation": "gelu", "dropout": 0.1,
                "attention_dropout": 0.1, "sinusoidal_pos_embds": False,
                "pad_token_id": 0}
    return {"model_type": "bert", "architectures": ["BertForPreTraining"],
            "hidden_size": hidden, "num_hidden_layers": layers,
            "num_attention_heads": heads, "intermediate_size": ffn,
            "vocab_size": vocab, "max_position_embeddings": positions,
            "type_vocab_size": 2, "hidden_act": "gelu",
            "layer_norm_eps": 1e-12, "hidden_dropout_prob": 0.1,
            "attention_probs_dropout_prob": 0.1, "pad_token_id": 0}


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """``tensors`` as a ``.safetensors`` file (keys sorted, the header
    padded with spaces to a multiple of 8 bytes, as the format's writer
    pads it): the machine with the card has no ``safetensors``."""
    names = {v: k for k, v in DTYPES.items()}
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)) + blob)
        for raw in chunks:
            fh.write(raw)


def stage_hf_repo(cache: Path, repo_id: str, files: Dict[str, object],
                  revision: str = REVISION, ref: str = "main") -> Path:
    """``files`` (name -> a dict for ``config.json`` and other JSON, a
    tensor dict for ``model.safetensors`` or ``pytorch_model.bin``, a list
    of lines for ``vocab.txt``, or bytes) as the snapshot ``revision`` of
    ``repo_id`` in the hub cache ``cache``, with ``refs/<ref>`` naming it.
    Returns the snapshot directory."""
    root = Path(cache) / ("models--" + repo_id.replace("/", "--"))
    snap = root / "snapshots" / revision
    snap.mkdir(parents=True, exist_ok=True)
    (root / "refs").mkdir(exist_ok=True)
    (root / "refs" / ref).write_text(revision)
    for name, content in files.items():
        path = snap / name
        if name.endswith(".safetensors"):
            write_safetensors(content, str(path))
        elif name.endswith(".bin"):
            torch.save(content, path)
        elif name.endswith(".json"):
            path.write_text(json.dumps(content))
        elif isinstance(content, bytes):
            path.write_bytes(content)
        else:
            path.write_text("\n".join(content) + "\n", encoding="utf-8")
    return snap


def caption_texts() -> List[str]:
    """The captions the synthetic corpora and ``caption_generator`` give."""
    from vlp_tpu_torch.data.caption_generator import generate_captions
    from vlp_tpu_torch.data.captions import DEFAULT_CAPTIONS_CSV
    from vlp_tpu_torch.data.tables import read_csv

    texts = [r["caption"] for r in generate_captions(64)]
    texts += [str(c) for c in read_csv(DEFAULT_CAPTIONS_CSV)["caption"]]
    return sorted(set(texts))


def vocab_tokens(texts: Sequence[str], rng: np.random.Generator,
                 size: int = VOCAB_SIZE) -> List[str]:
    """A BERT-shaped vocabulary of ``size`` lines: the special tokens at
    their ids, ``[unused<n>]`` around them, ASCII's printable characters
    and their ``##`` pieces, then each word of ``texts`` (lowercased and
    split as BERT's basic tokenizer splits) whole, as two pieces (``w[:k]``
    and ``##w[k:]``) or not at all (it then splits into characters), by
    thirds at random; ``[unused<n>]`` fills the rest."""
    from vlp_tpu_torch.data.tokenize import WordPieceTokenizer

    basic = WordPieceTokenizer(["[PAD]", "[UNK]", "[CLS]", "[SEP]"])
    tokens = [SPECIAL_IDS.get(i, f"[unused{i}]") for i in range(104)]
    chars = [chr(c) for c in range(33, 127) if not chr(c).isupper()]
    tokens += chars + ["##" + c for c in chars if c.isalnum()]
    words = sorted({w for t in texts for w in basic.words(t)})
    for word in words:
        pick = rng.integers(3)
        if pick == 0 or len(word) < 3:
            tokens.append(word)
        elif pick == 1:
            k = int(rng.integers(1, len(word)))
            tokens += [word[:k], "##" + word[k:]]
    seen, out = set(), []
    for t in tokens:
        if t not in seen:
            seen.add(t)
            out.append(t)
    out += [f"[unused{i}]" for i in range(len(out), size)]
    if len(out) != size:
        raise ValueError(f"{len(out)} tokens do not fit {size} lines")
    return out


def xrv_file_state(gen: torch.Generator, in_chans: int = 1,
                   classes: int = 18, prefix: str = "model."
                   ) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet50's state dict as torchxrayvision saves it
    (under ``prefix``), written from the layout's loops: convolutions
    N(0, 2/fan_in), BatchNorm weights U(0.5, 1), biases, running means
    N(0, 0.1), running variances U(0.5, 1.5), ``num_batches_tracked``, and
    an ``fc`` of ``classes`` outputs."""
    sd = {}

    def conv(key, cin, cout, k):
        sd[f"{key}.weight"] = torch.randn(cout, cin, k, k, generator=gen) \
            * (2.0 / (cin * k * k)) ** 0.5

    def bn(key, c):
        sd[f"{key}.weight"] = 0.5 + 0.5 * torch.rand(c, generator=gen)
        sd[f"{key}.bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{key}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{key}.running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(1000)

    conv("conv1", in_chans, 64, 7)
    bn("bn1", 64)
    cin = 64
    for stage, blocks in enumerate((3, 4, 6, 3)):
        planes = 64 * 2 ** stage
        for b in range(blocks):
            pre = f"layer{stage + 1}.{b}"
            conv(f"{pre}.conv1", cin, planes, 1)
            bn(f"{pre}.bn1", planes)
            conv(f"{pre}.conv2", planes, planes, 3)
            bn(f"{pre}.bn2", planes)
            conv(f"{pre}.conv3", planes, 4 * planes, 1)
            bn(f"{pre}.bn3", 4 * planes)
            if b == 0:
                conv(f"{pre}.downsample.0", cin, 4 * planes, 1)
                bn(f"{pre}.downsample.1", 4 * planes)
            cin = 4 * planes
    sd["fc.weight"] = torch.randn(classes, cin, generator=gen) * cin ** -0.5
    sd["fc.bias"] = torch.zeros(classes)
    return {prefix + k: v for k, v in sd.items()}


def write_files(root: Path) -> dict:
    """Every file of the phase under ``root`` (see the module docstring).
    Returns the paths, the HF base states and the xrv state."""
    from vlp_tpu_torch.models.bert import TEXT_CONFIGS

    gen = torch.Generator().manual_seed(SEED)
    vocab = vocab_tokens(caption_texts(), np.random.default_rng(SEED))
    cache = root / "hf_hub"
    out = {"cache": cache, "base": {}, "snapshots": {}}
    for key, repo, layout, weights in (
            ("distilbert", DISTILBERT_REPO, "distilbert", "model.safetensors"),
            ("tinybert", TINYBERT_REPO, "bert", "pytorch_model.bin")):
        c = TEXT_CONFIGS[key]
        dims = (c.hidden_size, c.num_layers, c.intermediate_size,
                c.vocab_size, c.max_position)
        base = hf_base_state(layout, *dims, gen)
        out["base"][key] = base
        config = hf_config(layout, c.hidden_size, c.num_layers, c.num_heads,
                           c.intermediate_size, c.vocab_size, c.max_position)
        out["snapshots"][key] = stage_hf_repo(cache, repo, {
            "config.json": config,
            weights: hf_file_state(layout, base, gen),
            "vocab.txt": vocab,
            "tokenizer_config.json": {"do_lower_case": True}})
    # the refusal's cache: the TinyBERT weights without a vocab.txt
    bare = root / "hf_hub_no_vocab"
    src = out["snapshots"]["tinybert"]
    stage_hf_repo(bare, TINYBERT_REPO, {
        "config.json": json.loads((src / "config.json").read_text())})
    os.symlink(src / "pytorch_model.bin",
               bare / ("models--" + TINYBERT_REPO.replace("/", "--"))
               / "snapshots" / REVISION / "pytorch_model.bin")
    out["bare_cache"] = bare
    out["vocab"] = out["snapshots"]["distilbert"] / "vocab.txt"
    out["xrv_state"] = xrv_file_state(gen)
    out["xrv"] = root / "xrv_resnet50.pt"
    torch.save(out["xrv_state"], out["xrv"])
    out["xrv_bad"] = root / "xrv_resnet50_3ch.pt"
    torch.save(xrv_file_state(gen, in_chans=3), out["xrv_bad"])
    return out


# --------------------------------------------------------------------------
# the expected states, from the files' tensors
# --------------------------------------------------------------------------

def expected_text_state(base: Dict[str, torch.Tensor], layout: str,
                        layers: int) -> Dict[str, torch.Tensor]:
    """The port's ``BertEncoder`` state of an HF base state: a ``Dense``
    holds ``Linear``'s weight transposed, ``qkv`` the rows of q, k and v
    stacked and transposed."""
    emb = {"word_embeddings.weight": "embeddings.word_embeddings.weight",
           "position_embeddings.weight":
               "embeddings.position_embeddings.weight",
           "token_type_embeddings.weight":
               "embeddings.token_type_embeddings.weight",
           "embed_ln.weight": "embeddings.LayerNorm.weight",
           "embed_ln.bias": "embeddings.LayerNorm.bias"}
    out = {k: base[v] for k, v in emb.items() if v in base}
    stack, names = HF_NAMES[layout]
    q, k, v, o, attn_ln, lin1, lin2, ffn_ln = names
    for i in range(layers):
        src, dst = f"{stack}.{i}", f"layers.{i}"
        out[f"{dst}.attn.qkv.weight"] = torch.cat(
            [base[f"{src}.{n}.weight"] for n in (q, k, v)]).T
        out[f"{dst}.attn.qkv.bias"] = torch.cat(
            [base[f"{src}.{n}.bias"] for n in (q, k, v)])
        for mine, theirs in (("attn.out", o), ("ffn_in", lin1),
                             ("ffn_out", lin2)):
            out[f"{dst}.{mine}.weight"] = base[f"{src}.{theirs}.weight"].T
            out[f"{dst}.{mine}.bias"] = base[f"{src}.{theirs}.bias"]
        for mine, theirs in (("attn_ln", attn_ln), ("ffn_ln", ffn_ln)):
            for leaf in ("weight", "bias"):
                out[f"{dst}.{mine}.{leaf}"] = base[f"{src}.{theirs}.{leaf}"]
    return out


def expected_backbone_state(xrv: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """The port's ResNet50 backbone state of an xrv file's tensors."""
    out = {}
    for key, value in xrv.items():
        key = key[len("model."):]
        if key.startswith("fc.") or key.endswith("num_batches_tracked"):
            continue
        parts = key.split(".")
        if parts[0] in ("conv1", "bn1"):
            parts[0] = "stem_conv" if parts[0] == "conv1" else "stem_bn"
        else:
            parts = ["stages", str(int(parts[0][5:]) - 1)] + parts[1:]
            if parts[3] == "downsample":
                parts[3:5] = ["ds_conv" if parts[4] == "0" else "ds_bn"]
        out[".".join(parts)] = value
    return out


def _bit_equal(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               what: str) -> None:
    import chip_smoke as cs

    cs.check(set(got) == set(want),
             f"{what}: keys {sorted(set(got) ^ set(want))[:4]} differ")
    bad = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
    cs.check(not bad, f"{what}: {len(bad)} tensors differ, e.g. {bad[:3]}")


# --------------------------------------------------------------------------
# the runs
# --------------------------------------------------------------------------

class _Hooks:
    """Wraps driver functions and the data module's tokenization for one
    run; each wrapper records what the run did and checks it there."""

    def __init__(self):
        self.saved = []

    def wrap(self, owner, name, make):
        orig = getattr(owner, name)
        self.saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)


def _main(argv) -> tuple:
    """``driver.main(argv)`` in this process, the launch counts set to 0
    just before it and read just after; (launches, seconds, peak bytes)."""
    import chip_smoke as cs
    from vlp_tpu_torch.train import driver

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cs._reset_counts()
    t0 = time.perf_counter()
    cs.check(driver.main(list(argv)) == 0, f"weights: {argv} failed")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return ({k: v for k, v in cs._counts().items() if v}, seconds,
            torch.cuda.max_memory_allocated())


def _time_steps(trainer, events: list) -> None:
    """Wraps ``trainer.train_step`` to record a pair of CUDA events around
    each call (no synchronisation inside the run)."""
    step = trainer.train_step

    def timed(state, batch):
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        out = step(state, batch)
        pair[1].record()
        events.append(pair)
        return out

    trainer.train_step = timed


def _step_ms(events: list) -> float:
    """The median step after the first (its warm-up), by the events."""
    times = [a.elapsed_time(b) for a, b in events[1:]]
    return float(np.median(times)) if times else float("nan")


def _text_vs_cpu(model, ids: np.ndarray, mask: np.ndarray, key: str,
                 state: Dict[str, torch.Tensor]) -> float:
    """The text tower's CLS embeddings of ``EMB_ROWS`` captions on the card
    against an fp32 CPU tower holding ``state``; the error as a share of
    the largest |value|."""
    from vlp_tpu_torch.models.bert import TEXT_CONFIGS, BertEncoder

    tower = model.text_encoder
    ids_t, mask_t = (torch.from_numpy(a[:EMB_ROWS]).long() for a in (ids,
                                                                     mask))
    with torch.no_grad():
        got = tower(ids_t.cuda(), mask_t.cuda()).float().cpu()
        ref_tower = BertEncoder(TEXT_CONFIGS[key], torch.float32)
        ref_tower.load_state_dict(state)
        ref = ref_tower(ids_t, mask_t)
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _pretrain(smi: str, root: Path, files: dict, tag: str, experiment: str,
              key: str) -> dict:
    import chip_smoke as cs
    from vlp_tpu_torch.data import datamodule, tokenize
    from vlp_tpu_torch.models.bert import TEXT_CONFIGS
    from vlp_tpu_torch.train import driver

    layout = "distilbert" if key == "distilbert" else "bert"
    want = expected_text_state(files["base"][key], layout,
                               TEXT_CONFIGS[key].num_layers)
    seen, events = {}, []

    def record_tokens(orig):
        def tokenize_all(samples, name, max_length=40):
            out = orig(samples, name, max_length)
            texts = [str(s["caption"]) for split in samples.values()
                     for s in split]
            seen.setdefault("tokens", (texts, out, max_length))
            return out
        return tokenize_all

    def checked_load(orig):
        def load(cfg, trainer):
            orig(cfg, trainer)
            model = trainer.state.model
            got = {k: v.detach().cpu().clone()
                   for k, v in model.text_encoder.state_dict().items()}
            _bit_equal(got, want, f"{tag}: the text tower after the import")
            texts, out, _ = seen["tokens"]
            ids, mask = out["train"]
            seen["emb"] = _text_vs_cpu(model, ids, mask, key, want)
            _time_steps(trainer, events)
        return load

    out = root / f"weights_{key}"
    argv = ["--device", "cuda", f"experiment={experiment}",
            "data.name=synthetic_pretrain",
            f"data.synthetic_num_samples={SAMPLES}", "trainer.max_epochs=1",
            "trainer.save_last=false", f"output_dir={out}"]
    with _Hooks() as hooks:
        hooks.wrap(datamodule, "tokenize_all_captions", record_tokens)
        hooks.wrap(driver, "_maybe_load_pretrained_text_tower", checked_load)
        launches, seconds, peak = _main(argv)
    cs.check("emb" in seen, f"{tag}: the text tower was not imported")
    texts, tokens, length = seen["tokens"]
    wordpiece = tokenize.WordPieceTokenizer(str(files["vocab"]))
    ids = np.concatenate([tokens[s][0] for s in tokens])
    mask = np.concatenate([tokens[s][1] for s in tokens])
    want_ids, want_mask = wordpiece(texts, length)
    hash_ids, _ = tokenize.HashTokenizer()(texts, length)
    cs.check(np.array_equal(ids, want_ids) and np.array_equal(mask,
                                                              want_mask),
             f"{tag}: the run's caption ids differ from WordPiece's")
    cs.check(not np.array_equal(ids, hash_ids),
             f"{tag}: the run's caption ids are the hash tokenizer's")
    pieces = {i for t, i in wordpiece.vocab.items() if t.startswith("##")}
    n_pieces = int(np.isin(ids[mask > 0], list(pieces)).sum())
    n_unk = int((ids[mask > 0] == wordpiece.unk_id).sum())
    cs.check(n_pieces > 0, f"{tag}: no ## piece among the caption ids")
    cs.check(seen["emb"] <= cs.BOUND_EMB,
             f"{tag}: CLS embeddings {seen['emb']:.4g} of the largest "
             f"|value| from fp32 on the CPU (bound {cs.BOUND_EMB})")
    (rec,) = cs._records(out, 0)
    steps = rec["_step"]
    cs._augment_launches(launches, steps, tag)
    print(f"weights {tag} {experiment}: 1 epoch, {steps} train steps in "
          f"{seconds:.1f} s, launches {launches}; {len(texts)} captions "
          f"tokenized by WordPiece ({n_pieces} ## pieces, {n_unk} [UNK] "
          f"among {int(mask.sum())} tokens; ids equal the CPU tokenizer's, "
          f"not the hash tokenizer's); the text tower bit-equal to the "
          f"file's tensors after the import; CLS embeddings bf16 on the card"
          f" vs fp32 on the CPU ({EMB_ROWS} captions): {seen['emb']:.6g} of"
          f" the largest |value| (bound {cs.BOUND_EMB}); "
          f"{_rates(events, 128, rec, peak)}; "
          f"{cs._epoch_split(out, 1, seconds)}; on {smi}")
    return launches


def _rates(events: list, batch: int, rec: dict, peak: int) -> str:
    ms = _step_ms(events)
    return (f"a step {ms:.2f} ms by CUDA events (median of steps 1-"
            f"{len(events) - 1}; {batch / ms * 1e3:.1f} images/s), epoch 0 "
            f"{rec['train/images_per_sec']:.1f} images/s with step 0's "
            f"warm-up, peak memory {peak / 2 ** 30:.2f} GiB")


def _backbone_state(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone()
            for k, v in model.backbone.state_dict().items()}


def _xrv(smi: str, root: Path, files: dict) -> dict:
    import chip_smoke as cs
    from vlp_tpu_torch.models import resnet
    from vlp_tpu_torch.train import driver

    want = expected_backbone_state(files["xrv_state"])
    seen, events, messages = {}, [], []

    class Catch(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    def checked_warm(orig):
        def warm(cfg, trainer):
            model = trainer.state.model
            init = _backbone_state(model)
            head = {k: v.detach().cpu().clone()
                    for k, v in model.head.state_dict().items()}
            os.environ["XRV_WEIGHTS_PATH"] = str(files["xrv_bad"])
            orig(cfg, trainer)
            seen["bad_kept_init"] = all(
                torch.equal(a, init[k]) for k, a in
                _backbone_state(model).items())
            seen["warned"] = [m for m in messages if "random init" in m]
            os.environ["XRV_WEIGHTS_PATH"] = str(files["xrv"])
            orig(cfg, trainer)
            _bit_equal(_backbone_state(model), want,
                       "29c: the backbone after the import")
            seen["head_kept"] = all(torch.equal(v.cpu(), head[k]) for k, v
                                    in model.head.state_dict().items())
            x = torch.randn(FEATURE_IMAGES, 224, 224, 1,
                            generator=torch.Generator().manual_seed(SEED))
            backbone, mode = model.backbone, model.backbone.training
            backbone.eval()
            ref = resnet.resnet50(in_chans=1, dtype=torch.float32)
            ref.load_state_dict(want)
            ref.eval()
            with torch.no_grad():
                got = backbone.forward_features(x.cuda()).float().cpu()
                feats = ref.forward_features(x)
            backbone.train(mode)
            seen["feat_err"] = (got - feats).abs().max().item()
            seen["feat_bound"] = cs.BOUND_LOGITS * max(
                1.0, feats.abs().max().item())
            _time_steps(trainer, events)
        return warm

    out = root / "weights_xrv"
    argv = ["--device", "cuda", f"experiment={XRV_EXPERIMENT}",
            "data.name=synthetic_downstream",
            f"data.synthetic_num_samples={SAMPLES}", "trainer.max_epochs=1",
            "k_fold_cross_validation=false", "trainer.save_last=false",
            f"output_dir={out}"]
    logger = logging.getLogger("vlp_tpu_torch.models.torch_import")
    catch = Catch(logging.WARNING)
    logger.addHandler(catch)
    try:
        with _Hooks() as hooks:
            hooks.wrap(driver, "_maybe_warm_start", checked_warm)
            launches, seconds, peak = _main(argv)
    finally:
        logger.removeHandler(catch)
        os.environ.pop("XRV_WEIGHTS_PATH", None)
    cs.check("feat_err" in seen, "29c: the xrv weights were not imported")
    cs.check(seen["bad_kept_init"] and len(seen["warned"]) == 1,
             f"29c: the 3-channel file: init kept {seen['bad_kept_init']}, "
             f"warnings {seen['warned']}")
    cs.check(seen["head_kept"], "29c: the head changed in the import")
    cs.check(seen["feat_err"] <= seen["feat_bound"],
             f"29c: eval features {seen['feat_err']:.4g} from fp32 on the "
             f"CPU (bound {seen['feat_bound']:.4g})")
    (rec,) = cs._records(out, 0)
    steps = rec["_step"]
    cs._augment_launches(launches, steps, "29c")
    print(f"weights 29c {XRV_EXPERIMENT}: the 3-channel file warned "
          f"({seen['warned'][0][:60]}...) and left the backbone at its "
          f"init; XRV_WEIGHTS_PATH's file loaded: {len(want)} backbone "
          f"tensors bit-equal to the file's, the head at its init; eval "
          f"features bf16 on the card vs fp32 on the CPU ({FEATURE_IMAGES} "
          f"images, 224, 1 channel): max_abs {seen['feat_err']:.6g} (bound "
          f"{seen['feat_bound']:.6g}); 1 fold, {steps} train steps in "
          f"{seconds:.1f} s, launches {launches}; "
          f"{_rates(events, 32, rec, peak)}; "
          f"{cs._epoch_split(out, 1, seconds)}; on {smi}")
    return launches


def _start_refusal(root: Path, files: dict):
    """29d, started in the background: the command line with the TinyBERT
    weights but no ``vocab.txt`` in the hub cache (small images: it stops
    before the first step)."""
    import chip_smoke as cs

    env = dict(os.environ, HF_HUB_CACHE=str(files["bare_cache"]))
    repo = Path(cs.__file__).resolve().parent
    env["PYTHONPATH"] = os.pathsep.join(
        [str(repo)] + [p for p in [env.get("PYTHONPATH")] if p])
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "vlp_tpu_torch.train", "--device", "cuda",
         "experiment=pretrain_resnet18_tinybert",
         "data.name=synthetic_pretrain", "data.synthetic_num_samples=160",
         "downstream_data.synthetic_num_samples=160", "data.image_size=64",
         "downstream_data.image_size=64",
         f"output_dir={root / 'weights_refusal'}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish_refusal(started) -> None:
    import chip_smoke as cs

    t0, proc = started
    try:
        _, err = proc.communicate(timeout=REFUSAL_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    lines = [line for line in err.splitlines() if line.strip()]
    cs.check(proc.returncode != 0 and any(
        line.startswith("RuntimeError") and REFUSAL_TEXT in line
        for line in lines), f"29d: exit {proc.returncode}, stderr "
        f"{err[-600:]}")
    print(f"weights 29d: weights staged without vocab.txt: the command line "
          f"exited {proc.returncode} after {seconds:.1f} s (beside 29a-29c)"
          f" with {lines[-1][:90]!r}...")


def phase_weights(smi: str, root: Path, stats: dict) -> dict:
    """Phase 29. Returns the launches of each training run."""
    del stats  # #11/#12 at these shapes: phases 3/5 and 21 hold them
    import chip_smoke as cs
    from vlp_tpu_torch.data import tokenize

    t0 = time.perf_counter()
    cs._quiet_trainer_logs()
    files = write_files(root / "weights")
    t_write = time.perf_counter() - t0
    print(f"weights: wrote an HF hub cache ({DISTILBERT_REPO}: "
          f"model.safetensors; {TINYBERT_REPO}: pytorch_model.bin; a "
          f"{VOCAB_SIZE}-line vocab.txt), the xrv ResNet50 and its 3-channel"
          f" twin in {t_write:.1f} s")
    refusal = _start_refusal(root, files)
    saved = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = str(files["cache"])
    paths = {}
    try:
        for tag, experiment, key in PRETRAINS:
            paths[f"weights_{key}_trainer"] = _pretrain(
                smi, root, files, tag, experiment, key)
    finally:
        if saved is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = saved
        tokenize._TOKENIZER_CACHE.clear()
    paths["weights_xrv_trainer"] = _xrv(smi, root, files)
    _finish_refusal(refusal)
    print(f"phase 29: {time.perf_counter() - t0:.1f} s")
    return paths
