"""The port's text side against the JAX package: the hash tokenizer
(``vlp_tpu_torch/data/tokenize.py``), the text towers
(``vlp_tpu_torch/models/bert.py``) on converted weights, and the flax
initializers' scales of the dual tower's parameters (``flax_init_``).

Inputs come from numpy seeds; JAX runs on the CPU. Tolerances:
- tokenizer: equal ids and masks.
- ``BertEncoder`` in fp32 against the flax module (perturbed weights,
  ragged masks, one all-zero row): 1e-5 of the largest |CLS value|; the
  same arithmetic, summed in other orders (the port packs q|k|v into one
  product and runs SDPA's math on the CPU, flax three products and two
  einsums).
- in bf16 against flax bf16: 2^-5 of the largest |value|. Both round at
  the same points (q, k, v, q / sqrt(hd), the scores, the softmax, o, the
  out product, x + y, gelu, the FFN products; each <= 2^-9 relative); a
  summation-order difference can flip one rounding, and the post-LN
  LayerNorms re-normalise what passes through: a few bf16 ulps per layer
  over two layers (microbert) or one (the cut towers).
- initial scales: a parameter's standard deviation within 5% of the flax
  initializer's draw of the same shape (the smallest tensor compared has
  4096 elements: the sample std's relative error is ~1/sqrt(2 n) < 1.2%,
  four of them under 5%); constants equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.data import tokenize as jtok
from vlp_tpu.models import bert as jbert
from vlp_tpu.models.vlm import VisionLanguageModel as JVLM
from vlp_tpu_torch import convert
from vlp_tpu_torch.data import tokenize as ttok
from vlp_tpu_torch.models import bert as tbert
from vlp_tpu_torch.models.vit import flax_init_
from vlp_tpu_torch.models.vlm import VisionLanguageModel

FP32_REL = 1e-5
BF16_REL = 2.0 ** -5
INIT_REL = 0.05

CAPTIONS = [
    "Osteosarcoma of the distal FEMUR, lateral view.",
    "",
    "Giant-cell tumour; proximal tibia (AP)!!",
    "a " * 60,
    "MIXED Case: 12 cm lesion, 3/4 of the shaft...",
    "   ",
    "ünïcode wörds and 100% noise",
]


@pytest.mark.parametrize("max_length", [2, 5, 16, 40])
@pytest.mark.parametrize("vocab", [30522, 1200])
def test_hash_tokenizer_matches_jax(max_length, vocab):
    ids, mask = ttok.HashTokenizer(vocab)(CAPTIONS, max_length)
    want_ids, want_mask = jtok.HashTokenizer(vocab)(CAPTIONS, max_length)
    assert ids.dtype == np.int32 and mask.dtype == np.int32
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    # an empty caption is [CLS] [SEP]; a long one is truncated to
    # max_length and still ends in [SEP]
    assert list(ids[1, :2]) == [ttok.CLS_ID, ttok.SEP_ID]
    assert mask[3].all() and ids[3, -1] == ttok.SEP_ID
    assert (ttok.CLS_ID, ttok.SEP_ID, ttok.PAD_ID, ttok.UNK_ID) == (
        jtok.CLS_ID, jtok.SEP_ID, jtok.PAD_ID, jtok.UNK_ID)


def test_tokenize_all_captions_shares_one_padding_over_the_splits():
    samples = {"train": [{"caption": c} for c in CAPTIONS[:4]],
               "val": [{"caption": c} for c in CAPTIONS[4:]]}
    out = ttok.tokenize_all_captions(samples, "tinybert", max_length=24)
    ids, mask = jtok.HashTokenizer()(CAPTIONS, 24)
    assert isinstance(ttok.get_tokenizer("distilbert"), ttok.HashTokenizer)
    np.testing.assert_array_equal(out["train"][0], ids[:4])
    np.testing.assert_array_equal(out["val"][1], mask[4:])


def _text_cfg(name, layers):
    cfg = jbert.TEXT_CONFIGS[name]
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def _inputs(seed, vocab, b=5, length=12):
    """Ids and ragged masks; row 3 is all zeros, row 0 all ones."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(999, vocab, (b, length)).astype(np.int32)
    lens = np.array([length, 3, 7, 0, 1])[:b]
    mask = (np.arange(length)[None] < lens[:, None]).astype(np.int32)
    return ids, mask


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            p.shape).astype(np.float32), jax.device_get(tree))


@pytest.mark.parametrize("name,layers", [("microbert", None),
                                         ("tinybert", 1),
                                         ("distilbert", 1)])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_bert_encoder_matches_flax(name, layers, precision):
    jdt, tdt, rel = {"fp32": (jnp.float32, torch.float32, FP32_REL),
                     "bf16": (jnp.bfloat16, torch.bfloat16, BF16_REL)}[
        precision]
    cfg = _text_cfg(name, layers)
    ids, mask = _inputs(0, cfg.vocab_size)
    jm = jbert.BertEncoder(cfg, dtype=jdt)
    variables = _perturbed(jm.init(jax.random.key(0), jnp.asarray(ids),
                                   jnp.asarray(mask)), 1)
    want = np.asarray(jm.apply(variables, jnp.asarray(ids),
                               jnp.asarray(mask)), np.float32)
    tcfg = dataclasses.replace(tbert.TEXT_CONFIGS[name],
                               num_layers=cfg.num_layers)
    model = tbert.BertEncoder(tcfg, tdt)
    convert.load_weights(model, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (5, cfg.hidden_size)
    assert torch.isfinite(got).all()  # row 3's mask is all zeros
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= rel, err


def test_all_zero_mask_row_is_flax_uniform_average():
    """A row with no valid key: flax fills every score with finfo.min, so
    its softmax is uniform over all keys; the port's zero bias row and zero
    q give the same average (a boolean SDPA mask would give NaN or 0), and
    a partly padded row keeps flax's fill on its padded keys."""
    cfg = _text_cfg("microbert", None)
    ids, mask = _inputs(2, cfg.vocab_size)
    mask[:] = 0
    jm = jbert.BertEncoder(cfg, dtype=jnp.float32)
    variables = _perturbed(jm.init(jax.random.key(1), jnp.asarray(ids),
                                   jnp.asarray(mask)), 3)
    want = np.asarray(jm.apply(variables, jnp.asarray(ids),
                               jnp.asarray(mask)))
    model = tbert.BertEncoder(tbert.MICROBERT, torch.float32)
    convert.load_weights(model, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FP32_REL * np.abs(want).max())
    # the attention of such a row is the plain mean of the values
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(5, 2, 12, 32, generator=gen) for _ in range(3))
    for dtype in (torch.float32, torch.bfloat16):
        bias, live = tbert.padding_bias(torch.from_numpy(mask), dtype)
        assert bias.shape == (5, 1, 1, 12) and live.shape == (5, 1, 1, 1)
        assert not bias.any() and not live.any()
        o = torch.nn.functional.scaled_dot_product_attention(
            q.to(dtype) * live, k.to(dtype), v.to(dtype), attn_mask=bias)
        mean = v.to(dtype).float().mean(2, keepdim=True).expand_as(o)
        tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
        assert (o.float() - mean).abs().max().item() <= tol
    bias, live = tbert.padding_bias(torch.tensor([[1, 1, 0], [0, 0, 0]]),
                                    torch.float32)
    assert bias.flatten().tolist() == [0, 0, torch.finfo(torch.float32).min,
                                       0, 0, 0]
    assert live.flatten().tolist() == [1, 0]


def _flax_leaves(tree):
    return {convert.torch_key("params/" + k): np.asarray(v)
            for k, v in convert.pack_qkv(convert.flatten(
                jax.device_get(tree))).items()}


@pytest.mark.parametrize("text_model", ["tinybert", "microbert"])
def test_flax_init_scales_of_the_dual_tower(text_model):
    """Embedding tables N(0, 1/D), the packed q|k|v kernel lecun-normal
    over D, the out kernel over H * hd, the projections N(0, d^-1/2),
    logit_scale its init: each against the flax module's own initial
    draw."""
    jm = JVLM(image_model="resnet_micro", text_model=text_model,
              embedding_dim=96, logit_scale_init=2.5, dtype=jnp.float32)
    ids, mask = _inputs(0, 1000, b=2, length=8)
    jv = jm.init({"params": jax.random.key(0)},
                 jnp.zeros((2, 16, 16, 3)), jnp.asarray(ids),
                 jnp.asarray(mask))
    want = _flax_leaves(jv["params"])
    model = VisionLanguageModel("resnet_micro", text_model, 96,
                                logit_scale_init=2.5, dtype=torch.float32)
    flax_init_(model, torch.Generator().manual_seed(0))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    assert got["logit_scale"].item() == pytest.approx(2.5) == float(
        want["logit_scale"])
    checked = 0
    for name, p in got.items():
        w = want[name].reshape(tuple(p.shape))
        if w.std() == 0:
            np.testing.assert_array_equal(p.detach().numpy(), w, name)
        elif p.numel() >= 4096:
            assert p.detach().std().item() == pytest.approx(
                float(w.std()), rel=INIT_REL), name
            assert abs(p.detach().mean().item()) < 0.1 * w.std(), name
            checked += 1
    new = [n for n in got if n.startswith("text_encoder") or "projection"
           in n]
    assert checked >= 8 and new
