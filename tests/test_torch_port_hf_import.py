"""The port's HF text-tower import (``vlp_tpu_torch/utils/hf_files.py``,
``models/bert.load_hf_weights`` and the driver's text-tower warm start)
against ``huggingface_hub``, ``safetensors``, ``transformers`` and the JAX
package's converters, on checkpoints written from seeds
(``chip_smoke_weights``' writers: the HF hub cache layout, ``config.json``,
``model.safetensors`` and ``pytorch_model.bin`` with the prefixes,
TensorFlow's ``gamma``/``beta`` names and the pretraining heads a real
checkpoint holds).

Tolerances:
- the cache lookup, the safetensors reader and the converted state dicts:
  equal (bit for bit: the import only transposes, concatenates and
  renames).
- the fp32 forward against the flax ``BertEncoder`` and against
  ``transformers``' ``BertModel``/``DistilBertModel`` (``last_hidden_state
  [:, 0]``): 1e-5 of the largest |CLS value|, ``test_torch_port_text.py``'s
  bound (the same arithmetic summed in other orders).
"""
import contextlib
import dataclasses
import json
import logging
import os
import subprocess
import sys
import types

# no HF code path may reach for the network, and transformers loads its
# PyTorch side only (all read at their import)
HF_OFFLINE = {"HF_HUB_OFFLINE": "1", "TRANSFORMERS_OFFLINE": "1",
              "HF_HUB_DISABLE_TELEMETRY": "1", "USE_TF": "0",
              "USE_FLAX": "0", "USE_TORCH": "1"}
os.environ.update(HF_OFFLINE)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke_weights as W
from vlp_tpu.models import bert as jbert
from vlp_tpu_torch import convert
from vlp_tpu_torch.config import TrainConfig, apply_overrides, get_experiment
from vlp_tpu_torch.data import tokenize as ttok
from vlp_tpu_torch.models import bert as tbert
from vlp_tpu_torch.models.tasks import TaskStatics, build_task
from vlp_tpu_torch.models.vit import flax_init_
from vlp_tpu_torch.train import driver
from vlp_tpu_torch.train.setup import MEAN, STD
from vlp_tpu_torch.utils import hf_files

from torch_parallel_workers import hf_text_tower_worker, run_ranks

FP32_REL = 1e-5
# the towers at a reduced width: full layer counts and 12 heads
SMALL = dict(hidden_size=48, intermediate_size=96, vocab_size=512,
             max_position=64)
HF_ENV = ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE", "HF_HOME",
          "XDG_CACHE_HOME")
REPOS = {"distilbert": W.DISTILBERT_REPO, "tinybert": W.TINYBERT_REPO}
WEIGHTS = {"distilbert": "model.safetensors", "tinybert": "pytorch_model.bin"}


def _layout(key):
    return "distilbert" if key == "distilbert" else "bert"


def _stage(cache, key, seed=0, vocab=True, **dims):
    """``key``'s checkpoint in the hub cache ``cache`` at ``dims`` (default
    ``SMALL``); returns its HF base state."""
    c = dataclasses.replace(tbert.TEXT_CONFIGS[key], **(dims or SMALL))
    gen = torch.Generator().manual_seed(seed)
    layout = _layout(key)
    base = W.hf_base_state(layout, c.hidden_size, c.num_layers,
                           c.intermediate_size, c.vocab_size, c.max_position,
                           gen)
    files = {"config.json": W.hf_config(
                 layout, c.hidden_size, c.num_layers, c.num_heads,
                 c.intermediate_size, c.vocab_size, c.max_position),
             WEIGHTS[key]: W.hf_file_state(layout, base, gen)}
    if vocab:
        files["vocab.txt"] = [W.SPECIAL_IDS.get(i, f"[unused{i}]")
                              for i in range(104)] + list("abcdefgh")
    W.stage_hf_repo(cache, REPOS[key], files)
    return base


@contextlib.contextmanager
def _captured(name):
    """The records the port's logger ``name`` emits (its loggers do not
    propagate to the root, where caplog listens)."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger(name)
    logger.addHandler(handler)
    try:
        yield records
    finally:
        logger.removeHandler(handler)


@pytest.fixture
def hub(tmp_path, monkeypatch):
    """An empty hub cache as ``HF_HUB_CACHE`` (and as ``huggingface_hub``'s
    constant, offline, whenever it was imported); no tokenizer cached."""
    import huggingface_hub.constants

    for key in HF_ENV:
        monkeypatch.delenv(key, raising=False)
    cache = tmp_path / "hub"
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_CACHE",
                        str(cache))
    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(ttok, "_TOKENIZER_CACHE", {})
    return cache


@pytest.fixture
def offline_hf(hub, monkeypatch):
    """``hub``, with ``transformers`` offline and on that cache too (it
    reads both once, at its import, which another test may have done)."""
    import transformers.utils.hub

    monkeypatch.setattr(transformers.utils.hub, "_is_offline_mode", True)
    monkeypatch.setattr(transformers.utils.hub, "TRANSFORMERS_CACHE",
                        str(hub))
    return hub


# --------------------------------------------------------------------------
# the hub cache
# --------------------------------------------------------------------------

ENV_CASES = [
    {},
    {"XDG_CACHE_HOME": "{tmp}/xdg"},
    {"HF_HOME": "{tmp}/home", "XDG_CACHE_HOME": "{tmp}/xdg"},
    {"HUGGINGFACE_HUB_CACHE": "{tmp}/legacy", "HF_HOME": "{tmp}/home"},
    {"HF_HUB_CACHE": "{tmp}/hub", "HUGGINGFACE_HUB_CACHE": "{tmp}/legacy",
     "HF_HOME": "{tmp}/home"},
    {"HF_HOME": "~/hf_home"},
    {"HF_HUB_CACHE": "$VLP_TEST_ROOT/expanded", "VLP_TEST_ROOT": "{tmp}"},
]


def test_hub_cache_root_follows_huggingface_hubs_precedence(tmp_path,
                                                            monkeypatch):
    """``huggingface_hub.constants.HF_HUB_CACHE`` as the module computes it
    at import (reloaded in a process of its own for each environment)
    against ``hub_cache_dir()`` read at call time."""
    cases = [{k: v.format(tmp=tmp_path) for k, v in c.items()}
             for c in ENV_CASES]
    code = (
        "import importlib, json, os, sys\n"
        "import huggingface_hub.constants as c\n"
        "out = []\n"
        f"for case in json.loads({json.dumps(json.dumps(cases))}):\n"
        f"    for k in {HF_ENV + ('VLP_TEST_ROOT',)!r}:\n"
        "        os.environ.pop(k, None)\n"
        "    os.environ.update(case)\n"
        "    out.append(importlib.reload(c).HF_HUB_CACHE)\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, check=True)
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = []
    for case in cases:
        for key in HF_ENV + ("VLP_TEST_ROOT",):
            monkeypatch.delenv(key, raising=False)
        for key, value in case.items():
            monkeypatch.setenv(key, value)
        got.append(hf_files.hub_cache_dir())
    assert got == want
    assert len(set(got)) == len(cases)


def test_cached_file_matches_try_to_load_from_cache(tmp_path):
    """Two revisions (``main`` and a ``v2`` ref), a commit named directly,
    a file only one snapshot has, a repo with no ``refs``, an absent
    repo."""
    from huggingface_hub import try_to_load_from_cache

    cache = tmp_path / "hub"
    first = W.stage_hf_repo(cache, W.TINYBERT_REPO, {
        "config.json": {"a": 1}, "vocab.txt": ["[PAD]"]}, revision="1" * 40)
    W.stage_hf_repo(cache, W.TINYBERT_REPO, {"config.json": {"a": 2}},
                    revision="2" * 40, ref="v2")
    bare = cache / "models--org--no-refs" / "snapshots" / ("3" * 40)
    bare.mkdir(parents=True)
    (bare / "config.json").write_text("{}")
    cases = [(W.TINYBERT_REPO, f, r) for f in ("config.json", "vocab.txt",
                                               "missing.bin")
             for r in (None, "main", "v2", "1" * 40, "2" * 40, "9" * 40)]
    cases += [("org/no-refs", "config.json", r) for r in (None, "3" * 40)]
    cases += [("org/absent", "config.json", None)]
    found = 0
    for repo, name, rev in cases:
        want = try_to_load_from_cache(repo, name, cache_dir=str(cache),
                                      revision=rev)
        want = want if isinstance(want, str) else None
        got = hf_files.cached_file(repo, name, revision=rev or "main",
                                   cache_dir=str(cache))
        assert got == want, (repo, name, rev)
        found += got is not None
    assert found == 9
    assert hf_files.snapshot_dir(W.TINYBERT_REPO, cache_dir=str(cache)) \
        == str(first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64])
def test_safetensors_reader_and_writer_match_the_library(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    gen = torch.Generator().manual_seed(3)
    tensors = {"w": torch.randn(7, 5, generator=gen),
               "b": torch.randn(5, generator=gen),
               "scalar": torch.randn((), generator=gen),
               "empty": torch.zeros(0, 3),
               "odd": torch.randn(3, 3, 3, generator=gen)}
    tensors = {k: (v * 100 if dtype == torch.int64 else v).to(dtype)
               for k, v in tensors.items()}
    save_file(tensors, str(tmp_path / "lib.safetensors"),
              metadata={"format": "pt"})
    ours = hf_files.read_safetensors(str(tmp_path / "lib.safetensors"))
    W.write_safetensors(tensors, str(tmp_path / "ours.safetensors"))
    theirs = load_file(str(tmp_path / "ours.safetensors"))
    for got in (ours, theirs):
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == dtype and got[k].shape == v.shape, k
            assert torch.equal(got[k], v), k


def test_base_model_state_drops_heads_and_renames(tmp_path):
    gen = torch.Generator().manual_seed(1)
    for layout, n_extra in (("distilbert", 6), ("bert", 8)):
        base = W.hf_base_state(layout, 24, 2, 48, 40, 16, gen)
        file = W.hf_file_state(layout, base, gen)
        assert len(file) == len(base) + n_extra
        got = hf_files.base_model_state(file)
        assert set(got) == set(base)
        assert all(got[k] is base[k] for k in base)


# --------------------------------------------------------------------------
# the converters
# --------------------------------------------------------------------------

def _jax_route(key, cfg):
    """The JAX package's own import: ``load_hf_weights`` (``transformers``'
    ``AutoModel.from_pretrained`` from the ``hub`` fixture's cache, then
    ``_convert_*``) into a flax ``BertEncoder`` of ``cfg``; (module,
    params)."""
    jm = jbert.BertEncoder(cfg, dtype=jnp.float32)
    ids = jnp.zeros((1, 4), jnp.int32)
    params = jm.init(jax.random.key(0), ids, jnp.ones_like(ids))["params"]
    converted = jbert.load_hf_weights(params, key)
    assert converted is not None
    return jm, converted


@pytest.mark.parametrize("key", ["distilbert", "tinybert"])
def test_import_is_bit_equal_to_the_jax_converters_and_forward_matches(
        offline_hf, key):
    """Both key layouts (safetensors under ``distilbert.`` with its MLM
    head; ``.bin`` under ``bert.`` with ``gamma``/``beta``, the pooler,
    ``position_ids`` and the ``cls.*`` heads): the port's state dict equals
    ``convert.state_dict_from_flax`` of the JAX route's params, and the fp32
    forwards agree."""
    _stage(offline_hf, key)
    jcfg = dataclasses.replace(jbert.TEXT_CONFIGS[key], **SMALL)
    tcfg = dataclasses.replace(tbert.TEXT_CONFIGS[key], **SMALL)
    jm, jparams = _jax_route(key, jcfg)
    model = tbert.BertEncoder(tcfg, torch.float32)
    state = tbert.load_hf_weights(model, key)
    want = convert.state_dict_from_flax({"params": jparams}, model)
    assert set(state) == set(want)
    for k in want:
        assert state[k].dtype == torch.float32
        assert torch.equal(state[k], want[k]), k
    model.load_state_dict(state)
    rng = np.random.default_rng(2)
    ids = rng.integers(104, SMALL["vocab_size"], (5, 12)).astype(np.int32)
    mask = (np.arange(12)[None] < np.array([12, 3, 7, 0, 1])[:, None]
            ).astype(np.int32)
    ref = np.asarray(jm.apply({"params": jparams}, jnp.asarray(ids),
                              jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    torch.from_numpy(mask)).numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= FP32_REL, err


@pytest.mark.parametrize("key,dims", [
    ("tinybert", {}),  # TinyBERT uncut: 4 x 312, vocab 30522
    ("distilbert", dict(hidden_size=312, intermediate_size=1200))])
def test_forward_matches_transformers(offline_hf, key, dims):
    """The port's fp32 tower from the cache against ``transformers``'
    model loaded from the same cache (``from_pretrained(...,
    local_files_only=True)``): the CLS row of ``last_hidden_state``."""
    from transformers import AutoModel

    hub = offline_hf
    _stage(hub, key, seed=5, **(dims or {"max_position": 512}))
    cfg = dataclasses.replace(tbert.TEXT_CONFIGS[key], **dims)
    model = tbert.BertEncoder(cfg, torch.float32)
    model.load_state_dict(tbert.load_hf_weights(model, key))
    hf = AutoModel.from_pretrained(REPOS[key], cache_dir=str(hub),
                                   local_files_only=True).eval()
    assert type(hf).__name__ == ("DistilBertModel" if key == "distilbert"
                                 else "BertModel")
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(rng.integers(104, cfg.vocab_size, (4, 24)))
    mask = (torch.arange(24)[None] < torch.tensor([24, 9, 2, 17])[:, None]
            ).long()
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state[:, 0]
        got = model(ids, mask)
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= FP32_REL, err


@pytest.mark.parametrize("key", ["distilbert", "tinybert"])
def test_converter_refuses_a_missing_key_a_wrong_shape_or_config(hub, key):
    base = _stage(hub, key)
    cfg = tbert.TEXT_CONFIGS[key]
    small = dataclasses.replace(cfg, **SMALL)
    model = tbert.BertEncoder(small, torch.float32)
    layout = _layout(key)
    state = dict(base)
    stack = tbert.HF_LAYOUTS[layout][0]
    del state[f"{stack}.2.{tbert.HF_LAYOUTS[layout][1]['v']}.bias"]
    with pytest.raises(KeyError, match="lacks"):
        tbert.convert_hf_state(state, cfg, layout, model)
    wide = tbert.BertEncoder(dataclasses.replace(small, hidden_size=60),
                             torch.float32)
    with pytest.raises(ValueError, match="shape"):
        tbert.load_hf_weights(wide, key)
    with pytest.raises(KeyError, match="does not fit"):
        tbert.load_hf_weights({"word_embeddings.weight": (512, 48)}, key)
    snap = hf_files.snapshot_dir(REPOS[key])
    config = json.loads(open(os.path.join(snap, "config.json")).read())
    config["n_heads" if layout == "distilbert" else
           "num_attention_heads"] = 8
    with open(os.path.join(snap, "config.json"), "w") as fh:
        json.dump(config, fh)
    with pytest.raises(ValueError, match="layers and heads"):
        tbert.load_hf_weights(model, key)


def test_absent_or_unreadable_files_warn_and_keep_random_init(hub):
    model = tbert.BertEncoder(dataclasses.replace(tbert.TINYBERT, **SMALL),
                              torch.float32)
    with _captured("vlp_tpu_torch.models.bert") as records:
        assert tbert.load_hf_weights(model, "tinybert") is None
        assert tbert.load_hf_weights(model, "microbert") is None
        _stage(hub, "distilbert")
        snap = hf_files.snapshot_dir(W.DISTILBERT_REPO)
        with open(os.path.join(snap, "model.safetensors"), "wb") as fh:
            fh.write(b"\x10\x00\x00\x00\x00\x00\x00\x00{not json}")
        assert tbert.load_hf_weights(model, "distilbert") is None
    msgs = [r.getMessage() for r in records]
    assert [r.levelno for r in records] == [logging.WARNING] * 3
    assert W.TINYBERT_REPO in msgs[0] and str(hub) in msgs[0]
    assert "microbert" in msgs[1]
    assert W.DISTILBERT_REPO in msgs[2] and "JSONDecodeError" in msgs[2]


# --------------------------------------------------------------------------
# the driver's text-tower warm start
# --------------------------------------------------------------------------

def _vlp(monkeypatch, key):
    """A VLP task (ResNet micro + ``key`` at ``SMALL``) on the CPU, and a
    trainer-shaped holder of its model."""
    monkeypatch.setitem(tbert.TEXT_CONFIGS, key, dataclasses.replace(
        tbert.TEXT_CONFIGS[key], **SMALL))
    cfg = apply_overrides(get_experiment("smoke_synthetic_pretrain"), [
        "model.model=resnet_micro", f"model.text_model={key}",
        f"data.tokenizer={key}", "data.image_size=32"])
    task = build_task(TrainConfig.from_config(cfg),
                      TaskStatics(mean=MEAN, std=STD), torch.device("cpu"))
    flax_init_(task.model, torch.Generator().manual_seed(0))
    trainer = types.SimpleNamespace(state=types.SimpleNamespace(
        model=task.model))
    return cfg, trainer


def _snapshot(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("key", ["distilbert", "tinybert"])
def test_driver_loads_the_text_tower_and_nothing_else(hub, monkeypatch, key):
    base = _stage(hub, key)
    cfg, trainer = _vlp(monkeypatch, key)
    before = _snapshot(trainer.state.model)
    with _captured("vlp_tpu_torch.train.driver") as records:
        driver._maybe_load_pretrained_text_tower(cfg, trainer)
    after = trainer.state.model.state_dict()
    want = W.expected_text_state(base, _layout(key),
                                 tbert.TEXT_CONFIGS[key].num_layers)
    for k, v in after.items():
        if k.startswith("text_encoder."):
            assert torch.equal(v, want[k[len("text_encoder."):]]), k
        else:
            assert torch.equal(v, before[k]), k
    assert len(want) == sum(k.startswith("text_encoder.") for k in after)
    (line,) = [r.getMessage() for r in records]
    assert key in line and hf_files.snapshot_dir(REPOS[key]) in line


def test_driver_keeps_random_init_without_files(hub, monkeypatch):
    cfg, trainer = _vlp(monkeypatch, "tinybert")
    before = _snapshot(trainer.state.model)
    with _captured("vlp_tpu_torch.models.bert") as records:
        driver._maybe_load_pretrained_text_tower(cfg, trainer)
    assert all(torch.equal(v, before[k])
               for k, v in trainer.state.model.state_dict().items())
    assert [r.levelno for r in records] == [logging.WARNING]


def test_driver_refuses_pretrained_weights_with_hash_ids(hub, monkeypatch):
    """The weights are there, ``vocab.txt`` is not: the JAX package's
    ``RuntimeError``, and the tower untouched."""
    _stage(hub, "tinybert", vocab=False)
    cfg, trainer = _vlp(monkeypatch, "tinybert")
    before = _snapshot(trainer.state.model)
    assert ttok.tokenizer_is_hash_fallback("tinybert")
    with pytest.raises(RuntimeError, match="fell back to the hash "
                                           "tokenizer"):
        driver._maybe_load_pretrained_text_tower(cfg, trainer)
    assert all(torch.equal(v, before[k])
               for k, v in trainer.state.model.state_dict().items())


def test_driver_import_under_fsdp_gathers_to_the_single_process_state(
        hub, monkeypatch, tmp_path):
    """Two gloo ranks under ``mesh.param_sharding=fsdp``: each takes its
    shards of the imported tower; the gathered state equals one process's
    after the same import (every entry, bit for bit)."""
    base = _stage(hub, "tinybert")
    overrides = ["model.model=resnet_micro", "data.image_size=32",
                 "data.tokenizer=tinybert", "mesh.param_sharding=fsdp"]
    ranks = run_ranks(hf_text_tower_worker, 2, tmp_path, overrides, SMALL)
    single = hf_text_tower_worker(None, overrides, SMALL)
    assert ranks[0]["sharded"] and not single["sharded"]
    assert ranks[1]["state"] == {}
    gathered = ranks[0]["state"]
    assert set(gathered) == set(single["state"])
    for k, v in single["state"].items():
        np.testing.assert_array_equal(gathered[k], v, err_msg=k)
    want = W.expected_text_state(base, "bert", tbert.TINYBERT.num_layers)
    for k, v in want.items():
        np.testing.assert_array_equal(gathered["text_encoder." + k],
                                      v.numpy(), err_msg=k)
