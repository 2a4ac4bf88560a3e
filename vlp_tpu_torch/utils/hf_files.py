"""The files of a Hugging Face model in the local hub cache: the port's own
copy of what ``from_pretrained(name, local_files_only=True)`` reads, without
``transformers``, ``huggingface_hub`` or ``safetensors``.

The cache root is ``huggingface_hub``'s (0.36), read at call time:
``HF_HUB_CACHE``, else ``HUGGINGFACE_HUB_CACHE``, else ``$HF_HOME/hub``, else
``$XDG_CACHE_HOME/huggingface/hub``, else ``~/.cache/huggingface/hub``. A repo
id ``org/name`` lives under ``models--org--name``; ``refs/<revision>`` holds
the commit its snapshot is named by (``snapshots/<commit>/``), and a revision
with no ref names the snapshot itself. Nothing here touches the network: a
file that is not in the cache is ``None``.

Weights come from ``model.safetensors`` (read here: an 8-byte little-endian
header length, a JSON header of each tensor's dtype, shape and byte range,
then the raw data) or ``pytorch_model.bin`` (``torch.load`` with
``weights_only=True``), in that order, as ``from_pretrained`` takes them.
``base_model_state`` normalises a checkpoint's keys to the base model's, as
``from_pretrained`` does when it loads ``AutoModel``: the ``bert.`` or
``distilbert.`` prefix stripped, TensorFlow's ``LayerNorm.gamma``/``.beta``
renamed ``.weight``/``.bias``, and every tensor the base model lacks (the
pretraining heads ``cls.*`` and ``vocab_*``, the ``position_ids`` buffer,
TinyBERT's ``fit_denses``) dropped.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import torch

# safetensors dtype names -> torch dtypes
DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
           "BOOL": torch.bool}
WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")
# the base models' prefixes in a checkpoint saved from a model with heads
BASE_PREFIXES = ("bert.", "distilbert.")
# the first component of every key of the base models (BertModel,
# DistilBertModel)
BASE_MODULES = ("embeddings", "encoder", "transformer", "pooler")


def hub_cache_dir() -> str:
    """The hub cache root, by ``huggingface_hub``'s precedence of its
    environment variables (read now, not at import)."""
    env = os.environ
    hf_home = os.path.expandvars(os.path.expanduser(env.get(
        "HF_HOME", os.path.join(env.get(
            "XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"),
                                           ".cache")), "huggingface"))))
    legacy = env.get("HUGGINGFACE_HUB_CACHE", os.path.join(hf_home, "hub"))
    return os.path.expandvars(os.path.expanduser(env.get("HF_HUB_CACHE",
                                                         legacy)))


def snapshot_dir(repo_id: str, revision: str = "main",
                 cache_dir: Optional[str] = None) -> Optional[str]:
    """The snapshot directory of ``repo_id`` at ``revision`` in the cache,
    or None where the cache holds none."""
    root = os.path.join(cache_dir or hub_cache_dir(),
                        "models--" + repo_id.replace("/", "--"))
    ref = os.path.join(root, "refs", revision)
    if os.path.isfile(ref):
        with open(ref) as fh:
            revision = fh.read()
    path = os.path.join(root, "snapshots", revision)
    return path if revision and os.path.isdir(path) else None


def cached_file(repo_id: str, filename: str, revision: str = "main",
                cache_dir: Optional[str] = None) -> Optional[str]:
    """The path of ``filename`` in ``repo_id``'s snapshot, or None."""
    snap = snapshot_dir(repo_id, revision, cache_dir)
    path = None if snap is None else os.path.join(snap, filename)
    return path if path is not None and os.path.isfile(path) else None


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU; raises on a
    dtype it does not know or a byte range outside the file."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
        data = bytearray(os.path.getsize(path) - 8 - n)
        fh.readinto(data)
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {entry['dtype']}, "
                             f"not one of {sorted(DTYPES)}")
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        size = torch.empty((), dtype=dtype).element_size()
        count = (end - begin) // size
        if end > len(data) or count != int(torch.Size(shape).numel()):
            raise ValueError(f"{path}: {name}'s bytes [{begin}, {end}) do "
                             f"not hold {shape} {entry['dtype']}")
        flat = torch.frombuffer(data, dtype=dtype, count=count,
                                offset=begin) if count else \
            torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(shape).clone()
    return out


def read_weights(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file or a ``torch.save``d state dict."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def base_model_state(state: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A checkpoint's tensors under the base model's keys (see the module
    docstring)."""
    out = {}
    for key, value in state.items():
        for prefix in BASE_PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        for old, new in (("LayerNorm.gamma", "LayerNorm.weight"),
                         ("LayerNorm.beta", "LayerNorm.bias")):
            if key.endswith(old):
                key = key[:-len(old)] + new
        if key.split(".")[0] in BASE_MODULES and \
                not key.endswith("position_ids"):
            out[key] = value
    return out


def load_pretrained(repo_id: str
                    ) -> Optional[Tuple[dict, Dict[str, torch.Tensor], str]]:
    """(``config.json``, the base model's state, the weights' path) of
    ``repo_id`` from the cache, or None where its config or weights are not
    there. Raises where a file is there but cannot be read."""
    config = cached_file(repo_id, "config.json")
    if config is None:
        return None
    for name in WEIGHT_FILES:
        path = cached_file(repo_id, name)
        if path is not None:
            with open(config) as fh:
                cfg = json.load(fh)
            return cfg, base_model_state(read_weights(path)), path
    return None
