"""The port's torchvision / torchxrayvision ResNet import
(``vlp_tpu_torch/models/torch_import.py`` and the driver's xrv warm start)
against the JAX package's ``convert_torchvision_resnet`` and the
torchvision-exact ResNet50 of ``tests/test_torch_import.py``
(``build_torch_resnet``), on state dicts drawn from seeds.

Tolerances:
- the converted state dict: bit-equal to ``convert.state_dict_from_flax``
  of the JAX converter's trees (the import copies, renames and, for
  ``fc``, transposes).
- the 1-channel ResNet50's eval-mode features in fp32 against the torch
  model's ``forward_features``: 1e-5 of the largest |feature| (the same
  convolutions, BatchNorm written as (x - mean) * rsqrt(var + eps) * w + b
  where torch fuses it: fp32 rounding over 16 blocks).
"""
import contextlib
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke_weights as W
from test_torch_import import build_torch_resnet
from vlp_tpu.models import resnet as jresnet
from vlp_tpu.models.torch_import import \
    convert_torchvision_resnet as jconvert
from vlp_tpu_torch import convert
from vlp_tpu_torch.config import TrainConfig, get_experiment
from vlp_tpu_torch.models import resnet as tresnet
from vlp_tpu_torch.models.tasks import TaskStatics, build_task
from vlp_tpu_torch.models.torch_import import (
    convert_torchvision_resnet, load_torchxrayvision_resnet50)
from vlp_tpu_torch.models.vit import flax_init_
from vlp_tpu_torch.train import driver

FEATURE_REL = 1e-5
XRV = "baseline_only_imaging_xrv_resnet50"
LOGGER = "vlp_tpu_torch.models.torch_import"


@contextlib.contextmanager
def _captured(name):
    """The records of the port's logger ``name`` (its loggers do not
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


@pytest.fixture(scope="module")
def xrv_model():
    """The xrv architecture as torchvision builds it (1-channel conv1, an
    18-class fc), every parameter and running statistic drawn from a
    seed."""
    model = build_torch_resnet(torch, "bottle", (3, 4, 6, 3), in_ch=1,
                               num_classes=18)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        for name, b in model.named_buffers():
            if name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
            elif name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
    return model.eval()


@pytest.fixture(scope="module")
def backbone():
    return tresnet.resnet50(in_chans=1, dtype=torch.float32).eval()


def test_import_is_bit_equal_to_the_jax_converter(xrv_model, backbone):
    """The JAX converter on flax's trees (their shapes only: it replaces
    every leaf), mapped onto the port by ``convert``, against the port's;
    ``num_batches_tracked`` dropped, the 18-class ``fc`` left out."""
    x = jnp.zeros((1, 64, 64, 1))
    shapes = jax.eval_shape(
        lambda: jresnet.resnet50(num_classes=0, dtype=jnp.float32).init(
            jax.random.key(0), x, train=False))
    sd = {k: v.numpy() for k, v in xrv_model.state_dict().items()}
    assert any(k.endswith("num_batches_tracked") for k in sd)
    params, stats = jconvert(sd, shapes["params"], shapes["batch_stats"])
    want = convert.state_dict_from_flax(
        {"params": params, "batch_stats": stats}, backbone)
    got = convert_torchvision_resnet(xrv_model.state_dict(), backbone)
    assert set(got) == set(want) == set(backbone.state_dict())
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k


def test_eval_features_match_torchvisions(xrv_model, backbone):
    backbone.load_state_dict(convert_torchvision_resnet(
        xrv_model.state_dict(), backbone))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 1, 64, 64)).astype(np.float32))
    with torch.no_grad():
        want = xrv_model.forward_features(x)
        got = backbone.forward_features(x.permute(0, 2, 3, 1))
    assert got.shape == want.shape == (2, 2048)
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= FEATURE_REL, err


def test_head_takes_a_matching_fc_and_keeps_its_own_otherwise(xrv_model,
                                                              backbone):
    sd = xrv_model.state_dict()
    state = dict(backbone.state_dict())
    gen = torch.Generator().manual_seed(2)
    for classes, taken in ((18, True), (1, False)):
        head = {"head.weight": torch.randn(2048, classes, generator=gen),
                "head.bias": torch.randn(classes, generator=gen)}
        with _captured(LOGGER) as records:
            got = convert_torchvision_resnet(sd, {**state, **head})
        if taken:
            assert torch.equal(got["head.weight"], sd["fc.weight"].T)
            assert torch.equal(got["head.bias"], sd["fc.bias"])
            assert not records
        else:
            assert all(torch.equal(got[k], v) for k, v in head.items())
            (rec,) = records
            assert rec.levelno == logging.INFO
            assert "keeping the fresh head" in rec.getMessage()
    shapes = {k: tuple(v.shape) for k, v in state.items()}
    got = convert_torchvision_resnet(sd, {**shapes, "head.weight": (2048, 1),
                                          "head.bias": (1,)})
    assert set(got) == set(state)  # no tensor to keep: the head untouched


def test_converter_refuses_a_missing_key_or_a_wrong_shape(xrv_model,
                                                          backbone):
    sd = dict(xrv_model.state_dict())
    del sd["layer3.0.conv2.weight"]
    with pytest.raises(KeyError, match="layer3.0.conv2.weight"):
        convert_torchvision_resnet(sd, backbone)
    sd = dict(xrv_model.state_dict())
    sd["layer2.1.bn2.running_var"] = torch.ones(7)
    with pytest.raises(ValueError, match="shape"):
        convert_torchvision_resnet(sd, backbone)


def test_loader_strips_the_xrv_prefix_and_warns_on_any_failure(
        tmp_path, backbone, monkeypatch):
    """The file as xrv saves it (``model.`` + torchvision's keys), then
    files that do not load: a 3-channel conv1, bytes that are no
    checkpoint, a path that does not exist, and no path without the
    ``torchxrayvision`` package: each a warning and None."""
    gen = torch.Generator().manual_seed(3)
    xrv = W.xrv_file_state(gen)
    torch.save(xrv, tmp_path / "xrv.pt")
    got = load_torchxrayvision_resnet50(backbone, str(tmp_path / "xrv.pt"))
    want = W.expected_backbone_state(xrv)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    torch.save(W.xrv_file_state(gen, in_chans=3), tmp_path / "rgb.pt")
    (tmp_path / "junk.pt").write_bytes(b"not a checkpoint")
    monkeypatch.setitem(__import__("sys").modules, "torchxrayvision", None)
    with _captured(LOGGER) as records:
        for path in (tmp_path / "rgb.pt", tmp_path / "junk.pt",
                     tmp_path / "absent.pt", None):
            assert load_torchxrayvision_resnet50(
                backbone, path and str(path)) is None
    assert [r.levelno for r in records] == [logging.WARNING] * 4
    msgs = [r.getMessage() for r in records]
    assert "(64, 3, 7, 7)" in msgs[0] and "random init" in msgs[0]
    assert "ModuleNotFoundError" in msgs[3] or "ImportError" in msgs[3]


@pytest.fixture(scope="module")
def xrv_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("xrv")
    gen = torch.Generator().manual_seed(4)
    xrv = W.xrv_file_state(gen)
    torch.save(xrv, root / "xrv.pt")
    torch.save(W.xrv_file_state(gen, in_chans=3), root / "rgb.pt")
    return root, xrv


def _classifier(**changes):
    """The xrv classifier's model on the CPU at its init, in a
    trainer-shaped holder."""
    cfg = get_experiment(XRV)
    for key, value in changes.items():
        setattr(cfg.model, key, value)
    task = build_task(TrainConfig.from_config(cfg),
                      TaskStatics(mean=0.0, std=1.0, out_channels=1),
                      torch.device("cpu"))
    flax_init_(task.model, torch.Generator().manual_seed(0))
    return cfg, types.SimpleNamespace(
        state=types.SimpleNamespace(model=task.model))


@pytest.mark.parametrize("case", ["loaded", "wrong_file", "absent",
                                  "not_pretrained"])
def test_driver_xrv_warm_start(xrv_files, monkeypatch, case):
    """``model.pretrained`` with ``XRV_WEIGHTS_PATH``: the backbone takes
    the file (parameters and running statistics), the head keeps its init
    and one line names the file; a file that does not fit, or none, warns
    and keeps the init; without ``model.pretrained`` nothing is read."""
    root, xrv = xrv_files
    monkeypatch.setitem(__import__("sys").modules, "torchxrayvision", None)
    path = {"loaded": root / "xrv.pt", "wrong_file": root / "rgb.pt",
            "not_pretrained": root / "xrv.pt"}.get(case)
    if path is None:
        monkeypatch.delenv("XRV_WEIGHTS_PATH", raising=False)
    else:
        monkeypatch.setenv("XRV_WEIGHTS_PATH", str(path))
    cfg, trainer = _classifier(pretrained=case != "not_pretrained")
    model = trainer.state.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with _captured(LOGGER) as warned, \
            _captured("vlp_tpu_torch.train.driver") as info:
        driver._maybe_warm_start(cfg, trainer)
    after = model.state_dict()
    if case == "loaded":
        want = W.expected_backbone_state(xrv)
        assert len(want) == sum(k.startswith("backbone.") for k in after)
        for k, v in after.items():
            if k.startswith("backbone."):
                assert torch.equal(v, want[k[len("backbone."):]]), k
            else:
                assert torch.equal(v, before[k]), k
        assert not warned
        (line,) = [r.getMessage() for r in info]
        assert str(path) in line
        return
    assert all(torch.equal(v, before[k]) for k, v in after.items())
    assert not info
    assert [r.levelno for r in warned] == (
        [] if case == "not_pretrained" else [logging.WARNING])
