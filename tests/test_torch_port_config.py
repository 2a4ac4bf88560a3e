"""The port's experiment entries and command-line resolution
(``vlp_tpu_torch.config``) against the JAX package's ``get_experiment`` and
``apply_overrides``, and its copy of the host preprocessing
(``vlp_tpu_torch.data.preprocess_host``) against the reference's NumPy path
(``use_native=False``) on seeded PNGs: equal to the bit, since the copy does
the same arithmetic with the same decoder and resize.
"""
import sys

import cv2
import numpy as np
import pytest

from vlp_tpu.config import Config, apply_overrides, get_experiment
from vlp_tpu.data import preprocess_host as jph
from vlp_tpu_torch.config import (EXPERIMENTS, NEST_UNFUSED,
                                  TRAIN_EXPERIMENTS, ServeConfig,
                                  TrainConfig, serve_config)
from vlp_tpu_torch.data import preprocess_host as tph


def _jax_config(key: str):
    """The JAX Config an entry's key names: the experiment, then the
    overrides written after it."""
    name, *overrides = key.split(" ")
    return apply_overrides(get_experiment(name), overrides)


@pytest.mark.parametrize("key", sorted(EXPERIMENTS))
def test_entries_match_the_jax_experiments(key):
    cfg = _jax_config(key)
    assert EXPERIMENTS[key] == ServeConfig.from_config(cfg)
    assert TRAIN_EXPERIMENTS[key] == TrainConfig.from_config(cfg)


def test_the_slice_entries_say_what_the_slice_runs():
    vit_b = TRAIN_EXPERIMENTS["baseline_only_imaging_vit_base"]
    assert vit_b.serve.model == "vit_base_patch16_224"
    assert vit_b.batch_size == 32 and vit_b.scheduler == "cosine_warmup"
    assert vit_b.coral_lambda == 0.0 and vit_b.serve.crop
    assert TRAIN_EXPERIMENTS["baseline_only_imaging_vit_large"].batch_size \
        == 64
    unfused = TRAIN_EXPERIMENTS[NEST_UNFUSED]
    assert not unfused.serve.megakernel and unfused.batch_size == 64
    assert unfused.serve.model == "nest_small"


@pytest.mark.parametrize("overrides", [
    ["experiment=baseline_only_imaging_vit_base"],
    ["experiment=baseline_only_imaging_nest_small", "model.megakernel=false"],
    ["experiment=baseline_only_imaging_nest_small",
     "model.fused_attention=true", "data.image_size=16",
     "trainer.precision=fp32"],
    ["model.model=nest_small"],
])
def test_command_line_resolves_as_apply_overrides(overrides):
    want = ServeConfig.from_config(apply_overrides(Config(), overrides))
    assert serve_config(overrides) == want


def test_command_line_refuses_what_the_port_would_ignore():
    with pytest.raises(ValueError, match="model.megakernel"):
        serve_config(["experiment=baseline_only_imaging_vit_base",
                      "optimizer.lr=0.1"])
    with pytest.raises(KeyError, match="not ported"):
        serve_config(["experiment=baseline_only_imaging_resnet34"])
    assert serve_config(["experiment=baseline_only_imaging_nest_small",
                         "model.megakernel=false"]) == \
        EXPERIMENTS[NEST_UNFUSED]


@pytest.fixture
def pngs(tmp_path):
    """Seeded PNGs: gray, BGR and BGRA, tall, wide and square."""
    rng = np.random.default_rng(12)
    shapes = [(40, 30), (30, 52, 3), (33, 33, 4), (64, 48, 3)]
    paths = []
    for i, shape in enumerate(shapes):
        img = (rng.random(shape) ** 2 * 255).astype(np.uint8)
        path = str(tmp_path / f"{i}.png")
        assert cv2.imwrite(path, img)
        paths.append(path)
    return paths


@pytest.mark.parametrize("crop", [False, True])
def test_preprocess_matches_the_reference_numpy_path(pngs, crop):
    for path in pngs:
        want = jph.preprocess_image(path, image_size=24, crop=crop,
                                    use_native=False)
        got = tph.preprocess_image(path, image_size=24, crop=crop)
        assert got.dtype == np.uint8 and got.shape == (24, 24)
        np.testing.assert_array_equal(got, want)
    arr = np.random.default_rng(1).integers(0, 256, (50, 20), np.uint8)
    np.testing.assert_array_equal(
        tph.preprocess_image(arr, image_size=16, crop=crop),
        jph.preprocess_image(arr, image_size=16, crop=crop, use_native=False))


def test_decoders_fall_back_to_pil_then_raise(monkeypatch, pngs):
    monkeypatch.setattr(tph, "_cv2", lambda: None)
    gray = tph.decode_image(pngs[0])
    np.testing.assert_array_equal(gray[:, :, 0],
                                  cv2.imread(pngs[0], cv2.IMREAD_UNCHANGED))
    rgb = tph.decode_image(pngs[3])
    np.testing.assert_array_equal(rgb, cv2.imread(pngs[3])[:, :, ::-1])
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="cv2.*PIL"):
        tph.decode_image(pngs[0])
    with pytest.raises(ImportError, match="cv2.*PIL"):
        tph.resize(np.zeros((5, 6), np.float32), 4)
