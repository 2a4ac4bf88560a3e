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

from vlp_tpu.config import (Config, apply_overrides, get_experiment,
                            list_experiments)
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


def test_the_resnet_entries_say_what_the_slice_runs():
    r34 = TRAIN_EXPERIMENTS["baseline_only_imaging_resnet34"]
    assert r34.serve.model == "resnet34" and r34.serve.crop
    assert r34.coral_lambda == 1000.0 and r34.batch_size == 64
    assert r34.lr == 1.2925748253710286e-4
    assert r34.scheduler == "cosine_warmup" and r34.optimizer == "adamw"
    assert (r34.serve.stem, r34.serve.bn_dtype) == ("conv7", "fp32")
    xrv = TRAIN_EXPERIMENTS["baseline_only_imaging_xrv_resnet50"]
    assert xrv.serve.model == "resnet50-res512-all"
    assert xrv.serve.in_channels == 1 and xrv.serve.scale_intensity
    assert xrv.batch_size == 32 and xrv.lr == 9.142907e-4
    assert xrv.coral_lambda == 0.0 and not xrv.serve.crop


PRETRAIN = ("pretrain_resnet34_tinybert", "pretrain_resnet34_distilbert",
            "pretrain_resnet18_tinybert", "pretrain_resnet50_distilbert",
            "pretrain_resnet34_tinybert_masked_loss",
            "pretrain_resnet34_tinybert_non_square_loss",
            "pretrain_resnet34_tinybert_frozen_text",
            "pretrain_resnet34_tinybert_split_lr",
            "pretrain_resnet34_tinybert_no_augs",
            "pretrain_resnet34_distilbert_masked",
            "pretrain_resnet34_distilbert_dedup")


def test_the_pretrain_entries_say_what_the_slice_runs():
    """The eleven pretrain experiments the chip checks run (each entry is
    also held against the JAX experiment above; the tables hold every
    registered experiment, so the other pretrain ones are there too), and
    what each says: the dual tower,
    batch 128 at 224 px with 40-token captions, AdamW at 1e-3 under cosine
    with the 5-degree shear; the variants' loss, groups and augmentation;
    the DistilBERT line's embedding 32 and Adam without a schedule."""
    vlp = {k: v for k, v in TRAIN_EXPERIMENTS.items()
           if v.serve.task == "vision_language"}
    assert sorted(vlp) == sorted(
        n for n in list_experiments()
        if get_experiment(n).model.task == "vision_language")
    assert set(PRETRAIN) <= set(vlp)
    main = vlp["pretrain_resnet34_tinybert"]
    assert (main.serve.model, main.serve.text_model) == ("resnet34",
                                                         "tinybert")
    assert main.batch_size == 128 and main.serve.image_size == 224
    assert main.max_token_length == 40 and main.serve.embedding_dim == 128
    assert (main.optimizer, main.lr, main.scheduler) == ("adamw", 1e-3,
                                                         "cosine")
    assert main.augment().shear_deg == 5.0 and main.augment().enabled
    assert main.augment().noise_prob == 0.5
    assert main.serve.logit_scale_max == 100.0
    assert vlp["pretrain_resnet34_tinybert_masked_loss"].serve.loss_variant \
        == "masked"
    assert vlp["pretrain_resnet34_tinybert_non_square_loss"].serve \
        .loss_variant == "non_square"
    assert vlp["pretrain_resnet34_tinybert_frozen_text"].text_encoder_lr \
        == 0.0
    split = vlp["pretrain_resnet34_tinybert_split_lr"]
    assert (split.image_encoder_lr, split.text_encoder_lr,
            split.projection_lr) == (1e-4, 1e-5, 1e-3)
    assert not vlp["pretrain_resnet34_tinybert_no_augs"].augment().enabled
    for name, lr in (("pretrain_resnet34_distilbert_masked", 1e-4),
                     ("pretrain_resnet34_distilbert_dedup", 1e-5)):
        d = vlp[name]
        assert d.serve.embedding_dim == 32 and d.optimizer == "adam"
        assert d.lr == lr and d.scheduler == "none"


@pytest.mark.parametrize("overrides", [
    ["experiment=baseline_only_imaging_vit_base"],
    ["experiment=baseline_only_imaging_nest_small", "model.megakernel=false"],
    ["experiment=baseline_only_imaging_nest_small",
     "model.fused_attention=true", "data.image_size=16",
     "trainer.precision=fp32"],
    ["model.model=nest_small"],
    ["experiment=baseline_only_imaging_resnet34", "model.stem=s2d",
     "trainer.bn_dtype=bf16"],
    ["experiment=baseline_only_imaging_xrv_resnet50", "data.image_size=64"],
])
def test_command_line_resolves_as_apply_overrides(overrides):
    want = ServeConfig.from_config(apply_overrides(Config(), overrides))
    assert serve_config(overrides) == want


def test_command_line_refuses_what_the_port_would_ignore():
    with pytest.raises(ValueError, match="model.megakernel"):
        serve_config(["experiment=baseline_only_imaging_vit_base",
                      "optimizer.lr=0.1"])
    # every registered experiment resolves, the fusion ones too; an
    # unknown name raises
    assert serve_config(["experiment=baseline_fusion_resnet34"]) == \
        ServeConfig.from_config(get_experiment("baseline_fusion_resnet34"))
    with pytest.raises(KeyError, match="unknown experiment"):
        serve_config(["experiment=no_such_experiment"])
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
    # without both, PNGs take the numpy reader; anything else raises
    # naming the two decoders
    for path in pngs:
        np.testing.assert_array_equal(tph.decode_image(path),
                                      jph.decode_image(path))
    jpeg = pngs[0][:-4] + ".jpg"
    assert cv2.imwrite(jpeg, cv2.imread(pngs[0]))
    with pytest.raises(ValueError, match="cv2.*PIL"):
        tph.decode_image(jpeg)
    # resizing needs neither: cv2's INTER_AREA in numpy
    img = np.random.default_rng(2).random((6, 6)).astype(np.float32) * 255
    np.testing.assert_array_equal(
        tph.resize(img, 4), cv2.resize(img, (4, 4),
                                       interpolation=cv2.INTER_AREA))
