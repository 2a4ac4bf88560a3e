"""The port's serving slice against the JAX package's, end to end on the CPU:
a JAX classifier task (tiny NesT, fp32) -> Orbax checkpoint ->
scripts/export_flax_params.py -> .npz -> ``vlp_tpu_torch.serve.Predictor``,
held against ``vlp_tpu.serve.Predictor`` on the same checkpoint (half-block
kernels in Pallas interpret mode) on a ragged request.

Probabilities agree within 5e-5: fp32 on both sides, and the sigmoid's
slope is at most 1/4, so this is the atol of the block-level tests on the
logits.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vlp_tpu.models.nest as jnest
import vlp_tpu_torch.models.nest as tnest
from vlp_tpu.config import apply_overrides, get_experiment
from vlp_tpu.models.tasks import TaskStatics, build_task
from vlp_tpu.utils import checkpoint as ckpt

TINY = dict(img_size=16, patch_size=2, embed_dims=(16, 32), num_heads=(2, 4),
            depths=(1, 1), block_size=4)
MEAN, STD = 120.0, 50.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _export_module():
    spec = importlib.util.spec_from_file_location(
        "export_flax_params",
        os.path.join(REPO, "scripts", "export_flax_params.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tiny_checkpoint(monkeypatch, tmp_path):
    """(cfg, Orbax checkpoint path, exported .npz path) of a tiny-NesT
    classifier with perturbed random weights."""
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jnest, "nest_small",
                        lambda **kw: jnest.NesT(**TINY, **kw))
    monkeypatch.setattr(tnest, "nest_small",
                        lambda **kw: tnest.NesT(**TINY, **kw))
    cfg = apply_overrides(get_experiment("baseline_only_imaging_nest_small"),
                          ["data.image_size=16", "trainer.precision=fp32"])
    task = build_task(cfg, TaskStatics(mean=MEAN, std=STD))
    batch = {"image_u8": jnp.zeros((4, 16, 16), jnp.uint8)}
    variables = task.init_variables(jax.random.key(0), batch)
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), jax.device_get(variables["params"]))
    path = ckpt.save(str(tmp_path / "ckpt"),
                     {"params": params,
                      "extra_vars": {k: v for k, v in variables.items()
                                     if k != "params"}})
    npz = _export_module().export(cfg, path, str(tmp_path / "weights.npz"))
    return cfg, path, npz


def test_torch_predictor_matches_jax_predictor(tiny_checkpoint):
    from vlp_tpu.serve import Predictor as JaxPredictor
    from vlp_tpu_torch.serve import Predictor

    cfg, path, npz = tiny_checkpoint
    images = np.random.default_rng(7).integers(0, 256, (5, 16, 16),
                                               dtype=np.uint8)
    ref = JaxPredictor(cfg, path, MEAN, STD, batch_size=4)
    want = ref.predict_arrays(images)
    port = Predictor(cfg, npz, MEAN, STD, batch_size=4, device="cpu")
    got = port.predict_arrays(images)  # 5 images at batch 4: ragged tail
    assert got.shape == (5,) and got.dtype == np.float32
    assert np.ptp(want) > 1e-3  # the check is not on a constant output
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    np.testing.assert_allclose(
        port.predict_logits(images), np.log(got / (1 - got)), atol=1e-4)
    feats = port.task.features_fn(port._batch(images[:4], None)).numpy()
    want_feats = np.asarray(ref.task.features_fn(
        ref.variables, {"image_u8": jnp.asarray(images[:4])}))
    np.testing.assert_allclose(feats, want_feats, atol=5e-5, rtol=0)


def test_serve_cli_writes_csv(tiny_checkpoint, tmp_path):
    import csv

    import cv2

    from vlp_tpu_torch.serve import main

    _, _, npz = tiny_checkpoint
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(9)
    for i in range(3):
        cv2.imwrite(str(img_dir / f"{i}.png"),
                    rng.integers(0, 256, (20, 24), dtype=np.uint8))
    out = tmp_path / "preds.csv"
    assert main(["--weights", npz, "--images", str(img_dir), "--output",
                 str(out), "--device", "cpu", "--batch-size", "2",
                 "experiment=baseline_only_imaging_nest_small",
                 "data.image_size=16", "trainer.precision=fp32"]) == 0
    with open(out) as fh:
        rows = list(csv.DictReader(fh))
    assert [os.path.basename(r["image_path"]) for r in rows] == \
        ["0.png", "1.png", "2.png"]
    probs = np.array([float(r["tumor_prob"]) for r in rows])
    assert np.all((probs > 0) & (probs < 1))


def test_unported_backbones_and_tasks_raise():
    from vlp_tpu_torch.models.registry import create_backbone
    from vlp_tpu_torch.models.tasks import TaskStatics as TStatics
    from vlp_tpu_torch.models.tasks import build_task as tbuild

    # every backbone of the reference's allowlist is ported; another name
    # is refused as the JAX registry refuses it
    with pytest.raises(ValueError, match="Unknown backbone"):
        create_backbone("resnet101")
    cfg = apply_overrides(get_experiment("baseline_only_imaging_nest_small"),
                          ["model.task=fusion"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tbuild(cfg, TStatics())
    # the vision-language task is ported: the dual tower of the experiment
    from vlp_tpu_torch.models.tasks import VisionLanguageTask

    cfg = apply_overrides(get_experiment("pretrain_resnet34_tinybert"),
                          ["model.model=resnet_micro",
                           "model.text_model=microbert"])
    task = tbuild(cfg, TStatics())
    assert isinstance(task, VisionLanguageTask)
    assert task.model.text_encoder.cfg.hidden_size == 64
    assert task.loss_variant == "symmetric_infonce"
    # the classifier's Predictor refuses it rather than failing on logits
    from vlp_tpu_torch.serve import Predictor

    with pytest.raises(ValueError, match="no logits"):
        Predictor(cfg, None, 0.0, 1.0, device="cpu")


@pytest.mark.parametrize("name", ["baseline_only_imaging_nest_small"])
def test_port_experiment_matches_jax_experiment(name):
    from vlp_tpu_torch.config import EXPERIMENTS, ServeConfig

    assert EXPERIMENTS[name] == ServeConfig.from_config(get_experiment(name))
