"""The training entry point (``python -m vlp_tpu_torch.train``, through
``driver.main``) on the real-data path, on the CPU: one fold of
``baseline_only_imaging_resnet34`` with ``test=true`` and one of
``pretrain_resnet34_tinybert`` at ``data.image_size=32``, over a fixture
corpus in the INTERNAL, BTXRD, MURA and LERA layouts
(``chip_smoke_data.write_corpus``) found through ``*_DATASET_PATH``; then
``python -m vlp_tpu_torch.eval.test_eval`` on the downstream run's best
checkpoint writes the run's test CSV byte for byte.
"""
import json
import math

import pytest

from vlp_tpu_torch.eval import test_eval
from vlp_tpu_torch.train import driver

import chip_smoke_data

SMALL = ["data.image_size=32", "k_fold_cross_validation=false",
         "trainer.max_epochs=1"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    env = chip_smoke_data.write_corpus(root, downstream=60, pretrain=90,
                                       sides=(24, 48))
    return root, {k: v for k, v in env.items() if k.endswith("_PATH")}


def _run(corpus, tmp_path, monkeypatch, name, extra=()):
    root, env = corpus
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    out = tmp_path / name
    chip_smoke_data.seed_cache(root, out / "datacache")
    argv = ["--device", "cpu", f"experiment={name}", *SMALL,
            f"output_dir={out}", *extra]
    assert driver.main(argv) == 0
    with open(out / "fold0.done.json") as fh:
        summary = json.load(fh)["summary"]
    assert not (out / "fold1.done.json").exists()
    return out, summary, argv


def test_downstream_fold_with_test_on_the_fixture(corpus, tmp_path,
                                                  monkeypatch):
    out, summary, argv = _run(corpus, tmp_path, monkeypatch,
                              "baseline_only_imaging_resnet34",
                              ["test=true"])
    for m in ("accuracy", "auroc", "loss"):
        v = summary[f"val/combined/accuracy_best_val/combined/{m}"]
        assert math.isfinite(v)
    csv = (out / "test_eval.csv").read_text()
    assert csv.startswith("level,group,fold,metric,value\n")
    assert "overall,overall,0,accuracy," in csv
    (best,) = [p for p in (out / "checkpoints" / "fold0").glob("epoch*.pt")]
    assert test_eval.main([
        "--device", "cpu", "--output-file", str(tmp_path / "cli.csv"),
        "--checkpoints", str(best),
        *[a for a in argv if "=" in a and not a.startswith("test=")]]) == 0
    assert (tmp_path / "cli.csv").read_text() == csv


def test_pretrain_fold_on_the_fixture(corpus, tmp_path, monkeypatch):
    _, summary, _ = _run(corpus, tmp_path, monkeypatch,
                         "pretrain_resnet34_tinybert",
                         ["downstream_data.image_size=32"])
    keys = [k for k in summary if k.endswith("linear_probe_auroc")
            or "val/mura/loss" in k or "val/lera/loss" in k]
    assert len(keys) >= 3 and all(math.isfinite(summary[k]) for k in keys)
    assert any(k.startswith("downstream_entire/") for k in summary)
