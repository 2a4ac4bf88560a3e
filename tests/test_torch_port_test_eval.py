"""The frozen test-set evaluation of the port (``vlp_tpu_torch/eval``,
``train/driver.py``'s ``test=true``) against the JAX package's
``vlp_tpu/eval/subgroup.py`` and ``test_eval.py``, which pandas runs here;
and the trainer's profiling of the first epoch (``train/loop.py``).

- ``calculate_metrics``: equal to the JAX function's values (the same
  float arithmetic in the same order), NaN where a subgroup holds one
  class;
- ``evaluate_results``: the CSV byte-equal to the one pandas writes for the
  same prediction frames; ``predictions_frame`` and
  ``aggregate_across_folds`` equal column by column (pandas' Kahan mean and
  Welford std, ddof 1, reproduced bit for bit);
- ``driver.train`` with ``test=true`` (the fusion task on the synthetic
  corpus, ``resnet_micro`` at 32 px, 4 folds x 1 epoch, on the CPU):
  ``test_eval.csv`` byte-equal to the JAX ``evaluate_results`` of the
  port's own probabilities, and ``test/<metric>`` equal to pandas' mean of
  the overall rows; the command line's CSV byte-equal to the driver's.
"""
import contextlib
import json
import os
import time

import numpy as np
import pandas as pd
import pytest
import torch

from vlp_tpu.eval import subgroup as jsub
from vlp_tpu.eval.test_eval import split_overrides as jsplit_overrides
from vlp_tpu_torch.config import TrainConfig, apply_overrides, get_experiment
from vlp_tpu_torch.data.datamodule import DownstreamData, build_datamodule
from vlp_tpu_torch.data.synthetic import make_synthetic_downstream
from vlp_tpu_torch.eval import subgroup as sub
from vlp_tpu_torch.eval import test_eval
from vlp_tpu_torch.models.tasks import build_task
from vlp_tpu_torch.train import driver, loop
from vlp_tpu_torch.train.loop import Trainer

CPU = torch.device("cpu")
RUN = ["experiment=smoke_synthetic_only_imaging", "model.task=fusion",
       "model.model=resnet_micro", "data.image_size=32",
       "data.synthetic_num_samples=64", "data.batch_size=16",
       "data.eval_batch_size=8", "trainer.max_epochs=1",
       "trainer.precision=fp32", "k_fold_cross_validation=true"]


# --------------------------------------------------------------------------
# (f), (g) the metrics and the long table against pandas
# --------------------------------------------------------------------------

def _equal(a, b):
    return a == b or (np.isnan(a) and np.isnan(b))


@pytest.mark.parametrize("case", ["random", "ties", "single_class_0",
                                  "single_class_1", "all_one", "all_zero",
                                  "one_row"])
def test_calculate_metrics_matches_jax(case):
    rng = np.random.default_rng(len(case))
    n = 1 if case == "one_row" else 40
    y = rng.integers(0, 2, n)
    p = rng.random(n)
    if case == "ties":
        p = np.round(p * 4) / 4
    elif case.startswith("single_class"):
        y[:] = int(case[-1])
    elif case == "all_one":
        p[:] = 0.9
    elif case == "all_zero":
        p[:] = 0.1
    got, want = sub.calculate_metrics(y, p), jsub.calculate_metrics(y, p)
    assert list(got) == list(want)
    assert all(_equal(got[k], want[k]) for k in want), (got, want)
    single = len(set(y.tolist())) < 2
    assert np.isnan(got["roc_auc"]) == single


def _frames(n_folds=4, seed=0):
    """(port frames, JAX frames) of the synthetic corpus's samples with
    seeded probabilities, some exactly 0.5, one fold single-class in one
    dataset."""
    samples, _ = make_synthetic_downstream(72, 16, seed=3)
    rng = np.random.default_rng(seed)
    ours, theirs = [], []
    for fold in range(n_folds):
        probs = rng.random(len(samples)).astype(np.float32)
        probs[:4] = 0.5
        if fold == 1:
            probs[:] = 0.9  # every prediction positive
        ours.append(sub.predictions_frame(probs, samples))
        theirs.append(jsub.predictions_frame(probs, samples))
    return ours, theirs


def test_predictions_frame_matches_jax():
    ours, theirs = _frames(1)
    got, want = ours[0], theirs[0]
    assert tuple(got) == tuple(want.columns) == sub.FRAME_COLUMNS
    for col in want.columns:
        assert list(np.asarray(got[col]).tolist()) == want[col].tolist(), col


def test_evaluate_results_csv_is_byte_equal_to_pandas(tmp_path):
    ours, theirs = _frames()
    want = jsub.evaluate_results(str(tmp_path / "jax.csv"), theirs)
    got = sub.evaluate_results(str(tmp_path / "port.csv"), ours)
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()
    assert not (tmp_path / "port.csv.tmp").exists()
    assert list(got) == list(want.columns)
    assert got["group"] == want["group"].tolist()
    assert all(_equal(a, b) for a, b in zip(got["value"], want["value"]))
    assert set(got["level"]) == {"overall", *sub.SUBGROUP_LEVELS}
    assert any(np.isnan(v) for v in got["value"])
    # no frames: the header alone
    sub.evaluate_results(str(tmp_path / "empty.csv"), [])
    jsub.evaluate_results(str(tmp_path / "jempty.csv"), [])
    assert (tmp_path / "empty.csv").read_bytes() == \
        (tmp_path / "jempty.csv").read_bytes() == \
        b"level,group,fold,metric,value\n"
    with pytest.raises(ValueError, match="missing columns"):
        sub.evaluate_results(None, [{"prob": np.zeros(1)}])


def test_aggregate_across_folds_matches_pandas():
    ours, theirs = _frames()
    want = jsub.aggregate_across_folds(jsub.evaluate_results(None, theirs))
    got = sub.aggregate_across_folds(sub.evaluate_results(None, ours))
    assert list(got) == list(want.columns)
    for col in ("level", "group", "metric", "count"):
        assert got[col] == want[col].tolist(), col
    for col in ("mean", "std"):
        np.testing.assert_array_equal(np.array(got[col]),
                                      want[col].to_numpy(float))
    # a single fold: std is NaN (ddof 1)
    one = sub.aggregate_across_folds(sub.evaluate_results(None, ours[:1]))
    assert all(np.isnan(s) for s in one["std"]) and set(one["count"]) <= {0, 1}


# --------------------------------------------------------------------------
# (h), (i) test=true through the driver, and the command line
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One k-fold fusion run with test=true: (config, aggregate)."""
    out = tmp_path_factory.mktemp("test_run")
    cfg = apply_overrides(get_experiment("smoke_synthetic_only_imaging"),
                          RUN[1:] + ["test=true", f"output_dir={out}"])
    return cfg, driver.train(cfg, "cpu")


def test_test_true_writes_the_jax_table_of_the_ports_probabilities(run):
    cfg, agg = run
    out = cfg.output_dir
    assert os.path.exists(os.path.join(out, "cv_summary.json"))
    with open(os.path.join(out, "cv_summary.json")) as fh:
        assert "test/accuracy" not in json.load(fh)
    ckpts = driver.best_checkpoints(out)
    assert [f for f, _ in ckpts] == [0, 1, 2, 3]
    for fold, path in ckpts:
        with open(os.path.join(out, "checkpoints", f"fold{fold}",
                               "last.pt.meta.json")) as fh:
            assert json.load(fh)["checkpoint_best_path"] == path
    dm = DownstreamData(cfg, CPU)
    frames = [test_eval.collect_probs(cfg, path, dm, fold, CPU)
              for fold, path in ckpts]
    want = jsub.evaluate_results(
        os.path.join(out, "jax.csv"),
        [jsub.predictions_frame(f["prob"], dm.test) for f in frames])
    with open(os.path.join(out, "test_eval.csv"), "rb") as a, \
            open(os.path.join(out, "jax.csv"), "rb") as b:
        assert a.read() == b.read()
    overall = want[want.level == "overall"]
    assert sorted(overall.fold.unique()) == [0, 1, 2, 3]
    metrics = overall.metric.unique()
    assert [k for k in agg if k.startswith("test/")] == \
        [f"test/{m}" for m in metrics]
    for m in metrics:
        mean = float(overall[overall.metric == m]["value"].mean())
        assert _equal(agg[f"test/{m}"], mean), m
    assert agg["num_folds"] == 4


def test_the_command_line_writes_the_drivers_csv(run, tmp_path):
    cfg, _ = run
    paths = [p for _, p in driver.best_checkpoints(cfg.output_dir)]
    out = tmp_path / "cli.csv"
    argv = ["--output-file", str(out), "--device", "cpu", "--checkpoints",
            *paths, "--save-predictions", str(tmp_path / "preds"),
            "--save-failures", str(tmp_path / "fails"), *RUN,
            f"output_dir={tmp_path}"]
    assert test_eval.main(argv) == 0
    with open(os.path.join(cfg.output_dir, "test_eval.csv"), "rb") as fh:
        assert out.read_bytes() == fh.read()
    # the saved predictions read back as pandas reads the JAX frame's; the
    # first 10 misclassified images of each fold, named as the JAX CLI
    # names them
    dm = DownstreamData(cfg, CPU)
    names = set()
    for fold, path in enumerate(paths):
        frame = test_eval.collect_probs(cfg, path, dm, fold, CPU)
        saved = pd.read_csv(tmp_path / "preds"
                            / f"predictions_fold{fold}.csv")
        want = jsub.predictions_frame(frame["prob"], dm.test)
        pd.testing.assert_frame_equal(saved, want, check_dtype=False)
        wrong = want[(want["prob"] >= 0.5).astype(int) != want["tumor"]]
        names |= {f"fail{i}_true{row['tumor']}_p{row['prob']:.2f}.png"
                  for i, (_, row) in enumerate(wrong.head(10).iterrows())}
    assert names and set(os.listdir(tmp_path / "fails")) == names


@pytest.mark.parametrize("argv", [
    ["--output-file", "x.csv", "--checkpoints", "ck0", "ck1",
     "experiment=smoke_synthetic_only_imaging", "data.image_size=64"],
    ["--output-file=y.csv", "--checkpoints", "ck"],
    ["--checkpoints", "outputs/sweep/lr=0.001/fold0", "experiment=foo"],
])
def test_split_overrides_matches_jax(argv):
    assert test_eval.split_overrides(argv) == jsplit_overrides(argv)


def test_the_command_line_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_eval.main(["--output-file", "x.csv", "--checkpoints", "a.pt"])


def _touch(path, mtime):
    with open(path, "w") as fh:
        fh.write("x")
    os.utime(path, (mtime, mtime))


def _sidecar(fold_dir, best, mtime):
    path = os.path.join(fold_dir, "last.pt.meta.json")
    with open(path, "w") as fh:
        json.dump({"epoch": 0, "checkpoint_best_path": best}, fh)
    os.utime(path, (mtime, mtime))


def test_best_checkpoint_rule(tmp_path):
    """A fresh sidecar names the best; a stale one (a later epoch file more
    than 1 s newer) or none gives the newest epoch file; a fold without
    checkpoints is skipped; fold10 sorts after fold2."""
    t = time.time() - 100
    root = tmp_path / "checkpoints"
    dirs = {}
    for i in (0, 1, 2, 3, 10):
        dirs[i] = str(root / f"fold{i}")
        os.makedirs(dirs[i])
    # fold0: fresh sidecar naming the older of two epoch files
    a, b = (os.path.join(dirs[0], f"epoch00{e}_m0.5.pt") for e in (0, 1))
    _touch(a, t)
    _touch(b, t + 0.5)
    _sidecar(dirs[0], a, t + 1)
    # fold1: a stale sidecar (an epoch file 5 s newer)
    c, d = (os.path.join(dirs[1], f"epoch00{e}_m0.5.pt") for e in (0, 1))
    _touch(c, t)
    _sidecar(dirs[1], c, t + 1)
    _touch(d, t + 6)
    # fold2: no sidecar, one epoch file
    e = os.path.join(dirs[2], "epoch000_m0.5.pt")
    _touch(e, t)
    # fold3: nothing; fold10: no sidecar, two epoch files
    f, g = (os.path.join(dirs[10], f"epoch00{i}_m0.5.pt") for i in (0, 1))
    _touch(f, t + 3)
    _touch(g, t + 2)
    assert driver.best_checkpoints(str(tmp_path)) == [
        (0, a), (1, d), (2, e), (10, f)]


def test_test_true_without_checkpoints_returns_nothing(tmp_path):
    cfg = apply_overrides(get_experiment("smoke_synthetic_only_imaging"),
                          [f"output_dir={tmp_path}"])
    assert driver._evaluate_test_set(cfg, None, CPU) == {}


# --------------------------------------------------------------------------
# (k) the trainer traces the first epoch of a fresh fit only
# --------------------------------------------------------------------------

def test_profile_traces_epoch_zero_and_never_a_resumed_fit(tmp_path,
                                                           monkeypatch):
    opened = []

    @contextlib.contextmanager
    def fake_trace(path):
        opened.append(path)
        yield

    monkeypatch.setattr(loop, "trace", fake_trace)
    cfg = apply_overrides(get_experiment("smoke_synthetic_only_imaging"), [
        "model.model=resnet_micro", "data.image_size=32",
        "data.batch_size=8", "data.synthetic_num_samples=48",
        "trainer.max_epochs=2", "trainer.profile=true",
        f"trainer.profile_dir={tmp_path / 'prof'}"])
    cfg.output_dir = str(tmp_path)

    def trainer(ckpt_dir):
        fold = next(build_datamodule(cfg, CPU).folds())
        task = build_task(TrainConfig.from_config(cfg), fold.statics, CPU)
        return Trainer(cfg, task, fold.train_loader, fold.val_loaders,
                       checkpoint_dir=str(tmp_path / ckpt_dir))

    first = trainer("a")
    first.fit(max_epochs=1)
    assert opened == [str(tmp_path / "prof")]
    resumed = trainer("b")
    resumed.load_resume_state(str(tmp_path / "a" / "last.pt"))
    assert resumed.start_epoch == 1
    resumed.fit()
    assert opened == [str(tmp_path / "prof")]
    fresh = trainer("c")
    fresh.fit()
    assert opened == [str(tmp_path / "prof")] * 2
