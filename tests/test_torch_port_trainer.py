"""The port's trainer and k-fold driver (``vlp_tpu_torch/train/loop.py``,
``driver.py``) against the JAX package's, on the CPU.

One epoch of one step at lr 0 (``cosine_warmup``'s lr at step 0;
augmentation off, fp32, ``resnet_micro`` at 32 px, and ``microbert`` on
16-token captions for VLP) through both ``Trainer``s, on the same synthetic
fold (the port's data module gives the JAX one's batches) and the same
weights (the JAX trainer's, carried across by ``convert``): the same metric
keys, and the values within the tolerances below. The step at lr 0 moves
no weight but trains BatchNorm's running statistics on the padded batch,
which the validation then reads. Then resume (bit-equal on the CPU), the
NaN guard, the missing-monitor rule, the commit barrier, ``aggregate_folds``
and the parameter counts against the JAX package's, the profiler trace,
and the command line in a subprocess that cannot import JAX or the JAX
package.

Tolerances:
- the counts behind accuracy, precision, recall, F1 and balanced accuracy:
  equal (no logit lies within fp32 rounding of 0; checked);
- losses (train and validation) and the binned AUROC: 1e-5 relative, and
  the AUROC's histograms equal where no score moves a bin (checked through
  equal AUROC);
- VLP retrieval metrics: equal (the rankings agree; a rank changed moves a
  value by at least 1 / (rows x k));
- ``train/images_per_sec`` is a wall-clock rate: only its key is compared.
"""
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vlp_tpu.config import apply_overrides as japply
from vlp_tpu.config import get_experiment as jget
from vlp_tpu.data.datamodule import build_datamodule as jbuild_dm
from vlp_tpu.models.tasks import TaskStatics as JStatics
from vlp_tpu.models.tasks import build_task as jbuild_task
from vlp_tpu.train import driver as jdriver
from vlp_tpu.train.loop import Trainer as JTrainer
from vlp_tpu.utils.hparams import log_hyperparameters as jlog_hparams
from vlp_tpu.utils.logging import MemorySink as JSink
from vlp_tpu_torch import convert
from vlp_tpu_torch.config import TrainConfig, apply_overrides, get_experiment
from vlp_tpu_torch.data.datamodule import build_datamodule
from vlp_tpu_torch.models.tasks import TaskStatics, build_task
from vlp_tpu_torch.train import driver
from vlp_tpu_torch.train.callbacks import LinearProbeCallback
from vlp_tpu_torch.train.loop import Trainer
from vlp_tpu_torch.train.optim import make_optimizer
from vlp_tpu_torch.train.step import make_train_step
from vlp_tpu_torch.utils.hparams import log_hyperparameters
from vlp_tpu_torch.utils.logging import MemorySink
from vlp_tpu_torch.utils.profiling import StepTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
LOSS_REL = 1e-5
COUNT_METRICS = ("accuracy", "precision", "recall", "f1",
                 "balanced_accuracy")

CLASSIFIER = ["model.model=resnet_micro", "data.name=synthetic_downstream",
              "data.image_size=32", "data.batch_size=32",
              "data.eval_batch_size=8", "data.synthetic_num_samples=40",
              "data.disable_augmentations=true", "trainer.precision=fp32",
              "trainer.scan_steps=1", "trainer.max_epochs=1"]
VLP = ["model.model=resnet_micro", "model.text_model=microbert",
       "data.image_size=32", "data.batch_size=64", "data.eval_batch_size=8",
       "data.synthetic_num_samples=60", "data.disable_augmentations=true",
       "scheduler.name=cosine_warmup", "trainer.scan_steps=1",
       "trainer.checkpoint_monitor=val/combined/loss",
       "trainer.checkpoint_mode=min", "trainer.early_stopping_monitor=null"]


def _configs(name, overrides, tmp_path):
    jcfg = japply(jget(name), overrides)
    tcfg = apply_overrides(get_experiment(name), overrides)
    jcfg.output_dir = str(tmp_path / "jax")
    tcfg.output_dir = str(tmp_path / "port")
    return jcfg, tcfg


def _trainers(name, overrides, tmp_path):
    """Both trainers on fold 0, the port's with the JAX one's weights."""
    jcfg, tcfg = _configs(name, overrides, tmp_path)
    jfold = next(jbuild_dm(jcfg).folds())
    jtr = JTrainer(jcfg, jbuild_task(jcfg, jfold.statics),
                   jfold.train_loader, jfold.val_loaders)
    fold = next(build_datamodule(tcfg, CPU).folds())
    assert fold.statics.mean == jfold.statics.mean
    task = build_task(TrainConfig.from_config(tcfg), fold.statics, CPU)
    tr = Trainer(tcfg, task, fold.train_loader, fold.val_loaders)
    convert.load_weights(task.model, jax.device_get(jtr.variables))
    return jtr, tr


@pytest.mark.parametrize("name,overrides", [
    ("baseline_only_imaging_resnet34", CLASSIFIER),
    ("smoke_synthetic_pretrain", VLP)], ids=["classifier", "vlp"])
def test_one_epoch_at_lr0_matches_the_jax_trainer(name, overrides, tmp_path):
    jtr, tr = _trainers(name, overrides, tmp_path)
    assert len(tr.train_loader) == len(jtr.train_loader) == 1
    want, got = jtr.fit(), tr.fit()
    assert set(got) == set(want)
    assert tr.state.step == int(jtr.state.step) == 1
    assert tr.state.optimizer.param_groups[0]["lr"] == 0.0
    for key in sorted(want):
        if key in ("epoch", "train/images_per_sec"):
            continue
        w, g = float(want[key]), float(got[key])
        if key.rsplit("/", 1)[1] in COUNT_METRICS or "_at_" in key:
            assert g == w, (key, g, w)
        else:
            assert math.isclose(g, w, rel_tol=LOSS_REL, abs_tol=1e-7), \
                (key, g, w)
    if name == "smoke_synthetic_pretrain":
        assert any(k.startswith("val/lera/recall_at_") for k in got)


def _resume_cfg(tmp_path):
    cfg = apply_overrides(get_experiment("smoke_synthetic_only_imaging"), [
        "model.model=resnet_micro", "data.image_size=32",
        "data.batch_size=8", "data.synthetic_num_samples=48",
        "scheduler.name=cosine_warmup", "scheduler.warmup_epochs=1",
        "trainer.max_epochs=3", "data.shear_augmentation=true"])
    cfg.output_dir = str(tmp_path)
    return cfg


def _resume_trainer(cfg, ckpt_dir):
    fold = next(build_datamodule(cfg, CPU).folds())
    task = build_task(TrainConfig.from_config(cfg), fold.statics, CPU)
    return Trainer(cfg, task, fold.train_loader, fold.val_loaders,
                   checkpoint_dir=str(ckpt_dir))


def _timeless(metrics):
    return {k: v for k, v in metrics.items()
            if not k.endswith("train/images_per_sec")}


def _history(trainer):
    return [_timeless(rec) for rec in trainer.sink.history]


def test_resume_from_last_is_bit_equal(tmp_path):
    """3 epochs straight == 1 epoch, then a new process-like trainer
    resumed from ``last`` for 2 (the schedule at the restored step, the
    sampler's RNG, the generator, AdamW's moments, the running
    statistics)."""
    cfg = _resume_cfg(tmp_path)
    straight = _resume_trainer(cfg, tmp_path / "a")
    straight.fit()
    first = _resume_trainer(cfg, tmp_path / "b")
    first.fit(max_epochs=1)
    resumed = _resume_trainer(cfg, tmp_path / "c")
    resumed.load_resume_state(str(tmp_path / "b" / "last.pt"))
    assert resumed.start_epoch == 1 and resumed.state.step == \
        first.state.step
    resumed.fit()
    assert _history(first) + _history(resumed) == _history(straight)
    a, c = (t.state.model.state_dict() for t in (straight, resumed))
    assert all(torch.equal(a[k], c[k]) for k in a)
    assert _timeless(straight.snapshot.snapshot) == \
        _timeless(resumed.snapshot.snapshot)


def test_nan_loss_raises_and_the_barrier_still_commits(tmp_path,
                                                       monkeypatch):
    cfg = _resume_cfg(tmp_path)
    tr = _resume_trainer(cfg, tmp_path / "ck")
    real = tr.task.loss_fn

    def nan_loss(batch, gen):
        loss, aux = real(batch, gen)
        return loss * float("nan"), {**aux, "loss": loss * float("nan")}

    tr.train_step = make_train_step(
        type("T", (), {"loss_fn": staticmethod(nan_loss)}),
        tr.state.optimizer, tr.state.schedules)
    waited = []
    monkeypatch.setattr(tr._last_saver, "wait",
                        lambda: waited.append("last"))
    with pytest.raises(FloatingPointError, match="NaN at epoch 0"):
        tr.fit()
    assert waited == ["last"]


def test_a_monitor_that_never_appears_raises_unless_the_probe_skipped(
        tmp_path):
    cfg = _resume_cfg(tmp_path)
    cfg.trainer.max_epochs = 1
    cfg.trainer.checkpoint_monitor = "val/combined/no_such_metric"
    with pytest.raises(ValueError, match="never appeared"):
        _resume_trainer(cfg, tmp_path / "a").fit()
    tr = _resume_trainer(cfg, tmp_path / "b")
    probe = LinearProbeCallback(lambda: None)
    probe.skipped_last = True
    tr.linear_probe = probe
    probe.on_validation_start = lambda epoch: {}
    assert "val/combined/accuracy" in tr.fit()


def test_aggregate_folds_matches_jax():
    rng = np.random.default_rng(0)
    summaries = [{"a": float(rng.random()), "b": int(rng.integers(9)),
                  "c": "text", "config": {"x": 1}, "d": True}
                 for _ in range(4)]
    summaries[2]["only_here"] = 1.0
    assert driver.aggregate_folds(summaries) == \
        jdriver.aggregate_folds(summaries)
    assert driver.aggregate_folds([]) == jdriver.aggregate_folds([]) == {}


def test_config_fingerprint_and_checks(tmp_path, monkeypatch):
    for name in ("INTERNAL", "BTXRD", "MURA", "LERA"):
        monkeypatch.delenv(f"{name}_DATASET_PATH", raising=False)
    cfg = get_experiment("smoke_synthetic_only_imaging")
    jcfg = jget("smoke_synthetic_only_imaging")
    assert cfg.to_dict() == jcfg.to_dict()
    fp = driver._config_fingerprint(cfg)
    cfg.resume_completed_folds = True
    assert driver._config_fingerprint(cfg) == fp
    cfg.optimizer.lr = 0.5
    assert driver._config_fingerprint(cfg) != fp
    for overrides, err in ((["mesh.data_parallel=2"], ValueError),
                           (["mesh.model_parallel=2"], ValueError),
                           (["mesh.param_sharding=tp"], ValueError),
                           (["ckpt_path=x", "k_fold_cross_validation=true"],
                            ValueError),
                           # the real datasets without their roots, as
                           # the JAX package's readers refuse them
                           (["data.name=downstream"], OSError)):
        bad = apply_overrides(get_experiment("smoke_synthetic_only_imaging"),
                              overrides)
        bad.output_dir = str(tmp_path)
        with pytest.raises(err):
            driver.train(bad, "cpu")
    with pytest.raises(OSError, match="INTERNAL_DATASET_PATH"):
        driver.train(bad, "cpu")
    # test=true runs (the frozen test-set evaluation after the folds) and
    # stays out of the fingerprint
    good = get_experiment("smoke_synthetic_only_imaging")
    fp = driver._config_fingerprint(good)
    good.test = True
    driver._check_config(good)
    assert driver._config_fingerprint(good) == fp


# the subprocess cannot import these: the machine with the card has none
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "sklearn",
           "vlp_tpu")
# None in sys.modules: an import raises ImportError and find_spec gives
# None, as where the package is not installed
BLOCKER = f"""
import runpy, sys
sys.modules.update(dict.fromkeys({BLOCKED!r}))
sys.argv = ['vlp_tpu_torch.train'] + sys.argv[1:]
runpy.run_module('vlp_tpu_torch.train', run_name='__main__')
"""


def test_command_line_runs_without_jax(tmp_path):
    out = tmp_path / "run"
    args = ["--device", "cpu", "experiment=smoke_synthetic_only_imaging",
            "model.model=resnet_micro", "data.image_size=32",
            "data.synthetic_num_samples=40", "k_fold_cross_validation=true",
            "trainer.max_epochs=1", f"output_dir={out}"]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", BLOCKER, *args],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out / "cv_summary.json") as fh:
        summary = json.load(fh)
    assert summary["num_folds"] == 4
    for m in ("accuracy", "precision", "recall", "auroc"):
        v = summary[f"val/combined/accuracy_best_val/combined/{m}_mean"]
        assert 0.0 <= v <= 1.0
    assert sorted(p.name for p in out.glob("fold*.done.json")) == \
        [f"fold{i}.done.json" for i in range(4)]
    for i in range(4):
        names = os.listdir(out / "checkpoints" / f"fold{i}")
        assert "last.pt" in names and "last.pt.meta.json" in names
        assert sum(n.startswith("epoch000_") and n.endswith(".pt")
                   for n in names) == 1


def test_command_line_defaults_to_cuda():
    proc = subprocess.run(
        [sys.executable, "-c", "import torch; torch.cuda.is_available = "
         "lambda: False; from vlp_tpu_torch.train.driver import main; "
         "main(['experiment=smoke_synthetic_only_imaging'])"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("overrides", [[], ["model.freeze_encoder=true"]])
def test_parameter_counts_match_jax(overrides):
    base = ["model.model=resnet_micro", "data.image_size=32"] + overrides
    jcfg = japply(jget("smoke_synthetic_only_imaging"), base)
    cfg = apply_overrides(get_experiment("smoke_synthetic_only_imaging"),
                          base)
    variables = jbuild_task(jcfg, JStatics()).init_variables(
        jax.random.key(0), {"image_u8": np.zeros((1, 32, 32), np.uint8)})
    want = jlog_hparams(jcfg, variables["params"],
                {k: v for k, v in variables.items() if k != "params"},
                JSink())
    task = build_task(TrainConfig.from_config(cfg), TaskStatics(), CPU)
    make_optimizer(TrainConfig.from_config(cfg), task.model, 1)
    got = log_hyperparameters(cfg, task.model, MemorySink())
    assert got == want


def test_profile_trace_features_and_step_timer(tmp_path):
    cfg = _resume_cfg(tmp_path)
    cfg.trainer.max_epochs = 1
    cfg.trainer.profile = True
    cfg.trainer.profile_dir = str(tmp_path / "prof")
    tr = _resume_trainer(cfg, tmp_path / "ck")
    tr.fit()
    with open(tmp_path / "prof" / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)
    loader = tr.val_loaders["internal"]
    feats, labels = tr.extract_features(loader)
    assert feats.shape == (len(loader.bundle), 128) == \
        (labels.shape[0], 128)
    timer = StepTimer(warmup=1)
    for _ in range(3):
        timer.start()
        timer.stop(torch.zeros(1))
    stats = timer.stats(batch_size=8)
    assert len(timer._times) == 2 and stats["images_per_sec"] > 0
