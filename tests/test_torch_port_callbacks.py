"""The port's callbacks and checkpoints (``vlp_tpu_torch/train/
callbacks.py``, ``vlp_tpu_torch/utils/checkpoint.py``) on the CPU:
``EarlyStopping`` and ``MetricSnapshot`` against the JAX package's on the
same metric streams (equal state and summaries); the linear probe against
the JAX callback (scikit-learn) on fixed features; checkpoint round trips,
async and sync writes giving the same files, ``last`` surviving a write
that fails midway, a new best at its predecessor's path kept, the commit
barrier when ``fit`` raises; the VLP -> classifier transfer against the
JAX package's ``extract_image_encoder``/``graft_backbone`` on converted
trees (equal tensors), and through the driver (a micro VLP run's best
checkpoint grafted bit-equal before the fine-tune's first step); the
driver's reuse of completed folds only under the same config.

The probe: the port solves sklearn's objective (L2, C = 1, intercept
unpenalised) by Newton's method to a gradient of 1e-10; sklearn's lbfgs
stops earlier, at a projected gradient of 1e-4 on the objective divided by
the sample count, up to 2.2e-3 from the optimum in probability on these
features (1.2e-4 to 4.2e-4 with tol=1e-10). So the port's objective must
be at most sklearn's (its optimum is at least as good), its probabilities
within 5e-3 of the JAX callback's ``LogisticRegression(max_iter=1000)``,
and the metrics, which threshold or rank the probabilities, equal to the
JAX callback's.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from sklearn.linear_model import LogisticRegression

from vlp_tpu.config import apply_overrides as japply
from vlp_tpu.config import get_experiment as jget
from vlp_tpu.models.tasks import TaskStatics as JStatics
from vlp_tpu.models.tasks import build_task as jbuild_task
from vlp_tpu.train import callbacks as jcb
from vlp_tpu.utils import checkpoint as jckpt
from vlp_tpu.utils.logging import MemorySink as JSink
from vlp_tpu_torch import convert
from vlp_tpu_torch.config import TrainConfig, apply_overrides, get_experiment
from vlp_tpu_torch.models.tasks import TaskStatics, build_task
from vlp_tpu_torch.models.vit import flax_init_
from vlp_tpu_torch.train import callbacks as cb
from vlp_tpu_torch.train.optim import make_optimizer
from vlp_tpu_torch.train.state import TrainState
from vlp_tpu_torch.train.setup import random_batch
from vlp_tpu_torch.train.step import make_train_step, to_device
from vlp_tpu_torch.utils import checkpoint as ckpt
from vlp_tpu_torch.utils.logging import MemorySink

CPU = torch.device("cpu")
PROBE_TOL = 5e-3


# --------------------------------------------------------------------------
# early stopping and the snapshot
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["max", "min"])
def test_early_stopping_and_snapshot_match_jax_on_metric_streams(mode):
    rng = np.random.default_rng(1 if mode == "max" else 2)
    ours = cb.EarlyStopping("m", mode, patience=3, min_epochs=4)
    theirs = jcb.EarlyStopping("m", mode, patience=3, min_epochs=4)
    sink, jsink = MemorySink(), JSink()
    snap, jsnap = cb.MetricSnapshot(sink, "m", mode), \
        jcb.MetricSnapshot(jsink, "m", mode)
    for epoch in range(30):
        metrics = {"other": float(rng.random()), "epoch": epoch}
        if rng.random() > 0.2:  # the monitor is missing some epochs
            metrics["m"] = float(np.round(rng.random(), 1))
        for a, b in ((ours, theirs), (snap, jsnap)):
            a.on_validation_end(epoch, metrics)
            b.on_validation_end(epoch, metrics)
        assert (ours.best, ours.wait, ours.should_stop) == \
            (theirs.best, theirs.wait, theirs.should_stop)
        assert snap.best == jsnap.best and snap.snapshot == jsnap.snapshot
        assert sink.summary == jsink.summary
    assert ours.should_stop
    fresh, jfresh = MemorySink(), JSink()
    cb.MetricSnapshot(fresh, "m").restore(snap.best, snap.snapshot)
    jcb.MetricSnapshot(jfresh, "m").restore(jsnap.best, jsnap.snapshot)
    assert fresh.summary == jfresh.summary == snap.snapshot


# --------------------------------------------------------------------------
# the linear probe
# --------------------------------------------------------------------------

def _features(seed, n_tr=48, n_va=24, d=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_tr + n_va, d)).astype(np.float32) * 2.0
    y = (x[:, 0] + x[:, 1] + rng.normal(size=n_tr + n_va) > 0).astype(int)
    return x[:n_tr], y[:n_tr], x[n_tr:], y[n_tr:]


def _objective(x, y, w, b):
    z = np.asarray(x, np.float64) @ w + b
    return np.sum(np.logaddexp(0, z) - y * z) + 0.5 * np.sum(w * w)


@pytest.mark.parametrize("seed", range(4))
def test_linear_probe_matches_the_sklearn_callback(seed):
    feats = _features(seed, d=8 + 8 * seed)
    got = cb.LinearProbeCallback(lambda: feats, every_n_epochs=5)
    want = jcb.LinearProbeCallback(lambda variables: feats, every_n_epochs=5)
    assert got.on_validation_start(3) == {} == \
        want.on_validation_start(3, None)
    metrics = got.on_validation_start(5)
    assert metrics == want.on_validation_start(5, None)
    assert set(metrics) == {
        "downstream_validation/linear_probe_balanced_accuracy",
        "downstream_validation/linear_probe_auroc"}
    x_tr, y_tr, x_va, _ = feats
    w, b = cb.fit_logistic_regression(x_tr, y_tr)
    clf = LogisticRegression(max_iter=1000).fit(x_tr, y_tr)
    assert _objective(x_tr, y_tr, w, b) <= _objective(
        x_tr, y_tr, clf.coef_[0].astype(np.float64),
        float(clf.intercept_[0])) + 1e-12
    gap = np.abs(cb.predict_proba(x_va, w, b)
                 - clf.predict_proba(x_va)[:, 1]).max()
    assert gap <= PROBE_TOL


def test_linear_probe_skips_single_class_data():
    x_tr, y_tr, x_va, y_va = _features(0)
    probe = cb.LinearProbeCallback(lambda: (x_tr, y_tr, x_va, y_va * 0))
    assert probe.on_validation_start(0) == {} and probe.skipped_last
    probe.extract_features = lambda: (x_tr, y_tr, x_va, y_va)
    assert probe.on_validation_start(0) and not probe.skipped_last


def test_balanced_accuracy_is_sklearns():
    from sklearn.metrics import balanced_accuracy_score

    rng = np.random.default_rng(0)
    for _ in range(5):
        y, p = rng.integers(0, 2, 30), rng.integers(0, 2, 30)
        assert cb.balanced_accuracy(y, p) == balanced_accuracy_score(y, p)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _state(seed=0, steps=1):
    cfg = apply_overrides(get_experiment("smoke_synthetic_only_imaging"), [
        "model.model=resnet_micro", "data.image_size=32"])
    tcfg = TrainConfig.from_config(cfg)
    task = build_task(tcfg, TaskStatics(mean=100.0, std=50.0), CPU)
    flax_init_(task.model, torch.Generator().manual_seed(seed))
    opt, schedules = make_optimizer(tcfg, task.model, 4)
    state = TrainState.create(task.model, opt, schedules, seed=seed)
    step = make_train_step(task, opt, schedules)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        step(state, to_device(random_batch(rng, 4, 32), CPU))
    return state


def _equal_states(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i in oa["state"]:
        for k in oa["state"][i]:
            assert torch.equal(oa["state"][i][k], ob["state"][i][k])
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_full_state_round_trip(tmp_path):
    state = _state(steps=2)
    path = ckpt.save_train_state(str(tmp_path / "s.pt"), state,
                                 meta={"epoch": 3})
    assert ckpt.load_meta(path) == {"epoch": 3}
    assert ckpt.load_meta(str(tmp_path / "none.pt")) is None
    other = _state(seed=1, steps=1)
    ckpt.restore_train_state(path, other)
    _equal_states(state, other)
    assert not os.path.exists(path + ".tmp")


def test_async_and_sync_writes_give_the_same_files(tmp_path):
    state = _state()
    for mode in (True, False):
        saver = ckpt.LastStateSaver(str(tmp_path / f"{mode}" / "last.pt"),
                                    async_write=mode)
        best = ckpt.Checkpointer(str(tmp_path / f"{mode}"), "m",
                                 async_write=mode)
        os.makedirs(tmp_path / f"{mode}", exist_ok=True)
        saver.save(state, meta={"epoch": 0})
        assert best.maybe_save({"m": 0.25}, state, 0, meta={"epoch": 0})
        assert not best.maybe_save({"m": 0.125}, state, 1)
        saver.wait()
        best.wait()
    for name in ("last.pt", "last.pt.meta.json", "epoch000_m0.2500.pt"):
        with open(tmp_path / "True" / name, "rb") as a, \
                open(tmp_path / "False" / name, "rb") as b:
            assert a.read() == b.read(), name
    metas = [json.loads((tmp_path / d / "epoch000_m0.2500.pt.meta.json")
                        .read_text()) for d in ("True", "False")]
    for meta, d in zip(metas, ("True", "False")):
        assert meta.pop("checkpoint_best_path") == str(
            tmp_path / d / "epoch000_m0.2500.pt")
    assert metas[0] == metas[1] == {"epoch": 0, "checkpoint_best": 0.25}


@pytest.mark.parametrize("async_write", [True, False])
def test_last_survives_a_write_that_fails_midway(tmp_path, monkeypatch,
                                                 async_write):
    first, second = _state(0), _state(1)
    saver = ckpt.LastStateSaver(str(tmp_path / "last.pt"),
                                async_write=async_write)
    saver.save(first, meta={"epoch": 0})
    saver.wait()
    real_save = torch.save

    def torn(obj, path):
        with open(path, "wb") as fh:
            fh.write(b"a torn body")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn)
    with pytest.raises(OSError, match="disk full"):
        saver.save(second, meta={"epoch": 1})
        saver.wait()
    monkeypatch.setattr(torch, "save", real_save)
    assert ckpt.load_meta(str(tmp_path / "last.pt")) == {"epoch": 0}
    restored = _state(2)
    ckpt.restore_train_state(str(tmp_path / "last.pt"), restored)
    _equal_states(first, restored)


def test_a_new_best_at_the_old_path_is_kept(tmp_path):
    state = _state()
    best = ckpt.Checkpointer(str(tmp_path), "m", async_write=True)
    assert best.maybe_save({"m": 0.50001}, state, 0, meta={"epoch": 0})
    first = best.best_path
    assert best.maybe_save({"m": 0.50002}, state, 0, meta={"epoch": 0})
    assert best.best_path == first
    best.wait()
    assert os.path.exists(first) and os.path.exists(first + ".meta.json")
    assert best.maybe_save({"m": 0.75}, state, 1)
    best.wait()
    assert not os.path.exists(first)
    assert sorted(os.listdir(tmp_path)) == ["epoch001_m0.7500.pt"]
    assert ckpt.restore_raw(best.best_path)["step"] == state.step


def test_the_barrier_runs_when_fit_raises(tmp_path, monkeypatch):
    from vlp_tpu_torch.train.loop import Trainer

    committed = []

    class Boom(RuntimeError):
        pass

    def fit_body(self, max_epochs):
        self.checkpointer.maybe_save({"val/combined/accuracy": 0.5},
                                     self.state, 0)
        raise Boom()

    monkeypatch.setattr(Trainer, "_fit", fit_body)
    tr = Trainer.__new__(Trainer)
    tr.state = _state()
    tr.checkpointer = ckpt.Checkpointer(str(tmp_path),
                                        "val/combined/accuracy")
    tr._last_saver = None
    real = tr.checkpointer.wait
    tr.checkpointer.wait = lambda: (real(), committed.append(True))
    with pytest.raises(Boom):
        tr.fit()
    assert committed == [True]
    assert os.path.exists(tr.checkpointer.best_path)


# --------------------------------------------------------------------------
# the VLP -> classifier transfer
# --------------------------------------------------------------------------

def _jax_tasks():
    overrides = ["model.model=resnet_micro", "model.text_model=microbert",
                 "data.image_size=32", "trainer.precision=fp32"]
    vcfg = japply(jget("smoke_synthetic_pretrain"), overrides)
    ccfg = japply(jget("smoke_synthetic_only_imaging"), overrides)
    statics = JStatics(mean=100.0, std=50.0)
    batch = {"image_u8": np.zeros((2, 32, 32), np.uint8),
             "input_ids": np.zeros((2, 8), np.int32),
             "attention_mask": np.ones((2, 8), np.int32),
             "label": np.zeros(2, np.int32)}
    vvars = jbuild_task(vcfg, statics).init_variables(
        jax.random.key(0), batch)
    cvars = jbuild_task(ccfg, statics).init_variables(
        jax.random.key(1), batch)
    return vcfg, ccfg, jax.device_get(vvars), jax.device_get(cvars)


def _perturbed_stats(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.random(
        np.shape(a)).astype(np.float32), tree)


def test_graft_matches_the_jax_transfer():
    vcfg, ccfg, vvars, cvars = _jax_tasks()
    vvars = {**vvars, "batch_stats": _perturbed_stats(vvars["batch_stats"],
                                                      0)}
    # the JAX driver's transfer: params and BatchNorm statistics
    jparams = jckpt.graft_backbone(
        cvars["params"], jckpt.extract_image_encoder(vvars["params"]))
    jstats = {**cvars["batch_stats"],
              "backbone": vvars["batch_stats"]["image_encoder"]}
    tv = build_task(TrainConfig.from_config(apply_overrides(
        get_experiment("smoke_synthetic_pretrain"),
        ["model.model=resnet_micro", "model.text_model=microbert"])),
        TaskStatics(), CPU)
    tc = build_task(TrainConfig.from_config(apply_overrides(
        get_experiment("smoke_synthetic_only_imaging"),
        ["model.model=resnet_micro"])), TaskStatics(), CPU)
    convert.load_weights(tv.model, vvars)
    convert.load_weights(tc.model, cvars)
    grafted = ckpt.graft_backbone(
        tc.model.state_dict(),
        ckpt.extract_image_encoder(tv.model.state_dict()))
    want = convert.state_dict_from_flax(
        {"params": jparams, "batch_stats": jstats}, tc.model)
    assert grafted.keys() == want.keys()
    for k in want:
        assert torch.equal(grafted[k], want[k]), k
    assert any(k.endswith("running_var") for k in grafted)
    tc.model.load_state_dict(grafted)


def test_graft_refuses_keys_and_shapes_that_do_not_match():
    tc = build_task(TrainConfig.from_config(apply_overrides(
        get_experiment("smoke_synthetic_only_imaging"),
        ["model.model=resnet_micro"])), TaskStatics(), CPU)
    state = tc.model.state_dict()
    encoder = {k[len("backbone."):]: v for k, v in state.items()
               if k.startswith("backbone.")}
    missing = dict(encoder)
    missing.pop(next(iter(missing)))
    with pytest.raises(KeyError, match="missing in source"):
        ckpt.graft_backbone(state, missing)
    with pytest.raises(KeyError, match="no place"):
        ckpt.graft_backbone(state, {**encoder, "extra.weight": torch.ones(1)})
    key = next(k for k, v in encoder.items() if v.dim() == 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.graft_backbone(state, {**encoder, key: encoder[key][:1]})
    with pytest.raises(KeyError, match="image_encoder"):
        ckpt.extract_image_encoder(state)


# --------------------------------------------------------------------------
# the driver's use of checkpoints: warm start and completed folds
# --------------------------------------------------------------------------

MICRO = ["model.model=resnet_micro", "model.text_model=microbert",
         "data.image_size=32", "downstream_data.image_size=32",
         "data.synthetic_num_samples=40", "trainer.max_epochs=1",
         "trainer.linear_probe_every_n_epochs=1"]


def test_warm_start_grafts_the_vlp_checkpoints_encoder(tmp_path,
                                                       monkeypatch):
    from vlp_tpu_torch.train import driver
    from vlp_tpu_torch.train.loop import Trainer

    pre = apply_overrides(get_experiment("smoke_synthetic_pretrain"),
                          MICRO + [f"output_dir={tmp_path / 'pre'}"])
    driver.train(pre, "cpu")
    best = ckpt.load_meta(str(tmp_path / "pre" / "checkpoints" / "fold0"
                              / "last.pt"))["checkpoint_best_path"]
    encoder = ckpt.extract_image_encoder(ckpt.restore_raw(best)["model"])
    seen = []
    fit = Trainer.fit

    def checked_fit(self, *args, **kwargs):
        state = self.state.model.backbone.state_dict()
        seen.append(state.keys() == encoder.keys() and all(
            torch.equal(state[k], encoder[k]) for k in state))
        return fit(self, *args, **kwargs)

    monkeypatch.setattr(Trainer, "fit", checked_fit)
    base = ["model.model=resnet_micro", "data.image_size=32",
            "data.name=synthetic_downstream", "data.synthetic_num_samples=40",
            "trainer.max_epochs=1", "k_fold_cross_validation=false"]
    fine = apply_overrides(get_experiment(
        "vlp_finetune_only_imaging_resnet34"),
        base + [f"model.pretrained_ckpt={best}",
                f"output_dir={tmp_path / 'fine'}"])
    driver.train(fine, "cpu")
    assert seen == [True]
    for path, err in (("REQUIRED:x", ValueError),
                      (str(tmp_path / "none.pt"), FileNotFoundError)):
        bad = apply_overrides(get_experiment(
            "vlp_finetune_only_imaging_resnet34"),
            base + [f"model.pretrained_ckpt={path}",
                    f"output_dir={tmp_path / 'bad'}"])
        with pytest.raises(err):
            driver.train(bad, "cpu")


def test_completed_folds_are_reused_only_under_the_same_config(
        tmp_path, monkeypatch):
    from vlp_tpu_torch.train import driver
    from vlp_tpu_torch.train.loop import Trainer

    args = ["model.model=resnet_micro", "data.image_size=32",
            "data.synthetic_num_samples=40", "trainer.max_epochs=1",
            "resume_completed_folds=true", f"output_dir={tmp_path}"]
    cfg = apply_overrides(get_experiment("smoke_synthetic_only_imaging"),
                          args)
    first = driver.train(cfg, "cpu")
    fits = []
    fit = Trainer.fit
    monkeypatch.setattr(Trainer, "fit", lambda self, *a, **k: (
        fits.append(1), fit(self, *a, **k))[1])
    again = driver.train(cfg, "cpu")
    assert fits == [] and again == first
    changed = apply_overrides(get_experiment("smoke_synthetic_only_imaging"),
                              args + ["optimizer.lr=0.5"])
    driver.train(changed, "cpu")
    assert fits == [1]
