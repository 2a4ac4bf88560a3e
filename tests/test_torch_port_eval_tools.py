"""The port's evaluation tooling (``vlp_tpu_torch/eval/plotting.py``,
``replot.py``, ``linear_probe_eval.py``, ``results_table.py``,
``latex.py``, ``eda.py``, the tasks' ``plot_outputs_fn`` and the driver's
post-fit pass) against the JAX package's and scikit-learn 1.9.0, on the
CPU, on inputs drawn by numpy from a seed.

Tolerances:
- silhouettes: 1e-6 of the JAX function's (scikit-learn's distances of
  fp32 features are rounded to fp32; the port's are fp64);
- t-SNE's P: 1e-6 absolute of scikit-learn's private
  ``sklearn.manifold._t_sne._joint_probabilities_nn`` (pinned to
  scikit-learn 1.9.0) on the same nearest-neighbour graph;
- the embedding: its KL divergence within 10% of ``TSNE(...).
  kl_divergence_`` with the JAX call's arguments (the port's gradient is
  exact, scikit-learn's Barnes-Hut), and ``trustworthiness`` within 0.02
  of that embedding's;
- confusion counts, tables, LaTeX and the EDA report: equal (bytes);
- ``plot_outputs_fn``: 2e-5 of the largest |value| (the eval-mode
  tolerance of test_torch_port_fusion.py; the tiny NesT's kernels in
  Pallas interpret mode on the JAX side);
- the linear probe's probabilities: 5e-3 of ``LogisticRegression(
  max_iter=1000)``'s (test_torch_port_callbacks.py: scikit-learn's lbfgs
  stops short of the optimum the port's Newton fit reaches);
- two gloo ranks' silhouettes: 1e-6 of one process's (eval-mode rows in
  other batches round differently).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from sklearn.linear_model import LogisticRegression
from sklearn.manifold import TSNE, _t_sne, trustworthiness
from sklearn.neighbors import NearestNeighbors

from torch_parallel_workers import FSDP_TRAINER, post_fit_worker, run_ranks
from vlp_tpu.config import get_experiment as jget
from vlp_tpu.eval import eda as jeda
from vlp_tpu.eval import latex as jlatex
from vlp_tpu.eval import plotting as jplotting
from vlp_tpu.eval import results_table as jresults
from vlp_tpu.eval import subgroup as jsub
from vlp_tpu.models import nest as jnest
from vlp_tpu.models.tasks import TaskStatics as JStatics
from vlp_tpu.models.tasks import build_task as jbuild_task
from vlp_tpu.ops.augment import AugmentConfig as JAugment
from vlp_tpu_torch import convert
from vlp_tpu_torch.config import (TrainConfig, apply_overrides,
                                  get_experiment)
from vlp_tpu_torch.data.datamodule import (DownstreamData, PretrainData,
                                           downstream_config)
from vlp_tpu_torch.eval import eda, latex, linear_probe_eval, plotting
from vlp_tpu_torch.eval import replot, results_table, subgroup
from vlp_tpu_torch.models import nest as tnest
from vlp_tpu_torch.models.tasks import TaskStatics, build_task
from vlp_tpu_torch.train import driver
from vlp_tpu_torch.train.step import collect_over_loader, to_device
from vlp_tpu_torch.utils import checkpoint as ckpt
from vlp_tpu_torch.utils.yaml_subset import safe_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SIL_ABS = 1e-6
P_ABS = 1e-6
KL_REL = 0.10
TRUST_ABS = 0.02
EVAL_REL = 2e-5
PROBE_ABS = 5e-3
TINY = dict(img_size=16, patch_size=2, embed_dims=(16, 32), num_heads=(2, 4),
            depths=(1, 1), block_size=4)
CLASSIFIER = ["model.model=resnet_micro", "data.name=synthetic_downstream",
              "data.image_size=32", "data.batch_size=16",
              "data.eval_batch_size=8", "data.synthetic_num_samples=64",
              "data.disable_augmentations=true", "trainer.precision=fp32",
              "trainer.max_epochs=1", "k_fold_cross_validation=false",
              "trainer.async_checkpointing=false"]
VLP = ["model.model=resnet_micro", "model.text_model=microbert",
       "data.image_size=32", "downstream_data.image_size=32",
       "data.synthetic_num_samples=40",
       "downstream_data.synthetic_num_samples=64",
       "trainer.precision=fp32"]


def _clusters(seed, n, f, k=3):
    """[n, f] fp32 features around ``k`` centres, and their labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, n)
    centres = rng.normal(0.0, 3.0, (k, f))
    x = centres[labels] + rng.normal(0.0, 1.0, (n, f))
    return x.astype(np.float32), labels


# --------------------------------------------------------------------------
# plotting: silhouettes, P, the embedding, the confusion counts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("datasets", ["two", "one"])
def test_silhouettes_match_the_jax_function(datasets, tmp_path):
    x, y = _clusters(0, 60, 24, k=2)
    names = np.where(np.arange(60) % 3 == 0, "btxrd", "internal") \
        if datasets == "two" else np.full(60, "internal")
    want = jplotting.plot_tsne_and_silhouette(
        x, y, list(names), str(tmp_path / "jax.png"))
    got = plotting.plot_tsne_and_silhouette(
        torch.from_numpy(x), torch.from_numpy(y), list(names),
        str(tmp_path / "port.png"), draw=False)
    assert set(got) == set(want)
    assert ("silhouette_dataset" in got) == (datasets == "two")
    for k in want:
        assert abs(got[k] - want[k]) <= SIL_ABS, k
    assert not (tmp_path / "port.png").exists()
    # a singleton cluster scores 0 as in scikit-learn; three-dim features
    # are flattened
    y1 = y.copy()
    y1[0] = 7
    from sklearn.metrics import silhouette_score as sk_silhouette
    assert abs(plotting.silhouette_score(x.reshape(60, 4, 6), y1)
               - sk_silhouette(x, y1)) <= SIL_ABS
    with pytest.raises(ValueError, match="Number of labels"):
        plotting.silhouette_score(x[:3], [0, 1, 2])


@pytest.mark.parametrize("n,f", [(40, 16), (150, 64)])
def test_joint_probabilities_match_sklearn(n, f):
    """P against ``_joint_probabilities_nn`` (scikit-learn 1.9.0's private
    function) on scikit-learn's own neighbour graph."""
    x, _ = _clusters(n, n, f)
    perplexity = plotting.default_perplexity(n)
    k = min(n - 1, int(3.0 * perplexity + 1))
    graph = NearestNeighbors(n_neighbors=k).fit(x).kneighbors_graph(
        mode="distance")
    graph.data **= 2
    want = _t_sne._joint_probabilities_nn(graph, perplexity, 0).toarray()
    got = plotting.joint_probabilities_nn(torch.from_numpy(x), perplexity)
    assert got.dtype == torch.float64 and got.shape == (n, n)
    assert np.abs(got.numpy() - want).max() <= P_ABS
    assert abs(float(got.sum()) - 1.0) <= 1e-12


def test_tsne_matches_sklearn_kl_and_trustworthiness():
    x, _ = _clusters(3, 120, 32)
    perplexity = min(30, max(2, len(x) // 4))
    sk = TSNE(n_components=2, random_state=42, perplexity=perplexity)
    want = sk.fit_transform(x)
    emb, kl = plotting.tsne(torch.from_numpy(x))
    assert emb.shape == (120, 2) and emb.dtype == torch.float32
    assert torch.isfinite(emb).all()
    assert abs(kl - sk.kl_divergence_) <= KL_REL * sk.kl_divergence_
    assert abs(trustworthiness(x, emb.numpy())
               - trustworthiness(x, want)) <= TRUST_ABS
    with pytest.raises(ValueError, match="perplexity"):
        plotting.tsne(torch.from_numpy(x[:2]))


def test_confusion_counts_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    probs = rng.uniform(0, 1, 50).astype(np.float32)
    probs[:6] = 0.5  # at the threshold: predicted positive
    labels = rng.integers(0, 2, 50)
    want = jplotting.plot_confusion_matrix(probs, labels,
                                           str(tmp_path / "jax.png"))
    got = plotting.plot_confusion_matrix(torch.from_numpy(probs),
                                         torch.from_numpy(labels),
                                         str(tmp_path / "port.png"))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (tmp_path / "port.png").stat().st_size > 0
    counts = plotting.confusion_counts(torch.full((3,), 0.5),
                                       torch.tensor([0, 1, 1]))
    assert counts.tolist() == [[0, 1], [0, 2]]


# --------------------------------------------------------------------------
# the tasks' plot_outputs_fn against the JAX tasks'
# --------------------------------------------------------------------------

@pytest.fixture
def tiny_nest(monkeypatch):
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jnest, "nest_small",
                        lambda **kw: jnest.NesT(**TINY, **kw))
    monkeypatch.setattr(tnest, "nest_small",
                        lambda **kw: tnest.NesT(**TINY, **kw))


@pytest.mark.parametrize("experiment", ["baseline_only_imaging_nest_small",
                                        "baseline_fusion_nest_small"],
                         ids=["imaging", "fusion"])
def test_plot_outputs_fn_matches_jax(tiny_nest, experiment):
    cfg = jget(experiment)
    cfg.trainer.precision = "fp32"
    cfg.data.image_size = 16
    cfg.data.disable_augmentations = True
    rng = np.random.default_rng(5)
    b = 6
    batch = {"image_u8": rng.integers(0, 256, (b, 16, 16), dtype=np.uint8),
             "label": np.asarray([0, 1, 1, 0, 1, 0], np.int32),
             "mask": np.ones(b, np.float32),
             "dataset_id": np.asarray([0, 1, 0, 1, 0, 1], np.int32),
             "clinical": rng.normal(0, 1, (b, 15)).astype(np.float32)}
    jbatch = jax.tree.map(jnp.asarray, batch)
    jtask = jbuild_task(cfg, JStatics(mean=120.0, std=50.0,
                                      augment=JAugment(enabled=False)))
    variables = jtask.init_variables(jax.random.key(0), jbatch)
    variables = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            p.shape).astype(np.float32), jax.device_get(variables))
    want = np.asarray(jax.jit(jtask.plot_outputs_fn)(variables, jbatch))
    tcfg = TrainConfig.from_config(cfg)
    task = build_task(tcfg, TaskStatics(mean=120.0, std=50.0,
                                        augment=tcfg.augment()))
    convert.load_weights(task.model, variables)
    task.model.train()
    got = task.plot_outputs_fn(to_device(batch, CPU))
    assert not task.model.training
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= EVAL_REL * np.abs(want).max()
    feats = task.features_fn(to_device(batch, CPU))
    logits = task.eval_fn(to_device(batch, CPU))["logits"]
    assert torch.equal(got[:, :-1], feats.float())
    assert torch.equal(got[:, -1], logits.float())


# --------------------------------------------------------------------------
# the driver's post-fit pass, replot
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def classifier_run(tmp_path_factory):
    """One fold of the micro classifier through ``driver.main``."""
    out = tmp_path_factory.mktemp("post_fit")
    assert driver.main(["--device", "cpu",
                        "experiment=baseline_only_imaging_resnet34",
                        *CLASSIFIER, f"output_dir={out}"]) == 0
    return out


def _summary(out):
    with open(out / "fold0.done.json") as fh:
        return json.load(fh)["summary"]


def test_driver_writes_silhouettes_and_figures(classifier_run):
    out = classifier_run
    summary = _summary(out)
    with open(out / "cv_summary.json") as fh:
        agg = json.load(fh)
    for key in ("silhouette_tumor", "silhouette_dataset"):
        assert -1.0 <= summary[key] <= 1.0
        assert agg[f"{key}_mean"] == summary[key]
    assert {"confusion_val.png", "tsne_val.png"} <= set(
        os.listdir(out / "plots" / "fold0"))
    with open(out / "metrics_fold0.jsonl.summary.json") as fh:
        assert json.load(fh)["silhouette_tumor"] == \
            summary["silhouette_tumor"]


def test_driver_without_matplotlib_keeps_the_silhouettes(classifier_run,
                                                         tmp_path):
    """The same run in a process where matplotlib cannot be imported: the
    same silhouettes, no figure, one line naming each figure."""
    out = tmp_path / "run"
    code = ("import sys\n"
            "sys.modules['matplotlib'] = None\n"
            "from vlp_tpu_torch.train import driver\n"
            f"sys.exit(driver.main({['--device', 'cpu', 'experiment=baseline_only_imaging_resnet34', *CLASSIFIER, f'output_dir={out}']!r}))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want, got = _summary(classifier_run), _summary(out)
    for key in ("silhouette_tumor", "silhouette_dataset"):
        assert got[key] == pytest.approx(want[key], abs=SIL_ABS)
    assert not (out / "plots").exists()
    for name in ("tsne_val.png", "confusion_val.png"):
        line = f"matplotlib is not installed: {out}/plots/fold0/{name}"
        assert line in proc.stderr


def test_replot_draws_the_last_checkpoints_figures(classifier_run):
    out = classifier_run
    assert replot.main([str(out), "--device", "cpu",
                        "experiment=baseline_only_imaging_resnet34",
                        *CLASSIFIER]) == 0
    assert sorted(os.listdir(out / "plots" / "fold0")) == [
        "confusion_val.png", "confusion_val_retro.png", "tsne_val.png",
        "tsne_val_retro.png"]
    # the run's only epoch: the last checkpoint holds the final weights
    cfg = apply_overrides(get_experiment("baseline_only_imaging_resnet34"),
                          CLASSIFIER + [f"output_dir={out}"])
    dm = DownstreamData(cfg, CPU)
    task = build_task(cfg, dm.fold_statics(0), CPU)
    (best,) = sorted((out / "checkpoints" / "fold0").glob("epoch*.pt"))
    task.model.load_state_dict(ckpt.restore_raw(str(best))["model"])
    fold = next(dm.folds())
    feats, labels, names = [], [], []
    for name, loader in fold.val_loaders.items():
        f, y = collect_over_loader(task.plot_outputs_fn, loader)
        feats.append(f[:, :-1])
        labels.append(y)
        names += [name] * len(y)
    scores = plotting.plot_tsne_and_silhouette(
        torch.cat(feats), torch.cat(labels), names, "", draw=False)
    assert scores == {k: _summary(out)[k] for k in scores}


def test_two_gloo_ranks_give_one_process_silhouettes(tmp_path):
    one = post_fit_worker(None, [], str(tmp_path / "one"))
    two = run_ranks(post_fit_worker, 2, tmp_path, [], str(tmp_path / "two"))
    assert set(one["scores"]) == {"silhouette_tumor", "silhouette_dataset"}
    assert two[0]["scores"] == two[1]["scores"]  # the same gathered rows
    for k, v in one["scores"].items():
        assert two[0]["scores"][k] == pytest.approx(v, abs=SIL_ABS)
    figures = [os.path.join("plots", "fold0", f)
               for f in ("confusion_val.png", "tsne_val.png")]
    assert one["figures"] == two[0]["figures"] == figures
    assert two[1]["figures"] == []  # rank 0 alone draws


# --------------------------------------------------------------------------
# the offline linear probe
# --------------------------------------------------------------------------

def test_linear_probe_cli_matches_jax_table_and_sklearn(tmp_path):
    cfg = apply_overrides(get_experiment("smoke_synthetic_pretrain"),
                          VLP + [f"output_dir={tmp_path}"])
    torch.manual_seed(0)
    vlp = build_task(TrainConfig.from_config(cfg), TaskStatics(), CPU)
    path = ckpt.save(str(tmp_path / "vlp.pt"),
                     {"model": vlp.model.state_dict()})
    out = tmp_path / "probe.csv"
    overrides = ["experiment=smoke_synthetic_pretrain", *VLP,
                 f"output_dir={tmp_path}"]
    assert linear_probe_eval.main(["--output-file", str(out),
                                   "--checkpoint", path, "--device", "cpu",
                                   *overrides]) == 0
    frames = linear_probe_eval.probe_frames(cfg, path, CPU)
    dm = DownstreamData(downstream_config(cfg), CPU)
    assert len(frames) == cfg.downstream_data.n_folds_downstream
    jsub.evaluate_results(str(tmp_path / "jax.csv"), [
        jsub.predictions_frame(f["prob"], dm.test) for f in frames])
    assert out.read_bytes() == (tmp_path / "jax.csv").read_bytes()
    # fold 0's probabilities against scikit-learn on the same features
    vlp_cfg = apply_overrides(get_experiment("smoke_synthetic_pretrain"),
                              VLP)
    task = build_task(vlp_cfg, dm.fold_statics(0), CPU)
    task.model.load_state_dict(ckpt.restore_raw(path)["model"])
    fold = next(dm.folds())
    x_tr, y_tr = collect_over_loader(task.features_fn, fold.train_loader)
    x_te, _ = collect_over_loader(task.features_fn, dm.test_loader(0))
    clf = LogisticRegression(max_iter=1000).fit(x_tr.numpy(), y_tr.numpy())
    want = clf.predict_proba(x_te.numpy())[:, 1]
    probe = linear_probe_eval.probe_fold(vlp_cfg, ckpt.restore_raw(path)[
        "model"], dm, 0, CPU)
    assert np.abs(probe["probs"] - want).max() <= PROBE_ABS
    assert np.array_equal(frames[0]["prob"], probe["probs"])


# --------------------------------------------------------------------------
# the results table, LaTeX, EDA
# --------------------------------------------------------------------------

def _test_eval_run(root, seed, folds=4):
    """A run directory holding a ``test_eval.csv`` of random probabilities
    (some folds with one class in a subgroup: NaN metrics)."""
    rng = np.random.default_rng(seed)
    cfg = apply_overrides(get_experiment("smoke_synthetic_only_imaging"),
                          ["data.synthetic_num_samples=48",
                           "data.image_size=16"])
    cfg.output_dir = str(root)
    test = DownstreamData(cfg, CPU).test
    root.mkdir()
    subgroup.evaluate_results(str(root / "test_eval.csv"), [
        subgroup.predictions_frame(rng.uniform(0, 1, len(test)), test)
        for _ in range(folds)])
    return str(root)


def _cv_run(root, seed, metrics=("accuracy", "precision", "recall",
                                 "auroc")):
    rng = np.random.default_rng(seed)
    agg = {"num_folds": 4}
    for m in metrics:
        for mon in ("val/combined/accuracy", "val/combined/loss"):
            key = f"{mon}_best_val/combined/{m}"
            agg[f"{key}_mean"] = float(rng.uniform(0.5, 0.9))
            if m != "recall":  # a missing std reads 0
                agg[f"{key}_std"] = float(rng.uniform(0.0, 0.1))
    root.mkdir()
    with open(root / "cv_summary.json", "w") as fh:
        json.dump(agg, fh, indent=2)
    return str(root)


def test_results_table_is_byte_equal_to_jax(tmp_path):
    runs = {"scratch": _test_eval_run(tmp_path / "scratch", 0),
            "ours": _test_eval_run(tmp_path / "ours", 1),
            "val": _cv_run(tmp_path / "val", 2),
            "partial": _cv_run(tmp_path / "partial", 3,
                               ("accuracy", "auroc"))}
    spec_text = (
        "title: Bone-tumor detection, frozen test set (4-fold CV)\n"
        "rows:\n"
        "  - section: Imaging\n"
        "    experiment: Scratch Baseline\n"
        "    model: ResNet34\n"
        f"    run_dir: {runs['scratch']}\n"
        "  - section: Imaging\n"
        "    experiment: VLP Finetune (ours)\n"
        "    model: ResNet34\n"
        f"    run_dir: {runs['ours']}\n"
        "  - section: Imaging\n"
        "    experiment: Validation only\n"
        "    model: 34\n"
        f"    run_dir: {runs['val']}\n"
        "  - section: Fusion\n"
        "    model: NesT-S\n"
        f"    run_dir: {runs['partial']}\n"
        "  - experiment: scratch, no section\n"
        "    model: ResNet34\n"
        f"    run_dir: {runs['scratch']}\n"
        "  - experiment: Ours, no section\n"
        "    model: ResNet34\n"
        f"    run_dir: {runs['val']}\n")
    spec_path = tmp_path / "spec.yaml"
    spec_path.write_text(spec_text)
    assert safe_load(spec_text) == yaml.safe_load(spec_text)
    want_md, want_df = jresults.render_markdown(yaml.safe_load(spec_text))
    got_md, tidy = results_table.render_markdown(safe_load(spec_text))
    assert got_md == want_md
    assert "**" in got_md and "↑" in got_md and "—" in got_md
    want_df.to_csv(tmp_path / "jax.csv", index=False)
    assert results_table.main([str(spec_path), "--out",
                               str(tmp_path / "t.md"), "--csv",
                               str(tmp_path / "port.csv")]) == 0
    assert (tmp_path / "t.md").read_text() == want_md
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()
    assert len(tidy) == len(want_df)
    # an empty table
    results_table.write_tidy_csv(str(tmp_path / "empty.csv"), [])
    pd.DataFrame([]).to_csv(tmp_path / "jempty.csv", index=False)
    assert (tmp_path / "empty.csv").read_bytes() == \
        (tmp_path / "jempty.csv").read_bytes()
    with pytest.raises(FileNotFoundError):
        results_table.collect_row_metrics(str(tmp_path))


SWEEPS = sorted(os.path.relpath(os.path.join(d, f), REPO)
                for d, _, fs in os.walk(os.path.join(REPO, "configs",
                                                     "sweeps"))
                for f in fs if f.endswith(".yaml"))


@pytest.mark.parametrize("sweep", SWEEPS)
def test_sweep_space_latex_is_byte_equal_to_jax(sweep, capsys):
    path = os.path.join(REPO, sweep)
    with open(path) as fh:
        text = fh.read()
    want = jlatex.sweep_space_to_latex(yaml.safe_load(text))
    assert latex.sweep_space_to_latex(safe_load(text)) == want
    assert latex.main(["space", path]) == 0
    assert capsys.readouterr().out == want + "\n"


def test_best_and_results_latex_are_byte_equal_to_jax(tmp_path, capsys):
    trials = tmp_path / "sweep_results.jsonl"
    trials.write_text("\n".join(json.dumps(r) for r in (
        {"params": {"optimizer.lr": 1e-4, "model.model": "resnet_34"},
         "value": 0.71},
        {"params": {"optimizer.lr": 3.3e-3, "model.model": "nest_small",
                    "data.batch_size": 64, "trainer.remat": True},
         "value": 0.83125},
        {"params": {"optimizer.lr": 0.5}, "value": None})) + "\n")
    for maximize in (True, False):
        assert latex.best_hparams_to_latex(str(trials), maximize) == \
            jlatex.best_hparams_to_latex(str(trials), maximize)
    summary = _cv_run(tmp_path / "run", 5)
    path = os.path.join(summary, "cv_summary.json")
    assert latex.cv_summary_to_latex(path) == \
        jlatex.cv_summary_to_latex(path)
    names = ["val/combined/loss_best_val/combined/auroc", "missing"]
    assert latex.cv_summary_to_latex(path, names) == \
        jlatex.cv_summary_to_latex(path, names)
    for kind, arg in (("best", str(trials)), ("results", path)):
        assert latex.main([kind, arg]) == 0
        got = capsys.readouterr().out
        assert jlatex.main([kind, arg]) == 0
        assert got == capsys.readouterr().out
    empty = tmp_path / "empty.jsonl"
    empty.write_text(json.dumps({"params": {}, "value": None}) + "\n")
    with pytest.raises(ValueError, match="no completed trials"):
        latex.best_hparams_to_latex(str(empty))


def _crafted_samples():
    """Ties among many values, a column with missing values (integers
    become floats in pandas), a ``label`` column, caption reuse."""
    rng = np.random.default_rng(6)
    out = []
    for i in range(120):
        s = {"label": int(rng.integers(0, 2)),
             "anatomy_site": f"site{int(rng.integers(0, 25))}",
             "sex": ["M", "F", None][i % 3],
             "caption_id": int(rng.integers(0, 30)),
             "dataset": "LERA" if i % 4 else "MURA"}
        if i % 5:
            s["age_encoded"] = int(rng.integers(0, 9))
        out.append(s)
    return out


def test_dataset_report_is_byte_equal_to_jax(tmp_path):
    cfg = apply_overrides(get_experiment("smoke_synthetic_only_imaging"),
                          ["data.synthetic_num_samples=64",
                           "data.image_size=16", f"output_dir={tmp_path}"])
    down = DownstreamData(cfg, CPU)
    pcfg = apply_overrides(get_experiment("smoke_synthetic_pretrain"),
                           ["data.synthetic_num_samples=48",
                            "data.image_size=16", f"output_dir={tmp_path}"])
    groups = {"train_val": down.train_val, "test": down.test,
              "pretrain": PretrainData(pcfg, CPU).train_val,
              "crafted": _crafted_samples(), "empty": []}
    for name, samples in groups.items():
        want = json.dumps(jeda.dataset_report(samples), indent=2)
        assert json.dumps(eda.dataset_report(samples), indent=2) == want, \
            name
    written = eda.plot_distributions(down.train_val, str(tmp_path / "p"))
    want = jeda.plot_distributions(down.train_val, str(tmp_path / "j"))
    assert [os.path.basename(p) for p in written] == \
        [os.path.basename(p) for p in want]
    assert all(os.path.getsize(p) > 0 for p in written)


def test_eda_cli_writes_the_jax_reports(tmp_path):
    overrides = ["experiment=smoke_synthetic_only_imaging",
                 "data.synthetic_num_samples=64", "data.image_size=16",
                 f"output_dir={tmp_path}"]
    assert eda.main(["--out-dir", str(tmp_path / "port"), *overrides]) == 0
    assert jeda.main(["--out-dir", str(tmp_path / "jax"), *overrides]) == 0
    for name in ("report_train_val.json", "report_test.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    assert sorted(os.listdir(tmp_path / "port" / "train_val")) == \
        sorted(os.listdir(tmp_path / "jax" / "train_val"))
