"""The port's sweep engine (``vlp_tpu_torch/train/sweep.py``), its YAML
reader (``utils/yaml_subset.py``) and ``setup_check`` against the JAX
package's: random and grid sweeps try the JAX engine's parameters trial for
trial; a bayes sweep draws the same forest seed, the same 64-candidate
pool and the same tree index (the generator's state equal after its first
surrogate trial) and beats random search on ``tests/test_sweeps.py``'s
objective; the reader equals ``yaml.safe_load`` on all 14 sweep files and
on the scalar forms YAML 1.1 resolves; ``yaml.safe_load`` of the wandb
handoff equals ``to_wandb_config``; the results files are written as the
JAX engine writes them; ``setup_check --device cpu`` exits 0.
"""
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from vlp_tpu.train.sweep import SweepEngine as JEngine
from vlp_tpu.train.sweep import to_wandb_config as jto_wandb
from vlp_tpu_torch.train import sweep as S
from vlp_tpu_torch.utils.yaml_subset import YamlError, safe_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_ROOT = os.path.join(REPO, "configs", "sweeps")
ALL_SWEEPS = sorted(glob.glob(os.path.join(SWEEP_ROOT, "**", "*.yaml"),
                              recursive=True))
SPACE = {
    "optimizer.lr": {"distribution": "log_uniform_values", "min": 1e-6,
                     "max": 1e-1},
    "data.batch_size": {"values": [8, 16, 32, 64, 128, 256]},
}


def _objective(cfg):
    lr, bs = float(cfg.optimizer.lr), float(cfg.data.batch_size)
    return {"score": -((np.log10(lr) + 3.0) ** 2)
            - (np.log2(bs) - 6.0) ** 2}


def _engines(method, tmp_path, trials, seed=3, parameters=SPACE):
    sweep = {"method": method, "metric": {"name": "score",
                                          "goal": "maximize"},
             "parameters": parameters, "overrides": ["seed=42"]}
    j = JEngine(sweep, str(tmp_path / f"jax_{method}"), seed=seed)
    t = S.SweepEngine(sweep, str(tmp_path / f"port_{method}"), seed=seed)
    j.run(trials, _objective)
    t.run(trials, _objective)
    return j, t


def test_all_14_sweep_files_read_as_yaml_safe_load():
    assert len(ALL_SWEEPS) == 14
    for path in ALL_SWEEPS:
        text = open(path).read()
        assert safe_load(text) == yaml.safe_load(text), path
        assert S.load_sweep(path) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 1e-5", "a: 1.0e-5", "a: 1.0e5", "a: yes", "a: Off", "a: ~",
    "a: null\nb:", "a: 010", "a: 0x1F", "a: 12:30", "a: -.5", "a: .inf",
    "a: +1_000", "a: [1, 'x', \"y\", {b: 2}]", "a:\n- 1\n- two",
    "a: 'it''s' # c", "a: b#c", "'q k': v", "k:\n  x: 1\n  y:\n    - [a, b]"
    "\n    - c", "hello", "- a\n- b", "a:\n  - b: 1",
    "rows:\n  - section: Imaging\n    run_dir: out/x\n  -   k: [1, 2]\n"
    "      m:\n        n: 3\n  - plain\n", "- a: 1\n  b: x, y (z)\n- c",
    "title: A, b (4-fold CV) ]", "a: [x, y]"])
def test_scalar_and_collection_forms_read_as_yaml_safe_load(text):
    assert safe_load(text) == yaml.safe_load(text)


def test_what_the_subset_lacks_raises():
    for text in ("a: &x 1", "a: !tag 1", "a: |\n  text", "---\na: 1",
                 "a: b: 1", "- a: b: 1"):
        with pytest.raises(YamlError):
            safe_load(text)


@pytest.mark.parametrize("method", ["random", "grid"])
def test_random_and_grid_pick_the_jax_trials(tmp_path, method):
    params = SPACE if method == "random" else {
        "optimizer.lr": {"values": [1e-4, 1e-3]},
        "data.batch_size": {"values": [16, 64, 256]}}
    j, t = _engines(method, tmp_path, 8, parameters=params)
    assert [h["params"] for h in t.history] == \
        [h["params"] for h in j.history]
    assert [h["value"] for h in t.history] == \
        [h["value"] for h in j.history]
    for name in ("sweep_results.jsonl", "sweep_best.json"):
        assert open(os.path.join(t.output_dir, name)).read() == \
            open(os.path.join(j.output_dir, name)).read()


def test_bayes_draws_the_jax_pool_and_beats_random(tmp_path):
    j, t = _engines("bayes", tmp_path, S.WARMUP + 1)
    assert [h["params"] for h in t.history[:S.WARMUP]] == \
        [h["params"] for h in j.history[:S.WARMUP]]
    # the forest's seed, the 64 candidates and the tree index: the same
    # draws in the same order
    assert t.rng.bit_generator.state == j.rng.bit_generator.state
    bayes, random = (_engines(m, tmp_path / "long", 24)[1]
                     for m in ("bayes", "random"))
    best = lambda e: max(h["value"] for h in e.history
                         if h["value"] is not None)
    assert best(bayes) >= best(random)
    warmup = [h["value"] for h in bayes.history[:S.WARMUP]]
    rest = [h["value"] for h in bayes.history[S.WARMUP:]]
    assert max(rest) >= max(warmup)
    assert np.mean(rest) > np.mean(warmup)


def test_forest_fits_what_it_saw():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(40, 2))
    y = np.where(x[:, 0] > 0.5, 1.0, -1.0) + x[:, 1]
    rf = S.RandomForest(random_state=7).fit(x, y)
    assert len(rf.estimators_) == S.N_TREES
    assert np.abs(rf.predict(x) - y).mean() < 0.25
    again = S.RandomForest(random_state=7).fit(x, y)
    assert (again.predict(x) == rf.predict(x)).all()


def test_numeric_and_extract_as_jax(tmp_path):
    j, t = _engines("random", tmp_path, 1)
    for v in (3, 2.5, "cosine", "resnet50", True):
        assert t._numeric(v) == j._numeric(v)
    for metrics in ({"score": 1.0}, {"score_mean": 2.0},
                    {"x_best_score_mean": 3.0}, {"other": 4.0}):
        assert t._extract(metrics) == j._extract(metrics)


def test_wandb_handoff_is_yaml_of_to_wandb_config(tmp_path):
    src = os.path.join(SWEEP_ROOT, "pretrain", "vlp_resnet34.yaml")
    dst = tmp_path / "wandb_sweep.yaml"
    assert S.main([src, "--emit-wandb", str(dst)]) == 0
    want = S.to_wandb_config(S.load_sweep(src))
    assert yaml.safe_load(open(dst)) == want == json.load(open(dst))
    assert want == jto_wandb(yaml.safe_load(open(src)))
    assert want["command"][-1] == "${args_no_hyphens}"
    odd = {"f": [5e-05, 1e20, 0.001, -2.5e-300, 3.0], "n": [None, True, 0],
           "s": ["1e-5", "yes", "a\"b"], "e": {}, "l": []}
    assert yaml.safe_load(S.yaml_json(odd)) == odd == json.loads(
        S.yaml_json(odd))


def test_setup_check_on_the_cpu_exits_0():
    proc = subprocess.run(
        [sys.executable, "-m", "vlp_tpu_torch.setup_check", "--device",
         "cpu"], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SETUP OK" in proc.stdout
    assert "training OK (loss decreased)" in proc.stdout
