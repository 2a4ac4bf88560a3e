"""Hyperparameter sweeps (counterpart of ``vlp_tpu/train/sweep.py:36-236``).

The sweep files' schema (``configs/sweeps/**``: method, metric, parameters,
overrides) driven by an in-process engine: random search, grid search, or
a Bayesian strategy (after five trials, one random tree of a random forest
fitted on the history scores 64 random candidates and the best is tried).
Each trial runs the port's ``train.driver.train`` and appends its record to
``sweep_results.jsonl``; the best goes to ``sweep_best.json``::

    python -m vlp_tpu_torch.train.sweep <yaml> [--trials N] \\
        [--output-dir D] [--seed S] [--emit-wandb OUT] [--device cuda|cpu]

The engine draws from ``np.random.default_rng(seed)`` in the JAX engine's
order, so random and grid sweeps try the JAX engine's parameters trial for
trial, and a bayes sweep draws the same forest seed, candidate pool and
tree index. The forest is the port's own (``RandomForest``: 30 bootstrapped
CART trees with squared-error splits, scikit-learn's regressor defaults),
since the card's machine has no scikit-learn; its trees score the pool as
scikit-learn's would up to their tie-breaks and random streams. The sweep
files are read by ``utils/yaml_subset.py`` (no PyYAML there either), and the
wandb handoff (``--emit-wandb``) is written as JSON that YAML reads back the
same (``yaml_json``).
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from vlp_tpu_torch.config.core import Config, apply_overrides
from vlp_tpu_torch.utils.logging import get_logger
from vlp_tpu_torch.utils.yaml_subset import safe_load

logger = get_logger(__name__)
N_TREES = 30
POOL = 64
WARMUP = 5


def sample_parameter(rng: np.random.Generator, spec: Dict[str, Any]) -> Any:
    if "values" in spec:
        vals = spec["values"]
        return vals[int(rng.integers(len(vals)))]
    if "value" in spec:
        return spec["value"]
    dist = spec.get("distribution", "uniform")
    lo, hi = float(spec["min"]), float(spec["max"])
    if dist in ("log_uniform_values", "log_uniform"):
        return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
    if dist == "int_uniform":
        return int(rng.integers(int(lo), int(hi) + 1))
    return float(rng.uniform(lo, hi))


def grid_space(parameters: Dict[str, Dict]) -> List[Dict[str, Any]]:
    keys = list(parameters)
    values = []
    for k in keys:
        spec = parameters[k]
        if "values" not in spec:
            raise ValueError(f"grid sweeps need 'values' for {k}")
        values.append(spec["values"])
    return [dict(zip(keys, combo)) for combo in itertools.product(*values)]


class _Tree:
    """A CART regression tree grown to purity (min 2 samples to split, 1
    a leaf, every feature considered at every node), thresholds halfway
    between neighbouring distinct values, the first best split on ties."""

    def __init__(self, x: np.ndarray, y: np.ndarray) -> None:
        # node: (feature, threshold, left, right) or (None, value)
        self.nodes: List[tuple] = []
        self._grow(x, y)

    def _grow(self, x: np.ndarray, y: np.ndarray) -> int:
        index = len(self.nodes)
        self.nodes.append((None, float(y.mean())))
        best = self._split(x, y) if len(y) >= 2 else None
        if best is not None:
            f, t = best
            left = x[:, f] <= t
            lo = self._grow(x[left], y[left])
            hi = self._grow(x[~left], y[~left])
            self.nodes[index] = (f, t, lo, hi)
        return index

    @staticmethod
    def _split(x: np.ndarray, y: np.ndarray) -> Optional[tuple]:
        n = len(y)
        best, best_gain = None, 1e-12 * max(1.0, float((y * y).sum()))
        total = ((y - y.mean()) ** 2).sum()
        for f in range(x.shape[1]):
            order = np.argsort(x[:, f], kind="stable")
            xs, ys = x[order, f], y[order]
            csum, csq = np.cumsum(ys), np.cumsum(ys * ys)
            for i in range(1, n):
                if xs[i] == xs[i - 1]:
                    continue
                nl, nr = i, n - i
                sl, sr = csum[i - 1], csum[-1] - csum[i - 1]
                ql, qr = csq[i - 1], csq[-1] - csq[i - 1]
                sse = (ql - sl * sl / nl) + (qr - sr * sr / nr)
                gain = total - sse
                if gain > best_gain:
                    best_gain = gain
                    best = (f, float((xs[i - 1] + xs[i]) / 2.0))
        return best

    def predict(self, x: np.ndarray) -> np.ndarray:
        out = np.empty(len(x))
        for r, row in enumerate(x):
            node = self.nodes[0]
            while node[0] is not None:
                node = self.nodes[node[2] if row[node[0]] <= node[1]
                                  else node[3]]
            out[r] = node[1]
        return out


class RandomForest:
    """``n_trees`` CART trees, each on a bootstrap sample of the rows drawn
    from ``np.random.RandomState(random_state)``; ``estimators_`` as
    scikit-learn names them."""

    def __init__(self, n_trees: int = N_TREES, random_state: int = 0
                 ) -> None:
        self.n_trees, self.random_state = n_trees, random_state
        self.estimators_: List[_Tree] = []

    def fit(self, x: np.ndarray, y: np.ndarray) -> "RandomForest":
        rs = np.random.RandomState(self.random_state)
        n = len(y)
        self.estimators_ = []
        for _ in range(self.n_trees):
            rows = rs.randint(0, n, n)
            self.estimators_.append(_Tree(x[rows], y[rows]))
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.mean([t.predict(x) for t in self.estimators_], axis=0)


class SweepEngine:
    def __init__(self, sweep_config: Dict[str, Any], output_dir: str,
                 seed: int = 0) -> None:
        self.cfg = sweep_config
        self.method = sweep_config.get("method", "random")
        metric = sweep_config.get("metric", {})
        self.metric_name = metric.get("name", "val/combined/accuracy")
        self.maximize = metric.get("goal", "maximize") == "maximize"
        self.parameters: Dict[str, Dict] = sweep_config.get("parameters", {})
        self.overrides: List[str] = list(sweep_config.get("overrides", []))
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.results_path = os.path.join(output_dir, "sweep_results.jsonl")
        self.rng = np.random.default_rng(seed)
        self.history: List[Dict[str, Any]] = []

    def _suggest(self, trial: int) -> Dict[str, Any]:
        if self.method == "grid":
            space = grid_space(self.parameters)
            return space[trial % len(space)]
        if self.method == "bayes" and len(self.history) >= WARMUP:
            return self._suggest_bayes()
        return {k: sample_parameter(self.rng, s)
                for k, s in self.parameters.items()}

    def _suggest_bayes(self) -> Dict[str, Any]:
        """One random tree of a forest fitted on the history scores a pool
        of random candidates; the predicted best is tried (Thompson
        sampling). The draws: the forest's seed, the pool, the tree."""
        done = [h for h in self.history if h.get("value") is not None]
        if not done:  # every recorded trial failed: nothing to fit
            return {k: sample_parameter(self.rng, s)
                    for k, s in self.parameters.items()}
        keys = list(self.parameters)
        x = np.array([[self._numeric(h["params"][k]) for k in keys]
                      for h in done])
        y = np.array([h["value"] for h in done], float)
        if not self.maximize:
            y = -y
        rf = RandomForest(N_TREES, int(self.rng.integers(2**31))).fit(x, y)
        pool = [{k: sample_parameter(self.rng, self.parameters[k])
                 for k in keys} for _ in range(POOL)]
        px = np.array([[self._numeric(c[k]) for k in keys] for c in pool])
        tree = rf.estimators_[int(self.rng.integers(len(rf.estimators_)))]
        return pool[int(np.argmax(tree.predict(px)))]

    @staticmethod
    def _numeric(v: Any) -> float:
        if isinstance(v, (int, float)):
            return float(v)
        # stable across processes (the builtin hash() is randomised per run)
        digest = hashlib.sha1(str(v).encode()).digest()
        return float(int.from_bytes(digest[:4], "big") % 10_000)

    def run(self, num_trials: int,
            train_fn: Optional[Callable] = None) -> Dict[str, Any]:
        """``train_fn(cfg) -> metrics``; the port's driver on the card by
        default."""
        if train_fn is None:
            from vlp_tpu_torch.train.driver import train as train_fn

        best = None
        for trial in range(num_trials):
            params = self._suggest(trial)
            overrides = self.overrides + [f"{k}={v}"
                                          for k, v in params.items()]
            cfg = apply_overrides(Config(), overrides)
            cfg.output_dir = os.path.join(self.output_dir, f"trial{trial}")
            logger.info("sweep trial %d: %s", trial, params)
            try:
                value = self._extract(train_fn(cfg))
            except Exception as e:
                logger.warning("trial %d failed: %s", trial, e)
                value = None
            rec = {"trial": trial, "params": params, "value": value}
            self.history.append(rec)
            with open(self.results_path, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
            if value is not None and (
                    best is None
                    or (value > best["value"]) == self.maximize
                    and value != best["value"]):
                best = rec
        logger.info("sweep best: %s", best)
        with open(os.path.join(self.output_dir, "sweep_best.json"),
                  "w") as fh:
            json.dump(best, fh, indent=2)
        return best or {}

    def _extract(self, metrics: Dict[str, float]) -> Optional[float]:
        # exact key, else the best-epoch snapshot key, else the fold mean
        for key in (self.metric_name,
                    f"{self.metric_name}_mean",
                    f"{self.metric_name}_best_{self.metric_name}"):
            if key in metrics:
                return float(metrics[key])
        # the snapshot form "<monitor>_best_<metric>_mean"
        for k, v in metrics.items():
            if k.endswith(f"_best_{self.metric_name}_mean") or \
                    k.endswith(f"_best_{self.metric_name}"):
                return float(v)
        logger.warning("metric %s not found in results (have %s)",
                       self.metric_name, sorted(metrics)[:10])
        return None


def load_sweep(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        return safe_load(fh.read())


def to_wandb_config(sweep_config: Dict[str, Any],
                    program: str = "train.py") -> Dict[str, Any]:
    """The wandb-agent form of a sweep (the reference's
    ``configs/sweeps/pretrain/vlp_resnet34.yaml:21-40``): the fixed
    overrides ride in ``command:`` ahead of ``${args_no_hyphens}``."""
    return {
        "program": program,
        "method": sweep_config.get("method", "bayes"),
        "metric": dict(sweep_config.get("metric", {})),
        "parameters": {k: dict(v) for k, v in
                       sweep_config.get("parameters", {}).items()},
        "command": (["python", "${program}"]
                    + list(sweep_config.get("overrides", []))
                    + ["${args_no_hyphens}"]),
    }


def yaml_json(obj: Any, indent: int = 0) -> str:
    """``obj`` (dicts, lists, strings, numbers, booleans, None) as JSON that
    YAML 1.1 reads back the same: a float keeps a dot and a signed
    exponent (``5.0e-05``; PyYAML reads ``5e-05`` as a string)."""
    pad, inner = " " * indent, " " * (indent + 2)
    if isinstance(obj, dict):
        if not obj:
            return "{}"
        items = [f"{inner}{json.dumps(str(k))}: {yaml_json(v, indent + 2)}"
                 for k, v in obj.items()]
        return "{\n" + ",\n".join(items) + f"\n{pad}}}"
    if isinstance(obj, (list, tuple)):
        if not obj:
            return "[]"
        items = [f"{inner}{yaml_json(v, indent + 2)}" for v in obj]
        return "[\n" + ",\n".join(items) + f"\n{pad}]"
    if isinstance(obj, float) and not isinstance(obj, bool):
        if obj != obj or obj in (float("inf"), float("-inf")):
            raise ValueError(f"{obj} has no JSON form")
        text = repr(obj)
        mant, _, exp = text.partition("e")
        if "." not in mant:
            mant += ".0"
        if exp and exp[0] not in "+-":
            exp = "+" + exp
        return mant + ("e" + exp if exp else "")
    return json.dumps(obj)


def emit_wandb_sweep(sweep_path: str, out_path: str,
                     program: str = "train.py") -> str:
    cfg = to_wandb_config(load_sweep(sweep_path), program)
    with open(out_path, "w") as fh:
        fh.write(yaml_json(cfg) + "\n")
    logger.info("wandb sweep config written to %s; on a connected machine: "
                "wandb sweep %s && wandb agent <id>", out_path, out_path)
    return out_path


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("sweep_config")
    parser.add_argument("--trials", type=int, default=10)
    parser.add_argument("--output-dir", default="outputs/sweep")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--emit-wandb", metavar="OUT_YAML", default=None,
        help="write the wandb-agent form of this sweep and exit")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    if args.emit_wandb:
        emit_wandb_sweep(args.sweep_config, args.emit_wandb)
        return 0
    from vlp_tpu_torch.train.driver import train

    engine = SweepEngine(load_sweep(args.sweep_config), args.output_dir,
                         args.seed)
    engine.run(args.trials, lambda cfg: train(cfg, device=args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
