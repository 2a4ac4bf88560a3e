"""Sweeps and results as LaTeX tables (counterpart of
``vlp_tpu/eval/latex.py``; reference scripts/sweep_config_to_latex_table.py
and sweep_ids_to_best_hparam_latex_table.py): a sweep's search space, the
best trial's hyperparameters from ``sweep_results.jsonl`` and the mean and
std across folds of ``cv_summary.json``, byte-equal to the JAX package's.
Sweep YAML is read with ``utils/yaml_subset`` (no PyYAML).

Usage: python -m vlp_tpu_torch.eval.latex {space,best,results} <path>
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from vlp_tpu_torch.utils.yaml_subset import safe_load


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v).replace("_", r"\_")


def sweep_space_to_latex(sweep_config: Dict[str, Any]) -> str:
    """Search-space table: parameter | distribution | range/values."""
    lines = [r"\begin{tabular}{lll}", r"\toprule",
             r"Parameter & Distribution & Range/Values \\", r"\midrule"]
    for name, spec in sweep_config.get("parameters", {}).items():
        if "values" in spec:
            dist, rng = "categorical", ", ".join(_fmt(v)
                                                 for v in spec["values"])
        elif "value" in spec:
            dist, rng = "fixed", _fmt(spec["value"])
        else:
            dist = spec.get("distribution", "uniform")
            rng = f"[{_fmt(spec['min'])}, {_fmt(spec['max'])}]"
        lines.append(f"{_fmt(name)} & {_fmt(dist)} & {rng} \\\\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    return "\n".join(lines)


def best_hparams_to_latex(results_jsonl: str, maximize: bool = True) -> str:
    """The best completed trial's hyperparameters from
    ``sweep_results.jsonl``."""
    trials: List[Dict] = []
    with open(results_jsonl) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec.get("value") is not None:
                trials.append(rec)
    if not trials:
        raise ValueError(f"no completed trials in {results_jsonl}")
    best = (max if maximize else min)(trials, key=lambda r: r["value"])
    lines = [r"\begin{tabular}{ll}", r"\toprule",
             r"Hyperparameter & Value \\", r"\midrule"]
    for k, v in best["params"].items():
        lines.append(f"{_fmt(k)} & {_fmt(v)} \\\\")
    lines.append(f"metric value & {_fmt(best['value'])} \\\\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    return "\n".join(lines)


def cv_summary_to_latex(summary_json: str,
                        metrics: Optional[List[str]] = None) -> str:
    """Mean +- std across folds of ``cv_summary.json`` (the shape of the
    reference README's results table); every ``*_mean`` key, sorted,
    unless ``metrics`` names them."""
    with open(summary_json) as fh:
        agg = json.load(fh)
    metrics = metrics or sorted({k[:-5] for k in agg if k.endswith("_mean")})
    lines = [r"\begin{tabular}{lr}", r"\toprule",
             r"Metric & Mean $\pm$ Std \\", r"\midrule"]
    for m in metrics:
        mean, std = agg.get(f"{m}_mean"), agg.get(f"{m}_std", 0.0)
        if mean is None:
            continue
        lines.append(f"{_fmt(m)} & ${mean:.3f} \\pm {std:.3f}$ \\\\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m vlp_tpu_torch.eval.latex",
                                description=__doc__)
    p.add_argument("kind", choices=["space", "best", "results"])
    p.add_argument("path")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    if args.kind == "space":
        with open(args.path) as fh:
            print(sweep_space_to_latex(safe_load(fh.read())))
    elif args.kind == "best":
        print(best_hparams_to_latex(args.path))
    else:
        print(cv_summary_to_latex(args.path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
