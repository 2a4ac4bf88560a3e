"""Phase 28 of ``chip_smoke.py``: the evaluation tooling on the card.
``chip_smoke.py`` runs ``phase_eval`` after phase 27, under the same
temporary root, so that 27's fixture tree and runs are still there.

First #1 ``ln_attention`` and #2 ``ln_mlp`` at the shapes the post-fit and
replot forwards give them (NesT-Small's three levels at the eval batch of
256 images) against their plain versions with phase 3's bounds.

28a. ``python -m vlp_tpu_torch.train experiment=baseline_only_imaging_
     nest_small`` (``driver.main``, full width, synthetic_downstream, 2
     folds x 1 epoch of a few steps, ``test=true``): every fold summary
     and ``cv_summary.json`` hold a finite ``silhouette_tumor`` and
     ``silhouette_dataset``; the figures exist where matplotlib imports,
     else the line naming each; the launches of each eval pass (the
     trainer's validation, the post-fit pass, the test evaluation: 24 of
     #1 and of #2 an eval forward, nothing else), the post-fit pass's
     seconds by fold, and the run's launches in all.
28b. ``tsne`` and ``silhouette_score`` on the card over 28a's last fold's
     val features against the same calls on the CPU (P within 1e-6
     absolute, silhouettes within 1e-9, the final KL divergence within
     5%); then the t-SNE and the silhouette alone at N = 4096 x 512.
28c. ``python -m vlp_tpu_torch.eval.replot`` over 28a's run directory:
     its #1/#2 launches, the ``*_retro.png`` figures (or their lines), the
     silhouettes equal to 28a's (the last checkpoint holds the final
     weights of a one-epoch fold).
28d. ``python -m vlp_tpu_torch.eval.linear_probe_eval`` on phase 27b's
     best VLP checkpoint over 27's fixture tree: the CSV's header and its
     rows, the same count for every fold; fold 0's probe weights from the
     card's features and from a CPU pass over the same checkpoint (fp32,
     TF32 off) within 1e-4.
28e. ``results_table`` over 27a's ResNet34 run (``test_eval.csv``), 28a's
     NesT run and 27b's VLP run (the ``cv_summary.json`` fallback);
     ``latex results`` of 28a's ``cv_summary.json``; ``eda`` on the
     fixture tree; ``window_to_uint8`` and the PNG writer read back.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import logging
import math
import time
from pathlib import Path

import numpy as np
import torch

from vlp_tpu_torch.data.dicom_tools import window_to_uint8
from vlp_tpu_torch.data.png import read_png, write_png
from vlp_tpu_torch.eval import (eda, latex, linear_probe_eval, plotting,
                                replot, results_table)
from vlp_tpu_torch.eval.subgroup import SUBGROUP_LEVELS, predictions_frame
from vlp_tpu_torch.train import driver

SEED = 28
NEST_SAMPLES = 320
NEST_FOLDS = 2
EVAL_BATCH = 256
TSNE_N, TSNE_F = 4096, 512
BOUND_P = 1e-6
BOUND_SILHOUETTE = 1e-9
BOUND_KL = 0.05
BOUND_PROBE = 1e-4


def _nest_overrides(out: Path) -> list:
    import chip_smoke as cs

    return [f"experiment={cs.NEST}", "data.name=synthetic_downstream",
            f"data.synthetic_num_samples={NEST_SAMPLES}",
            f"data.n_folds_downstream={NEST_FOLDS}",
            "k_fold_cross_validation=true", "trainer.max_epochs=1",
            "test=true", f"output_dir={out}"]


def _check_path_kernels(stats: dict) -> None:
    """#1/#2 at NesT-Small's levels at the eval batch against their plain
    versions (phase 3's bounds); the largest errors into ``stats``."""
    import chip_smoke as cs

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for nb, d, heads, _ in cs.LEVELS:
        n = EVAL_BATCH * nb
        x, attn, mlp = cs._inputs(gen, n, d)
        where = f"N={n} S={cs.SEQ} D={d} (eval batch {EVAL_BATCH})"
        cs._ln_attention_parts(where, x, attn, heads, stats["ln_attention"])
        rows = x.reshape(-1, d)
        out = cs.FB.ln_mlp(rows, *mlp)
        torch.cuda.synchronize()
        cs._check_outputs("ln_mlp", where, (out,),
                          (cs.FB.ln_mlp_plain(rows, *mlp),),
                          (cs.FB.ln_mlp_plain(rows.float(),
                                              *[t.float() for t in mlp]),),
                          ("y",), cs.BOUND_VS_PLAIN_BF16,
                          cs.BOUND_VS_PLAIN_FP32, stats["ln_mlp"])
        del x, attn, mlp, rows, out
        torch.cuda.empty_cache()


class _Recorder:
    """Wraps the trainer's validation, the driver's post-fit pass and test
    evaluation (each call's seconds, eval forwards and launches, by
    ``tag``) and ``plotting.plot_tsne_and_silhouette``, which the driver's
    and ``replot``'s passes call (each call's inputs and scores); a handler
    keeps the plotting module's warnings."""

    def __init__(self):
        self.passes = {"val": [], "post_fit": [], "test": []}
        self.calls, self.lines, self._saved = [], [], []

    def _timed(self, fn, tag, forwards):
        import chip_smoke as cs

        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            before = cs._counts()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            after = cs._counts()
            self.passes[tag].append({
                "seconds": time.perf_counter() - t0,
                "forwards": forwards(*args),
                "launches": {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}})
            return out

        return wrapped

    def __enter__(self):
        from vlp_tpu_torch.train.loop import Trainer

        plot = plotting.plot_tsne_and_silhouette

        def recorded(features, tumor, datasets, out_path, *args, **kwargs):
            scores = plot(features, tumor, datasets, out_path, *args,
                          **kwargs)
            self.calls.append({"features": features.detach().clone(),
                               "tumor": tumor.detach().clone(),
                               "datasets": list(datasets),
                               "path": out_path, "scores": scores})
            return scores

        def val_forwards(trainer):
            return sum(len(ld) for ld in trainer.val_loaders.values())

        def post_forwards(cfg, trainer, fold, main=True):
            return sum(len(ld) for ld in fold.val_loaders.values())

        def test_forwards(cfg, dm, device, mesh=None):
            return len(driver.best_checkpoints(cfg.output_dir)) * len(
                dm.test_loader(0))

        lines = self.lines

        class Keep(logging.Handler):
            def emit(self, record):
                lines.append(record.getMessage())

        self.handler = Keep(level=logging.WARNING)
        logging.getLogger(plotting.__name__).addHandler(self.handler)
        for owner, name, fn in (
                (Trainer, "_validate_classifier", self._timed(
                    Trainer._validate_classifier, "val", val_forwards)),
                (driver, "_post_fit_plots", self._timed(
                    driver._post_fit_plots, "post_fit", post_forwards)),
                (driver, "_evaluate_test_set", self._timed(
                    driver._evaluate_test_set, "test", test_forwards)),
                (plotting, "plot_tsne_and_silhouette", recorded)):
            self._saved.append((owner, name, getattr(owner, name)))
            setattr(owner, name, fn)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        logging.getLogger(plotting.__name__).removeHandler(self.handler)


def _figures(smi: str, out: Path, names, drawn: bool, lines, tag: str):
    """The figures under each ``plots/fold<k>`` where matplotlib imports,
    else none and one line naming each."""
    import chip_smoke as cs

    for k in range(NEST_FOLDS):
        for name in names:
            path = out / "plots" / f"fold{k}" / name
            if drawn:
                cs.check(path.is_file() and path.stat().st_size > 0,
                         f"{tag}: {path} not drawn")
            else:
                cs.check(not path.exists() and any(
                    f"matplotlib is not installed: {path} is not drawn"
                    in line for line in lines), f"{tag}: no line for {path}")


def _nest_run(smi: str, root: Path, rec: _Recorder, drawn: bool) -> tuple:
    """28a. Returns (run directory, launches)."""
    import chip_smoke as cs
    from chip_smoke_data import _main

    out = root / "eval_nest"
    launches, seconds, _ = _main(["--device", "cuda",
                                  *_nest_overrides(out)])
    post = rec.passes["post_fit"]
    cs.check(len(post) == NEST_FOLDS, f"28a: {len(post)} post-fit passes")
    summaries = [cs._fold_summary(out, k) for k in range(NEST_FOLDS)]
    with open(out / "cv_summary.json") as fh:
        agg = json.load(fh)
    for key in ("silhouette_tumor", "silhouette_dataset"):
        values = [s.get(key, float("nan")) for s in summaries] + [
            agg.get(f"{key}_mean", float("nan"))]
        cs.check(all(math.isfinite(v) and -1.0 <= v <= 1.0
                     for v in values), f"28a: {key} {values}")
    _figures(smi, out, ("tsne_val.png", "confusion_val.png"), drawn,
             rec.lines, "28a")
    # every eval pass: 24 of #1 and of #2 a forward, and nothing else
    evals = {}
    for tag, calls in rec.passes.items():
        for p in calls:
            want = {"ln_attention": 24 * p["forwards"],
                    "ln_mlp": 24 * p["forwards"]}
            cs.check(p["launches"] == want, f"28a {tag}: launches "
                     f"{p['launches']} in {p['forwards']} eval forwards, "
                     f"expected {want}")
        evals[tag] = sum(p["forwards"] for p in calls)
    records = [cs._records(out, k) for k in range(NEST_FOLDS)]
    steps = sum(r[-1]["_step"] for r in records)
    forwards = steps + sum(evals.values())
    want = {"ln_attention": 24 * forwards, "ln_mlp": 24 * forwards,
            "ln_attention_bwd": 24 * steps, "ln_mlp_bwd": 24 * steps,
            "shear_rows": 3 * steps, "add_gaussian_noise": steps}
    cs.check(launches == want, f"28a: launches {launches}, expected {want} "
             f"({steps} train steps, eval forwards {evals})")
    header = (out / "test_eval.csv").read_text().splitlines()[0]
    cs.check(header == cs.TEST_EVAL_HEADER, "28a: test_eval.csv header")
    print(f"eval 28a {cs.NEST}: {NEST_FOLDS} folds x 1 epoch ({steps} train "
          f"steps) + test=true in {seconds:.1f} s, launches {launches}; "
          f"silhouette_tumor by fold "
          f"{[round(s['silhouette_tumor'], 4) for s in summaries]}, "
          f"silhouette_dataset "
          f"{[round(s['silhouette_dataset'], 4) for s in summaries]}; the "
          f"post-fit pass by fold: "
          + ", ".join(f"{p['seconds']:.2f} s, {p['forwards']} eval forwards,"
                      f" launches {p['launches']}" for p in post)
          + f"; eval forwards by pass {evals}; figures "
          + ("drawn (matplotlib imports)" if drawn else
             "not drawn: matplotlib is not installed, each named in a "
             "line") + f"; on {smi}")
    return out, launches


def _tsne_vs_cpu(smi: str, call: dict) -> None:
    """28b."""
    import chip_smoke as cs

    x, y, names = call["features"], call["tumor"], call["datasets"]
    n = x.shape[0]
    xc, yc = x.cpu(), y.cpu()
    p_gpu = plotting.joint_probabilities_nn(x)
    p_cpu = plotting.joint_probabilities_nn(xc)
    p_gap = (p_gpu.cpu() - p_cpu).abs().max().item()
    sil = {}
    for key, labels, labels_cpu in (("tumor", y, yc),
                                    ("dataset", names, names)):
        g = plotting.silhouette_score(x, labels)
        c = plotting.silhouette_score(xc, labels_cpu)
        sil[key] = (g, c)
        cs.check(abs(g - c) <= BOUND_SILHOUETTE, f"28b: silhouette_{key} "
                 f"card {g!r} vs CPU {c!r}")
        cs.check(abs(g - call["scores"][f"silhouette_{key}"])
                 <= BOUND_SILHOUETTE, f"28b: silhouette_{key} {g!r} vs the "
                 f"driver's {call['scores'][f'silhouette_{key}']!r}")
    cs.check(p_gap <= BOUND_P, f"28b: P card vs CPU {p_gap}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb, kl_gpu = plotting.tsne(x)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, kl_cpu = plotting.tsne(xc)
    t_cpu = time.perf_counter() - t0
    cs.check(bool(torch.isfinite(emb).all()) and emb.shape == (n, 2),
             "28b: embedding")
    cs.check(abs(kl_gpu - kl_cpu) <= BOUND_KL * kl_cpu,
             f"28b: KL card {kl_gpu} vs CPU {kl_cpu}")
    print(f"eval 28b: 28a's last fold's val features [{n}, {x.shape[1]}]: P "
          f"card vs CPU max_abs {p_gap:.3g} (bound {BOUND_P:g}); "
          + ", ".join(f"silhouette_{k} card {g:.12f} CPU {c:.12f}"
                      for k, (g, c) in sil.items())
          + f" (bound {BOUND_SILHOUETTE:g}); t-SNE KL card {kl_gpu:.6f} CPU "
          f"{kl_cpu:.6f} (bound {BOUND_KL:.0%}), {t_gpu:.3f} s on the card, "
          f"{t_cpu:.3f} s on the CPU; on {smi}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    centres = torch.randn(4, TSNE_F, generator=gen, device="cuda") * 3.0
    labels = torch.randint(0, 4, (TSNE_N,), generator=gen, device="cuda")
    big = centres[labels] + torch.randn(TSNE_N, TSNE_F, generator=gen,
                                        device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score = plotting.silhouette_score(big, labels)
    torch.cuda.synchronize()
    t_sil = time.perf_counter() - t0
    t0 = time.perf_counter()
    emb, kl = plotting.tsne(big)
    torch.cuda.synchronize()
    t_big = time.perf_counter() - t0
    cs.check(bool(torch.isfinite(emb).all()) and math.isfinite(kl),
             "28b: the t-SNE at N = 4096")
    print(f"eval 28b: at N = {TSNE_N} x {TSNE_F} (4 clusters): t-SNE "
          f"{t_big:.3f} s on the card (KL {kl:.4f}, exact N x N gradient, "
          f"up to 1000 iterations), silhouette {t_sil * 1e3:.1f} ms "
          f"({score:.4f}); on {smi}")


def _replot(smi: str, out: Path, rec: _Recorder, drawn: bool,
            post_scores: list) -> dict:
    """28c. Returns the launches."""
    import chip_smoke as cs

    first = len(rec.calls)
    torch.cuda.synchronize()
    cs._reset_counts()
    t0 = time.perf_counter()
    cs.check(replot.main([str(out), "--device", "cuda",
                          *_nest_overrides(out)[:-1]]) == 0, "28c failed")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in cs._counts().items() if v}
    forwards = sum(p["forwards"] for p in rec.passes["post_fit"])
    want = {"ln_attention": 24 * forwards, "ln_mlp": 24 * forwards}
    cs.check(launches == want, f"28c: launches {launches}, expected {want}")
    scores = [c["scores"] for c in rec.calls[first:]]
    cs.check(len(scores) == NEST_FOLDS, f"28c: {len(scores)} folds")
    for k, (got, was) in enumerate(zip(scores, post_scores)):
        cs.check(set(got) == set(was) and all(
            abs(got[s] - was[s]) <= BOUND_SILHOUETTE for s in got),
            f"28c fold {k}: silhouettes {got} vs 28a's {was}")
    _figures(smi, out, ("tsne_val_retro.png", "confusion_val_retro.png"),
             drawn, rec.lines, "28c")
    print(f"eval 28c replot: {NEST_FOLDS} folds' last checkpoints in "
          f"{seconds:.1f} s, launches {launches} (24 of #1 and #2 an eval "
          f"forward); silhouettes equal to 28a's within "
          f"{BOUND_SILHOUETTE:g}; on {smi}")
    return launches


def _linear_probe(smi: str, root: Path) -> None:
    """28d."""
    import chip_smoke as cs
    from vlp_tpu_torch.config import Config, apply_overrides
    from vlp_tpu_torch.data.datamodule import (DownstreamData,
                                               downstream_config)
    from vlp_tpu_torch.utils import checkpoint as ckpt
    from vlp_tpu_torch.utils.checkpoint import restore_raw

    run = root / "data_pretrain"
    best = ckpt.load_meta(str(run / "checkpoints" / "fold0" / "last.pt"))[
        "checkpoint_best_path"]
    csv = root / "eval_probe.csv"
    overrides = [f"experiment={cs.PRETRAIN}", f"output_dir={run}"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.check(linear_probe_eval.main([
        "--output-file", str(csv), "--checkpoint", best, "--device", "cuda",
        *overrides]) == 0, "28d failed")
    seconds = time.perf_counter() - t0
    lines = csv.read_text().splitlines()
    cs.check(lines[0] == cs.TEST_EVAL_HEADER, f"28d: header {lines[0]!r}")
    cfg = apply_overrides(Config(), overrides)
    ds_cfg = downstream_config(cfg)
    dm = DownstreamData(ds_cfg, "cuda")
    frame = predictions_frame(np.zeros(len(dm.test)), dm.test)
    groups = 1 + sum(len(set(np.asarray(frame[lv]).tolist()))
                     for lv in SUBGROUP_LEVELS)
    folds = cfg.downstream_data.n_folds_downstream
    per_fold = {}
    for line in lines[1:]:
        fold = int(line.split(",")[2])
        per_fold[fold] = per_fold.get(fold, 0) + 1
    cs.check(per_fold == {k: 6 * groups for k in range(folds)},
             f"28d: rows by fold {per_fold}, expected {6 * groups} each")
    # fold 0's probe from the card's features and from the CPU's, fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fp32 = apply_overrides(Config(), overrides + ["trainer.precision=fp32"])
    fp32.model.task = "vision_language"
    state = restore_raw(best)["model"]
    t1 = time.perf_counter()
    card = linear_probe_eval.probe_fold(fp32, state, dm, 0, "cuda")
    t_card = time.perf_counter() - t1
    t1 = time.perf_counter()
    cpu = linear_probe_eval.probe_fold(
        fp32, state, DownstreamData(ds_cfg, "cpu"), 0, "cpu")
    t_cpu = time.perf_counter() - t1
    gap_w = float(np.abs(card["w"] - cpu["w"]).max())
    gap_b = abs(card["b"] - cpu["b"])
    cs.check(gap_w <= BOUND_PROBE and gap_b <= BOUND_PROBE,
             f"28d: fold 0's probe card vs CPU: w {gap_w}, b {gap_b}")
    print(f"eval 28d linear_probe_eval on {Path(best).name} (27b's best): "
          f"{folds} folds in {seconds:.1f} s, {len(lines) - 1} CSV rows "
          f"({6 * groups} a fold); fold 0's probe ({card['n_train']} train "
          f"rows, {len(card['w'])} features, fp32) card vs CPU: max |dw| "
          f"{gap_w:.3g}, |db| {gap_b:.3g} (bound {BOUND_PROBE:g}; card "
          f"{t_card:.1f} s, CPU {t_cpu:.1f} s); on {smi}")


def _tables(smi: str, root: Path, nest: Path) -> None:
    """28e."""
    import chip_smoke as cs

    t0 = time.perf_counter()
    spec = root / "eval_spec.yaml"
    spec.write_text(
        "title: Phase 28, fixture runs\n"
        "rows:\n"
        "  - section: Imaging\n"
        "    experiment: Scratch Baseline\n"
        "    model: ResNet34\n"
        f"    run_dir: {root / 'data_downstream'}\n"
        "  - section: Imaging\n"
        "    experiment: Scratch NesT\n"
        "    model: NesT-Small\n"
        f"    run_dir: {nest}\n"
        "  - section: Pretraining\n"
        "    experiment: VLP\n"
        "    model: ResNet34 + TinyBERT\n"
        f"    run_dir: {root / 'data_pretrain'}\n")
    md, tidy = root / "eval_table.md", root / "eval_table.csv"
    with contextlib.redirect_stdout(io.StringIO()):
        cs.check(results_table.main([str(spec), "--out", str(md), "--csv",
                                     str(tidy)]) == 0, "28e: results_table")
    rows = md.read_text().splitlines()
    cs.check(len(rows) == 9 and rows[5].startswith("| Scratch Baseline")
             and "—" not in rows[5] and "—" not in rows[6],
             f"28e: table {rows}")
    sources = {line.split(",")[1]: line.rsplit(",", 1)[1]
               for line in tidy.read_text().splitlines()[1:]}
    cs.check(sources.get("Scratch Baseline") == "test"
             and sources.get("Scratch NesT") == "test",
             f"28e: sources {sources}")
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        cs.check(latex.main(["results", str(nest / "cv_summary.json")]) == 0,
                 "28e: latex")
    tex = buf.getvalue()
    cs.check(tex.startswith(r"\begin{tabular}{lr}")
             and r"silhouette\_tumor" in tex, "28e: latex results")
    report_dir = root / "eval_eda"
    cs.check(eda.main(["--out-dir", str(report_dir),
                       f"experiment={cs.RESNET34}",
                       f"output_dir={root / 'data_downstream'}"]) == 0,
             "28e: eda")
    report = json.loads((report_dir / "report_train_val.json").read_text())
    test = json.loads((report_dir / "report_test.json").read_text())
    cs.check(report["num_samples"] > 0 and test["num_samples"] > 0
             and sum(report["label_balance"].values())
             == report["num_samples"], "28e: eda reports")
    rng = np.random.default_rng(SEED)
    pixels = rng.integers(-1024, 3072, (512, 384)).astype(np.int16)
    img = window_to_uint8(pixels, 400.0, 1800.0, "MONOCHROME1")
    path = root / "eval_window.png"
    write_png(path, img)
    from vlp_tpu_torch.data.preprocess_host import decode_image, decoder
    cs.check(np.array_equal(read_png(str(path))[:, :, 0], img)
             and np.array_equal(decode_image(str(path))[:, :, 0], img),
             "28e: the windowed PNG does not read back")
    print(f"eval 28e: results table (3 runs: test_eval.csv, test_eval.csv, "
          f"cv_summary.json) {len(tidy.read_text().splitlines()) - 1} tidy "
          f"rows; latex results of 28a's cv_summary.json "
          f"{len(tex.splitlines())} lines; eda on the fixture tree "
          f"{report['num_samples']} train/val + {test['num_samples']} test "
          f"samples; window_to_uint8 [512, 384] through the PNG writer read "
          f"back by the numpy reader and {decoder()}; "
          f"{time.perf_counter() - t0:.1f} s; on {smi}")


def phase_eval(smi: str, root: Path, stats: dict) -> dict:
    """Phase 28. Returns the launches of 28a and 28c."""
    import chip_smoke as cs

    t0 = time.perf_counter()
    cs._quiet_trainer_logs()
    drawn = importlib.util.find_spec("matplotlib") is not None
    _check_path_kernels(stats)
    t_a = time.perf_counter()
    with _Recorder() as rec:
        nest, launches = _nest_run(smi, root, rec, drawn)
        post_scores = [c["scores"] for c in rec.calls]
        t_b = time.perf_counter()
        _tsne_vs_cpu(smi, rec.calls[-1])
        t_c = time.perf_counter()
        retro = _replot(smi, nest, rec, drawn, post_scores)
    t_d = time.perf_counter()
    _linear_probe(smi, root)
    t_e = time.perf_counter()
    _tables(smi, root, nest)
    t_end = time.perf_counter()
    print(f"phase 28: {t_end - t0:.1f} s (kernels {t_a - t0:.1f}, 28a "
          f"{t_b - t_a:.1f}, 28b {t_c - t_b:.1f}, 28c {t_d - t_c:.1f}, 28d "
          f"{t_e - t_d:.1f}, 28e {t_end - t_e:.1f}); matplotlib "
          f"{'imports' if drawn else 'is not installed'}; on {smi}")
    return {"eval_nest_trainer": launches, "eval_replot": retro}
