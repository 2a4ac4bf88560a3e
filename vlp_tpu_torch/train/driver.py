"""K-fold cross-validation driver and command line (counterpart of
``vlp_tpu/train/driver.py``).

    python -m vlp_tpu_torch.train [--device cuda|cpu] experiment=<name>
        [dotted.overrides=...]

The reference's train() flow (src/train.py:56-257): the config, the data
module, per fold a task (its label weights and normalisation from the fold)
and a ``Trainer``, ``fit``, the fold's metrics at its best epoch from the
summary snapshot (with the fit's wall seconds in training, validation and
checkpoint saves, ``time/train_s``, ``time/validate_s``,
``time/checkpoint_s``), and the mean and std across folds in
``cv_summary.json``.
VLP runs add the downstream linear probe and precision@k callbacks
(src/train.py:126-135) and, after fit, precision@k of the best checkpoint
over the whole downstream set (src/train.py:187-211). A classifier (the
imaging-only or the fusion model) with ``model.pretrained_ckpt`` starts its
backbone from a VLP checkpoint's image tower (BatchNorm's running
statistics included); its heads and clinical branch keep their init.
With ``test=true`` a classifier run then evaluates each fold's best
checkpoint on the frozen test split (``eval.test_eval``), writes
``<output_dir>/test_eval.csv`` and adds ``test/<metric>``, the mean over
folds of the overall rows, to the returned aggregate.

It runs on ``cuda`` unless ``--device cpu`` is given (the tests give it);
there is no fallback to the CPU. Under the launcher,

    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m vlp_tpu_torch.train [--device cuda|cpu] experiment=<name> ...

it trains on N ranks, one process per device (``cuda:LOCAL_RANK`` over
NCCL; gloo for ``--device cpu``), with the JAX mesh's global-batch
semantics (``parallel/``): ``data.batch_size`` is the global batch, the
loss, gradients, BatchNorm statistics and metrics are the global batch's,
and only rank 0 logs and writes (metrics files, checkpoints, fold markers,
``cv_summary.json``, the test CSV); barriers sit where another rank reads
what rank 0 wrote. ``mesh.data_parallel`` must be -1 or the world;
``mesh.param_sharding=fsdp`` shards the parameters and AdamW moments over
the ranks (``parallel/fsdp.py``; every rank runs every forward, and the
checkpoints are gathered into the replicated run's format). With
``mesh.model_parallel=M`` the N = D x M ranks form the 2-D data x model
mesh (``parallel/mesh.py``): the batch shards over the D data ranks, and
``mesh.param_sharding=tp`` splits the weights and AdamW moments over the
M model ranks of each (``parallel/tp.py``; checkpoints again in the
replicated run's format)::

    python -m torch.distributed.run --standalone --nproc_per_node=<D*M> \
        -m vlp_tpu_torch.train experiment=<name> mesh.model_parallel=<M> \
        mesh.param_sharding=tp

Without the launcher's environment it is one process on one device.
``data.name=downstream|pretrain`` read the real datasets under
``INTERNAL_DATASET_PATH``, ``BTXRD_DATASET_PATH``, ``MURA_DATASET_PATH``
and ``LERA_DATASET_PATH`` (``data/datasets.py``; a VLP run's probe reads
INTERNAL and BTXRD too); the synthetic corpora need none. After a
classifier's fit, one eval-mode pass of the fold's final weights over its
val loaders gives ``silhouette_tumor`` and ``silhouette_dataset`` in the
fold's summary (``eval/plotting.py``, on the device; every rank takes part
in the gather) and, on rank 0 where matplotlib is installed, the t-SNE and
confusion figures under ``<output_dir>/plots/fold<k>/``; without
matplotlib one line names each figure that is not drawn. A VLP run's
text tower starts from the pretrained DistilBERT or TinyBERT checkpoint
where it and its ``vocab.txt`` are in the local HF hub cache
(``HF_HUB_CACHE``, ``HF_HOME``, ...: ``utils/hf_files.py``), and the
torchxrayvision ResNet50 with ``model.pretrained`` from
``XRV_WEIGHTS_PATH``; without the files each keeps its random init.
"""
from __future__ import annotations

import argparse
import copy
import glob
import hashlib
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from vlp_tpu_torch.config import Config, TrainConfig, apply_overrides
from vlp_tpu_torch.data.datamodule import (DownstreamData, build_datamodule,
                                           downstream_config)
from vlp_tpu_torch.eval.plotting import plot_val_outputs
from vlp_tpu_torch.eval.subgroup import evaluate_results
from vlp_tpu_torch.eval.test_eval import collect_probs
from vlp_tpu_torch.data.tokenize import tokenizer_is_hash_fallback
from vlp_tpu_torch.models.bert import TEXT_CONFIGS, load_hf_weights
from vlp_tpu_torch.models.tasks import build_task
from vlp_tpu_torch.models.torch_import import load_torchxrayvision_resnet50
from vlp_tpu_torch.ops._build import load_library
from vlp_tpu_torch.ops.retrieval import label_precision_at_k
from vlp_tpu_torch.parallel import tp
from vlp_tpu_torch.parallel.mesh import (check_mesh_config, create_mesh,
                                         destroy_mesh, launched)
from vlp_tpu_torch.train.callbacks import (DownstreamPrecisionAtK,
                                           LinearProbeCallback)
from vlp_tpu_torch.train.loop import Trainer
from vlp_tpu_torch.train.step import collect_over_loader
from vlp_tpu_torch.utils import checkpoint as ckpt
from vlp_tpu_torch.utils import hf_files
from vlp_tpu_torch.utils.hparams import log_hyperparameters
from vlp_tpu_torch.utils.logging import (JsonlSink, MemorySink, MultiSink,
                                         _to_jsonable, get_logger,
                                         quiet_unless_main)

logger = get_logger(__name__)
XRV = "resnet50-res512-all"


def _entries(trainer: Trainer, prefix: str) -> Dict[str, tuple]:
    """The replicated model's shape of each state entry under ``prefix``
    (the prefix removed): a sharded model's DTensors give their global
    shapes, a split one's splits."""
    return {k[len(prefix):]: shape
            for k, shape in tp.full_shapes(trainer.state.model).items()
            if k.startswith(prefix)}


def _load_entries(trainer: Trainer, prefix: str,
                  state: Dict[str, torch.Tensor]) -> None:
    """``state`` into the model's entries under ``prefix``; a sharded or
    split model's ranks each take their shards (``ckpt.load_model_state``)."""
    ckpt.load_model_state(trainer.state.model,
                          {prefix + k: v for k, v in state.items()},
                          strict=False)


def _maybe_warm_start(cfg: Config, trainer: Trainer) -> None:
    """A classifier's backbone (the imaging-only or the fusion model's)
    from a VLP checkpoint's image tower (reference
    OnlyImagingModule.py:75-98), or from a classifier checkpoint's
    backbone; the rest of the model keeps its init. With
    ``model.pretrained`` the torchxrayvision ResNet50's backbone first
    takes the pretrained weights at ``XRV_WEIGHTS_PATH`` (or the
    ``torchxrayvision`` package's; reference OnlyImagingModule.py:55-69,
    ``models/torch_import.py``); where they cannot be loaded it keeps its
    random init with a warning, as the JAX package's does."""
    if cfg.model.pretrained and cfg.model.model == XRV:
        weights = os.environ.get("XRV_WEIGHTS_PATH")
        loaded = load_torchxrayvision_resnet50(
            _entries(trainer, "backbone."), weights_path=weights)
        if loaded is not None:
            _load_entries(trainer, "backbone.", loaded)
            logger.info("Loaded torchxrayvision resnet50 weights into the "
                        "backbone from %s",
                        weights or "the torchxrayvision package")
    path = cfg.model.pretrained_ckpt
    if not path:
        return
    if path.startswith("REQUIRED:"):
        raise ValueError(
            f"experiment {cfg.experiment!r} needs model.pretrained_ckpt "
            "pointing at a VLP checkpoint (override it on the command line)")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    source = ckpt.restore_raw(path)["model"]
    encoder = ckpt.extract_image_encoder(source) \
        if any(k.startswith("image_encoder.") for k in source) \
        else {k[len("backbone."):]: v for k, v in source.items()
              if k.startswith("backbone.")}
    model = trainer.state.model
    # the keys and shapes checked against the replicated model's (a
    # sharded model's DTensors give their global shapes, a split one's
    # splits); the backbone's entries loaded
    grafted = ckpt.graft_backbone(
        {k: torch.empty(shape, device="meta")
         for k, shape in tp.full_shapes(model).items()}, encoder)
    ckpt.load_model_state(model, {k: v for k, v in grafted.items()
                                  if k.startswith("backbone.")},
                          strict=False)
    logger.info("Warm-started backbone (+BN stats) from %s", path)


def _maybe_load_pretrained_text_tower(cfg: Config, trainer: Trainer) -> None:
    """The reference's text towers start from pretrained HF weights
    (VisionLanguageModule.py:38-60; ROADMAP Queue 1 item 16): where the
    DistilBERT or TinyBERT checkpoint is in the local HF hub cache
    (``models/bert.load_hf_weights``) the text tower takes it, else it
    keeps its random init with a warning, as the JAX package's does.
    Pretrained weights with the hash tokenizer's ids are refused: the
    tokenizer's ``vocab.txt`` must be staged with them."""
    prefix = "text_encoder."
    target = _entries(trainer, prefix)
    if not target:
        return
    state = load_hf_weights(target, cfg.model.text_model)
    if state is None:
        return
    if tokenizer_is_hash_fallback(cfg.data.tokenizer):
        raise RuntimeError(
            f"pretrained {cfg.model.text_model} weights are available but "
            f"tokenizer {cfg.data.tokenizer!r} fell back to the hash "
            "tokenizer: hash-vocab token ids into a pretrained BERT "
            "produce garbage. Stage the HF tokenizer files locally or run "
            "the text tower from scratch.")
    _load_entries(trainer, prefix, state)
    name = TEXT_CONFIGS[cfg.model.text_model].hf_name
    logger.info("Loaded pretrained %s text-tower weights from %s",
                cfg.model.text_model, hf_files.snapshot_dir(name))


def _linear_probe_callback(cfg: Config, downstream: DownstreamData,
                           every_n: int, vlp_task):
    """The probe and precision@k callbacks over the first downstream CV
    split's loaders (reference src/train.py:126-135); features come from the
    VLP image tower with the downstream fold's normalisation."""
    fold = next(downstream.folds())
    probe_task = copy.copy(vlp_task)  # the same model, the fold's statics
    probe_task.statics = fold.statics

    def extract():
        x_tr, y_tr = collect_over_loader(probe_task.features_fn,
                                         fold.train_loader)
        xs, ys = zip(*(collect_over_loader(probe_task.features_fn, loader)
                       for loader in fold.val_loaders.values()))
        host = [t.float().cpu().numpy() for t in
                (x_tr, y_tr, torch.cat(xs), torch.cat(ys))]
        return tuple(host)

    def embed_val():
        es, ys = zip(*(collect_over_loader(probe_task.embed_images_fn, loader)
                       for loader in fold.val_loaders.values()))
        return torch.cat(es), torch.cat(ys)

    probe = LinearProbeCallback(extract, every_n_epochs=every_n)
    pak = DownstreamPrecisionAtK(embed_val, ks=cfg.model.retrieval_ks)
    return probe, pak


def _ckpt_identity(path: Optional[str]) -> list:
    """Identity of a checkpoint file's content: (name, size, mtime_ns) of
    it and its sidecar. A warm-start checkpoint regenerated at the same path
    invalidates fold markers; the path alone cannot tell old weights from
    new."""
    if not path or not os.path.isfile(path):
        return []
    return sorted((os.path.basename(p), os.stat(p).st_size,
                   os.stat(p).st_mtime_ns)
                  for p in (path, path + ".meta.json") if os.path.exists(p))


def _config_fingerprint(cfg: Config) -> str:
    """Stable hash of every config field that affects a fold's result
    (``resume_completed_folds`` and ``test`` excluded: they control what
    runs around the folds), with the warm-start checkpoint's content
    identity, so a fold marker written under other settings is never
    reused."""
    d = cfg.to_dict()
    d.pop("resume_completed_folds", None)
    d.pop("test", None)
    d["__pretrained_ckpt_identity__"] = _ckpt_identity(
        cfg.model.pretrained_ckpt)
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _write_fold_done(path: str, summary: Dict[str, float], fp: str) -> None:
    """The fold's completion marker (summary + config fingerprint), written
    to a temporary file and renamed, so a kill mid-write never leaves a
    truncated marker."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"fingerprint": fp,
                   "summary": {k: _to_jsonable(v)
                               for k, v in summary.items()}}, fh, indent=2)
    os.replace(tmp, path)


def _check_config(cfg: Config) -> None:
    """The checks that need no data, before anything is built."""
    if cfg.ckpt_path and cfg.k_fold_cross_validation:
        raise ValueError(
            "ckpt_path carries ONE fold's training state; under "
            "k_fold_cross_validation=true it would be loaded into every "
            "fold (same weights + skipped epoch range -> invalid CV "
            "statistics). Resume the interrupted fold with "
            "k_fold_cross_validation=false, or drop ckpt_path.")


def train(cfg: Config, device="cuda", mesh=None) -> Dict[str, float]:
    """Every fold of ``cfg`` (one without k-fold CV) on ``device``;
    returns the CV aggregate, also written to
    ``<output_dir>/cv_summary.json``. Under the launcher's environment (or
    with a ``mesh`` of a process group the caller formed) every rank runs
    it on its rows; a group formed here is torn down on exit and on
    error."""
    _check_config(cfg)
    own = mesh is None and launched()
    if own:
        mesh = create_mesh(cfg.mesh, torch.device(device).type)
    else:
        check_mesh_config(cfg.mesh, 1 if mesh is None
                          else mesh.world * mesh.model_world)
    try:
        return _train(cfg, device if mesh is None else mesh.device, mesh)
    finally:
        if own:
            destroy_mesh(mesh)


def _barrier(mesh) -> None:
    if mesh is not None:
        mesh.barrier()


def _train(cfg: Config, device, mesh) -> Dict[str, float]:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; the command line's --device cpu "
                           "runs on the CPU")
    main = mesh is None or mesh.is_main
    quiet_unless_main(mesh)
    if main:
        os.makedirs(cfg.output_dir, exist_ok=True)
        if mesh is not None and device.type == "cuda":
            # one build of the kernels for the host's ranks, not one each;
            # a failed build fails rank 0, and the launcher stops the rest
            load_library()
    _barrier(mesh)
    tcfg = TrainConfig.from_config(cfg)
    dm = build_datamodule(cfg, device, mesh=mesh)
    is_vlp = cfg.model.task == "vision_language"

    downstream = None
    if is_vlp:
        downstream = DownstreamData(downstream_config(cfg), device,
                                    mesh=mesh)

    fold_summaries: List[Dict[str, float]] = []
    n_folds = None if cfg.k_fold_cross_validation else 1
    fp = _config_fingerprint(cfg)
    for fold in dm.folds():
        if n_folds is not None and fold.index >= n_folds:
            break
        done_path = os.path.join(cfg.output_dir, f"fold{fold.index}.done.json")
        if cfg.resume_completed_folds and os.path.exists(done_path):
            try:
                with open(done_path) as fh:
                    done = json.load(fh)
            except (OSError, json.JSONDecodeError):
                done = None
            if done and done.get("fingerprint") == fp:
                logger.info("Fold %d: reusing completed summary (%s)",
                            fold.index, done_path)
                fold_summaries.append(done["summary"])
                continue
            if done is not None:
                logger.warning(
                    "Fold %d: %s fingerprint does not match this config "
                    "(args/data changed since it was written): re-running "
                    "the fold", fold.index, done_path)
        sinks = [MemorySink()]
        if main:
            sinks.append(JsonlSink(os.path.join(
                cfg.output_dir, f"metrics_fold{fold.index}.jsonl")))
        if cfg.logger == "wandb":
            logger.warning("wandb is not available to the port; JSONL sink "
                           "only")
        sink = MultiSink(sinks)
        task = build_task(tcfg, fold.statics, device, mesh)
        probe = pak = None
        if is_vlp:
            probe, pak = _linear_probe_callback(
                cfg, downstream, cfg.trainer.linear_probe_every_n_epochs,
                task)
        trainer = Trainer(
            cfg, task, fold.train_loader, fold.val_loaders, sink=sink,
            checkpoint_dir=os.path.join(cfg.output_dir, "checkpoints",
                                        f"fold{fold.index}"),
            linear_probe=probe, downstream_pak=pak,
            retrieval_ks=cfg.model.retrieval_ks)
        _maybe_warm_start(cfg, trainer)
        if is_vlp:
            _maybe_load_pretrained_text_tower(cfg, trainer)
        log_hyperparameters(cfg, trainer.state.model, sink)
        if cfg.ckpt_path:
            # resume (reference passes ckpt_path to trainer.fit,
            # src/train.py:171)
            if ckpt.load_meta(cfg.ckpt_path) is not None:
                trainer.load_resume_state(cfg.ckpt_path)
            else:
                ckpt.load_model_state(
                    trainer.state.model,
                    ckpt.restore_raw(cfg.ckpt_path)["model"])
                logger.warning(
                    "ckpt_path %s has no .meta.json sidecar: this is a "
                    "WARM START, not a resume; optimizer moments, the "
                    "schedule's position and the epoch counters restart "
                    "from zero", cfg.ckpt_path)
        trainer.fit()
        _barrier(mesh)  # rank 0's checkpoints are on disk
        summary = dict(sink.sinks[0].summary)
        summary.update({f"time/{k}": v for k, v in trainer.times.items()})
        if not is_vlp:
            summary.update(_post_fit_plots(cfg, trainer, fold, main))
        if is_vlp and trainer.checkpointer and \
                trainer.checkpointer.best_path:
            summary.update(_downstream_precision_at_k(cfg, trainer,
                                                      downstream))
        sink.log_summary(summary)
        sink.finish()
        if main:
            _write_fold_done(done_path, summary, fp)
        _barrier(mesh)  # the marker too
        fold_summaries.append(summary)
        logger.info("Fold %d summary: %s", fold.index,
                    {k: round(v, 4) for k, v in summary.items()
                     if isinstance(v, float)})

    agg = aggregate_folds(fold_summaries)
    if main:
        with open(os.path.join(cfg.output_dir, "cv_summary.json"),
                  "w") as fh:
            json.dump(agg, fh, indent=2)
    logger.info("CV aggregate: %s", {k: round(v, 4) for k, v in agg.items()})
    if cfg.test and not is_vlp:
        agg.update(_evaluate_test_set(cfg, dm, device, mesh))
    return agg


def _fold_number(path: str) -> int:
    return int(os.path.basename(path)[len("fold"):])


def best_checkpoints(output_dir: str) -> List[tuple]:
    """(fold index, best ``.pt``) of each ``checkpoints/fold<i>`` directory,
    in numeric order (fold10 after fold2). The best path is the one ``last``'s
    sidecar records, trusted only if no ``epoch*.pt`` is newer than the
    sidecar by more than 1 s (a later run in the same directory would
    otherwise be shadowed by an earlier run's sidecar); else the newest
    ``epoch*.pt`` by mtime, with a warning. A directory without a
    checkpoint is skipped with a warning."""
    out = []
    for fold_dir in sorted(
            glob.glob(os.path.join(output_dir, "checkpoints", "fold*")),
            key=_fold_number):
        paths = [p for p in glob.glob(os.path.join(fold_dir, "epoch*.pt"))
                 if os.path.isfile(p)]
        meta = ckpt.load_meta(os.path.join(fold_dir, "last.pt"))
        meta_path = os.path.join(fold_dir, "last.pt.meta.json")
        fresh = meta is not None and all(
            os.path.getmtime(p) <= os.path.getmtime(meta_path) + 1.0
            for p in paths)
        best = None
        if fresh and meta.get("checkpoint_best_path") and \
                os.path.isfile(meta["checkpoint_best_path"]):
            best = meta["checkpoint_best_path"]
        elif paths:
            best = max(paths, key=os.path.getmtime)
            if len(paths) > 1 or meta is not None:
                logger.warning(
                    "test=true: %s has a missing or stale sidecar (%d epoch "
                    "checkpoints on disk); using the newest by mtime: %s",
                    fold_dir, len(paths), best)
        if best:
            out.append((_fold_number(fold_dir), best))
        else:
            logger.warning("test=true: %s has no checkpoints; its fold is "
                           "skipped", fold_dir)
    return out


def _evaluate_test_set(cfg: Config, dm, device, mesh=None
                       ) -> Dict[str, float]:
    """Each fold's best checkpoint on the frozen test split, with that
    fold's statistics: ``<output_dir>/test_eval.csv`` (its ``fold`` is the
    checkpoint's position in the list) and ``test/<metric>``, the mean over
    folds of the overall rows, NaN skipped as pandas' ``mean`` skips it.
    On a mesh every rank evaluates its rows of the test loader and gathers
    the probabilities; rank 0 writes the CSV."""
    ckpts = best_checkpoints(cfg.output_dir)
    if not ckpts:
        logger.warning("test=true but no checkpoints found; skipping")
        return {}
    frames = [collect_probs(cfg, path, dm, fold, device)
              for fold, path in ckpts]
    out_csv = os.path.join(cfg.output_dir, "test_eval.csv")
    results = evaluate_results(
        out_csv if mesh is None or mesh.is_main else None, frames)
    overall: Dict[str, List[float]] = {}
    for level, metric, value in zip(results["level"], results["metric"],
                                    results["value"]):
        if level == "overall":
            overall.setdefault(metric, []).append(value)
    agg = {}
    for metric, values in overall.items():
        v = np.asarray(values, np.float64)
        n = int((~np.isnan(v)).sum())
        # pandas' nanmean: the sum with NaN as 0, over the values kept
        agg[f"test/{metric}"] = float(np.where(np.isnan(v), 0.0, v).sum()
                                      / n) if n else float("nan")
    logger.info("Frozen test set: %s (full CSV: %s)",
                {k: round(v, 4) for k, v in agg.items()}, out_csv)
    return agg


def _post_fit_plots(cfg: Config, trainer: Trainer, fold, main: bool = True
                    ) -> Dict[str, float]:
    """The fold's silhouette scores by tumor label and by dataset from one
    eval-mode pass of the trainer's final weights over its val loaders,
    and, on rank 0, the t-SNE and confusion figures (reference
    src/train.py:180-183, :261-325). Nothing is caught: a failed forward or
    t-SNE fails the run; only a missing matplotlib skips the figures."""
    return plot_val_outputs(
        trainer.task, fold.val_loaders,
        os.path.join(cfg.output_dir, "plots", f"fold{fold.index}"),
        draw=main)


def _downstream_precision_at_k(cfg: Config, trainer: Trainer,
                               downstream: DownstreamData
                               ) -> Dict[str, float]:
    """Label precision@k of the best VLP image tower over the whole
    downstream train + val data of its first fold (reference
    src/train.py:187-211), with that fold's normalisation. The fold's
    model is done training: it takes the best weights in place (a sharded
    model's ranks each their shards)."""
    best = trainer.checkpointer.restore_best()
    eval_task = copy.copy(trainer.task)
    ckpt.load_model_state(eval_task.model, best["model"])
    fold = next(downstream.folds())
    eval_task.statics = fold.statics
    embs, labels = zip(*(collect_over_loader(eval_task.embed_images_fn, ld)
                         for ld in [fold.train_loader,
                                    *fold.val_loaders.values()]))
    emb, y = torch.cat(embs), torch.cat(labels)
    ks = tuple(k for k in cfg.model.retrieval_ks if k + 1 <= emb.shape[0])
    if not ks:  # tiny downstream sets: p@k undefined
        return {}
    p = label_precision_at_k(emb, y, ks=ks)
    values = torch.stack([p[k] for k in ks]).tolist()
    return {f"downstream_entire/label_precision_at_{k}": v
            for k, v in zip(ks, values)}


def aggregate_folds(summaries: List[Dict[str, float]]) -> Dict[str, float]:
    """mean/std across folds (reference src/train.py:229-240)."""
    if not summaries:
        return {}
    keys = set.intersection(*(set(s) for s in summaries))
    out = {}
    for k in sorted(keys):
        vals = [float(s[k]) for s in summaries
                if isinstance(s[k], (int, float))]
        if not vals:
            continue
        out[f"{k}_mean"] = float(np.mean(vals))
        out[f"{k}_std"] = float(np.std(vals))
    out["num_folds"] = len(summaries)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m vlp_tpu_torch.train",
        description="K-fold training of an experiment on one device, or "
                    "on N under python -m torch.distributed.run; overrides "
                    "are dotted.path=value, experiment=<name> first.")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args, overrides = parser.parse_known_args(argv)
    cfg = apply_overrides(Config(), overrides)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    train(cfg, args.device)  # forms the process group under the launcher
    return 0
