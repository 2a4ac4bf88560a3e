"""Rank processes of the tensor-parallel tests (``test_torch_port_tp.py``),
spawned by ``torch_parallel_workers.run_ranks`` on a D x M mesh of gloo
ranks. They import torch and the port only (no JAX); the comparisons with
the JAX package run in the parent. ``fsdp.MIN_SIZE`` is set inside these
processes where a case lowers the JAX rule's threshold (the parent sets
``vlp_tpu.parallel.mesh._FSDP_MIN_SIZE`` to the same value), so that the
test widths split at all.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from torch_parallel_workers import (CPU, VLP_TRAINER, WARM_TRAINER, _gathered,
                                    _same_tree, _timeless)


def _set_min_size(value: int) -> None:
    from vlp_tpu_torch.parallel import fsdp

    fsdp.MIN_SIZE = value


# --------------------------------------------------------------------------
# blocks and tiny models against the same models unsplit
# --------------------------------------------------------------------------

def _tiny(kind: str):
    """(model, input) of a tiny fp32 model of ``kind`` from a fixed seed:
    the ViT in both attention layouts, NesT (level 0 stays whole at the
    test threshold, level 1 splits; blockified or with ``nhwc_windows``)
    and a Bottleneck ResNet on the s2d stem."""
    from vlp_tpu_torch.models.nest import NesT
    from vlp_tpu_torch.models.resnet import Bottleneck, ResNet
    from vlp_tpu_torch.models.vit import ViT, flax_init_

    f32 = dict(dtype=torch.float32)
    if kind.startswith("vit"):
        model = ViT(img_size=32, patch_size=8, hidden_dim=64, depth=2,
                    num_heads=4, megakernel=False,
                    fused_attention=kind == "vit_fused", **f32)
    elif kind == "nest":
        model = NesT(img_size=32, patch_size=4, embed_dims=(32, 64),
                     num_heads=(2, 4), depths=(1, 1), block_size=4, **f32)
    elif kind == "nest_nhwc":
        model = NesT(img_size=32, patch_size=4, embed_dims=(32, 64),
                     num_heads=(2, 4), depths=(1, 1), block_size=4,
                     nhwc_windows=True, **f32)
    else:
        model = ResNet((1, 1), Bottleneck, stem="s2d", **f32)
    flax_init_(model, torch.Generator().manual_seed(3))
    if kind.startswith("resnet"):
        with torch.no_grad():  # running statistics away from 0 and 1
            for name, buf in model.named_buffers():
                buf.uniform_(0.5, 1.5, generator=torch.Generator()
                             .manual_seed(len(name)))
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(4))
    return model, x


def _grads_full(model) -> Dict[str, np.ndarray]:
    from vlp_tpu_torch.parallel import tp

    grads = {k: p.grad for k, p in model.named_parameters()}
    if tp.is_split(model):
        grads = tp.gather_state(model, grads)
    return {k: g.detach().numpy().copy() for k, g in grads.items()}


def _run_tiny(model, x) -> Dict:
    """Forward and backward in training mode."""
    from vlp_tpu_torch.parallel import tp

    model.train()
    x = x.clone().requires_grad_(True)
    y = model(x)
    (y * torch.linspace(-1, 1, y.numel()).view_as(y)).sum().backward()
    state = tp.gather_state(model) if tp.is_split(model) \
        else model.state_dict()
    return {"y": y.detach().numpy().copy(), "dx": x.grad.numpy().copy(),
            "grads": _grads_full(model),
            "state": {k: v.numpy().copy() for k, v in state.items()}}


def blocks_worker(mesh, cases: Dict[str, int]) -> Dict:
    """Each tiny model (``cases``: kind -> the threshold) unsplit and split
    over the model ranks, forward and backward in training mode on the same
    input; the split model's report."""
    from vlp_tpu_torch.parallel import tp

    out = {}
    for kind, min_size in cases.items():
        _set_min_size(min_size)
        model, x = _tiny(kind)
        want = _run_tiny(model, x)
        model, x = _tiny(kind)
        tp.shard_model_tp(model, mesh)
        got = _run_tiny(model, x)
        out[kind] = {"want": want, "got": got, "report": tp.report(model)}
        if kind == "nest_nhwc":
            out[kind]["level_nhwc"] = [
                model._level_uses_nhwc(torch.zeros(4, 8, 8, 32), 0),
                model._level_uses_nhwc(torch.zeros(4, 4, 4, 64), 1)]
    _set_min_size(2 ** 16)
    return out


def nothing_splits_worker(mesh) -> str:
    """The error of a TP split of a model with no leaf the JAX rule
    shards."""
    from vlp_tpu_torch.parallel import tp

    model, _ = _tiny("vit_fused")
    try:
        tp.shard_model_tp(model, mesh)
    except ValueError as e:
        return str(e)
    return "split"


# --------------------------------------------------------------------------
# the trainer, its checkpoints and the driver under tp
# --------------------------------------------------------------------------

TP = ["mesh.param_sharding=tp", "mesh.model_parallel=2"]
TP_TRAINER = ["model.model=resnet_micro", "data.image_size=32",
              "data.batch_size=8", "data.eval_batch_size=8",
              "data.synthetic_num_samples=48",
              "scheduler.name=cosine_warmup", "scheduler.warmup_epochs=1",
              "trainer.max_epochs=2", "data.shear_augmentation=true",
              "mesh.model_parallel=2"]


def _trainer(mesh, overrides, ckpt_dir):
    """(trainer, fold) of the smoke classifier on ``resnet_micro`` with
    ``overrides`` on fold 0, on ``mesh``."""
    from vlp_tpu_torch.config import (TrainConfig, apply_overrides,
                                      get_experiment)
    from vlp_tpu_torch.data.datamodule import build_datamodule
    from vlp_tpu_torch.models.tasks import build_task
    from vlp_tpu_torch.train.loop import Trainer

    cfg = apply_overrides(get_experiment("smoke_synthetic_only_imaging"),
                          TP_TRAINER + list(overrides))
    cfg.output_dir = str(ckpt_dir)
    fold = next(build_datamodule(cfg, CPU, mesh=mesh).folds())
    task = build_task(TrainConfig.from_config(cfg), fold.statics, CPU, mesh)
    return Trainer(cfg, task, fold.train_loader, fold.val_loaders,
                   checkpoint_dir=str(ckpt_dir)), fold


def _full_state(model) -> Dict[str, np.ndarray]:
    from vlp_tpu_torch.parallel import tp

    if not tp.is_split(model):
        return _gathered(model)
    return {k: v.numpy().copy() for k, v in tp.gather_state(model).items()}


def _no_time(agg: Dict) -> Dict:
    return {k: v for k, v in agg.items()
            if not k.startswith("time/") and "per_sec" not in k}


def trainer_worker(mesh, tmp: str) -> Dict:
    """Under ``mesh.param_sharding=tp``: the smoke experiment's driver run
    (ResNet18, one fold of one epoch) against the replicated one; the
    trainer straight for 2 epochs against 1 epoch and a resumed one; the
    best checkpoint served by a one-process ``Predictor`` against the split
    model's eval forward; a replicated run's ``last`` resumed under tp
    against the replicated resume, and the tp run's under replicated; the
    VLP driver under tp and replicated, and a classifier under tp
    warm-started from the tp run's best: its gathered backbone when
    ``fit`` starts."""
    from vlp_tpu_torch.config import apply_overrides, get_experiment
    from vlp_tpu_torch.parallel import tp
    from vlp_tpu_torch.parallel.collectives import gather_rows
    from vlp_tpu_torch.parallel.mesh import shard_batch
    from vlp_tpu_torch.serve import Predictor
    from vlp_tpu_torch.train import driver
    from vlp_tpu_torch.train.loop import Trainer
    from vlp_tpu_torch.utils.checkpoint import (extract_image_encoder,
                                                load_meta, load_model_state,
                                                restore_raw, state_to_tree)

    out: Dict = {}
    smoke = {}
    for name, over in (("replicated", ["mesh.model_parallel=2"]),
                       ("tp", TP)):
        cfg = apply_overrides(get_experiment("smoke_synthetic_only_imaging"),
                              over + ["k_fold_cross_validation=false"])
        cfg.output_dir = f"{tmp}/smoke_{name}"
        smoke[name] = _no_time(driver.train(cfg, "cpu", mesh))
    out["smoke"] = smoke

    straight, fold = _trainer(mesh, TP, f"{tmp}/a")
    straight.fit()
    first, _ = _trainer(mesh, TP, f"{tmp}/b")
    first.fit(max_epochs=1)
    mesh.barrier()  # rank 0's last.pt is on disk
    resumed, _ = _trainer(mesh, TP, f"{tmp}/c")
    resumed.load_resume_state(f"{tmp}/b/last.pt")
    start = resumed.start_epoch
    resumed.fit()
    mesh.barrier()
    out["resume"] = {
        "split": len(straight.state.model.tp_splits),
        "start_epoch": start,
        "history_straight": _timeless(straight.sink.history),
        "history_first": _timeless(first.sink.history),
        "history_resumed": _timeless(resumed.sink.history),
        "straight_state": _full_state(straight.state.model),
        "resumed_state": _full_state(resumed.state.model)}

    # the best checkpoint on one process against the split model
    best = straight.checkpointer.best_path
    assert tp.is_split(straight.task.model)
    load_model_state(straight.task.model, restore_raw(best)["model"])
    rng = np.random.default_rng(9)
    b = 8
    images = rng.integers(0, 256, (b, 32, 32), dtype=np.uint8)
    full = {"image_u8": images, "label": np.zeros(b, np.int32),
            "dataset_id": np.zeros(b, np.int32),
            "mask": np.ones(b, np.float32)}
    local = {k: torch.from_numpy(v) for k, v in
             shard_batch(full, mesh).items()}
    split = gather_rows(straight.task.eval_fn(local)["logits"], mesh)
    if mesh.is_main:
        tree = restore_raw(best)
        pred = Predictor(straight.cfg, None, fold.statics.mean,
                         fold.statics.std, batch_size=b, device="cpu",
                         checkpoint=best)
        out["serve"] = {
            "format": "replicated" if isinstance(
                next(iter(tree["optimizer"]["state"])), int) else "other",
            "shapes": {k: tuple(v.shape) for k, v in tree["model"].items()},
            "predictor": pred.predict_logits(images),
            "split": split.numpy().copy()}

    # a replicated run's last.pt resumed under tp and replicated: the
    # state each holds after the load (gathered) against the file's
    rep, _ = _trainer(mesh, [], f"{tmp}/r")
    rep.fit(max_epochs=1)
    mesh.barrier()
    saved = restore_raw(f"{tmp}/r/last.pt")
    cross = {}
    for name, over in (("replicated", []), ("tp", TP)):
        t, _ = _trainer(mesh, over, f"{tmp}/r_{name}")
        t.load_resume_state(f"{tmp}/r/last.pt")
        tree = state_to_tree(t.state)
        cross[f"loaded_{name}"] = _same_tree(tree, saved)
        t.fit()
        cross[f"history_{name}"] = _timeless(t.sink.history)
    # and the tp run's last.pt resumed under replicated
    t, _ = _trainer(mesh, [], f"{tmp}/b_replicated")
    t.load_resume_state(f"{tmp}/b/last.pt")
    cross["tp_file_loaded_replicated"] = _same_tree(
        state_to_tree(t.state), restore_raw(f"{tmp}/b/last.pt"))
    out["cross"] = cross

    # the VLP driver under both, then the tp run's best as a warm start
    vlp = {}
    for name, over in (("replicated", ["mesh.model_parallel=2"]),
                       ("tp", TP)):
        cfg = apply_overrides(get_experiment("smoke_synthetic_pretrain"),
                              VLP_TRAINER + over)
        cfg.output_dir = f"{tmp}/vlp_{name}"
        vlp[name] = _no_time(driver.train(cfg, "cpu", mesh))
    out["vlp"] = vlp
    mesh.barrier()
    best = load_meta(f"{tmp}/vlp_tp/checkpoints/fold0/last.pt")[
        "checkpoint_best_path"]
    cfg = apply_overrides(get_experiment("vlp_finetune_only_imaging_resnet34"),
                          WARM_TRAINER + TP + [
                              f"model.pretrained_ckpt={best}"])
    cfg.output_dir = f"{tmp}/warm"
    fit, seen = Trainer.fit, []

    def gathered_fit(self, *a, **k):
        seen.append((tp.is_split(self.state.model),
                     _full_state(self.state.model)))  # every rank gathers
        return fit(self, *a, **k)

    Trainer.fit = gathered_fit
    try:
        driver.train(cfg, "cpu", mesh)
    finally:
        Trainer.fit = fit
    encoder = extract_image_encoder(restore_raw(best)["model"])
    (split_fit, state), = seen
    out["warm"] = {
        "split": split_fit,
        "encoder": {k: v.float().numpy() for k, v in encoder.items()},
        "backbone": {k[len("backbone."):]: v for k, v in state.items()
                     if k.startswith("backbone.")}}
    out["files"] = sorted(os.listdir(f"{tmp}/smoke_tp")) \
        if mesh.is_main else None
    return out
