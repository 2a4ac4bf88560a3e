"""Rank processes of the data-parallel tests (``test_torch_port_parallel*.py``).

``run_ranks(target, world, tmp_dir, *args)`` starts ``world`` processes with
the ``spawn`` context; each forms a gloo group through a ``FileStore`` under
``tmp_dir`` (no TCP port to collide across test workers), runs
``target(mesh, *args)`` and pickles its result to a file, which the parent
reads back. Each process is joined with a timeout and killed on expiry, so
a hung rendezvous fails one test, not the suite. The targets import torch
and the port only (no JAX): the tests compare their results in the parent.
"""
from __future__ import annotations

import contextlib
import functools
import os
import pickle
import tempfile
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

CPU = torch.device("cpu")
# the ATen CPU kernels that call MKL's vector math (ATen/cpu/vml.h)
VML_FUNCTIONS = ("acos", "asin", "atan", "cos", "erf", "erfc", "erfinv",
                 "exp", "log", "log10", "log2", "sin", "sqrt", "tan", "tanh",
                 "trunc")


def warm_vml() -> None:
    """One call of each MKL vector-math routine, on this thread alone.

    MKL sets a routine up on its first call. When that first call comes
    from two intra-op threads at once (a tensor large enough to split),
    one thread's share now and then runs a low-accuracy path: exp off by
    up to 1e-4 relative on half of a [4, 4, 17, 17] score tensor, which
    moved a tiny ViT's output by 1.8e-5 of its largest value in about one
    rank process in 300 under load. A one-element call runs on the
    calling thread alone, so after it no first call is shared."""
    for dtype in (torch.float32, torch.float64):
        x = torch.full((1,), 0.5, dtype=dtype)
        for name in VML_FUNCTIONS:
            getattr(torch, name)(x)


def _entry(target, rank, world, out, args, timeout_s, device,
           model_parallel=1, axis="model"):
    torch.set_num_threads(2)
    warm_vml()
    from vlp_tpu_torch.parallel import mesh as pmesh

    try:
        kw = dict(init_method=f"file://{out}/store", rank=rank,
                  world_size=world, timeout_s=timeout_s)
        if axis == "model":
            mesh = pmesh.create_mesh(None, device,
                                     model_parallel=model_parallel, **kw)
        else:  # the pipeline's stage axis or the sequence's token axis
            make = pmesh.create_pipeline_mesh if axis == "stage" \
                else pmesh.create_seq_mesh
            mesh = make(model_parallel, world // model_parallel, device, **kw)
        result = target(mesh, *args)
        pmesh.destroy_mesh(mesh)
    except BaseException:
        with open(f"{out}/rank{rank}.err", "w") as fh:
            fh.write(traceback.format_exc())
        raise
    with open(f"{out}/rank{rank}.pkl", "wb") as fh:
        pickle.dump(result, fh)


def run_ranks(target, world: int, tmp_dir, *args, timeout: float = 180.0,
              collective_timeout: float = 90.0, device: str = "cpu",
              model_parallel: int = 1, axis: str = "model") -> List:
    """``target(mesh, *args)`` on ``world`` ranks (gloo on the CPU, NCCL on
    ``device="cuda"``), on the ``world / model_parallel`` x
    ``model_parallel`` mesh, whose second axis is ``axis`` (``model``:
    ``create_mesh``; ``stage``: ``create_pipeline_mesh``; ``seq``:
    ``create_seq_mesh``); their results in global rank order. Raises
    with the ranks' tracebacks if any rank failed or hung."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = tempfile.mkdtemp(dir=str(tmp_dir))
    procs = [ctx.Process(target=_entry, args=(target, r, world, out, args,
                                              collective_timeout, device,
                                              model_parallel, axis))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [open(f"{out}/rank{r}.err").read() for r in range(world)
              if os.path.exists(f"{out}/rank{r}.err")]
    codes = [p.exitcode for p in procs]
    if hung or errors or any(codes):
        raise AssertionError(f"ranks hung {hung}, exit codes {codes}:\n"
                             + "\n".join(errors))
    results = []
    for r in range(world):
        with open(f"{out}/rank{r}.pkl", "rb") as fh:
            results.append(pickle.load(fh))
    return results


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor shard's full tensor (a collective: every rank calls it in
    the same order); any other tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _np(t: torch.Tensor) -> np.ndarray:
    return _full(t).detach().float().cpu().numpy().copy()


def local_numel(tensors) -> int:
    """Elements this rank holds of ``tensors`` (a DTensor's shard)."""
    from torch.distributed.tensor import DTensor

    return int(sum((t.to_local() if isinstance(t, DTensor) else t).numel()
                   for t in tensors))


# --------------------------------------------------------------------------
# the collectives, the global losses and BatchNorm
# --------------------------------------------------------------------------

def _leaf(a, rows=None):
    t = torch.tensor(a if rows is None else a[rows])
    return t.requires_grad_(True) if t.is_floating_point() else t


def losses_worker(mesh, d: Dict[str, np.ndarray]) -> Dict:
    from vlp_tpu_torch.models.vit import BatchNorm, set_batchnorm_mesh
    from vlp_tpu_torch.ops import losses
    from vlp_tpu_torch.parallel import collectives as C
    from vlp_tpu_torch.parallel.infonce import clip_loss

    rows = mesh.rows(d["img"].shape[0])
    out: Dict = {}
    # collectives: forward and adjoint
    x = _leaf(d["x"], rows)
    y = C.all_gather(x, mesh)
    (y * torch.tensor(d["w"])).sum().backward()
    out["gather"], out["gather_grad"] = _np(y), _np(x.grad)
    x = _leaf(d["x"], rows)
    s = C.all_reduce(x, mesh)
    (s * torch.tensor(d["w"][rows])).sum().backward()
    out["reduce"], out["reduce_grad"] = _np(s), _np(x.grad)
    x = _leaf(d["x"])
    part = C.reduce_scatter(x * (mesh.rank + 1), mesh)
    (part * torch.tensor(d["w"][rows])).sum().backward()
    out["scatter"], out["scatter_grad"] = _np(part), _np(x.grad)
    # the CLIP losses in both forms and the deprecated variants
    for variant in ("symmetric_infonce", "masked", "non_square"):
        for impl in ("gspmd", "shard_map"):
            for tail in (False, True):
                img, txt = _leaf(d["img"], rows), _leaf(d["txt"], rows)
                scale = _leaf(np.float32(d["logit_scale"]))
                mask = torch.tensor(d["mask_tail" if tail else "ones"][rows])
                loss = clip_loss(variant, impl, img, txt, scale, mask,
                                 torch.tensor(d["cid"][rows]), mesh)
                loss.backward()
                out[("clip", variant, impl, tail)] = (
                    float(loss), _np(img.grad), _np(txt.grad),
                    float(scale.grad))
    # the weighted masked BCE and CORAL
    logits = _leaf(d["logits"], rows)
    labels = torch.tensor(d["labels"][rows])
    w = losses.per_sample_class_weights(labels, tuple(d["class_weights"]))
    for tail in (False, True):
        logits.grad = None
        mask = torch.tensor(d["mask_tail"][rows]) if tail else None
        loss = losses.bce_with_logits(logits, labels, w, mask, mesh)
        loss.backward()
        out[("bce", tail)] = (float(loss), _np(logits.grad))
    feats = _leaf(d["feats"], rows)
    dom = torch.tensor(d["domain"][rows])
    m = torch.tensor(d["mask_tail"][rows])
    loss = losses.coral_loss(feats, feats, m * (dom == 0), m * (dom == 1),
                             mesh=mesh)
    loss.backward()
    out["coral"] = (float(loss), _np(feats.grad))
    # BatchNorm on NCHW maps and on [B, C] rows (the clinical MLP's)
    for key in ("bn4", "bn2"):
        x = _leaf(d[key], rows)
        bn = BatchNorm(x.shape[1])
        with torch.no_grad():
            bn.weight.copy_(torch.tensor(d[key + "_scale"]))
            bn.bias.copy_(torch.tensor(d[key + "_bias"]))
        set_batchnorm_mesh(bn, mesh)
        bn.train()
        y = bn(x)
        # each rank's share of one objective: the sum over the ranks is
        # the global batch's sum(y * cot)
        (y * torch.tensor(d[key + "_cot"][rows])).sum().backward()
        out[key] = {"y": _np(y), "dx": _np(x.grad),
                    "dscale": _np(bn.weight.grad), "dbias": _np(bn.bias.grad),
                    "mean": _np(bn.running_mean), "var": _np(bn.running_var)}
    # every rank starts from rank 0's weights
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(mesh.rank))
    C.broadcast_module(lin, mesh)
    out["broadcast"] = _np(lin.weight)
    return out


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------

@contextlib.contextmanager
def tiny_backbones(tiny: Optional[Dict[str, Dict]]):
    """While open, the port's registry builds each backbone named in
    ``tiny`` (``vit_base_patch16_224`` or ``nest_small``) as its ViT or
    NesT with those arguments."""
    from vlp_tpu_torch.models import nest, vit

    saved = []
    for name, kw in (tiny or {}).items():
        module, cls = (nest, nest.NesT) if name.startswith("nest") \
            else (vit, vit.ViT)
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, functools.partial(cls, **kw))
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def build(spec: Dict, mesh):
    """(task, state, step) of ``spec``: the experiment and overrides, the
    fold statics, the weights (a numpy state dict) and the step's
    optimizer, on ``mesh`` (None: one process); ``spec["tiny"]`` the
    backbones built small (``tiny_backbones``)."""
    from vlp_tpu_torch.config import (Config, TrainConfig, apply_overrides,
                                      get_experiment)
    from vlp_tpu_torch.models.tasks import TaskStatics, build_task
    from vlp_tpu_torch.ops.augment import AugmentConfig
    from vlp_tpu_torch.parallel import fsdp
    from vlp_tpu_torch.parallel.fsdp import shard_model
    from vlp_tpu_torch.parallel.tp import shard_model_tp
    from vlp_tpu_torch.train.optim import make_optimizer
    from vlp_tpu_torch.train.setup import init_training
    from vlp_tpu_torch.train.state import TrainState
    from vlp_tpu_torch.train.step import make_train_step

    fsdp.MIN_SIZE = spec.get("min_size", 2 ** 16)  # this rank process
    cfg = apply_overrides(get_experiment(spec["experiment"]) if
                          spec.get("experiment") else Config(),
                          list(spec["overrides"]))
    tcfg = TrainConfig.from_config(cfg)
    aug = tcfg.augment() if spec.get("augment") else AugmentConfig(
        enabled=False)
    statics = TaskStatics(mean=spec["mean"], std=spec["std"],
                          class_weights=tuple(spec.get("class_weights",
                                                       (1.0, 1.0))),
                          out_channels=tcfg.serve.in_channels, augment=aug)
    device = mesh.device if mesh is not None else torch.device(
        spec.get("device", "cpu"))
    with tiny_backbones(spec.get("tiny")):
        task = build_task(tcfg, statics, device, mesh)
    if spec.get("weights") is None:
        state, step = init_training(task, tcfg, spec["spe"], seed=0,
                                    state_seed=1)
        return task, state, step
    task.model.load_state_dict({k: torch.tensor(v, device=device)
                                for k, v in spec["weights"].items()})
    if mesh is not None and tcfg.param_sharding == "fsdp":
        shard_model(task.model, mesh)
    elif tcfg.param_sharding == "tp":
        shard_model_tp(task.model, mesh)
    opt, schedules = make_optimizer(tcfg, task.model, spec["spe"])
    state = TrainState.create(task.model, opt, schedules, seed=1)
    return task, state, make_train_step(task, opt, schedules)


def run_steps(spec: Dict, mesh) -> Dict:
    """``spec["steps"]`` steps on ``spec["batch"]`` (the global batch; on a
    mesh this rank's rows of it); the losses, the last aux's scalars, the
    gradients the last step applied and the model's state dict after (a
    sharded model's gathered), and with ``spec["elements"]`` the elements
    this rank holds of the parameters and of the optimizer's moments and
    the names of the sharded parameters (a split model's: gathered, and
    with ``spec["local"]`` also this rank's own state); with
    ``spec["spans"]`` the
    reduction spans each step recorded (``step.reduce_events``, each
    span's (start, end) in the order of ``record()`` on the CPU's stand-in
    for a CUDA event) and the FSDP units that hold sharded parameters."""
    from vlp_tpu_torch.parallel.mesh import shard_batch
    from vlp_tpu_torch.train.step import to_device

    task, state, step = build(spec, mesh)
    device = next(task.model.parameters()).device
    batch = to_device(shard_batch(spec["batch"], mesh), device)
    if spec.get("spans"):
        torch.cuda.Event = _OrderEvent  # this rank process only
        step.reduce_events = []
    losses, aux = [], {}
    for _ in range(spec.get("steps", 1)):
        aux = step(state, batch)
        losses.append(float(aux["loss"]))
    from vlp_tpu_torch.parallel import tp

    model = task.model
    grads = {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    full = model.state_dict()
    if tp.is_split(model):
        grads, full = tp.gather_state(model, grads), tp.gather_state(model)
    out = {"losses": losses,
           "aux": {k: float(v) for k, v in aux.items()
                   if isinstance(v, torch.Tensor) and v.dim() == 0},
           "grads": {k: _np(g) for k, g in grads.items()},
           "state": {k: _np(v) for k, v in full.items()}}
    if spec.get("local"):
        out["local"] = {k: _np(v) for k, v in model.state_dict().items()}
    if spec.get("elements"):
        from torch.distributed.tensor import DTensor

        params = list(model.parameters())
        moments = [t for s in state.optimizer.state.values()
                   for k, t in s.items() if k != "step"]
        out["elements"] = (local_numel(params), local_numel(moments))
        out["sharded"] = sorted(
            k for k, p in model.named_parameters()
            if isinstance(p, DTensor) or k in getattr(model, "tp_splits",
                                                      {}))
    if spec.get("spans"):
        out["spans"] = [[(a.at, b.at) for a, b in spans]
                        for spans in step.reduce_events]
        out["scatter_units"] = _scatter_units(task.model)
    return out


class _OrderEvent:
    """A CUDA event's stand-in on the CPU: ``at`` is the order in which
    ``record()`` ran."""
    count = 0

    def __init__(self, enable_timing: bool = False) -> None:
        self.at = None

    def record(self) -> None:
        _OrderEvent.count += 1
        self.at = _OrderEvent.count


def _scatter_units(model) -> int:
    """The FSDP units (``parallel/fsdp._units`` and the root) that hold a
    sharded parameter: each reduce-scatters once a backward."""
    from torch.distributed.tensor import DTensor

    from vlp_tpu_torch.parallel.fsdp import _units

    names = {id(m): n for n, m in model.named_modules()}
    owner = {}
    for i, unit in enumerate(_units(model)):
        for m in unit if isinstance(unit, list) else [unit]:
            owner[names[id(m)] + "."] = i

    def unit_of(name):
        prefixes = [p for p in owner if name.startswith(p)]
        return owner[max(prefixes, key=len)] if prefixes else "root"

    return len({unit_of(n) for n, p in model.named_parameters()
                if isinstance(p, DTensor)})


def steps_worker(mesh, specs: Dict[str, Dict]) -> Dict:
    return {name: run_steps(spec, mesh) for name, spec in specs.items()}


# --------------------------------------------------------------------------
# augmentation at the global batch
# --------------------------------------------------------------------------

def augment_rows(images: np.ndarray, seed: int, mesh) -> np.ndarray:
    """This rank's rows of the augmented global batch ``images`` (every
    row without a mesh), on a generator seeded with ``seed``."""
    from vlp_tpu_torch.ops.augment import AugmentConfig, augment_and_normalize
    from vlp_tpu_torch.parallel.mesh import shard_batch

    x = torch.tensor(shard_batch({"x": images}, mesh)["x"])
    gen = torch.Generator().manual_seed(seed)
    cfg = AugmentConfig(translate_prob=0.7, rotate_prob=0.7, zoom_prob=0.7,
                        flip_prob=0.5, noise_prob=0.7, noise_std=4.0,
                        shear_deg=5.0)
    return augment_and_normalize(x, gen, 100.0, 40.0, cfg, out_channels=1,
                                 dtype=torch.float32, mesh=mesh).numpy()


def augment_worker(mesh, batches: List[np.ndarray], seed: int) -> List:
    return [augment_rows(b, seed, mesh) for b in batches]


# --------------------------------------------------------------------------
# the loaders and the refusals
# --------------------------------------------------------------------------

def pretrain_bundle(n: int, size: int = 8, dup: int = 2):
    """A pretrain bundle of ``n`` random images whose captions each repeat
    ``dup`` times."""
    from vlp_tpu_torch.data.pipeline import ArrayBundle
    from vlp_tpu_torch.data.preprocess_host import ImageCache

    rng = np.random.default_rng(0)
    cache = ImageCache.from_arrays(
        rng.integers(0, 256, (n, size, size), dtype=np.uint8))
    cids = [i // dup for i in range(n)]
    samples = [{"dataset": "MURA" if i % 2 else "LERA",
                "image_path": f"s{i}", "label": i % 2,
                "caption_id": cids[i]} for i in range(n)]
    ids = (np.arange(6)[None, :] + np.arange(n)[:, None]).astype(np.int32)
    return ArrayBundle(samples, cache, token_ids=ids,
                       token_mask=np.ones((n, 6), np.int32)), cids


def loader_batches(mesh, n: int, batch_size: int, limit_mb: float,
                   epochs: int = 2, seed: int = 3):
    """(resident mode, the batches of ``epochs`` epochs as numpy) of a
    caption-unique loader over ``pretrain_bundle(n)`` under the budget
    ``limit_mb``; on a mesh this rank's rows, and the gathered global
    caption ids and masks."""
    from vlp_tpu_torch.data.pipeline import RESIDENT_LIMIT_MB, DeviceLoader
    from vlp_tpu_torch.data.sampler import NoDuplicateCaptionSampler
    from vlp_tpu_torch.parallel.collectives import gather_rows

    bundle, cids = pretrain_bundle(n)
    sampler = NoDuplicateCaptionSampler(n, cids, batch_size, seed=seed)
    old = os.environ.get(RESIDENT_LIMIT_MB)
    os.environ[RESIDENT_LIMIT_MB] = repr(limit_mb)
    try:
        loader = DeviceLoader(bundle, sampler, batch_size, CPU, mesh=mesh)
    finally:
        if old is None:
            del os.environ[RESIDENT_LIMIT_MB]
        else:
            os.environ[RESIDENT_LIMIT_MB] = old
    out = []
    for _ in range(epochs):
        for batch in loader:
            got = {k: v.numpy().copy() for k, v in batch.items()}
            got["global_caption_id"] = gather_rows(
                batch["caption_id"], mesh).numpy().copy()
            got["global_mask"] = gather_rows(batch["mask"],
                                             mesh).numpy().copy()
            out.append(got)
    return loader.resident_mode, out


def loaders_worker(mesh, cases: Dict[str, tuple]) -> Dict:
    return {name: loader_batches(mesh, *args) for name, args in
            cases.items()}


def refusals_worker(mesh) -> Dict[str, str]:
    """The message of each refusal at this world."""
    from vlp_tpu_torch.config import Config
    from vlp_tpu_torch.data.pipeline import DeviceLoader
    from vlp_tpu_torch.data.sampler import ShuffleBatchSampler
    from vlp_tpu_torch.parallel.mesh import check_mesh_config

    out = {}
    bundle, _ = pretrain_bundle(12)
    try:
        DeviceLoader(bundle, ShuffleBatchSampler(12, 5), 5, CPU, mesh=mesh)
    except ValueError as e:
        out["batch"] = str(e)
    for settings in ({"data_parallel": mesh.world + 1},
                     {"model_parallel": 2}, {"model_parallel": 3},
                     {"param_sharding": "fsdp"}, {"param_sharding": "tp"},
                     {"param_sharding": "fsdp", "model_parallel": 2},
                     {"param_sharding": "tp", "model_parallel": 2},
                     {"param_sharding": "tp", "model_parallel": 2,
                      "data_parallel": mesh.world},
                     {"infonce_impl": "shard_map", "model_parallel": 2}):
        m = Config().mesh
        for key, value in settings.items():
            setattr(m, key, value)
        try:
            check_mesh_config(m, mesh.world)
        except ValueError as e:
            out[",".join(f"{k}={v}" for k, v in settings.items())] = str(e)
    return out


def lonely_rank(store: str, out: str) -> None:
    """Rank 0 of a world of 2 whose peer never comes: the message of the
    error ``create_mesh`` raises, written to ``out``."""
    from vlp_tpu_torch.parallel.mesh import create_mesh

    try:
        create_mesh(None, "cpu", init_method=f"file://{store}", rank=0,
                    world_size=2, timeout_s=3.0)
        msg = "formed"
    except RuntimeError as e:
        msg = str(e)
    with open(out, "w") as fh:
        fh.write(msg)


# --------------------------------------------------------------------------
# the trainer, its checkpoints and the driver under fsdp
# --------------------------------------------------------------------------

FSDP_TRAINER = ["model.model=resnet_micro", "data.image_size=32",
                "data.batch_size=8", "data.eval_batch_size=8",
                "data.synthetic_num_samples=48",
                "scheduler.name=cosine_warmup", "scheduler.warmup_epochs=1",
                "trainer.max_epochs=2", "data.shear_augmentation=true"]


VLP_TRAINER = ["model.model=resnet_micro", "model.text_model=microbert",
               "data.image_size=32", "downstream_data.image_size=32",
               "data.synthetic_num_samples=40", "trainer.max_epochs=1",
               "trainer.linear_probe_every_n_epochs=1"]
WARM_TRAINER = ["model.model=resnet_micro", "data.image_size=32",
                "data.name=synthetic_downstream",
                "data.synthetic_num_samples=40", "trainer.max_epochs=1",
                "k_fold_cross_validation=false"]


def _timeless(records) -> List[Dict]:
    return [{k: v for k, v in r.items()
             if not k.endswith("train/images_per_sec")} for r in records]


def _fsdp_trainer(mesh, overrides, ckpt_dir):
    """(trainer, fold) of the smoke classifier with ``overrides`` on fold
    0, on ``mesh``."""
    from vlp_tpu_torch.config import (TrainConfig, apply_overrides,
                                      get_experiment)
    from vlp_tpu_torch.data.datamodule import build_datamodule
    from vlp_tpu_torch.models.tasks import build_task
    from vlp_tpu_torch.train.loop import Trainer

    cfg = apply_overrides(get_experiment("smoke_synthetic_only_imaging"),
                          FSDP_TRAINER + list(overrides))
    cfg.output_dir = str(ckpt_dir)
    fold = next(build_datamodule(cfg, CPU, mesh=mesh).folds())
    task = build_task(TrainConfig.from_config(cfg), fold.statics, CPU, mesh)
    return Trainer(cfg, task, fold.train_loader, fold.val_loaders,
                   checkpoint_dir=str(ckpt_dir)), fold


def _gathered(model) -> Dict[str, np.ndarray]:
    return {k: _np(v) for k, v in model.state_dict().items()}


def fsdp_trainer_worker(mesh, tmp: str) -> Dict:
    """Under ``mesh.param_sharding=fsdp``: the trainer straight for 2
    epochs against 1 epoch and a resumed one; the best checkpoint served
    by a one-process ``Predictor`` (rank 0) against the sharded model's
    eval forward; the k-fold driver; a replicated run's ``last`` resumed
    under fsdp against the replicated resume; the VLP driver (the linear
    probe's feature pass every epoch, the best checkpoint reloaded for the
    downstream precision@k) under fsdp and replicated, and a classifier
    under fsdp warm-started from the fsdp run's best: its gathered
    backbone when ``fit`` starts."""
    from vlp_tpu_torch.parallel.collectives import gather_rows
    from vlp_tpu_torch.parallel.fsdp import is_sharded
    from vlp_tpu_torch.parallel.mesh import shard_batch
    from vlp_tpu_torch.serve import Predictor
    from vlp_tpu_torch.train import driver
    from vlp_tpu_torch.utils.checkpoint import restore_raw

    fsdp = ["mesh.param_sharding=fsdp"]
    out: Dict = {}
    straight, fold = _fsdp_trainer(mesh, fsdp, f"{tmp}/a")
    straight.fit()
    first, _ = _fsdp_trainer(mesh, fsdp, f"{tmp}/b")
    first.fit(max_epochs=1)
    mesh.barrier()  # rank 0's last.pt is on disk
    resumed, _ = _fsdp_trainer(mesh, fsdp, f"{tmp}/c")
    resumed.load_resume_state(f"{tmp}/b/last.pt")
    start = resumed.start_epoch
    resumed.fit()
    mesh.barrier()
    from torch.distributed.tensor import DTensor
    out["resume"] = {
        "sharded": sum(isinstance(p, DTensor)
                       for p in straight.state.model.parameters()),
        "start_epoch": start,
        "history_straight": _timeless(straight.sink.history),
        "history_first": _timeless(first.sink.history),
        "history_resumed": _timeless(resumed.sink.history),
        "straight_state": _gathered(straight.state.model),
        "resumed_state": _gathered(resumed.state.model)}

    # the best checkpoint on one process against the sharded model
    best = straight.checkpointer.best_path
    assert is_sharded(straight.task.model)
    from vlp_tpu_torch.utils.checkpoint import load_model_state
    load_model_state(straight.task.model, restore_raw(best)["model"])
    rng = np.random.default_rng(9)
    b = 8
    images = rng.integers(0, 256, (b, 32, 32), dtype=np.uint8)
    full = {"image_u8": images, "label": np.zeros(b, np.int32),
            "dataset_id": np.zeros(b, np.int32),
            "mask": np.ones(b, np.float32)}
    local = {k: torch.from_numpy(v) for k, v in
             shard_batch(full, mesh).items()}
    sharded = gather_rows(straight.task.eval_fn(local)["logits"], mesh)
    if mesh.is_main:
        tree = restore_raw(best)
        pred = Predictor(straight.cfg, None, fold.statics.mean,
                         fold.statics.std, batch_size=b, device="cpu",
                         checkpoint=best)
        out["serve"] = {
            "format": "replicated" if isinstance(
                next(iter(tree["optimizer"]["state"])), int) else "other",
            "predictor": pred.predict_logits(images),
            "sharded": sharded.numpy().copy()}

    # the k-fold driver (2 folds of 1 epoch); rank 0 writes
    from vlp_tpu_torch.config import apply_overrides, get_experiment
    cfg = apply_overrides(get_experiment("smoke_synthetic_only_imaging"),
                          FSDP_TRAINER + fsdp + [
                              "k_fold_cross_validation=true",
                              "data.n_folds_downstream=2", "trainer.max_epochs=1"])
    cfg.output_dir = f"{tmp}/driver"
    out["driver"] = driver.train(cfg, "cpu", mesh)
    mesh.barrier()
    if mesh.is_main:
        out["driver_files"] = sorted(
            f for f in os.listdir(cfg.output_dir)
            if f.endswith(".json") and not f.startswith("metrics"))

    # a replicated run's last.pt resumed under fsdp and replicated: the
    # state each holds after the load (gathered) against the file's
    rep, _ = _fsdp_trainer(mesh, [], f"{tmp}/r")
    rep.fit(max_epochs=1)
    mesh.barrier()
    from vlp_tpu_torch.utils.checkpoint import state_to_tree
    saved = restore_raw(f"{tmp}/r/last.pt")
    cross = {}
    for name, over in (("replicated", []), ("fsdp", fsdp)):
        t, _ = _fsdp_trainer(mesh, over, f"{tmp}/r_{name}")
        t.load_resume_state(f"{tmp}/r/last.pt")
        tree = state_to_tree(t.state)
        if mesh.is_main:
            cross[f"loaded_{name}"] = _same_tree(tree, saved)
        t.fit()
        cross[f"history_{name}"] = _timeless(t.sink.history)
    out["cross"] = cross

    # the VLP driver under both, then the fsdp run's best as a warm start
    from vlp_tpu_torch.train.loop import Trainer
    from vlp_tpu_torch.utils.checkpoint import (extract_image_encoder,
                                                load_meta)
    vlp = {}
    for name, over in (("replicated", []), ("fsdp", fsdp)):
        cfg = apply_overrides(get_experiment("smoke_synthetic_pretrain"),
                              VLP_TRAINER + over)
        cfg.output_dir = f"{tmp}/vlp_{name}"
        vlp[name] = {k: v for k, v in driver.train(cfg, "cpu", mesh).items()
                     if not k.startswith("time/") and "per_sec" not in k}
    out["vlp"] = vlp
    mesh.barrier()
    best = load_meta(f"{tmp}/vlp_fsdp/checkpoints/fold0/last.pt")[
        "checkpoint_best_path"]
    cfg = apply_overrides(get_experiment("vlp_finetune_only_imaging_resnet34"),
                          WARM_TRAINER + fsdp + [
                              f"model.pretrained_ckpt={best}"])
    cfg.output_dir = f"{tmp}/warm"
    fit, seen = Trainer.fit, []

    def gathered_fit(self, *a, **k):
        seen.append((is_sharded(self.state.model),
                     _gathered(self.state.model)))  # every rank gathers
        return fit(self, *a, **k)

    Trainer.fit = gathered_fit
    try:
        driver.train(cfg, "cpu", mesh)
    finally:
        Trainer.fit = fit
    encoder = extract_image_encoder(restore_raw(best)["model"])
    (sharded_fit, state), = seen
    out["warm"] = {
        "sharded": sharded_fit,
        "encoder": {k: v.float().numpy() for k, v in encoder.items()},
        "backbone": {k[len("backbone."):]: v for k, v in state.items()
                     if k.startswith("backbone.")}}
    return out


def _same_tree(a, b) -> bool:
    """Two checkpoint trees equal: every tensor bit for bit, the rest
    by ``==``."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            _same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_tree, a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


def post_fit_worker(mesh, overrides: List[str], out_dir: str) -> Dict:
    """The driver's post-fit pass (``driver._post_fit_plots``) of the
    smoke classifier's fold 0 at its init weights (seed 0) on ``mesh``, or
    in one process when ``mesh`` is None, each rank writing under its own
    ``out_dir/rank<r>``: the silhouettes, the val rows and the figures
    under that directory."""
    from vlp_tpu_torch.config import (TrainConfig, apply_overrides,
                                      get_experiment)
    from vlp_tpu_torch.data.datamodule import build_datamodule
    from vlp_tpu_torch.models.tasks import build_task
    from vlp_tpu_torch.train import driver
    from vlp_tpu_torch.train.loop import Trainer

    rank = 0 if mesh is None else mesh.global_rank
    cfg = apply_overrides(get_experiment("smoke_synthetic_only_imaging"),
                          FSDP_TRAINER + list(overrides))
    cfg.output_dir = os.path.join(out_dir, f"rank{rank}")
    fold = next(build_datamodule(cfg, CPU, mesh=mesh).folds())
    torch.manual_seed(0)
    task = build_task(TrainConfig.from_config(cfg), fold.statics, CPU, mesh)
    trainer = Trainer(cfg, task, fold.train_loader, fold.val_loaders)
    scores = driver._post_fit_plots(cfg, trainer, fold,
                                    mesh is None or mesh.is_main)
    figures = sorted(os.path.relpath(os.path.join(d, f), cfg.output_dir)
                     for d, _, fs in os.walk(cfg.output_dir) for f in fs
                     if f.endswith(".png"))
    return {"scores": scores, "figures": figures,
            "rows": sum(len(ld.bundle) for ld in fold.val_loaders.values())}


def hf_text_tower_worker(mesh, overrides: List[str], small: Dict) -> Dict:
    """The VLP smoke model (TinyBERT at the widths ``small``) built as the
    trainer builds it on ``mesh`` (or one process where it is None), then
    the driver's text-tower import from the hub cache ``HF_HUB_CACHE``
    names; the full state (gathered to rank 0 where sharded: the other
    ranks get an empty dict)."""
    import dataclasses
    import types

    from vlp_tpu_torch.config import (TrainConfig, apply_overrides,
                                      get_experiment)
    from vlp_tpu_torch.models import bert
    from vlp_tpu_torch.parallel.fsdp import is_sharded
    from vlp_tpu_torch.train import driver
    from vlp_tpu_torch.train.setup import build_training
    from vlp_tpu_torch.utils.checkpoint import model_state

    full = bert.TEXT_CONFIGS["tinybert"]
    bert.TEXT_CONFIGS["tinybert"] = dataclasses.replace(full, **small)
    try:
        cfg = apply_overrides(get_experiment("smoke_synthetic_pretrain"),
                              list(overrides))
        _, state, _ = build_training(TrainConfig.from_config(cfg), CPU, 1,
                                     mesh=mesh)
        driver._maybe_load_pretrained_text_tower(
            cfg, types.SimpleNamespace(state=state))
        return {"sharded": is_sharded(state.model),
                "state": {k: _np(v)
                          for k, v in model_state(state.model).items()}}
    finally:
        bert.TEXT_CONFIGS["tinybert"] = full
