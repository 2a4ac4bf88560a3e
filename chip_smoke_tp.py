"""Phase 25 of ``chip_smoke.py``: tensor parallelism on the 2-D data x model
mesh (``mesh.model_parallel=M mesh.param_sharding=tp``,
``vlp_tpu_torch/parallel/tp.py``) on the card. ``chip_smoke.py`` runs
``phase_tp`` after phase 24; under the launcher it runs ``tp_rank``
(``chip_smoke.py --tp-rank <dir>``).

25a. #7/#8 (``attend_qkv`` and its backward) and #9/#10 (``fused_mlp`` and
     its backward, fc2's bias zero: a split MLP adds it after the sum) at a
     model rank's shapes, ViT-B/16 (N 32) and ViT-L/16 (N 64) at M = 2 and
     4: H / M heads of 64, F / M hidden columns, S 197. Each against its
     plain version in bf16 and fp32, one launch a call, timed (plain,
     kernel, kernel, plain) beside SDPA; whether ``fused_mlp.supports``
     lets the split MLP reach the kernel at the model's rows.
25b. W ranks on the (1, W) mesh: W = ``device_count`` over NCCL where
     there are two cards or more, else two ranks on the one card over gloo
     (``create_mesh`` takes it where a node's ranks outnumber its cards:
     NCCL refuses two ranks on one device; gloo runs every collective of
     the step on CUDA tensors), which the lines name. For
     ``pretrain_resnet34_tinybert`` (batch 128) and
     ``baseline_only_imaging_vit_base`` (batch 32): one step under tp
     against the replicated step (the W model ranks as replicas) from the
     same weights on the same global batch, augmentation off, at the
     base lr (``scheduler=none``, so that the parameters move): in fp32
     (TF32 off, cuDNN deterministic; ViT-B in flax's attention layout, as
     the attention kernels take bf16 alone) the loss within 23a's bound, the
     gathered gradients and AdamW's two moments (``tp.gather_optimizer_
     state``, as checkpoints gather them) within 3x the replicated step's
     own distance on the reversed batch (23a's rule), or 1e-5 where that is
     smaller (``BOUND_TP_FP32``); in bf16 (a split product sums bf16
     partial products) the tp step against the replicated fp32 step within
     2x the replicated bf16 step's own distance (phase 16's rule). In both,
     the parameters and their update (not 0) are printed beside their
     floors, and the replicated AdamW applied to the tp step's own gathered
     gradients gives its parameters and moments within 2 ulp (``_adamw_on``:
     AdamW on the shards against AdamW on the whole leaves). Then both
     bf16 steps with the experiment's augmentation in alternating turns:
     median step, the spans between the CUDA events around each model-axis
     collective summed a step (a rank's wait for its peers included), a
     rank's bytes of parameters and AdamW moments against
     the replicated run's, the port's expected share and the JAX
     placement's, launches a rank (#7/#8 on ViT-B's split blocks, #11/#12),
     and every whole leaf bit-equal on every rank after the turns.
25c. ``python -m vlp_tpu_torch.train`` under the launcher with
     ``mesh.model_parallel=W mesh.param_sharding=tp`` (on one card the
     run's log names gloo, as 25b's ranks do):
     ``baseline_only_imaging_resnet34`` on 320 synthetic images, 2 folds x
     2 epochs at a constant lr; each fold's best checkpoint (the
     replicated run's format) reloaded into a fresh one-process task
     evaluates its val loaders near the logged values
     (the split model's bf16 partial sums round in another order: the
     bounds of 21a's resume check), fold 0's best served by
     ``Predictor(checkpoint=...)``; fold 0 as 1 epoch and a launch resumed
     from its ``last.pt`` for the second against the k-fold run's fold 0.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import re
import statistics
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

import chip_smoke as cs
from vlp_tpu_torch.ops import block_attention as BA
from vlp_tpu_torch.ops import fused_block as FB
from vlp_tpu_torch.ops import fused_mlp as FM
from vlp_tpu_torch.parallel import collectives, tp
from vlp_tpu_torch.parallel.mesh import create_mesh, destroy_mesh, shard_batch
from vlp_tpu_torch.probes._timing import median_ms
from vlp_tpu_torch.train.setup import batch_for, build_training
from vlp_tpu_torch.train.step import to_device

# (label, N, S, D, heads, blocks) of the transformers whose split blocks
# 25a holds, and the model-axis sizes
TP_SHAPES = (("ViT-B", cs.VIT_BATCH, 197, 768, 12, 12),
             ("ViT-L", 64, 197, 1024, 16, 24))
TP_WORLDS = (2, 4)
# (experiment, global batch, the serving fields of its fp32 steps): the
# attention kernels take bf16 alone, so ViT-B's fp32 steps take flax's
# attention layout (SDPA; the same function and parameters)
TP_CASES = ((cs.PRETRAIN, cs.VLP_BATCH, {}),
            (cs.VIT_B, cs.VIT_BATCH, {"fused_attention": False}))
TP_TURNS = 3
TP_TURN_STEPS = 3
TP_TIMEOUT = 600
TP_TRAINER_SAMPLES = 320
# fp32 gradients and parameters under tp against the replicated step: the
# split reorders every split product's feature sums, which the reversed
# batch (the batch sums alone) does not, so the floor is also never below
# the CPU tests' fp32 bound for the tp step against the JAX one
BOUND_TP_FP32 = 1e-5
KERNELS_25A = ("attend_qkv", "attend_qkv_bwd", "fused_mlp", "fused_mlp_bwd")


def _tp_kernels() -> dict:
    """25a. Returns {kernel: {"<model> M=<m>": stat}}, each stat per
    training step of that model's split blocks."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    out = {name: {} for name in KERNELS_25A}

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    for label, n, s, d, heads, blocks in TP_SHAPES:
        for m in TP_WORLDS:
            dl, hl, fl, rows = d // m, heads // m, 4 * d // m, n * s
            key = f"{label} M={m}"
            st = {name: cs._stat() for name in KERNELS_25A}
            where = f"{key} N={n} S={s} D/M={dl} H/M={hl}"
            qkv = (rand(n, s, 3 * dl) * 1.5).bfloat16()
            do = rand(n, s, dl).bfloat16()
            cs._reset_counts()
            o = BA.attend_qkv(qkv, hl)
            dqkv = BA.attend_qkv_bwd(qkv, do, hl)
            torch.cuda.synchronize()
            launches = {k: v for k, v in cs._counts().items() if v}
            cs.check(launches == {"attend_qkv": 1, "attend_qkv_bwd": 1},
                     f"25a {where}: launches {launches}")
            cs._check_outputs("attend_qkv", where, (o,),
                              (BA.attend_qkv_plain(qkv, hl),),
                              (BA.attend_qkv_plain(qkv.float(), hl),),
                              ("o",), cs.BOUND_VS_PLAIN_BF16,
                              cs.BOUND_VS_PLAIN_FP32, st["attend_qkv"])
            cs._check_outputs(
                "attend_qkv_bwd", where, cs._dqkv_parts(dqkv, dl),
                cs._dqkv_parts(BA.attend_qkv_bwd_plain(qkv, do, hl), dl),
                cs._dqkv_parts(BA.attend_qkv_bwd_plain(
                    qkv.float(), do.float(), hl), dl),
                ("dq", "dk", "dv"), cs.BOUND_BWD_BF16, cs.BOUND_BWD_FP32,
                st["attend_qkv_bwd"])
            del o, dqkv
            ql, kl, vl = qkv.detach().requires_grad_().view(
                n, s, 3, hl, 64).permute(2, 0, 3, 1, 4)
            dol = do.view(n, s, hl, 64).transpose(1, 2)
            with torch.no_grad():
                lib_f = median_ms(lambda: F.scaled_dot_product_attention(
                    ql, kl, vl))
            ol = F.scaled_dot_product_attention(ql, kl, vl)
            lib_b = median_ms(lambda: torch.autograd.grad(
                ol, (ql, kl, vl), dol, retain_graph=True))
            del ql, kl, vl, ol
            for name, kern, plain, lib in (
                    ("attend_qkv", lambda: BA.attend_qkv(qkv, hl),
                     lambda: BA.attend_qkv_plain(qkv, hl), lib_f),
                    ("attend_qkv_bwd",
                     lambda: BA.attend_qkv_bwd(qkv, do, hl),
                     lambda: BA.attend_qkv_bwd_plain(qkv, do, hl), lib_b)):
                k_ms, p_ms = cs._timed_pair(plain, kern)
                print(f"time {name} {where}: kernel {k_ms:.4f} ms, plain "
                      f"{p_ms:.4f} ms, SDPA {lib:.4f} ms per call")
                cs._add(st[name], blocks, k_ms, p_ms,
                        cs._work(name, n, s, dl), lib)
            del qkv, do
            # the split MLP: x [rows, D] whole, this rank's F / M columns
            where = f"{key} M={rows} D={d} F/M={fl}"
            x, dy = rand(rows, d).bfloat16(), rand(rows, d).bfloat16()
            (b1, b2), (w1, w2) = FB._cast(
                torch.bfloat16, vectors=(rand(fl, scale=0.02),
                                         torch.zeros(d, device="cuda")),
                matrices=(rand(d, fl, scale=d ** -0.5),
                          rand(fl, d, scale=(4 * d) ** -0.5)))
            f32 = (w1.float(), b1, w2.float(), b2)
            cs._reset_counts()
            y = FM.fused_mlp(x, w1, b1, w2, b2)
            grads = FM.fused_mlp_bwd(x, w1, b1, w2, dy)
            torch.cuda.synchronize()
            launches = {k: v for k, v in cs._counts().items() if v}
            cs.check(launches == {"fused_mlp": 1, "fused_mlp_bwd": 1},
                     f"25a {where}: launches {launches}")
            cs._check_outputs("fused_mlp", where, (y,),
                              (FM.fused_mlp_plain(x, w1, b1, w2, b2),),
                              (FM.fused_mlp_plain(x.float(), *f32),), ("y",),
                              cs.BOUND_VS_PLAIN_BF16, cs.BOUND_VS_PLAIN_FP32,
                              st["fused_mlp"])
            cs._check_outputs(
                "fused_mlp_bwd", where, grads,
                FM.fused_mlp_bwd_plain(x, w1, b1, w2, dy),
                FM.fused_mlp_bwd_plain(x.float(), f32[0], b1, f32[2],
                                       dy.float()),
                ("dx", "dw1", "db1", "dw2", "db2"), cs.BOUND_BWD_BF16,
                cs.BOUND_BWD_FP32, st["fused_mlp_bwd"])
            del y, grads
            for name, kern, plain in (
                    ("fused_mlp", lambda: FM.fused_mlp(x, w1, b1, w2, b2),
                     lambda: FM.fused_mlp_plain(x, w1, b1, w2, b2)),
                    ("fused_mlp_bwd",
                     lambda: FM.fused_mlp_bwd(x, w1, b1, w2, dy),
                     lambda: FM.fused_mlp_bwd_plain(x, w1, b1, w2, dy))):
                k_ms, p_ms = cs._timed_pair(plain, kern)
                print(f"time {name} {where}: kernel {k_ms:.4f} ms, plain "
                      f"{p_ms:.4f} ms per call")
                cs._add(st[name], blocks, k_ms, p_ms,
                        cs._work(name, rows, 1, d, fl))
            supported = FM.supports(rows, d, fl)
            print(f"tp 25a {key}: fused_mlp.supports({rows}, {d}, {fl}) is "
                  f"{supported}: the split MLP "
                  + ("launches #9/#10" if supported else
                     "takes the reference's unfused route (Dense, GELU, "
                     "Dense) at these rows, as the whole MLP does"))
            del x, dy, w1, w2
            torch.cuda.empty_cache()
            for name in KERNELS_25A:
                out[name][key] = {k: v for k, v in cs._finish(
                    st[name]).items() if k not in ("flops", "bytes")}
                out[name][key]["supports"] = supported \
                    if name.startswith("fused_mlp") else True
    return out


# --------------------------------------------------------------------------
# 25b: the rank program
# --------------------------------------------------------------------------

def _named(model, tensors: dict) -> dict:
    """``tensors`` (by parameter name) whole, detached, in fp32 and
    copied: a split model's gathered over the model ranks (a collective:
    every rank calls it)."""
    if tp.is_split(model):
        tensors = tp.gather_state(model, tensors)
    return {k: v.detach().float().clone() for k, v in tensors.items()}


def _flat(named: dict) -> torch.Tensor:
    return torch.cat([named[k].reshape(-1) for k in sorted(named)])


def _moments(model, optimizer) -> dict:
    """AdamW's two moments in the replicated run's format (a split model's
    gathered by ``tp.gather_optimizer_state``, as its checkpoints are),
    each flat in fp32 in the optimizer's numbering."""
    state = tp.gather_optimizer_state(model, optimizer) \
        if tp.is_split(model) else optimizer.state_dict()
    return {q: torch.cat([st[q].float().reshape(-1) for _, st in sorted(
        state["state"].items())]) for q in ("exp_avg", "exp_avg_sq")}


def _one_step(mesh, tcfg, mode: str, batch) -> dict:
    """One step of ``tcfg`` under ``mode`` (``param_sharding``) on
    ``batch`` from the seeded weights: the loss; whole, flat and in fp32
    the parameters before and after it, the gradients and AdamW's two
    moments; the whole gradients by name, and the names of the parameters
    without one."""
    cuda = mesh.device
    task, state, step = build_training(
        dataclasses.replace(tcfg, param_sharding=mode), cuda,
        cs.STEPS_PER_EPOCH, mesh=mesh)
    model = task.model
    params = dict(model.named_parameters())
    before = _flat(_named(model, params))
    loss = float(step(state, to_device(shard_batch(batch, mesh), cuda))[
        "loss"])
    grads = _named(model, {k: torch.zeros_like(p) if p.grad is None
                           else p.grad for k, p in params.items()})
    out = {"loss": loss, "before": before,
           "param": _flat(_named(model, params)), "grads": grads,
           "grad": _flat(grads),
           "no_grad": {k for k, p in params.items() if p.grad is None},
           **_moments(model, state.optimizer)}
    out["update"] = out["param"] - before
    del task, state, step, model, params
    torch.cuda.empty_cache()
    return out


def _adamw_on(mesh, tcfg, got: dict) -> dict:
    """The replicated run's optimizer step on ``got``'s whole gradients
    (an elementwise function of them) against ``got``'s parameters and
    moments after its own step: AdamW on a rank's shards against AdamW on
    the whole leaves, apart from the gradients' rounding. Returns the
    largest ratio of |got - replicated| to 2 ulp of the replicated value,
    and the largest |got - replicated|, over the parameters and both
    moments."""
    task, state, _ = build_training(
        dataclasses.replace(tcfg, param_sharding="replicated"), mesh.device,
        cs.STEPS_PER_EPOCH, mesh=mesh)
    params = dict(task.model.named_parameters())
    for k, p in params.items():
        p.grad = None if k in got["no_grad"] \
            else got["grads"][k].to(p.dtype).clone()
    state.optimizer.step()
    want = {"param": _flat(_named(task.model, params)),
            **_moments(task.model, state.optimizer)}
    ulps = diff = 0.0
    for q, w in want.items():
        d = (got[q] - w).abs()
        ulps = max(ulps, float((d / (2 * 2.0 ** -23 * w.abs()
                                     + 1e-38)).max()))
        diff = max(diff, float(d.max()))
    del task, state, params
    torch.cuda.empty_cache()
    return {"adamw_ulps": ulps, "adamw_diff": diff}


# what 25b holds after one step, each as the relative L2 distance of the
# whole flat vectors against its floor; the parameters and their update
# are printed beside theirs (AdamW's first update, lr g / (|g| + eps),
# turns a rounding of a gradient near 0 into a change of its sign), and
# ``_adamw_on`` holds the update on the step's own gradients instead
HELD = ("grad", "exp_avg", "exp_avg_sq")
SHOWN = ("param", "update")


def _check_steps(mesh, plain, batch, fp32_fields) -> dict:
    """One step under tp against the replicated step on the same global
    batch (``plain``: augmentation off), at the experiment's base lr
    (``scheduler=none``: a warmup's lr is 0 at step 0, so that no
    parameter would move): the gradients and AdamW's moments against a
    floor, the parameters and their update beside it, and the update
    against the replicated optimizer's on the tp step's own gradients
    (``_adamw_on``). fp32 (cuDNN deterministic): the floor is the
    replicated step's own distance on the reversed batch. bf16: a split
    product sums bf16 partial products, which round otherwise than the
    whole one, so both bf16 steps are held against the replicated fp32
    step, the tp step within ``BOUND_GRAD_BF16_VS_CPU`` times the
    replicated bf16 step's own distance (phase 16's rule)."""
    plain = dataclasses.replace(plain, scheduler="none")
    fp32 = cs._with(plain, precision="fp32", **fp32_fields)
    torch.backends.cudnn.deterministic = True
    r32, v32, t32 = (_one_step(mesh, fp32, mode, b) for mode, b in (
        ("replicated", batch), ("replicated", cs._reversed(batch)),
        ("tp", batch)))
    torch.backends.cudnn.deterministic = False
    r16, t16 = (_one_step(mesh, plain, mode, batch)
                for mode in ("replicated", "tp"))

    def gaps(got, floor, cfg):
        return {**{q: cs._rel(got[q], r32[q]) for q in HELD + SHOWN},
                **{f"floor_{q}": cs._rel(floor[q], r32[q])
                   for q in HELD + SHOWN},
                "moved": float(got["update"].norm() / got["before"].norm()),
                **_adamw_on(mesh, cfg, got)}

    return {"fp32": {"loss": t32["loss"], "replicated_loss": r32["loss"],
                     **gaps(t32, v32, fp32)},
            "bf16": {"loss": t16["loss"], "replicated_loss": r16["loss"],
                     "fp32_loss": r32["loss"], **gaps(t16, r16, plain)}}


def _whole_spread(model) -> float:
    """The largest difference of any rank's whole (unsplit) parameters
    from global rank 0's."""
    splits = getattr(model, "tp_splits", {})
    flat = torch.cat([p.detach().float().reshape(-1)
                      for k, p in model.named_parameters()
                      if k not in splits])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    spread = (flat - ref).abs().max().reshape(1)
    dist.all_reduce(spread, op=dist.ReduceOp.MAX)
    return float(spread)


def _shares(model, mesh) -> tuple:
    """(bytes a rank holds of the parameters and AdamW moments by the
    port's splits, by the JAX placement), 12 bytes an fp32 element."""
    splits, m = model.tp_splits, mesh.model_world
    params = dict(model.named_parameters())
    port = jax = 0
    for k, shape in tp.full_shapes(model).items():
        if k not in params:
            continue
        n = math.prod(shape)
        port += n // m if k in splits else n
        flax = tp.conv_flax_shape(shape) \
            if len(shape) == 4 and k.endswith("weight") else shape
        jax += n // m if tp.jax_shards(flax, mesh) else n
    return 12 * port, 12 * jax


def _tp_case(mesh, key: str, batch_size: int, fp32_fields) -> dict:
    """25b on this rank for experiment ``key``: the one-step checks, then
    the bf16 steps of both modes in alternating turns."""
    cuda = mesh.device
    tcfg = cs.TRAIN_EXPERIMENTS[key]
    rng = np.random.default_rng(25)
    batches = [batch_for(tcfg, rng, batch_size)
               for _ in range(TP_TURN_STEPS)]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = _check_steps(mesh, dataclasses.replace(
        tcfg, disable_augmentations=True), batches[0], fp32_fields)
    local = [to_device(shard_batch(b, mesh), cuda) for b in batches]
    runs = {mode: build_training(dataclasses.replace(
        tcfg, param_sharding=mode), cuda, cs.STEPS_PER_EPOCH, mesh=mesh)
        for mode in ("replicated", "tp")}
    times = {m: [] for m in runs}
    axis = {m: [] for m in runs}
    calls = {m: 0 for m in runs}
    launches = {m: {} for m in runs}
    for _ in range(TP_TURNS):
        for mode, (_, state, step) in runs.items():
            mesh.barrier()
            torch.cuda.synchronize()
            cs._reset_counts()
            for b in local:
                collectives.model_axis_events = events = []
                t0 = time.perf_counter()
                step(state, b)
                torch.cuda.synchronize()
                times[mode].append(time.perf_counter() - t0)
                collectives.model_axis_events = None
                axis[mode].append(sum(a.elapsed_time(e) for a, e in events))
                calls[mode] = len(events)
            for k, v in cs._counts().items():
                if v:
                    launches[mode][k] = launches[mode].get(k, 0) + v
    task = runs["tp"][0]
    res["share"] = _shares(task.model, mesh)
    res["report"] = {k: len(v) for k, v in tp.report(task.model).items()}
    res["turns"] = {mode: {
        "ms": statistics.median(times[mode]) * 1e3,
        "model_axis_ms": statistics.median(axis[mode]),
        "model_axis_calls": calls[mode],
        "state_bytes": cs._state_bytes(t.model, state.optimizer),
        "spread": _whole_spread(t.model),
        "launches": launches[mode],
        "steps": TP_TURNS * TP_TURN_STEPS}
        for mode, (t, state, _) in runs.items()}
    return res


def tp_rank(out: Path) -> int:
    """25b's rank program (under the launcher's environment): every rank
    on the model axis of the (1, W) mesh; its results as
    ``rank<global rank>.json`` in ``out``."""
    logging.getLogger("vlp_tpu_torch").setLevel(logging.WARNING)
    world = int(os.environ["WORLD_SIZE"])
    mesh = create_mesh(None, "cuda", model_parallel=world)
    try:
        res = {key: _tp_case(mesh, key, b, f) for key, b, f in TP_CASES}
        res["backend"] = dist.get_backend()
        res["devices"] = [str(mesh.device), torch.cuda.get_device_name(
            mesh.device)]
        (out / f"rank{mesh.global_rank}.json").write_text(json.dumps(res))
    finally:
        destroy_mesh(mesh)
    return 0


def _tp_steps(smi: str, world: int, out: Path) -> tuple:
    """25b: one launch of the rank program; every rank's results checked
    here. Returns (the launches a rank of each tp path, the process
    group's backend)."""
    out.mkdir(parents=True)
    _, seconds = cs._launch([str(Path(cs.__file__).resolve()), "--tp-rank",
                             str(out)], world, TP_TIMEOUT, "25b")
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(world)]
    paths = _check_ranks(smi, world, ranks)
    print(f"tp 25b: launch {seconds:.1f} s")
    return paths, ranks[0]["backend"]


def _gaps(c: dict) -> str:
    return ", ".join(f"{q} {c[q]:.3g} ({c[f'floor_{q}']:.3g})"
                     for q in HELD + SHOWN)


def _adamw(c: dict) -> str:
    return (f"the replicated AdamW on the tp step's gathered gradients "
            f"against its parameters and moments: largest difference "
            f"{c['adamw_diff']:.3g}, {c['adamw_ulps']:.3g} of 2 ulp (bound "
            f"1)")


def _check_ranks(smi: str, world: int, ranks: list) -> dict:
    """25b's checks and lines over every rank's results."""
    paths = {}
    backend = ranks[0]["backend"]
    for key, batch, fp32_fields in TP_CASES:
        r0 = ranks[0][key]
        fp32 = cs._label("fp32", fp32_fields)
        c = r0["fp32"]
        rel = abs(c["loss"] - c["replicated_loss"]) / abs(
            c["replicated_loss"])
        print(f"tp 25b {key} {fp32} (D, M) = (1, {world}) over {backend}: "
              f"loss {c['loss']:.6f} vs replicated "
              f"{c['replicated_loss']:.6f} (relative {rel:.3g}, bound "
              f"{cs.BOUND_DP_LOSS}); after one AdamW step at the base lr "
              f"(the update {c['moved']:.3g} of the parameters' norm), "
              f"relative L2 from the replicated step: {_gaps(c)}; in "
              f"parentheses the replicated step's own on the reversed batch "
              f"(bound {cs.BOUND_DP_FLOOR:g}x that, at least "
              f"{BOUND_TP_FP32:g}, on {', '.join(HELD)}); {_adamw(c)}")
        cs.check(rel <= cs.BOUND_DP_LOSS, f"25b {key} fp32: loss {rel:.3g}")
        cs.check(c["moved"] > 0, f"25b {key} fp32: no parameter moved")
        cs.check(all(c[q] <= max(cs.BOUND_DP_FLOOR * c[f"floor_{q}"],
                                 BOUND_TP_FP32) for q in HELD),
                 f"25b {key} fp32: {c}")
        cs.check(c["adamw_ulps"] <= 1, f"25b {key} fp32: AdamW on the "
                 f"shards against the replicated AdamW: {c}")
        c = r0["bf16"]
        gap, own = (abs(x - c["fp32_loss"]) / abs(c["fp32_loss"])
                    for x in (c["loss"], c["replicated_loss"]))
        k = cs.BOUND_GRAD_BF16_VS_CPU
        print(f"tp 25b {key} bf16 (D, M) = (1, {world}) over {backend}, "
              f"against the replicated {fp32} step: loss relative {gap:.3g} "
              f"(the replicated bf16 step's own {own:.3g}; bound {k:g}x "
              f"that + {cs.BOUND_DP_LOSS}); after one AdamW step at the "
              f"base lr (the update {c['moved']:.3g} of the parameters' "
              f"norm), relative L2: {_gaps(c)}; in parentheses the "
              f"replicated bf16 step's own (bound {k:g}x that, on "
              f"{', '.join(HELD)}); {_adamw(c)}")
        cs.check(gap <= k * own + cs.BOUND_DP_LOSS, f"25b {key} bf16: loss "
                 f"{gap:.3g} against {own:.3g}")
        cs.check(c["moved"] > 0, f"25b {key} bf16: no parameter moved")
        cs.check(all(c[q] <= k * c[f"floor_{q}"] + 1e-7 for q in HELD),
                 f"25b {key} bf16: {c}")
        cs.check(c["adamw_ulps"] <= 1, f"25b {key} bf16: AdamW on the "
                 f"shards against the replicated AdamW: {c}")
        for prec in ("fp32", "bf16"):
            cs.check(all(rk[key][prec]["loss"] == r0[prec]["loss"]
                         for rk in ranks), f"25b {key} {prec}: the ranks' "
                     "losses differ")
        turns = r0["turns"]
        steps = turns["tp"]["steps"]
        want = {"shear_rows": 3 * steps, "add_gaussian_noise": steps}
        if key == cs.VIT_B:
            want.update(attend_qkv=12 * steps, attend_qkv_bwd=12 * steps)
        for rk in ranks:
            for mode in ("replicated", "tp"):
                t = rk[key]["turns"][mode]
                cs.check(t["launches"] == want, f"25b {key} {mode}: "
                         f"launches a rank {t['launches']}, expected {want}")
                cs.check(t["spread"] == 0.0, f"25b {key} {mode}: whole "
                         f"leaves differ across ranks by {t['spread']}")
        tp_t, rep = turns["tp"], turns["replicated"]
        port, jax = r0["share"]
        cs.check(rep["model_axis_calls"] == 0 and tp_t["model_axis_calls"]
                 > 0, f"25b {key}: model-axis collectives {tp_t}, {rep}")
        cs.check(tp_t["state_bytes"] == port, f"25b {key}: a rank holds "
                 f"{tp_t['state_bytes']} bytes, the splits give {port}")
        print(f"tp 25b {key} bf16 (D, M) = (1, {world}) over {backend}, "
              f"global batch {batch}, {TP_TURNS} alternating turns of "
              f"{TP_TURN_STEPS} steps: median step tp {tp_t['ms']:.3f} ms, "
              f"replicated {rep['ms']:.3f} ms ({tp_t['ms'] / rep['ms']:.3f}x)"
              f"; model-axis collectives {tp_t['model_axis_calls']} a step, "
              f"{tp_t['model_axis_ms']:.3f} ms a step between their events "
              f"(median); a rank's parameters + AdamW moments tp "
              f"{tp_t['state_bytes'] / 2 ** 20:.1f} MiB, replicated "
              f"{rep['state_bytes'] / 2 ** 20:.1f} MiB "
              f"({tp_t['state_bytes'] / rep['state_bytes']:.3f}x; the JAX "
              f"placement's {jax / rep['state_bytes']:.3f}x); leaves "
              f"{r0['report']}; launches a rank {want} over {steps} steps; "
              f"whole leaves bit-equal on every rank; ranks on "
              f"{sorted({tuple(rk['devices']) for rk in ranks})}; on {smi}")
        paths[f"tp_{'vit_b' if key == cs.VIT_B else 'vlp_resnet34_tinybert'}"
              "_train"] = tp_t["launches"]
    return paths


# --------------------------------------------------------------------------
# 25c: the training entry point under tp
# --------------------------------------------------------------------------

def _reload_near_log(cfg, out: Path) -> float:
    """Each fold's best checkpoint reloaded into a fresh one-process task:
    its val loaders' loss within ``BOUND_RESUME_LOSS`` and accuracy within
    ``BOUND_RESUME_ACC`` of the values the split run logged at its best
    epoch. Returns the largest relative loss gap."""
    cuda = torch.device("cuda")
    tcfg = cs.TrainConfig.from_config(cfg)
    prefix = "val/combined/accuracy_best_val/combined/"
    gaps, pairs = [], []
    for fold in cs.build_datamodule(cfg, cuda).folds():
        meta = cs.ckpt.load_meta(str(out / "checkpoints"
                                     / f"fold{fold.index}" / "last.pt"))
        tr = cs.Trainer(cfg, cs.build_task(tcfg, fold.statics, cuda),
                        fold.train_loader, fold.val_loaders)
        tr.state.model.load_state_dict(
            cs.ckpt.restore_raw(meta["checkpoint_best_path"])["model"])
        got = tr._validate_classifier()
        logged = cs._fold_summary(out, fold.index)
        gap = abs(got["val/combined/loss"] - logged[f"{prefix}loss"]) / abs(
            logged[f"{prefix}loss"])
        acc = abs(got["val/combined/accuracy"] - logged[f"{prefix}accuracy"])
        gaps.append(gap)
        pairs.append((got["val/combined/loss"], logged[f"{prefix}loss"]))
        cs.check(gap <= cs.BOUND_RESUME_LOSS and acc <= cs.BOUND_RESUME_ACC,
                 f"25c fold {fold.index}: reloaded loss gap {gap:.3g}, "
                 f"accuracy gap {acc:.3g}")
        del tr
    return max(gaps), pairs


def _tp_trainer(smi: str, world: int, backend: str, root: Path) -> None:
    """25c."""
    common = ["-m", "vlp_tpu_torch.train", "--device", "cuda",
              f"experiment={cs.RESNET34}", "data.name=synthetic_downstream",
              f"data.synthetic_num_samples={TP_TRAINER_SAMPLES}",
              "data.n_folds_downstream=2", "scheduler.name=none",
              f"mesh.model_parallel={world}", "mesh.param_sharding=tp"]
    a, b, c = (root / f"tp_trainer_{x}" for x in "abc")
    proc, seconds = cs._launch(common + [
        "k_fold_cross_validation=true", "trainer.max_epochs=2",
        f"output_dir={a}"], world, TP_TIMEOUT, "25c")
    shared = "the process group takes gloo" in proc.stdout + proc.stderr
    cs.check(shared == (backend == "gloo"), f"25c: the run's choice of "
             f"gloo (logged: {shared}) against 25b's {backend}")
    split = re.findall(r"tensor parallelism: (\d+) state entries split",
                       proc.stdout + proc.stderr)
    cs.check(len(split) == 2 and int(split[0]) > 0, f"25c: the run's split "
             f"lines {split}, expected one a fold")
    cs.check(sorted(p.name for p in a.glob("fold*.done.json"))
             == ["fold0.done.json", "fold1.done.json"]
             and (a / "cv_summary.json").is_file(), "25c: the k-fold run's "
             "markers and summary")
    cfg = cs.apply_overrides(cs.get_experiment(cs.RESNET34), [
        o for o in common if "=" in o and not o.startswith("mesh.")]
        + ["k_fold_cross_validation=true", f"output_dir={a}"])
    gap, pairs = _reload_near_log(cfg, a)
    best = cs.ckpt.load_meta(str(a / "checkpoints" / "fold0" / "last.pt"))[
        "checkpoint_best_path"]
    tree = cs.ckpt.restore_raw(best)
    cs.check(all(isinstance(k, int) for k in tree["optimizer"]["state"]),
             "25c: the tp checkpoint's optimizer state is not in the "
             "replicated format")
    pred = cs.Predictor(cs.EXPERIMENTS[cs.RESNET34], None, mean=128.0,
                        std=64.0, batch_size=cs.BATCH, device="cuda",
                        checkpoint=best)
    images = np.random.default_rng(8).integers(
        0, 256, (cs.BATCH, 224, 224), dtype=np.uint8)
    probs = pred.predict_arrays(images)
    cs.check(probs.shape == (cs.BATCH,) and bool(np.all(np.isfinite(probs)))
             and bool(np.all((probs >= 0) & (probs <= 1))),
             "25c: Predictor's probabilities")
    del pred
    # fold 0: 1 epoch, then a launch resumed from its last.pt
    one = common + ["k_fold_cross_validation=false"]
    cs._launch(one + ["trainer.max_epochs=1", f"output_dir={b}"], world,
               TP_TIMEOUT, "25c first epoch")
    _, resume_s = cs._launch(one + [
        "trainer.max_epochs=2", f"output_dir={c}",
        f"ckpt_path={b / 'checkpoints' / 'fold0' / 'last.pt'}"], world,
        TP_TIMEOUT, "25c resume")
    got, want = cs._records(c, 0)[-1], cs._records(a, 0)[-1]
    cs.check(got["epoch"] == want["epoch"] == 1, f"25c resume: epochs "
             f"{got['epoch']}, {want['epoch']}")
    gaps = {}
    for k in ("train/loss", "val/combined/loss", "val/combined/accuracy"):
        gaps[k] = abs(got[k] - want[k]) / abs(want[k]) \
            if k.endswith("loss") else abs(got[k] - want[k])
        cs.check(gaps[k] <= (cs.BOUND_RESUME_LOSS if k.endswith("loss")
                             else cs.BOUND_RESUME_ACC),
                 f"25c resume {k}: {got[k]} vs the straight run's {want[k]}")
    print(f"tp 25c {cs.RESNET34} python -m vlp_tpu_torch.train "
          f"mesh.model_parallel={world} mesh.param_sharding=tp over "
          f"{backend}: 2 folds x 2 epochs on {TP_TRAINER_SAMPLES} images in "
          f"{seconds:.1f} s (launch included); the 2 best checkpoints (the "
          f"replicated run's format) reloaded into one-process tasks "
          f"evaluate their val loaders to the logged loss within "
          f"{gap:.3g} (bound {cs.BOUND_RESUME_LOSS}; reloaded, logged: "
          f"{pairs}); {split[0]} state entries split; fold 0's best "
          f"({os.path.basename(best)}) serves {cs.BATCH} images through "
          f"Predictor(checkpoint=...), probabilities in [0, 1]; fold 0 as 1 "
          f"epoch + a resumed launch ({resume_s:.1f} s) against the k-fold "
          f"run's fold 0 at epoch 1: gaps "
          f"{ {k: round(v, 5) for k, v in gaps.items()} }; on {smi}")


def phase_tp(smi: str, root: Path) -> tuple:
    """Phase 25. Returns ({kernel: {"<model> M=<m>": stat}} of 25a, the tp
    paths' launches a rank)."""
    t0 = time.perf_counter()
    stats = _tp_kernels()
    cards = torch.cuda.device_count()
    world = max(cards, 2)
    if cards == 1:
        print("tp: one card, so the M = 2 model ranks share it over gloo, "
              "which parallel.mesh.create_mesh takes where a node's ranks "
              "outnumber its cards (NCCL refuses two ranks on one device; "
              "gloo runs every collective of the step on CUDA tensors, "
              "staged through the host): the split, its collectives and "
              "the kernels at a rank's shapes run; the time of a split "
              "across cards does not show")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    paths, backend = _tp_steps(smi, world, root / "tp_steps")
    _tp_trainer(smi, world, backend, root)
    print(f"phase 25: {time.perf_counter() - t0:.1f} s")
    return stats, paths
