"""Phase 26 of ``chip_smoke.py``: GPipe pipeline parallelism
(``vlp_tpu_torch/parallel/pipeline.py``) and sequence parallelism
(``parallel/sequence.py``) through full-width ViT encoder stacks, the sweep
entry point, ``setup_check`` and the FLOP counter on the card.
``chip_smoke.py`` runs ``phase_pp`` after phase 25; under the launcher it
runs ``pp_rank`` (``chip_smoke.py --pp-rank <dir>``), once for each
n in ``WORLDS``: n ranks over NCCL where there are n cards, else n ranks on
the one card over gloo (``create_mesh``'s rule), whose stage hops go
through host copies (gloo takes no point-to-point operation on a CUDA
tensor) while its collectives take the CUDA tensors; the lines name the
route.

First #7 and #8 alone, on the card, at the shapes 26a's and 26b's fused
paths give them (a stage's microbatch [8, 197, 3072], 16 heads; the
gathered qkv [16, 196, 2304], 12 heads), held against their plain versions
with phase 7's bounds: the bf16 bound of 26a and 26b below is relative to
a sequential run that launches the same kernels on the same shapes.

26a. 12 of ViT-L/16's 24 encoder blocks (D 1024, 16 heads of 64, S 197;
     the depth cut to keep the script within its time limit) on the
     (1, n) pipeline mesh, each block's weights made on the card from its
     own seed, a stage rank building only its own; M = 4 and 8
     microbatches of 8 images. The fused layout in bf16 runs #7/#8 in
     every block of every microbatch. Held against the same 12 blocks in
     sequence on global rank 0 from the same weights: in fp32 (flax's
     layout, TF32 off; M = 4) the output and each gradient tensor of the
     linear functional sum(y * w) within ``BOUND_FP32`` of its largest
     value; in bf16 the output's and the whole gradient's relative L2
     from the fp32 sequential run within ``BOUND_FLOOR`` x the sequential
     bf16 run's own (phase 16's rule). Then the bf16 pipeline step and the
     sequential step in alternating turns: the step's median, the measured
     idle share of a rank (1 - its stage_fn's CUDA-event spans / the step)
     against the schedule's bubble (n - 1) / (M + n - 1), the hop's event
     spans a step, a rank's parameter bytes against 1 / n of the stack's,
     and #7/#8 launches a rank a step (``12 / n * M`` each).
26b. ViT-B/16's 12 blocks (D 768, 12 heads) on the (1, n) sequence mesh,
     each rank holding every block and T / n tokens of each row: the
     fused layout at T 196 (#7 takes S <= 256) and flax's at T 196 and 784
     (a 448-pixel image's patches). Held against the 12 blocks in sequence
     on rank 0 as 26a (fp32 at T 196 in flax's layout; bf16 in each case);
     then in turns: the step, the all-gathers and reduce-scatters a block
     and their event spans, a rank's peak activation memory against the
     sequential run's, and the launches of #7/#8 (and #9/#10 where
     ``fused_mlp.supports`` holds at a rank's rows).
26c. ``python -m vlp_tpu_torch.train.sweep``'s ``main`` on a bayes sweep
     this phase writes (``synthetic_downstream``, ResNet34, one fold of one
     epoch, 6 trials: the sixth is the forest's), on the card: every
     trial's value in ``sweep_results.jsonl`` and the best in
     ``sweep_best.json``; ``setup_check --device cuda`` exits 0; and
     ``analytic_flops`` of ``bench.py``'s VLP step (ResNet34 + TinyBERT at
     batch 128, 224 pixels, 40 tokens) a image, for the benchmark to read.
"""
from __future__ import annotations

import json
import logging
import os
import statistics
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import chip_smoke as cs
from vlp_tpu_torch.models.vit import EncoderBlock, flax_init_
from vlp_tpu_torch.ops import fused_mlp as FM
from vlp_tpu_torch.parallel import collectives
from vlp_tpu_torch.parallel.mesh import create_pipeline_mesh, create_seq_mesh
from vlp_tpu_torch.parallel.pipeline import (make_pipeline_fn,
                                             scan_blocks_stage_fn,
                                             stage_blocks)
from vlp_tpu_torch.parallel.sequence import (make_seq_parallel_fn,
                                             reduce_seq_gradients)

WORLDS = (2, 4)
# (depth, width, heads, tokens) of the stacks
VIT_L = (12, 1024, 16, 197)  # ViT-L/16's width; its depth 24 cut to 12
VIT_B = (12, 768, 12)
MICROBATCHES = (4, 8)
MICROBATCH = 8
# (layout, tokens, rows) of 26b's cases
SP_CASES = (("fused", 196, 16), ("flax", 196, 16), ("flax", 784, 4))
BOUND_FP32 = 1e-5
BOUND_FLOOR = 2.0
TURNS = 3
RANK_TIMEOUT = 900
SEED = 26
SWEEP_TRIALS = 6
SWEEP_SAMPLES = 160
FLOPS_BATCH = 128
ATTN = ("attend_qkv", "attend_qkv_bwd")
# (where, N, S, D, heads) of #7/#8's calls on 26a's path (a stage's
# microbatch) and 26b's fused one (the gathered qkv of every token)
PATH_ATTN = (("26a ViT-L/16 a microbatch", MICROBATCH, VIT_L[3], VIT_L[1],
              VIT_L[2]),
             ("26b ViT-B/16 the gathered qkv", SP_CASES[0][2], SP_CASES[0][1],
              VIT_B[1], VIT_B[2]))
MLP = ("fused_mlp", "fused_mlp_bwd")


# --------------------------------------------------------------------------
# the rank program
# --------------------------------------------------------------------------

def _block(i: int, spec, layout: str) -> EncoderBlock:
    """Block i of a stack, its weights from its own seed on the card."""
    dim, heads = spec[1], spec[2]
    block = EncoderBlock(dim, heads, 4.0, torch.device("cuda"),
                         fused_attention=layout == "fused")
    gen = torch.Generator(device="cuda").manual_seed(SEED * 1000 + i)
    flax_init_(block, gen)
    with torch.no_grad():  # LayerNorms and biases away from 1 and 0
        for name, p in block.named_parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=gen, device="cuda")
                       * 0.05)
    return block


def _twin(blocks: torch.nn.ModuleList, spec) -> torch.nn.ModuleList:
    """The same blocks in flax's layout (the same state dict)."""
    out = torch.nn.ModuleList()
    for block in blocks:
        twin = EncoderBlock(spec[1], spec[2], 4.0, torch.device("cuda"),
                            fused_attention=False)
        twin.load_state_dict(block.state_dict())
        out.append(twin)
    return out


def _rand(gen, *shape) -> torch.Tensor:
    return torch.randn(*shape, generator=gen, device="cuda")


def _flat_grads(blocks) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1) for b in blocks
                      for p in b.parameters()])


def _zero(blocks) -> None:
    for b in blocks:
        b.zero_grad(set_to_none=True)


def _sequential(blocks, x: torch.Tensor, w: torch.Tensor):
    """The stack in sequence on x [.., S, D] flattened to rows; y and the
    gradients of sum(y * w)."""
    _zero(blocks)
    h = x.reshape((-1,) + tuple(x.shape[-2:]))
    for b in blocks:
        h = b(h)
    (h.float() * w.reshape(h.shape)).sum().backward()
    return h.detach().float().reshape(x.shape), _flat_grads(blocks)


def _rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.double() - ref.double()).norm() / ref.double().norm())


def _worst_tensor(a: torch.Tensor, ref: torch.Tensor, sizes) -> float:
    """The largest of each tensor's max |a - ref| / max |ref|."""
    worst = 0.0
    for ga, gr in zip(a.split(sizes), ref.split(sizes)):
        scale = float(gr.abs().max())
        worst = max(worst, float((ga - gr).abs().max()) / max(scale, 1e-30))
    return worst


def _sizes(blocks) -> list:
    return [p.numel() for b in blocks for p in b.parameters()]


def _quiet() -> None:
    logging.getLogger("vlp_tpu_torch").setLevel(logging.WARNING)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _timed_step(mesh, fn) -> float:
    """ms of ``fn`` on every rank, from a barrier to the barrier after the
    card finished."""
    mesh.barrier()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    mesh.barrier()
    return (time.perf_counter() - t0) * 1e3


def _span(events) -> float:
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events)


def _launches() -> dict:
    return {k: v for k, v in cs._counts().items() if v}


def _gather_to_main(mesh, pairs, flat: torch.Tensor, owner: int):
    """``flat`` of global rank ``owner`` on rank 0 (a broadcast in the
    pair's group); None elsewhere."""
    g = mesh.global_rank
    if owner == 0:
        return flat if g == 0 else None
    if g not in (0, owner):
        return None
    buf = flat if g == owner else torch.empty_like(flat)
    dist.broadcast(buf, owner, group=pairs[owner])
    return buf if g == 0 else None


def _pp_case(mesh, pairs, stage, whole, m: int, dtype, layout: str,
             floor=None) -> dict:
    """One pipeline step of ``stage`` on M microbatches against the
    sequential fp32 run of ``whole`` on rank 0 (flax's layout, from
    ``floor`` when given: (y, grads, sequential bf16's gaps))."""
    n = mesh.model_world
    gen = torch.Generator(device="cuda").manual_seed(SEED + m)
    x = _rand(gen, m, MICROBATCH, VIT_L[3], VIT_L[1])
    w = _rand(gen, m, MICROBATCH, VIT_L[3], VIT_L[1])
    pipe = make_pipeline_fn(scan_blocks_stage_fn(), mesh, n, m)
    _zero(stage)
    y = pipe(stage, x.to(dtype))
    (y.float() * w).sum().backward()
    mine = _flat_grads(stage)
    out = {"layout": layout, "dtype": str(dtype).split(".")[-1], "m": m}
    got = [_gather_to_main(mesh, pairs, mine, s) for s in range(n)]
    del mine
    if mesh.global_rank == 0:
        grads = torch.cat(got)
        ref_y, ref_g, seq_gap = floor
        out.update(y_rel=_rel_l2(y.float(), ref_y),
                   y_max=float((y.float() - ref_y).abs().max()
                               / ref_y.abs().max()),
                   grad_rel=_rel_l2(grads, ref_g),
                   grad_worst=_worst_tensor(grads, ref_g, _sizes(whole)),
                   floor_y=seq_gap[0], floor_grad=seq_gap[1])
    _zero(stage)
    return out


def _pp(n: int) -> dict:
    """26a on this rank."""
    mesh = create_pipeline_mesh(n, device="cuda")
    g, s = mesh.global_rank, mesh.model_rank
    pairs = {r: dist.new_group([0, r]) for r in range(1, n)}
    depth = VIT_L[0]
    fused = stage_blocks(lambda i: _block(i, VIT_L, "fused"), depth, mesh)
    flax = _twin(fused, VIT_L)
    whole = whole_flax = None
    if g == 0:  # the sequential stack, from the same weights
        whole = torch.nn.ModuleList(_block(i, VIT_L, "fused")
                                    for i in range(depth))
        whole_flax = _twin(whole, VIT_L)
    one_block = sum(p.numel() * p.element_size()
                    for p in fused[0].parameters())
    res = {"rank": g, "stage": s, "backend": dist.get_backend(),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in fused.parameters()),
           "stack_bytes": one_block * depth,
           "hop_host": collectives.host_hop(mesh,
                                            torch.zeros(1, device="cuda")),
           "cases": [], "turns": {}}
    for m in MICROBATCHES:
        floor = None
        if g == 0:
            gen = torch.Generator(device="cuda").manual_seed(SEED + m)
            x = _rand(gen, m, MICROBATCH, VIT_L[3], VIT_L[1])
            w = _rand(gen, m, MICROBATCH, VIT_L[3], VIT_L[1])
            ref_y, ref_g = _sequential(whole_flax, x, w)
            y16, g16 = _sequential(whole, x.bfloat16(), w)
            floor = (ref_y, ref_g, (_rel_l2(y16, ref_y), _rel_l2(g16, ref_g)))
            del y16, g16, x, w
            _zero(whole)
            _zero(whole_flax)
        res["cases"].append(_pp_case(mesh, pairs, fused, whole, m,
                                     torch.bfloat16, "fused", floor))
        if m == MICROBATCHES[0]:
            res["cases"].append(_pp_case(mesh, pairs, flax, whole_flax, m,
                                         torch.float32, "flax", floor))
        del floor
        torch.cuda.empty_cache()
    for m in MICROBATCHES:
        res["turns"][str(m)] = _pp_turns(mesh, fused, whole, m)
    del whole, whole_flax, fused, flax
    torch.cuda.empty_cache()
    return res


def _pp_turns(mesh, stage, whole, m: int) -> dict:
    """The bf16 pipeline step and the sequential one (rank 0) in
    alternating turns."""
    n, g = mesh.model_world, mesh.global_rank
    gen = torch.Generator(device="cuda").manual_seed(SEED + m)
    x = _rand(gen, m, MICROBATCH, VIT_L[3], VIT_L[1]).bfloat16()
    w = _rand(gen, m, MICROBATCH, VIT_L[3], VIT_L[1])
    pipe = make_pipeline_fn(scan_blocks_stage_fn(), mesh, n, m)

    def pp_step():
        _zero(stage)
        (pipe(stage, x).float() * w).sum().backward()

    def seq_step():
        if g == 0:
            _sequential(whole, x, w)

    pp_step()
    seq_step()  # warm
    pp_ms, seq_ms, busy, hops = [], [], [], []
    launches = None
    for _ in range(TURNS):
        pipe.compute_events, collectives.stage_axis_events = [], []
        cs._reset_counts()
        pp_ms.append(_timed_step(mesh, pp_step))
        launches = _launches()
        busy.append(_span(pipe.compute_events))
        hops.append(_span(collectives.stage_axis_events))
        pipe.compute_events = collectives.stage_axis_events = None
        seq_ms.append(_timed_step(mesh, seq_step))
    _zero(stage)
    return {"pp_ms": pp_ms, "seq_ms": seq_ms, "busy_ms": busy,
            "hop_ms": hops, "launches": launches}


def _sp_step(fn, blocks, x, w, mesh, events=None) -> tuple:
    """One token-parallel step: this rank's rows of y, the stack's
    gradients (``reduce_seq_gradients``, between CUDA events appended to
    ``events`` when given)."""
    _zero(blocks)
    y = fn(blocks, x)
    t = y.shape[1]
    r = mesh.model_rank
    (y.float() * w[:, r * t:(r + 1) * t]).sum().backward()
    if events is not None:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    reduce_seq_gradients(blocks.parameters(), mesh)
    if events is not None:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    return y


def _sp(n: int) -> dict:
    """26b on this rank."""
    mesh = create_seq_mesh(n, device="cuda")
    g = mesh.global_rank
    depth = VIT_B[0]
    fused = torch.nn.ModuleList(_block(i, VIT_B, "fused")
                                for i in range(depth))
    flax = _twin(fused, VIT_B)
    layouts = {"fused": fused, "flax": flax}
    fn = make_seq_parallel_fn(mesh)
    res = {"rank": g, "cases": [], "turns": {}}
    refs = {}
    for layout, tokens, rows in SP_CASES:
        gen = torch.Generator(device="cuda").manual_seed(SEED + tokens)
        x = _rand(gen, rows, tokens, VIT_B[1])
        w = _rand(gen, rows, tokens, VIT_B[1])
        blocks = layouts[layout]
        if g == 0 and tokens not in refs:
            refs[tokens] = _sequential(flax, x, w)
        for dtype in ((torch.float32, torch.bfloat16)
                      if (layout, tokens) == ("flax", 196)
                      else (torch.bfloat16,)):
            floor = None
            if g == 0 and dtype == torch.bfloat16:
                y16, g16 = _sequential(blocks, x.bfloat16(), w)
                floor = (_rel_l2(y16, refs[tokens][0]),
                         _rel_l2(g16, refs[tokens][1]))
                del y16, g16
            collectives.reset_seq_counts()
            cs._reset_counts()
            y = _sp_step(fn, blocks, x.to(dtype), w, mesh)
            torch.cuda.synchronize()
            case = {"layout": layout, "tokens": tokens, "rows": rows,
                    "dtype": str(dtype).split(".")[-1],
                    "counts": dict(collectives.seq_counts),
                    "launches": _launches()}
            full = collectives.seq_gather(y.detach().float(), mesh)
            if g == 0:
                ref_y, ref_g = refs[tokens]
                grads = _flat_grads(blocks)
                case.update(y_rel=_rel_l2(full, ref_y),
                            y_max=float((full - ref_y).abs().max()
                                        / ref_y.abs().max()),
                            grad_rel=_rel_l2(grads, ref_g),
                            grad_worst=_worst_tensor(grads, ref_g,
                                                     _sizes(blocks)))
                if floor is not None:
                    case.update(floor_y=floor[0], floor_grad=floor[1])
            res["cases"].append(case)
            del y, full
        res["turns"][f"{layout}-{tokens}"] = _sp_turns(
            mesh, fn, blocks, x.bfloat16(), w)
        _zero(blocks)
        torch.cuda.empty_cache()
    del refs
    return res


def _sp_turns(mesh, fn, blocks, x, w) -> dict:
    g = mesh.global_rank
    marks = []

    def sp_step():
        _sp_step(fn, blocks, x, w, mesh, marks)

    def seq_step():
        if g == 0:
            _sequential(blocks, x, w)

    peaks = {}
    for name, step in (("sp", sp_step), ("seq", seq_step)):
        _zero(blocks)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step()  # warm, and the peak
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
    sp_ms, seq_ms, spans, reduce_ms = [], [], [], []
    for _ in range(TURNS):
        collectives.seq_axis_events = []
        marks.clear()
        sp_ms.append(_timed_step(mesh, sp_step))
        spans.append(_span(collectives.seq_axis_events))
        reduce_ms.append(marks[0].elapsed_time(marks[1]))
        collectives.seq_axis_events = None
        seq_ms.append(_timed_step(mesh, seq_step))
    _zero(blocks)
    return {"sp_ms": sp_ms, "seq_ms": seq_ms, "seq_axis_ms": spans,
            "reduce_ms": reduce_ms, "peak_sp": peaks["sp"],
            "peak_seq": peaks["seq"]}


def pp_rank(out: Path) -> int:
    """26a and 26b's rank program (under the launcher's environment): its
    results as ``rank<global rank>.json`` in ``out``."""
    _quiet()
    n = int(os.environ["WORLD_SIZE"])
    res = {"26a": _pp(n)}
    res["26b"] = _sp(n)
    res["device"] = [torch.cuda.current_device(),
                     torch.cuda.get_device_name()]
    (out / f"rank{int(os.environ['RANK'])}.json").write_text(json.dumps(res))
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


# --------------------------------------------------------------------------
# the parent: launches, checks, 26c
# --------------------------------------------------------------------------

def _med(values) -> float:
    return statistics.median(values)


def _check_pp(smi: str, n: int, ranks: list, route: str) -> dict:
    """26a's lines and checks; the launches a rank of each case."""
    a = [r["26a"] for r in ranks]
    per = VIT_L[0] // n
    main = a[0]
    for c in main["cases"]:
        where = (f"26a ViT-L/16 n={n} M={c['m']} {c['layout']} "
                 f"{c['dtype']}")
        cs.check(all(np.isfinite([c["y_rel"], c["grad_rel"]])),
                 f"{where}: non-finite")
        if c["dtype"] == "float32":
            print(f"pp {where}: against the sequential stack (fp32, TF32 "
                  f"off): output {c['y_max']:.3g}, worst gradient tensor "
                  f"{c['grad_worst']:.3g} of its largest value (bound "
                  f"{BOUND_FP32:g}); relative L2 {c['y_rel']:.3g} / "
                  f"{c['grad_rel']:.3g}")
            cs.check(c["y_max"] <= BOUND_FP32
                     and c["grad_worst"] <= BOUND_FP32,
                     f"{where}: {c['y_max']:.3g}, {c['grad_worst']:.3g}")
        else:
            print(f"pp {where}: relative L2 from the fp32 sequential "
                  f"stack: output {c['y_rel']:.4g} (the sequential bf16 "
                  f"run's {c['floor_y']:.4g}), gradient {c['grad_rel']:.4g} "
                  f"({c['floor_grad']:.4g}); bound {BOUND_FLOOR:g}x; worst "
                  f"tensor {c['grad_worst']:.3g}")
            cs.check(c["y_rel"] <= BOUND_FLOOR * c["floor_y"] + 1e-6
                     and c["grad_rel"] <= BOUND_FLOOR * c["floor_grad"]
                     + 1e-6, f"{where}: {c}")
    paths = {}
    for m in MICROBATCHES:
        key = str(m)
        steps = [_med(r["turns"][key]["pp_ms"]) for r in a]
        pp_ms, seq_ms = _med(a[0]["turns"][key]["pp_ms"]), _med(
            a[0]["turns"][key]["seq_ms"])
        idle = [1.0 - _med(r["turns"][key]["busy_ms"]) / _med(
            r["turns"][key]["pp_ms"]) for r in a]
        hops = [_med(r["turns"][key]["hop_ms"]) for r in a]
        bubble = (n - 1) / (m + n - 1)
        want = {"attend_qkv": per * m, "attend_qkv_bwd": per * m}
        for r in a:
            got = {k: v for k, v in r["turns"][key]["launches"].items()
                   if k in ATTN + MLP}
            cs.check(got == want, f"26a n={n} M={m} rank {r['rank']}: "
                     f"launches {got}, expected {want}")
        print(f"pp 26a ViT-L/16 n={n} M={m} ({route}; {smi}): step "
              f"{pp_ms:.2f} ms against the sequential step's {seq_ms:.2f} "
              f"ms in turns ({pp_ms / seq_ms:.3f}x; every rank's median "
              f"{', '.join(f'{t:.2f}' for t in steps)}); measured idle "
              f"share a rank {', '.join(f'{i:.3f}' for i in idle)} against "
              f"the schedule's bubble {bubble:.3f}; hop event spans "
              f"{', '.join(f'{h:.2f}' for h in hops)} ms a step (a rank's "
              f"wait for its peer included); #7/#8 launches a rank a step "
              f"{want['attend_qkv']} + {want['attend_qkv_bwd']}")
        paths[f"pp_vit_l_n{n}_m{m}"] = dict(want)
    for r in a:
        share = r["param_bytes"] / r["stack_bytes"]
        cs.check(abs(share - 1.0 / n) < 1e-9, f"26a rank {r['rank']}: "
                 f"holds {share:.4f} of the stack")
    print(f"pp 26a n={n}: a rank's parameter bytes {a[0]['param_bytes']} "
          f"= {a[0]['param_bytes'] / a[0]['stack_bytes']:.4f} of the "
          f"stack's {a[0]['stack_bytes']} (1/n = {1 / n:.4f}); hops "
          + ("through host copies (gloo)" if a[0]["hop_host"]
             else f"on the device ({a[0]['backend']})"))
    if not FM.supports(MICROBATCH * VIT_L[3], VIT_L[1], 4 * VIT_L[1]):
        print(f"pp 26a: fused_mlp.supports({MICROBATCH * VIT_L[3]}, "
              f"{VIT_L[1]}, {4 * VIT_L[1]}) is False: a stage's MLPs take "
              "the reference's unfused route, as the whole model's do")
    return paths


def _check_sp(smi: str, n: int, ranks: list, route: str) -> dict:
    """26b's lines and checks; the launches a rank of each case."""
    b = [r["26b"] for r in ranks]
    main = b[0]
    depth = VIT_B[0]
    paths = {}
    for i, c in enumerate(main["cases"]):
        where = (f"26b ViT-B/16 n={n} {c['layout']} T={c['tokens']} "
                 f"B={c['rows']} {c['dtype']}")
        cs.check(all(r["cases"][i]["counts"] == {
            "all_gather": depth, "reduce_scatter": depth} for r in b),
            f"{where}: sequence collectives "
            f"{[r['cases'][i]['counts'] for r in b]}")
        rows = c["rows"] * c["tokens"] // n
        mlp = FM.supports(rows, VIT_B[1], 4 * VIT_B[1])
        want = {}
        if c["layout"] == "fused":
            want.update(attend_qkv=depth, attend_qkv_bwd=depth)
        if mlp and c["dtype"] == "bfloat16":
            want.update(fused_mlp=depth, fused_mlp_bwd=depth)
        for r in b:
            got = {k: v for k, v in r["cases"][i]["launches"].items()
                   if k in ATTN + MLP}
            cs.check(got == want, f"{where} rank {r['rank']}: launches "
                     f"{got}, expected {want}")
        if c["dtype"] == "float32":
            print(f"sp {where}: against the sequential stack (fp32, TF32 "
                  f"off): output {c['y_max']:.3g}, worst gradient tensor "
                  f"{c['grad_worst']:.3g} of its largest value (bound "
                  f"{BOUND_FP32:g})")
            cs.check(c["y_max"] <= BOUND_FP32
                     and c["grad_worst"] <= BOUND_FP32, f"{where}: {c}")
        else:
            print(f"sp {where}: relative L2 from the fp32 sequential "
                  f"stack: output {c['y_rel']:.4g} (the sequential bf16 "
                  f"run's {c['floor_y']:.4g}), gradient {c['grad_rel']:.4g} "
                  f"({c['floor_grad']:.4g}); bound {BOUND_FLOOR:g}x; "
                  f"fused_mlp.supports({rows}, {VIT_B[1]}, {4 * VIT_B[1]}) "
                  f"is {mlp}; launches a rank a step {want or 'none'}")
            cs.check(c["y_rel"] <= BOUND_FLOOR * c["floor_y"] + 1e-6
                     and c["grad_rel"] <= BOUND_FLOOR * c["floor_grad"]
                     + 1e-6, f"{where}: {c}")
            paths[f"sp_vit_b_{c['layout']}_t{c['tokens']}_n{n}"] = want
    for key, t in main["turns"].items():
        sp_ms, seq_ms = _med(t["sp_ms"]), _med(t["seq_ms"])
        spans = [_med(r["turns"][key]["seq_axis_ms"]) for r in b]
        reduce = [_med(r["turns"][key]["reduce_ms"]) for r in b]
        print(f"sp 26b ViT-B/16 n={n} {key} bf16 ({route}; {smi}): step "
              f"{sp_ms:.2f} ms against the sequential step's {seq_ms:.2f} "
              f"ms in turns ({sp_ms / seq_ms:.3f}x); {depth} all-gathers "
              f"and {depth} reduce-scatters a step, event spans "
              f"{', '.join(f'{s:.2f}' for s in spans)} ms a step (a rank's "
              f"wait for its peers included); the gradients' sum over the "
              f"seq ranks {', '.join(f'{s:.2f}' for s in reduce)} ms a "
              f"step; rank 0's peak activation "
              f"memory {t['peak_sp'] / 2**20:.1f} MiB against the "
              f"sequential step's {t['peak_seq'] / 2**20:.1f} MiB "
              f"({t['peak_sp'] / t['peak_seq']:.3f}x)")
    return paths


def _launch_ranks(smi: str, n: int, root: Path) -> dict:
    out = root / f"pp_ranks_{n}"
    out.mkdir(parents=True)
    cards = torch.cuda.device_count()
    route = (f"{n} ranks over NCCL on {n} cards" if cards >= n else
             f"{n} ranks on {cards} card(s) over gloo: hops through host "
             "copies, collectives on the CUDA tensors")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _, seconds = cs._launch([str(Path(cs.__file__).resolve()), "--pp-rank",
                             str(out)], n, RANK_TIMEOUT, f"26a/26b n={n}")
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(n)]
    backends = {r["26a"]["backend"] for r in ranks}
    cs.check(backends == {"nccl" if cards >= n else "gloo"},
             f"26 n={n}: backends {backends} on {cards} card(s)")
    paths = _check_pp(smi, n, ranks, route)
    paths.update(_check_sp(smi, n, ranks, route))
    print(f"pp/sp n={n}: launch {seconds:.1f} s")
    return paths


SWEEP_YAML = """\
# 26c: a bayes sweep of ResNet34 on the synthetic downstream corpus
method: bayes
metric:
  name: val/combined/loss
  goal: minimize
parameters:
  optimizer.lr:
    min: 1.0e-4
    max: 1.0e-2
  optimizer.name:
    values: [adamw, adam]
overrides:
  - experiment=baseline_only_imaging_resnet34
  - data.name=synthetic_downstream
  - data.synthetic_num_samples={samples}
  - k_fold_cross_validation=false
  - trainer.max_epochs=1
"""


def _sweep(smi: str, root: Path) -> dict:
    """26c's sweep: ``main`` of the entry point on the card."""
    from vlp_tpu_torch.train import sweep

    cs._quiet_trainer_logs()
    path = root / "sweep.yaml"
    path.write_text(SWEEP_YAML.format(samples=SWEEP_SAMPLES))
    out = root / "sweep"
    cs._reset_counts()
    t0 = time.perf_counter()
    rc = sweep.main([str(path), "--trials", str(SWEEP_TRIALS),
                     "--output-dir", str(out), "--seed", str(SEED),
                     "--device", "cuda"])
    seconds = time.perf_counter() - t0
    launches = _launches()
    records = [json.loads(line) for line in
               (out / "sweep_results.jsonl").read_text().splitlines()]
    best = json.loads((out / "sweep_best.json").read_text())
    cs.check(rc == 0 and len(records) == SWEEP_TRIALS
             and all(r["value"] is not None and np.isfinite(r["value"])
                     for r in records), f"26c sweep: rc {rc}, {records}")
    cs.check(best == min(records, key=lambda r: r["value"]),
             f"26c sweep: best {best}")
    cs.check(set(launches) <= {"shear_rows", "add_gaussian_noise"}
             and launches.get("shear_rows", 0) > 0,
             f"26c sweep: launches {launches}")
    print(f"sweep 26c ({smi}): {SWEEP_TRIALS} bayes trials of "
          f"{cs.RESNET34} on {SWEEP_SAMPLES} synthetic images, 1 fold x 1 "
          f"epoch, in {seconds:.1f} s; values "
          f"{', '.join(f'{r['value']:.4f}' for r in records)} (trial 5 "
          f"from the forest: {records[-1]['params']}); best trial "
          f"{best['trial']}; launches {launches}")
    return launches


def _setup_check() -> None:
    from vlp_tpu_torch import setup_check

    rc = setup_check.main(["--device", "cuda"])
    cs.check(rc == 0, f"26c setup_check --device cuda exited {rc}")
    print("setup 26c: setup_check.main(['--device', 'cuda']) (python -m "
          "vlp_tpu_torch.setup_check --device cuda) returned 0")


def _flops() -> None:
    """``analytic_flops`` of bench.py's VLP step a image."""
    from vlp_tpu_torch.config.core import Config, apply_overrides
    from vlp_tpu_torch.models.tasks import TaskStatics, build_task
    from vlp_tpu_torch.utils.flops import analytic_flops

    cfg = apply_overrides(Config(), [
        "model.task=vision_language", "model.model=resnet34",
        "model.text_model=tinybert", f"data.batch_size={FLOPS_BATCH}"])
    task = build_task(cfg, TaskStatics(mean=128.0, std=30.0),
                      torch.device("cpu"))
    task.model.eval()
    batch = {"image_u8": torch.zeros(FLOPS_BATCH, 224, 224,
                                     dtype=torch.uint8),
             "input_ids": torch.zeros(FLOPS_BATCH, 40, dtype=torch.int32),
             "attention_mask": torch.ones(FLOPS_BATCH, 40,
                                          dtype=torch.int32)}
    fwd = analytic_flops(lambda b: task.model(
        task._prep_eval(b), b["input_ids"], b["attention_mask"]), batch)
    cs.check(fwd > 0, "26c: no FLOPs counted")
    print(f"flops 26c: {cs.PRETRAIN}'s step (ResNet34 + TinyBERT, batch "
          f"{FLOPS_BATCH}, 224 px, 40 tokens): forward "
          f"{fwd / FLOPS_BATCH / 1e9:.4f} GFLOP a image, training (3x) "
          f"{3 * fwd / FLOPS_BATCH / 1e9:.4f} GFLOP a image (2*MAC, the "
          "plain path)")


def _check_path_kernels(stats: dict) -> None:
    """#7 and #8 at the shapes 26a's and 26b's paths give them, on the
    card, against their plain versions with phase 7's bounds (the largest
    error into ``stats``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for label, n, s, d, heads in PATH_ATTN:
        where = f"{label} N={n} S={s} D={d} H={heads}"
        qkv = (torch.randn(n, s, 3 * d, generator=gen, device="cuda")
               * 1.5).bfloat16()
        do = torch.randn(n, s, d, generator=gen, device="cuda").bfloat16()
        out = cs.BA.attend_qkv(qkv, heads)
        torch.cuda.synchronize()
        cs._check_outputs("attend_qkv", where, (out,),
                          (cs.BA.attend_qkv_plain(qkv, heads),),
                          (cs.BA.attend_qkv_plain(qkv.float(), heads),),
                          ("o",), cs.BOUND_VS_PLAIN_BF16,
                          cs.BOUND_VS_PLAIN_FP32, stats["attend_qkv"])
        dqkv = cs.BA.attend_qkv_bwd(qkv, do, heads)
        torch.cuda.synchronize()
        cs._check_outputs(
            "attend_qkv_bwd", where, cs._dqkv_parts(dqkv, d),
            cs._dqkv_parts(cs.BA.attend_qkv_bwd_plain(qkv, do, heads), d),
            cs._dqkv_parts(cs.BA.attend_qkv_bwd_plain(
                qkv.float(), do.float(), heads), d),
            ("dq", "dk", "dv"), cs.BOUND_BWD_BF16, cs.BOUND_BWD_FP32,
            stats["attend_qkv_bwd"])
        del out, dqkv
    torch.cuda.empty_cache()


def phase_pp(smi: str, root: Path, stats: dict = None) -> dict:
    """Phase 26. Returns the launches a rank of each path; the kernels'
    checks at the paths' shapes add their errors to ``stats`` (phase 7's,
    or their own)."""
    t0 = time.perf_counter()
    if stats is None:
        stats = {name: cs._stat() for name in ATTN}
    _check_path_kernels(stats)
    cards = torch.cuda.device_count()
    if cards < max(WORLDS):
        print(f"pp/sp: {cards} card(s), so the n ranks of a mesh larger "
              "than that share the card over gloo: the schedules, their "
              "hops and collectives and the kernels at a rank's shapes "
              "run; the time of stages or token blocks on their own cards "
              "does not show")
    paths = {}
    for n in WORLDS:
        paths.update(_launch_ranks(smi, n, root))
    t_c = time.perf_counter()
    paths["sweep_resnet34"] = _sweep(smi, root)
    _setup_check()
    _flops()
    print(f"phase 26: {time.perf_counter() - t0:.1f} s (26c "
          f"{time.perf_counter() - t_c:.1f} s)")
    return paths
