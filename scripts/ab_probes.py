"""Before and after of the probes #13 ``mlp_tile`` and #19a ``mlp_chain``
(each instance, each chain stage), of the attention probes #15
``attn_sched`` and #16 ``attn_sched_bwd`` (each mode, and each core alone),
of #14 ``mlp_tile_bwd`` (each instance) and of #18 ``bn_relu_gemm`` in one
process on one CUDA card, at the probes' shapes (``probes/attn_probe.py``,
``probes/mega_probe.py``, ``probes/mlp_probe.py``: NesT-Small level 3, S
196, D 384, 12 heads of 32, F 1536; ``probes/bn_gemm_probe.py``: the three
ResNet50 boundary shapes; ``--batch`` 128).

``--parent DIR`` is a second checkout of the repository (for example an
earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). Its library is built from its own
``vlp_tpu_torch/csrc`` by its own ``_build.py`` into its own build
directory (``scripts/ab_attention.py``'s ``_load_parent_build``). In the
parent's turns this tree's ``attn_sched``, ``attn_sched_core``,
``attn_sched_bwd``, ``attn_sched_bwd_core`` and ``mlp_tile_bwd`` wrappers
launch that library's entry points of the same names and its workspace
queries (their C signatures must be this tree's), so does
``bn_relu_gemm`` (``vlp_bn_relu_gemm``), and #14 runs the
parent's instances (``BWD_TILES`` as its ``ops/mlp_tile.py`` lists them).
#13 and #19a run the parent's instances (its ``TILES``) through the
parent's ``vlp_mlp_tile``: by this tree's wrappers where the parent's
``_SIGNATURES`` give it this tree's C signature, else by the one-launch
tile engine's signature that the parent's ``_SIGNATURES`` bind
(``_engine_call``). Every other kernel and all the code around them are
this tree's. The turns alternate (parent, change, change, parent, ...)
after one warm-up turn of each, and each turn times, as device time alone
per call (``_timing.device_ms``: 20 calls queued behind a spin kernel, so
the host's time does not show):

  attn_fwd_<mode>_ms       #15 in mode v0, nosm, pipe, pipe2, stage
  attn_fwd_core_<mode>_ms  its core alone on the probe's qkv
  attn_bwd_<mode>_ms       #16 in mode v0, stage2, uni
  attn_bwd_core_<mode>_ms  its core alone on the probe's qkv and do
  mlp_fwd_<tm>x<fs>_ms     #13 (LN and GELU on) at each of the side's
                           instances, and
  mlp_fwd_fastest_ms       the fastest of them
  mlp_chain_<stages>_<tm>x<fs>_ms
                           #19a with stages matmuls (none), gelu or
                           ln+gelu at each instance, and
  mlp_chain_<stages>_fastest_ms
                           the fastest instance of each stage set
  mlp_bwd_<tm>x<fs>_ms     #14 at each of the side's instances, and
  mlp_bwd_fastest_ms       the fastest of them
  bn_gemm_<shape>_ms       #18 at each of the probe's shapes
  ln_attention_ms, ln_attention_bwd_ms, ln_mlp_ms, ln_mlp_bwd_ms,
  two_matmuls_ms, sdpa_fwd_ms, sdpa_bwd_ms, bn_two_op_<shape>_ms
                           the shipped #1, #3 (on #1's qkv and o), #2 and
                           #4, two cuBLAS matmuls (#19a's yardstick), SDPA
                           forward and backward on the same q, k, v and
                           #18's two-op PyTorch version: yardsticks, this
                           tree's on both sides

After the turns, one call of each #13 instance, #19a stage set and
instance, #15 and #16 mode, each core, each #14 instance and #18 at each
shape per side runs under ``torch.profiler``: the ``split`` of the summary
lists each call's kernels in launch order with their device ms. The
summary's ``registers`` compares the two builds' ptxas reports (``-Xptxas
-v``, ``_build.build_log``) for every instance of the wgmma mainloop and
the attention cores that both hold. ``--only parent`` times and
splits the parent's kernels alone (the yardsticks too), without building
this tree's library: the profile of the parent before a change is built.

Random inputs from fixed seeds (the probes' draws), the same on both
sides. Prints one JSON line per turn, then one with each side's median of
every metric over its turns, the splits, and the card's name and power
limit (``nvidia-smi``). Exits with code 2 without a CUDA device.

Usage:
  python scripts/ab_probes.py --parent DIR [--rounds 5] [--batch 128] \\
      [--only parent] [--output ab_probes.json]
"""
from __future__ import annotations

import argparse
import ast
import concurrent.futures
import json
import os
import re
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ab_attention import (_call_kernels, _Library, _Mixed,  # noqa: E402
                          _load_parent_build)
from chip_smoke import _ptxas_report  # noqa: E402
from vlp_tpu_torch.ops import _build  # noqa: E402
from vlp_tpu_torch.ops import attn_sched as AS  # noqa: E402
from vlp_tpu_torch.ops import bn_gemm as BG  # noqa: E402
from vlp_tpu_torch.ops import fused_block as FB  # noqa: E402
from vlp_tpu_torch.ops import mlp_tile as MT  # noqa: E402
from vlp_tpu_torch.ops._common import _stream  # noqa: E402
from vlp_tpu_torch.probes import (attn_probe, bn_gemm_probe,  # noqa: E402
                                  mega_probe, mlp_probe)
from vlp_tpu_torch.probes._timing import device_ms, require_cuda  # noqa: E402

PARENT_ENTRY_POINTS = ("vlp_attn_sched", "vlp_attn_sched_core",
                       "vlp_attn_sched_bwd", "vlp_attn_sched_bwd_workspace",
                       "vlp_attn_sched_bwd_core",
                       "vlp_attn_sched_bwd_core_workspace",
                       "vlp_mlp_tile_bwd", "vlp_mlp_tile_bwd_workspace",
                       "vlp_bn_relu_gemm")
# the kernels whose registers the two builds are compared on
REGISTER_KERNELS = ("wgmma_gemm_kernel", "mhsa_reg_kernel",
                    "mhsa_reg_bwd_kernel")
# the hashes that nvcc gives a source's anonymous namespace in mangled
# names (_GLOBAL__N__<hash>_<n>_<file>_cu_<hash>): they change with any
# header the source includes, so the comparison drops them
ANON_NAMESPACE = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?_cu)_[0-9a-f]{8}")


def bn_inputs(batch, gen):
    """{shape label: (x, a, b, w)} of #18 at the probe's shapes and
    ``batch`` (the probe's draws)."""
    return {label: bn_gemm_probe.gemm_inputs(batch * hw * hw, c, k, gen)
            for label, hw, c, k in bn_gemm_probe.SHAPES}


def compare_registers(parent_log: str, own_log: str):
    """The registers of every ``REGISTER_KERNELS`` instance that both ptxas
    reports name (anonymous namespaces named by their file alone): how
    many are the same, {name: [parent, change]} of those that differ, and
    how many only one build holds."""
    regs = [{ANON_NAMESPACE.sub(r"_GLOBAL__N_\1", k): v[0]
             for k, v in _ptxas_report(log)[0].items()
             if any(n in k for n in REGISTER_KERNELS)}
            for log in (parent_log, own_log)]
    both = sorted(set(regs[0]) & set(regs[1]))
    return {"same": sum(regs[0][k] == regs[1][k] for k in both),
            "differ": {k: [regs[0][k], regs[1][k]] for k in both
                       if regs[0][k] != regs[1][k]},
            "only_parent": len(set(regs[0]) - set(regs[1])),
            "only_change": len(set(regs[1]) - set(regs[0]))}


def parent_tiles(root: str, name: str):
    """``name`` (``TILES`` or ``BWD_TILES``) of the parent checkout's
    ``ops/mlp_tile.py``, read from its source (the module itself imports
    this tree's package)."""
    path = os.path.join(root, "vlp_tpu_torch", "ops", "mlp_tile.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return tuple(tuple(t) for t in ast.literal_eval(node.value))
    raise ValueError(f"{path}: no {name}")


def _engine_call(lib, x, w1, w2, vecs, *, ln, gelu, tm, fs):
    """One call of the one-launch tile engine's ``vlp_mlp_tile`` (x, gamma,
    beta, w1, b1, w2, b2, out, M, D, F, tm, fs, ln, gelu, bias, eps,
    stream, as its library's ``_SIGNATURES`` bind them): #13 with ``vecs``
    = (gamma, beta, b1, b2), #19a with ``vecs`` None."""
    (m, d), f = x.shape, w1.shape[1]
    ptrs = [v.data_ptr() for v in vecs] if vecs else [0] * 4
    out = torch.empty_like(x)
    err = lib.vlp_mlp_tile(x.data_ptr(), ptrs[0], ptrs[1], w1.data_ptr(),
                           ptrs[2], w2.data_ptr(), ptrs[3], out.data_ptr(),
                           m, d, f, tm, fs, int(ln), int(gelu),
                           int(vecs is not None), FB._EPS, _stream())
    _build.check(lib, err, "the parent's mlp_tile")
    return out


def _chain_label(stages):
    return "+".join(stages) if stages else "matmuls"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--batch", type=int, default=attn_probe.BATCH)
    ap.add_argument("--only", choices=("parent",), default=None)
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    smi = require_cuda("ab_probes")
    root = os.path.abspath(args.parent)
    parent_build = _load_parent_build(root)
    tiles = {"change": MT.BWD_TILES,
             "parent": parent_tiles(root, "BWD_TILES")}
    fwd_tiles = {"change": MT.TILES, "parent": parent_tiles(root, "TILES")}
    # the parent's #13/#19a through this tree's wrappers only where its C
    # signature is this tree's
    same_fwd = (parent_build._SIGNATURES["vlp_mlp_tile"]
                == _build._SIGNATURES["vlp_mlp_tile"])
    if args.only:
        parent_lib = parent_build.load_library()
        sides = {"parent": (_Library(parent_lib),) * 2}
    else:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            libs = [pool.submit(_build.load_library),
                    pool.submit(parent_build.load_library)]
            parent_lib = libs[1].result()
            own_lib = libs[0].result()
        sides = {"change": (_build, _build),
                 "parent": (_Library(_Mixed(
                     own_lib, parent_lib, PARENT_ENTRY_POINTS
                     + ("vlp_mlp_tile",) * same_fwd)), _build)}
    torch.backends.cuda.matmul.allow_tf32 = False

    gen = torch.Generator(device="cuda").manual_seed(0)
    x, g, b, wq, bq, wo, bo, dy = attn_probe.attn_inputs(args.batch, gen)
    aparams = (g, b, wq, bq, wo)
    qkv = AS.ln_qkv_plain(x, g, b, wq, bq)[-1]
    do = (dy.float() @ wo.float().T).bfloat16()
    sdpa_fwd, sdpa_bwd = attn_probe._sdpa(qkv, do)
    (g1, b1, bq1, bo1), (wq1, wo1) = FB._cast(
        x.dtype, vectors=(g, b, bq, bo), matrices=(wq, wo))
    m = args.batch * mega_probe.SEQ
    mx, mg, mb, w1, mb1, w2, mb2, mdy = mega_probe.mlp_inputs(m, gen)
    mparams = (mg, mb, w1, mb1, w2)
    fparams = (*mparams, mb2)
    bn = bn_inputs(args.batch, gen)

    def use(side):
        AS._build = MT._build = BG._build = sides[side][0]
        FB._build = sides[side][1]
        MT.BWD_TILES = tiles[side]
        MT.TILES = fwd_tiles[side]

    def mlp_fwd(side, tm, fs, stages=None):
        """#13 (``stages`` None) or #19a at (tm, fs) on ``side``."""
        ln = stages is None or "ln" in stages
        gelu = stages is None or "gelu" in stages
        if side == "change" or same_fwd:
            if stages is None:
                return lambda: MT.mlp_tile(mx, *fparams, tm=tm, fs=fs)
            return lambda: MT.mlp_chain(mx, w1, w2, stages, tm=tm, fs=fs)
        vecs = (mg, mb, mb1, mb2) if stages is None else None
        return lambda: _engine_call(parent_lib, mx, w1, w2, vecs, ln=ln,
                                    gelu=gelu, tm=tm, fs=fs)

    def calls(side):
        """{metric: the call it times} on ``side``."""
        use(side)
        _, qkv1, o1 = FB._ln_attention_cuda(x, g1, b1, wq1, bq1, wo1, bo1,
                                            attn_probe.HEADS)
        fns = {}
        for mode in AS.MODES:
            fns[f"attn_fwd_{mode}_ms"] = (
                lambda mode=mode: AS.attn_sched(
                    x, *aparams, bo, attn_probe.HEADS, mode))
            fns[f"attn_fwd_core_{mode}_ms"] = (
                lambda mode=mode: AS.attn_sched_core(
                    qkv, attn_probe.HEADS, mode))
        for mode in AS.BWD_MODES:
            fns[f"attn_bwd_{mode}_ms"] = (
                lambda mode=mode: AS.attn_sched_bwd(
                    x, *aparams, dy, attn_probe.HEADS, mode))
            fns[f"attn_bwd_core_{mode}_ms"] = (
                lambda mode=mode: AS.attn_sched_bwd_core(
                    qkv, do, attn_probe.HEADS, mode))
        for tm, fs in fwd_tiles[side]:
            fns[f"mlp_fwd_{tm}x{fs}_ms"] = mlp_fwd(side, tm, fs)
            for stages in MT.CHAIN_STAGES:
                fns[f"mlp_chain_{_chain_label(stages)}_{tm}x{fs}_ms"] = (
                    mlp_fwd(side, tm, fs, stages))
        for tm, fs in tiles[side]:
            fns[f"mlp_bwd_{tm}x{fs}_ms"] = (
                lambda tm=tm, fs=fs: MT.mlp_tile_bwd(mx, *mparams, mdy,
                                                     tm=tm, fs=fs))
        fns["ln_attention_ms"] = lambda: FB.ln_attention(
            x, *aparams, bo, attn_probe.HEADS)
        fns["ln_attention_bwd_ms"] = lambda: FB.ln_attention_bwd(
            x, g1, b1, wq1, bq1, wo1, dy, attn_probe.HEADS, qkv1, o1)
        fns["ln_mlp_ms"] = lambda: FB.ln_mlp(mx, *fparams)
        fns["ln_mlp_bwd_ms"] = lambda: FB.ln_mlp_bwd(mx, *mparams, mdy)
        fns["two_matmuls_ms"] = lambda: mlp_probe.two_matmuls(mx, w1, w2)
        fns["sdpa_fwd_ms"] = sdpa_fwd
        fns["sdpa_bwd_ms"] = sdpa_bwd
        for label, ops in bn.items():
            fns[f"bn_gemm_{label}_ms"] = (
                lambda ops=ops: BG.bn_relu_gemm(*ops))
            fns[f"bn_two_op_{label}_ms"] = (
                lambda ops=ops: bn_gemm_probe.two_op(*ops))
        return fns

    def turn(side):
        out = {"side": side}
        for name, fn in calls(side).items():
            out[name] = device_ms(fn)
        for prefix in ("mlp_fwd", "mlp_bwd", *(
                f"mlp_chain_{_chain_label(s)}" for s in MT.CHAIN_STAGES)):
            out[f"{prefix}_fastest_ms"] = min(
                v for k, v in out.items() if k.startswith(prefix + "_"))
        return out

    order = list(sides)
    for side in order:  # warm-up: plans, allocator, caches
        turn(side)
    records = []
    for r in range(args.rounds):
        for side in (order if r % 2 == 0 else order[::-1]):
            rec = turn(side)
            records.append(rec)
            print(json.dumps(rec), flush=True)
    metrics = sorted({k for rec in records for k in rec
                      if k.endswith("_ms")})
    median = {side: {k: statistics.median(x[k] for x in records
                                          if x["side"] == side and k in x)
                     for k in metrics
                     if any(k in x for x in records if x["side"] == side)}
              for side in order}
    splits = {}
    for side in order:
        for name, fn in calls(side).items():
            if name.startswith(("attn_fwd", "attn_bwd", "mlp_",
                                "bn_gemm")):
                splits[f"{side} {name[:-3]}"] = [
                    (k[:120], ms) for k, ms in _call_kernels(fn)]
    summary = {"card": smi, "batch": args.batch, "rounds": args.rounds,
               "tiles": tiles, "fwd_tiles": fwd_tiles, "median": median,
               "split_ms": splits}
    if not args.only:
        summary["registers"] = compare_registers(
            parent_build.build_log().read_text(),
            _build.build_log().read_text())
    print(json.dumps(summary), flush=True)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"turns": records, "summary": summary}, f, indent=1)
    if not args.only:
        use("change")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
