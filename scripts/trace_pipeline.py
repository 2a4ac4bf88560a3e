"""Where a GPipe step's time goes on each stage rank: one traced step of
``parallel/pipeline.py`` over ViT-L/16's 24 encoder blocks (chip_smoke
phase 26a's stack: D 1024, 16 heads of 64, S 197, bf16, the fused layout),
n stages of one card each, M microbatches of 8 images.

Run from the repo root; the script builds the kernels once and then starts
its n ranks under the launcher (NCCL where there are n cards)::

  python scripts/trace_pipeline.py [--stages 4] [--microbatches 8] \\
      [--output chiprun_out/pp_trace]

``--device cpu --tiny`` runs the same control flow on gloo ranks on the CPU
at a tiny size (no device trace there). On each rank: warm steps, then
``--steps`` untraced steps (their median, from a barrier to the barrier
after the card finished), then one step under ``torch.profiler``, whose
Chrome trace the rank reads back:

- the step's wall time (the traced step's and the untraced median: the
  profiler's own cost);
- the device: the union of every kernel's interval in the step (busy), the
  compute kernels' (all but NCCL's) by kind (matrix products, the port's
  attention kernels #7/#8, the rest), NCCL's kernels (count, summed span:
  a hop's transfer and its wait for the peer together);
- each gap between consecutive compute kernels split in two: the part
  before the host issued the next kernel's launch call (the device waited
  on the host's dispatch) and the rest (it waited on a dependency: a hop's
  data, or the launch's own latency);
- the host: launch calls and their summed time, blocking calls
  (synchronize, event waits), and the host's time a launched kernel;
- the kernels that take the most time and the host operations called
  most often (``TOP`` each; a host operation's time includes its
  children's).

Then the hop alone: the chain of stage hops of one microbatch's
activation [8, 197, 1024] bf16 with every rank ready (a barrier before
each), its CUDA-event time: the transfer without the wait. Global rank 0
also traces the sequential stack's step on all M x 8 images (the others
wait). Writes ``summary.json`` (every rank's numbers) and rank 1's Chrome
trace (gzip) to ``--output``, and prints one JSON line with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from vlp_tpu_torch.models.vit import EncoderBlock, flax_init_  # noqa: E402
from vlp_tpu_torch.parallel import collectives  # noqa: E402
from vlp_tpu_torch.parallel.mesh import create_pipeline_mesh  # noqa: E402
from vlp_tpu_torch.parallel.pipeline import (make_pipeline_fn,  # noqa: E402
                                             scan_blocks_stage_fn,
                                             stage_blocks)

# (depth, width, heads, tokens, microbatch rows)
VIT_L = (24, 1024, 16, 197, 8)
TINY = (8, 64, 2, 17, 2)
SEED = 26
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")
GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "Gemm")
TOP = 12  # kernels by summed time, host operations by count


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stages", type=int, default=4)
    p.add_argument("--microbatches", type=int, default=8)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--output", default="chiprun_out/pp_trace")
    return p.parse_args(argv)


def _block(i: int, spec, device: torch.device) -> EncoderBlock:
    block = EncoderBlock(spec[1], spec[2], 4.0, device,
                         fused_attention=True)
    gen = torch.Generator(device=device).manual_seed(SEED * 1000 + i)
    flax_init_(block, gen)
    return block


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _kind(name: str) -> str:
    if "nccl" in name.lower():
        return "nccl"
    if "mhsa" in name:
        return "attention"
    if any(k in name for k in GEMM_NAMES):
        return "gemm"
    return "other"


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _read_trace(path: str, label: str) -> dict:
    """The step's numbers from a Chrome trace whose step is the user
    annotation ``label`` (times in ms)."""
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    step = [e for e in events if e.get("ph") == "X"
            and e.get("name") == label and e.get("cat") == "user_annotation"]
    if not step:
        return {}
    t0, t1 = step[0]["ts"], step[0]["ts"] + step[0]["dur"]
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel" and t0 <= e["ts"] <= t1]
    runtime = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in ("cuda_runtime", "cuda_driver")
               and t0 <= e["ts"] <= t1]
    launch = {e["args"].get("correlation"): e for e in runtime
              if e.get("name") in LAUNCH_CALLS}
    out = {"step_ms": (t1 - t0) / 1e3, "kernels": len(kernels),
           "busy_ms": _union((k["ts"], k["ts"] + k["dur"])
                             for k in kernels) / 1e3}
    by_kind = {}
    for k in kernels:
        c = by_kind.setdefault(_kind(k["name"]), [0, 0.0])
        c[0] += 1
        c[1] += k["dur"] / 1e3
    out["by_kind"] = {k: {"count": c, "ms": ms} for k, (c, ms) in
                      by_kind.items()}
    compute = sorted((k for k in kernels if _kind(k["name"]) != "nccl"),
                     key=lambda k: k["ts"])
    out["compute_busy_ms"] = _union((k["ts"], k["ts"] + k["dur"])
                                    for k in compute) / 1e3
    host_gap = dep_gap = 0.0
    end = None
    for k in compute:
        if end is not None and k["ts"] > end:
            gap = k["ts"] - end
            call = launch.get(k["args"].get("correlation"))
            late = 0.0 if call is None else min(max(call["ts"] - end, 0.0),
                                                gap)
            host_gap += late
            dep_gap += gap - late
        end = k["ts"] + k["dur"] if end is None else max(end, k["ts"]
                                                         + k["dur"])
    out.update(
        gap_host_ms=host_gap / 1e3, gap_dependency_ms=dep_gap / 1e3,
        lead_ms=(compute[0]["ts"] - t0) / 1e3 if compute else None,
        tail_ms=(t1 - end) / 1e3 if compute else None)
    delays = sorted(k["ts"] - launch[k["args"]["correlation"]]["ts"]
                    for k in compute
                    if k["args"].get("correlation") in launch)
    if delays:
        out["launch_to_start_us"] = {
            "p10": delays[len(delays) // 10], "median":
            statistics.median(delays), "p90": delays[9 * len(delays) // 10]}
    names = {}
    for k in kernels:
        c = names.setdefault(k["name"][:90], [0, 0.0])
        c[0] += 1
        c[1] += k["dur"] / 1e3
    out["top_kernels"] = sorted(([n, c, ms] for n, (c, ms) in names.items()),
                                key=lambda r: -r[2])[:TOP]
    ops = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op" \
                and t0 <= e["ts"] <= t1:
            c = ops.setdefault(e["name"], [0, 0.0])
            c[0] += 1
            c[1] += e["dur"] / 1e3
    out["top_ops"] = sorted(([n, c, ms] for n, (c, ms) in ops.items()),
                            key=lambda r: -r[1])[:TOP]
    calls = {}
    for e in runtime:
        c = calls.setdefault(e["name"], [0, 0.0])
        c[0] += 1
        c[1] += e["dur"] / 1e3
    out["launch_calls"] = sum(calls[n][0] for n in LAUNCH_CALLS
                              if n in calls)
    out["launch_call_ms"] = sum(calls[n][1] for n in LAUNCH_CALLS
                                if n in calls)
    out["blocking_ms"] = {n: calls[n][1] for n in BLOCKING_CALLS
                          if n in calls}
    if out["launch_calls"]:
        out["host_us_a_launch"] = out["step_ms"] * 1e3 / out["launch_calls"]
    return out


def _traced(fn, label: str, device: torch.device, keep: str = None):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=acts) as prof:
            with record_function(label):
                fn()
                _sync(device)
        prof.export_chrome_trace(path)
        res = _read_trace(path, label)
        if keep:
            with open(path, "rb") as src, gzip.open(keep, "wb") as dst:
                shutil.copyfileobj(src, dst)
    return res


def _wall(mesh, device, fn) -> float:
    mesh.barrier()
    t0 = time.perf_counter()
    fn()
    _sync(device)
    mesh.barrier()
    return (time.perf_counter() - t0) * 1e3


def _hop_alone(mesh, x, device, rounds: int = 20) -> float:
    """ms of one chain hop of x with every rank ready (a barrier first)."""
    s, n = mesh.model_rank, mesh.model_world
    times = []
    for _ in range(rounds):
        mesh.barrier()
        t0 = time.perf_counter()
        collectives.hop(x if s < n - 1 else None, mesh, 1,
                        like=x if s > 0 else None)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rank_main(a) -> int:
    spec = TINY if a.tiny else VIT_L
    depth, dim, _, tokens, rows = spec
    n, m = a.stages, a.microbatches
    mesh = create_pipeline_mesh(n, device=a.device)
    device = mesh.device
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    g, s = mesh.global_rank, mesh.model_rank
    stage = stage_blocks(lambda i: _block(i, spec, device), depth, mesh)
    gen = torch.Generator(device=device).manual_seed(SEED + m)
    x = torch.randn(m, rows, tokens, dim, generator=gen,
                    device=device).to(dtype)
    w = torch.randn(m, rows, tokens, dim, generator=gen, device=device)
    pipe = make_pipeline_fn(scan_blocks_stage_fn(), mesh, n, m)

    def step():
        stage.zero_grad(set_to_none=True)
        (pipe(stage, x).float() * w).sum().backward()

    for _ in range(2):
        step()
    walls = [_wall(mesh, device, step) for _ in range(a.steps)]
    out = Path(a.output)
    res = {"rank": g, "stage": s, "backend": dist.get_backend(),
           "wall_ms": walls, "wall_median_ms": statistics.median(walls)}
    mesh.barrier()
    res["traced"] = _traced(step, "pp_step", device,
                            str(out / "rank1_trace.json.gz") if g == 1
                            else None)
    mesh.barrier()
    res["hop_alone_ms"] = _hop_alone(mesh, x[0], device)
    res["hop_bytes"] = x[0].numel() * x[0].element_size()
    del stage
    if g == 0:  # the sequential stack on every microbatch at once
        whole = torch.nn.ModuleList(_block(i, spec, device)
                                    for i in range(depth))
        flat = x.reshape(m * rows, tokens, dim)

        def seq_step():
            whole.zero_grad(set_to_none=True)
            h = flat
            for b in whole:
                h = b(h)
            (h.float() * w.reshape(h.shape)).sum().backward()

        seq_step()
        seq_walls = []
        for _ in range(a.steps):
            t0 = time.perf_counter()
            seq_step()
            _sync(device)
            seq_walls.append((time.perf_counter() - t0) * 1e3)
        res["seq_wall_median_ms"] = statistics.median(seq_walls)
        res["seq_traced"] = _traced(seq_step, "seq_step", device)
    mesh.barrier()
    (out / f"rank{g}.json").write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not measured"


def main(argv=None) -> int:
    a = _args(argv)
    if "WORLD_SIZE" in os.environ:
        return rank_main(a)
    out = Path(a.output)
    out.mkdir(parents=True, exist_ok=True)
    if a.device == "cuda":
        from vlp_tpu_torch.ops import _build
        _build.load_library()  # once, before the ranks
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={a.stages}", str(Path(__file__).resolve()),
           *(argv if argv is not None else sys.argv[1:])]
    proc = subprocess.run(cmd, text=True, capture_output=True, timeout=1200)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        return proc.returncode
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(a.stages)]
    summary = {"card": _smi() if a.device == "cuda" else "cpu",
               "stages": a.stages, "microbatches": a.microbatches,
               "tiny": a.tiny, "ranks": ranks}
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
