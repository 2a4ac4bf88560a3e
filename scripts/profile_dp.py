"""Where the data-parallel training step's time goes against one process,
on the ranks of one host.

Run under the launcher (one process a card, NCCL)::

  python -m torch.distributed.run --standalone --nproc_per_node=W \\
      scripts/profile_dp.py [--experiment pretrain_resnet34_tinybert] \\
      [--turns 3] [--steps 4] [--output dp_profile.json]

Builds the experiment's training twice from the same seeded weights: the
data-parallel step on this rank's rows of each global batch, and (rank 0
alone, the others waiting) the one-process step on the whole global batch.
Times, in alternating turns of ``--steps`` synchronised steps each, five
variants: ``one``, ``dp``, ``dp_local_bn`` (BatchNorm on this rank's rows,
``set_batchnorm_mesh(model, None)``), ``dp_no_grad_reduce``
(``reduce_gradients`` skipped) and ``fsdp`` (the same training under
``mesh.param_sharding=fsdp``, ``parallel/fsdp.py``, from the same
weights). The two ablations change what is computed above one rank and
serve only to split the DP step's time. Then one step of ``one``, ``dp``
and ``fsdp`` each under
``torch.profiler``: the collectives (``c10d::`` calls), the kernel
launches, the summed device time per step and the operations that take
the most host time (self CPU ms). Prints one JSON line (rank 0) with the medians in ms, the
card's name and power limit; ``--output`` also writes it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vlp_tpu_torch.config import PRETRAIN, TRAIN_EXPERIMENTS  # noqa: E402
from vlp_tpu_torch.models.vit import set_batchnorm_mesh  # noqa: E402
from vlp_tpu_torch.parallel.mesh import (create_mesh, destroy_mesh,  # noqa
                                         shard_batch)
from vlp_tpu_torch.train import step as step_module  # noqa: E402
from vlp_tpu_torch.train.setup import (batch_for,  # noqa: E402
                                       build_training)
from vlp_tpu_torch.train.step import to_device  # noqa: E402


# operations listed by self host time in a profiled step
TOP_HOST = 12


def _timed(step, state, batches) -> list:
    out = []
    for b in batches:
        t0 = time.perf_counter()
        step(state, b)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def _profiled(step, state, batch) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    top = sorted(events, key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:TOP_HOST]
    return {
        "collectives": sum(e.count for e in events
                           if e.key.startswith("c10d::")),
        "kernel_launches": sum(e.count for e in events
                               if e.key.startswith("cudaLaunchKernel")),
        "device_ms": sum(e.self_device_time_total for e in events) / 1e3,
        "host_ms": sum(e.self_cpu_time_total for e in events) / 1e3,
        "top_host_ms": {e.key: [round(e.self_cpu_time_total / 1e3, 3),
                                e.count] for e in top}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--experiment", default=PRETRAIN)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--output")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_dp: no CUDA device", file=sys.stderr)
        return 2
    mesh = create_mesh(None, "cuda")
    try:
        cuda = mesh.device
        tcfg = TRAIN_EXPERIMENTS[args.experiment]
        rng = np.random.default_rng(1)
        full = [batch_for(tcfg, rng, tcfg.batch_size)
                for _ in range(args.steps)]
        local = [to_device(shard_batch(b, mesh), cuda) for b in full]
        full = [to_device(b, cuda) for b in full]
        ostate = ostep = None
        if mesh.is_main:
            _, ostate, ostep = build_training(tcfg, cuda, 10)
        task, state, step = build_training(tcfg, cuda, 10, mesh=mesh)
        reduce = step_module.reduce_gradients

        def dp():
            return _timed(step, state, local)

        def dp_local_bn():
            set_batchnorm_mesh(task.model, None)
            try:
                return _timed(step, state, local)
            finally:
                set_batchnorm_mesh(task.model, mesh)

        def dp_no_grad_reduce():
            step_module.reduce_gradients = lambda params, m: None
            try:
                return _timed(step, state, local)
            finally:
                step_module.reduce_gradients = reduce

        def one():
            return _timed(ostep, ostate, full) if mesh.is_main else []

        _, fstate, fstep = build_training(dataclasses.replace(
            tcfg, param_sharding="fsdp"), cuda, 10, mesh=mesh)

        def fsdp():
            return _timed(fstep, fstate, local)

        variants = {"one": one, "dp": dp, "dp_local_bn": dp_local_bn,
                    "dp_no_grad_reduce": dp_no_grad_reduce, "fsdp": fsdp}
        times = {k: [] for k in variants}
        for turn in range(args.turns + 1):  # the first is a warm-up
            for name, fn in variants.items():
                mesh.barrier()
                got = fn()
                if turn:
                    times[name] += got
                mesh.barrier()
        prof = {"dp": _profiled(step, state, local[0]),
                "fsdp": _profiled(fstep, fstate, local[0])}
        mesh.barrier()
        if mesh.is_main:
            prof["one"] = _profiled(ostep, ostate, full[0])
        mesh.barrier()
        if mesh.is_main:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip().splitlines()[0]
            out = {"experiment": args.experiment, "world": mesh.world,
                   "global_batch": tcfg.batch_size, "card": smi,
                   "median_ms": {k: statistics.median(v) * 1e3
                                 for k, v in times.items()},
                   "min_ms": {k: min(v) * 1e3 for k, v in times.items()},
                   "steps_each": len(times["dp"]), "profile_step": prof}
            line = json.dumps(out)
            print(line, flush=True)
            if args.output:
                Path(args.output).write_text(line + "\n")
    finally:
        destroy_mesh(mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
