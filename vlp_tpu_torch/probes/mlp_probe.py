"""The MLP matmul-chain probe on one CUDA card (counterpart of
``benchmarks/mlp_probe.py``): what the half block's two products cost as
the port's chain (fc1 and fc2 as hand-written wgmma tiles with their
epilogues in registers; the Pallas kernel keeps h on chip), against the
same two products as separate cuBLAS calls, at NesT-Small level 3
(``--batch`` 128: x [25088, 384], W1 [384, 1536], W2 [1536, 384]).

``mlp_chain`` (#19a, ``ops/mlp_tile.py``: #2's launch sequence without
bias or residual) with stages ``()``, ``("gelu",)`` and ``("ln", "gelu")``
at each ``(tm, fs)`` instance, and ``mlp_single`` (#19b, the wgmma + TMA
kernel, one instance), each timed in turns with its plain version and its
yardstick (plain, kernel, yardstick, yardstick, kernel, plain) on CUDA
events around each call: ``torch.matmul(x, w1)`` for the single product
(the one PyTorch call computing the same function: the library time), two
bf16 ``torch.matmul`` calls for the pure chain (the script's "XLA chain"
line; no single call computes a chain). Each kernel is timed again as
device time alone (``kernel_device_ms``: calls queued behind a spin
kernel, so the wrappers' host time does not count), in turns with its
yardstick where it has one (``library_device_ms``: ``torch.matmul``, or
the two matmuls beside the pure chain). Each record has the kernel's
largest error against the plain version, absolute and relative to the
plain output's largest |value|, its bound (``probes/_timing.bound_ms``)
and TFLOP/s.

The TPU script launches ``grid = M // tm`` and so leaves the rows past the
last whole tile unwritten (rows 24576-25087 at tm = 1024); the port writes
every row and does not copy that hole. The reference's draws: x ~ N(0, 1),
w1 ~ N(0, 1/D), w2 ~ N(0, 1/F), bf16 (``mega_probe.mlp_inputs``).

Prints one JSON line per record (and the card's name and power limit);
writes nothing. Needs a CUDA card; exits with code 2 without one.

  python -m vlp_tpu_torch.probes.mlp_probe [--batch 128]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple

import torch

from vlp_tpu_torch.ops import mlp_tile as MT
from vlp_tpu_torch.probes._timing import (device_in_turns, in_turns,
                                          require_cuda)
from vlp_tpu_torch.probes.mega_probe import (BATCH, D, F, SEQ, errors,
                                             mlp_inputs, record)


def chain_work(m: int, d: int, f: int, single: bool = False
               ) -> Tuple[int, int]:
    """(operations, bytes) of one call: x and the weights read once, the
    output written once (y [m, d] for the chain, z [m, f] for the single
    product)."""
    if single:
        return 2 * m * d * f, 2 * m * d + 2 * d * f + 2 * m * f
    return 4 * m * d * f, 4 * m * d + 4 * d * f


def two_matmuls(x: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
    """The pure chain as two cuBLAS calls: z rounded to bf16 between them,
    as the chain rounds h."""
    return torch.matmul(torch.matmul(x, w1), w2)


def run(batch: int = BATCH, seed: int = 0, device: str = "cuda"
        ) -> List[Dict]:
    """Every chain and single-product variant on ``device`` (a CPU device
    runs the plain versions; the tests use it for the control flow); one
    record per variant."""
    gen = torch.Generator(device=device).manual_seed(seed)
    m = batch * SEQ
    x, _, _, w1, _, w2, _, _ = mlp_inputs(m, gen)
    records = []
    for stages in MT.CHAIN_STAGES:
        def plain(stages=stages):
            return MT.mlp_chain_plain(x, w1, w2, stages)

        ref = plain()
        yard, extra = {}, {}
        if not stages:  # the pure chain's yardstick
            yard["two_matmuls"] = lambda: two_matmuls(x, w1, w2)
            extra["two_matmuls_max_abs_err"] = errors(
                (yard["two_matmuls"](),), (ref,))["max_abs_err"]
        for tm, fs in MT.TILES:
            def kern(stages=stages, tm=tm, fs=fs):
                return MT.mlp_chain(x, w1, w2, stages, tm=tm, fs=fs)

            err = errors((kern(),), (ref,))
            t = in_turns(plain=plain, kernel=kern, **yard)
            if yard:
                dev = device_in_turns(kernel=kern,
                                      library=yard["two_matmuls"])
            else:
                dev = device_in_turns(kernel=kern)
            label = "+".join(stages) if stages else "matmuls"
            records.append(record(
                "mlp_chain", f"{label} tm={tm} fs={fs}", t,
                chain_work(m, D, F), stages=list(stages), tm=tm, fs=fs,
                **{f"{k}_device_ms": v for k, v in dev.items()}, **err,
                **extra))
        del ref

    def splain():
        return MT.mlp_single_plain(x, w1)

    ref = splain()
    lib_err = errors((torch.matmul(x, w1),), (ref,))["max_abs_err"]
    def skern():
        return MT.mlp_single(x, w1)

    err = errors((skern(),), (ref,))
    t = in_turns(plain=splain, kernel=skern,
                 library=lambda: torch.matmul(x, w1))
    dev = device_in_turns(kernel=skern, library=lambda: torch.matmul(x, w1))
    records.append(record(
        "mlp_single", "128x128", t, chain_work(m, D, F, single=True),
        kernel_device_ms=dev["kernel"], library_device_ms=dev["library"],
        library_max_abs_err=lib_err, **err))
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=BATCH)
    args = parser.parse_args(argv)
    smi = require_cuda("mlp_probe")
    device = torch.cuda.get_device_name(0)
    for rec in run(args.batch):
        print(json.dumps({**rec, "device": device, "nvidia_smi": smi}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
