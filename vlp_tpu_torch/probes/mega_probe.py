"""The MLP half-block schedule probe on one CUDA card (counterpart of the
``mlp`` half of ``benchmarks/mega_variants.py``): what the MLP of a
pre-LN block costs, forward and backward (the Pallas bodies keep the
hidden activation ``h [M, 4D]`` on chip; the port's sequences pass it
through device memory), at NesT-Small level 3 (S 196, D 384, F 1536;
``--batch`` 128 gives M = 25088).

Forward (#13): ``mlp_tile`` (``ops/mlp_tile.py``: #2's launch sequence
with the accurate GELU) at each ``(tm, fs)`` instance, and its two
ablation bounds at the default instance (GELU -> identity, LN ->
identity), beside the shipped ``ln_mlp`` (#2, the script's "v0 (current)"
line) and the plain version. Backward (#14): ``mlp_tile_bwd`` at each
backward instance beside the shipped ``ln_mlp_bwd`` (#4) and the plain
version. Each instance of either also with device time alone
(``_timing.device_in_turns``: 20 calls queued behind a spin kernel, so no
host time shows) of the kernel and the shipped #2 or #4 taken in turns
(``kernel_device_ms``, ``shipped_device_ms``); #2's and #4's own records
carry their ``kernel_device_ms``. Each is
timed in turns with its plain version (plain, kernel, kernel, plain) by
CUDA events, with its largest error against the plain version, absolute
and relative to the plain output's largest |value| (none for the
ablations, as in the script; #4 returns bf16 weight gradients and rounds h
as bf16(z * cdf), so it has only the relative one), its bound
(``probes/_timing.bound_ms``) and TFLOP/s. The reference's draws: x ~ N(0,
1), w1 ~ N(0, 1/D), w2 ~ N(0, 1/F) in bf16, gamma 1, beta, b1, b2 0, dy ~
N(0, 1).

Prints one JSON line per record (and the card's name and power limit);
writes nothing. Needs a CUDA card; exits with code 2 without one.

  python -m vlp_tpu_torch.probes.mega_probe [--batch 128]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple

import torch

from vlp_tpu_torch.ops import fused_block as FB
from vlp_tpu_torch.ops import mlp_tile as MT
from vlp_tpu_torch.probes._timing import (bound_ms, device_in_turns,
                                          in_turns, require_cuda)

BATCH = 128
SEQ, D = 196, 384
F = 4 * D
# the wrappers' default instance, #2's widths: the ablations run there
DEFAULT_TILE = (128, 128)


def mlp_work(m: int, d: int, f: int, backward: bool = False
             ) -> Tuple[int, int]:
    """(operations, bytes) of one call, each input read once and each
    output written once. Forward: two products; x, W1, W2, gamma, beta,
    b1, b2 in, y out. Backward: five products; x, dy, W1, W2, gamma,
    beta, b1 in, dx and the fp32 parameter gradients out."""
    if backward:
        return 10 * m * d * f, 6 * m * d + 12 * d * f + 20 * d + 8 * f
    return 4 * m * d * f, 4 * m * d + 4 * d * f + 12 * d + 4 * f


def mlp_inputs(m: int, gen: torch.Generator, d: int = D, f: int = F):
    """x, gamma, beta, w1, b1, w2, b2, dy on the generator's device."""
    dev = gen.device

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x = rand(m, d).bfloat16()
    w1 = (rand(d, f) * d ** -0.5).bfloat16()
    w2 = (rand(f, d) * f ** -0.5).bfloat16()
    dy = rand(m, d).bfloat16()
    ones = torch.ones(d, device=dev)
    zeros = torch.zeros(d, device=dev)
    return x, ones, zeros, w1, torch.zeros(f, device=dev), w2, zeros, dy


def record(probe: str, variant: str, t: Dict[str, float], work, **extra):
    """A record of times ``t`` (kernel, plain and any yardstick, in ms)."""
    flops, nbytes = work
    return {"probe": probe, "variant": variant,
            **{f"{k}_ms": v for k, v in t.items()}, "flops": flops,
            "bytes": nbytes, **bound_ms(flops, nbytes),
            "tflops": flops / t["kernel"] / 1e9, **extra}


def device_alone(t: Dict[str, float]) -> Dict[str, float]:
    """``device_in_turns``' times as record fields ``<name>_device_ms``."""
    return {f"{k}_device_ms": v for k, v in t.items()}


def errors(outs, refs) -> Dict[str, float]:
    """The largest |out - ref| over the outputs (``max_abs_err``), and the
    largest relative to its reference's largest |value|
    (``max_rel_err``)."""
    diffs = [((o.float() - r.float()).abs().max().item(),
              r.float().abs().max().item()) for o, r in zip(outs, refs)]
    return {"max_abs_err": max(a for a, _ in diffs),
            "max_rel_err": max(a / top for a, top in diffs)}


def run(batch: int = BATCH, seed: int = 0, device: str = "cuda"
        ) -> List[Dict]:
    """Every forward and backward variant on ``device`` (a CPU device runs
    the plain versions; the tests use it for the control flow); one record
    per variant."""
    gen = torch.Generator(device=device).manual_seed(seed)
    m = batch * SEQ
    x, g, b, w1, b1, w2, b2, dy = mlp_inputs(m, gen)
    params = (g, b, w1, b1, w2, b2)
    fwd_work = mlp_work(m, D, F)
    bwd_work = mlp_work(m, D, F, backward=True)

    def plain():
        return MT.mlp_tile_plain(x, *params)

    def shipped_fwd():
        return FB.ln_mlp(x, *params)

    ref = plain()
    records = []
    for tm, fs in MT.TILES:
        def kern(tm=tm, fs=fs):
            return MT.mlp_tile(x, *params, tm=tm, fs=fs)

        err = errors((kern(),), (ref,))
        rec = record("mlp_fwd", f"tile tm={tm} fs={fs}", in_turns(
            plain=plain, kernel=kern), fwd_work, tm=tm, fs=fs, **err)
        rec.update(device_alone(device_in_turns(kernel=kern,
                                                shipped=shipped_fwd)))
        records.append(rec)
    for label, flags in (("no-gelu BOUND", dict(gelu=False)),
                         ("no-ln BOUND", dict(ln=False))):
        t = in_turns(
            plain=lambda flags=flags: MT.mlp_tile_plain(x, *params, **flags),
            kernel=lambda flags=flags: MT.mlp_tile(x, *params, **flags))
        records.append(record("mlp_fwd", label, t, fwd_work,
                              tm=DEFAULT_TILE[0], fs=DEFAULT_TILE[1],
                              max_abs_err=None, max_rel_err=None))
    err = errors((shipped_fwd(),), (ref,))
    rec = record("mlp_fwd", "ln_mlp #2 (shipped, fast GELU)", in_turns(
        plain=plain, kernel=shipped_fwd), fwd_work, **err)
    rec.update(device_alone(device_in_turns(kernel=shipped_fwd)))
    records.append(rec)
    del ref

    bparams = (g, b, w1, b1, w2)

    def bplain():
        return MT.mlp_tile_bwd_plain(x, *bparams, dy)

    def shipped():
        return FB.ln_mlp_bwd(x, *bparams, dy)

    refs = bplain()
    for tm, fs in MT.BWD_TILES:
        def bkern(tm=tm, fs=fs):
            return MT.mlp_tile_bwd(x, *bparams, dy, tm=tm, fs=fs)

        err = errors(bkern(), refs)
        rec = record("mlp_bwd", f"tile tm={tm} fs={fs}", in_turns(
            plain=bplain, kernel=bkern), bwd_work, tm=tm, fs=fs, **err)
        rec.update(device_alone(device_in_turns(kernel=bkern,
                                                shipped=shipped)))
        records.append(rec)
    rel = errors(shipped(), refs)["max_rel_err"]
    rec = record("mlp_bwd", "ln_mlp_bwd #4 (shipped)", in_turns(
        plain=bplain, kernel=shipped), bwd_work, max_abs_err=None,
        max_rel_err=rel)
    rec.update(device_alone(device_in_turns(kernel=shipped)))
    records.append(rec)
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=BATCH)
    args = parser.parse_args(argv)
    smi = require_cuda("mega_probe")
    device = torch.cuda.get_device_name(0)
    for rec in run(args.batch):
        print(json.dumps({**rec, "device": device, "nvidia_smi": smi}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
