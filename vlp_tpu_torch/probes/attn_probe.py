"""The attention half-block schedule probe on one CUDA card (counterpart of
the ``attn`` and ``attnbwd`` halves of ``benchmarks/mega_variants.py``):
what each schedule of one sample's attention costs, at NesT-Small level 3
(S 196, D 384, 12 heads of 32; ``--batch`` 128).

Forward (#15): ``attn_sched`` (``ops/attn_sched.py``) in each mode (v0,
the nosm bound, pipe, pipe2, stage) beside the shipped four-launch
``ln_attention`` (#1). Backward (#16): ``attn_sched_bwd`` in each mode
(v0, stage2, uni), which recomputes LN, qkv and o from x as the Pallas
body does, beside the shipped ``ln_attention_bwd`` (#3), which reads the
qkv and o of one untimed #1 launch and recomputes neither. Each is timed in
turns with its plain version (plain, kernel, core, SDPA, then reversed) by
CUDA events; ``core_ms`` is the mode's attention core alone on the same
qkv (and do), ``sdpa_ms`` ``F.scaled_dot_product_attention`` on the same
q, k, v views (forward, or its autograd backward alone): the cores'
yardstick, which the port never calls. Each mode also carries device time
alone (``_timing.device_in_turns``: 20 calls queued behind a spin kernel,
so no host time shows) of the kernel, its core, the shipped #1 (forward)
or #3 (backward) and SDPA, taken in turns (``kernel_device_ms``,
``core_device_ms``, ``shipped_device_ms``, ``sdpa_device_ms``); #1's and
#3's own records carry their ``kernel_device_ms``. Errors are against the
plain bf16 version, absolute and relative to the plain output's largest
|value| (none for nosm, another function, as in the script; #3 returns bf16
weight gradients, so it has only the relative one). Every mode of a direction
faces one bound (``attn_work``). The reference's draws: x ~ N(0, 1), wqkv
and wout ~ N(0, 1/D) in bf16, biases and beta 0, gamma 1, dy ~ N(0, 1).

Prints one JSON line per record (and the card's name and power limit);
writes nothing. Needs a CUDA card; exits with code 2 without one.

  python -m vlp_tpu_torch.probes.attn_probe [--batch 128]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from vlp_tpu_torch.ops import attn_sched as AS
from vlp_tpu_torch.ops import fused_block as FB
from vlp_tpu_torch.ops._common import _heads
from vlp_tpu_torch.probes._timing import (device_in_turns, in_turns,
                                          require_cuda)
from vlp_tpu_torch.probes.mega_probe import device_alone, errors, record

BATCH = 128
SEQ, D, HEADS = 196, 384, 12


def attn_work(n: int, s: int, d: int, backward: bool = False
              ) -> Tuple[int, int]:
    """(operations, bytes) of one call at N = n, S = s, width d, each input
    read once and each output written once (M = n * s). Forward: the qkv
    and output projections and QK^T, PV; x, the weights and vectors in, y
    out. Backward: the products of the ``uni`` schedule, which the others
    also compute (qkv recomputed, dWqkv, dln; do, dWout; QK^T, PV, dp, dv,
    dq, dk); x, dy and the parameters in, dx and the fp32 parameter
    gradients out."""
    m = n * s
    att = 2 * n * s * s * d
    if backward:
        return (3 * 2 * m * d * 3 * d + 2 * 2 * m * d * d + 6 * att,
                6 * m * d + 24 * d * d + 44 * d)
    return (2 * m * d * 3 * d + 2 * m * d * d + 2 * att,
            4 * m * d + 8 * d * d + 24 * d)


def attn_inputs(n: int, gen: torch.Generator, s: int = SEQ, d: int = D):
    """x, gamma, beta, wqkv, bqkv, wout, bout, dy on the generator's
    device (``mega_variants.py:721-725``, ``:747-751``)."""
    dev = gen.device

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x = rand(n, s, d).bfloat16()
    wqkv = (rand(d, 3 * d) * d ** -0.5).bfloat16()
    wout = (rand(d, d) * d ** -0.5).bfloat16()
    dy = rand(n, s, d).bfloat16()
    zeros = torch.zeros(d, device=dev)
    return (x, torch.ones(d, device=dev), zeros, wqkv,
            torch.zeros(3 * d, device=dev), wout, zeros, dy)


def _sdpa(qkv: torch.Tensor, do: torch.Tensor):
    """(forward, backward) closures of SDPA on qkv's q, k, v views; the
    backward differentiates one saved forward with do."""
    q, k, v = _heads(qkv.detach().requires_grad_(), HEADS)
    dol = do.view(*do.shape[:2], HEADS, -1).transpose(1, 2)
    out = F.scaled_dot_product_attention(q, k, v)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v)

    return fwd, lambda: torch.autograd.grad(out, (q, k, v), dol,
                                            retain_graph=True)


def run(batch: int = BATCH, seed: int = 0, device: str = "cuda"
        ) -> List[Dict]:
    """Every forward and backward mode on ``device`` (a CPU device runs the
    plain versions; the tests use it for the control flow); one record per
    mode and one per shipped kernel."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x, g, b, wq, bq, wo, bo, dy = attn_inputs(batch, gen)
    params = (g, b, wq, bq, wo, bo)
    fwd_work = attn_work(batch, SEQ, D)
    bwd_work = attn_work(batch, SEQ, D, backward=True)
    qkv = AS.ln_qkv_plain(x, g, b, wq, bq)[-1]
    do = (dy.float() @ wo.float().T).bfloat16()
    sdpa_fwd, sdpa_bwd = _sdpa(qkv, do)

    ref = AS.attn_sched_plain(x, *params, HEADS)

    def shipped_fwd():
        return FB.ln_attention(x, *params, HEADS)

    records = []
    for mode in AS.MODES:
        def plain(mode=mode):
            return AS.attn_sched_plain(x, *params, HEADS, mode)

        def kern(mode=mode):
            return AS.attn_sched(x, *params, HEADS, mode)

        def fcore(mode=mode):
            return AS.attn_sched_core(qkv, HEADS, mode)

        err = ({"max_abs_err": None, "max_rel_err": None} if mode == "nosm"
               else errors((kern(),), (ref,)))
        rec = record("attn_fwd", mode, in_turns(
            plain=plain, kernel=kern, core=fcore, sdpa=sdpa_fwd), fwd_work,
            **err)
        rec.update(device_alone(device_in_turns(
            kernel=kern, core=fcore, shipped=shipped_fwd, sdpa=sdpa_fwd)))
        records.append(rec)
    rec = record(
        "attn_fwd", "ln_attention #1 (shipped)", in_turns(
            plain=lambda: AS.attn_sched_plain(x, *params, HEADS),
            kernel=shipped_fwd), fwd_work,
        **errors((shipped_fwd(),), (ref,)))
    rec.update(device_alone(device_in_turns(kernel=shipped_fwd)))
    records.append(rec)
    del ref
    (g1, b1, bq1, bo1), (wq1, wo1) = FB._cast(
        x.dtype, vectors=(g, b, bq, bo), matrices=(wq, wo))

    bparams = (g, b, wq, bq, wo)
    # #3 reads the forward launch's qkv and o (on the CPU it recomputes them)
    if x.is_cuda:
        _, qkv1, o1 = FB._ln_attention_cuda(x, g1, b1, wq1, bq1, wo1, bo1,
                                            HEADS)
    else:
        qkv1 = o1 = None

    def shipped():
        return FB.ln_attention_bwd(x, g1, b1, wq1, bq1, wo1, dy, HEADS,
                                   qkv1, o1)

    def bplain():
        return AS.attn_sched_bwd_plain(x, *bparams, dy, HEADS)

    refs = bplain()
    for mode in AS.BWD_MODES:
        def bkern(mode=mode):
            return AS.attn_sched_bwd(x, *bparams, dy, HEADS, mode)

        def core(mode=mode):
            return AS.attn_sched_bwd_core(qkv, do, HEADS, mode)

        rec = record("attn_bwd", mode, in_turns(
            plain=bplain, kernel=bkern, core=core, sdpa=sdpa_bwd), bwd_work,
            **errors(bkern(), refs))
        rec.update(device_alone(device_in_turns(
            kernel=bkern, core=core, shipped=shipped, sdpa=sdpa_bwd)))
        records.append(rec)
    rel = errors(shipped(), refs)["max_rel_err"]
    rec = record(
        "attn_bwd", "ln_attention_bwd #3 (shipped, reads #1's qkv and o, "
        "recomputes neither)", in_turns(plain=bplain, kernel=shipped),
        bwd_work, max_abs_err=None, max_rel_err=rel)
    rec.update(device_alone(device_in_turns(kernel=shipped)))
    records.append(rec)
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=BATCH)
    args = parser.parse_args(argv)
    smi = require_cuda("attn_probe")
    device = torch.cuda.get_device_name(0)
    for rec in run(args.batch):
        print(json.dumps({**rec, "device": device, "nvidia_smi": smi}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
