"""The BatchNorm(+ReLU)-prologue GEMM probe on one CUDA card (counterpart of
``benchmarks/bn_gemm_probe.py``): at a ResNet50 bottleneck boundary the
forward computes ``relu(bn(x)) @ W``; run as two PyTorch ops, the
normalised map is written to device memory and read back before the GEMM.
``bn_relu_gemm`` (``ops/bn_gemm.py``, kernel #18) applies the folded
affine and the ReLU as it loads x, so x is read once and nothing else is
stored.

At batch 128 the stage-1 and stage-2 boundary shapes, ``[128*56*56, 256]
-> 64``, ``[128*28*28, 512] -> 128`` and ``[128*56*56, 64] -> 256``: the
kernel, its plain version and the two-op PyTorch version
``relu(x.float() * a + b).bfloat16() @ W`` (cuBLAS) timed in turns (plain,
kernel, two-op, two-op, kernel, plain) on CUDA events around each call,
then kernel and two-op again as device time alone (``kernel_device_ms``,
``two_op_device_ms``: calls queued behind a spin kernel, so the wrappers'
host time does not count), with the errors against the plain version. No
single PyTorch call computes the function, so the two-op version is the
yardstick.

Prints one JSON line per shape (and the card's name and power limit);
writes nothing. Needs a CUDA card; exits with code 2 without one.

  python -m vlp_tpu_torch.probes.bn_gemm_probe [--batch 128]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple

import torch

from vlp_tpu_torch.ops.bn_gemm import bn_relu_gemm, bn_relu_gemm_plain
from vlp_tpu_torch.probes._timing import (bound_ms, device_in_turns,
                                          in_turns, require_cuda)

BATCH = 128
# (label, side, C in, K out) of the bottleneck boundary GEMMs at 224
SHAPES = (("stage1_256to64", 56, 256, 64),
          ("stage2_512to128", 28, 512, 128),
          ("stage1_expand_64to256", 56, 64, 256))


def gemm_inputs(m: int, c: int, k: int, gen: torch.Generator):
    """x [m, c] ~ N(0, 1) bf16, a and b [1, c] ~ N(0, 1) fp32,
    w [c, k] ~ N(0, 0.05^2) bf16, on the generator's device (the
    reference's draws)."""
    dev = gen.device
    x = torch.randn(m, c, generator=gen, device=dev).bfloat16()
    a = torch.randn(1, c, generator=gen, device=dev)
    b = torch.randn(1, c, generator=gen, device=dev)
    w = (torch.randn(c, k, generator=gen, device=dev) * 0.05).bfloat16()
    return x, a, b, w


def two_op(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           w: torch.Tensor) -> torch.Tensor:
    """The unfused PyTorch version: the normalised map in bf16, then a
    bf16 matmul."""
    return torch.relu(x.float() * a + b).bfloat16() @ w


def gemm_work(m: int, c: int, k: int) -> Tuple[int, int]:
    """(operations, bytes) of one call: x, a, b, w read once, the output
    written once."""
    return 2 * m * c * k, 2 * m * c + 8 * c + 2 * c * k + 2 * m * k


def measure(label: str, hw: int, c: int, k: int, batch: int,
            gen: torch.Generator) -> Dict:
    m = batch * hw * hw
    x, a, b, w = gemm_inputs(m, c, k, gen)
    ref = bn_relu_gemm_plain(x, a, b, w).float()
    err = (bn_relu_gemm(x, a, b, w).float() - ref).abs().max().item()
    two_err = (two_op(x, a, b, w).float() - ref).abs().max().item()
    del ref
    t = in_turns(plain=lambda: bn_relu_gemm_plain(x, a, b, w),
                 kernel=lambda: bn_relu_gemm(x, a, b, w),
                 two_op=lambda: two_op(x, a, b, w))
    dev = device_in_turns(kernel=lambda: bn_relu_gemm(x, a, b, w),
                          two_op=lambda: two_op(x, a, b, w))
    flops, nbytes = gemm_work(m, c, k)
    return {"probe": "bn_relu_gemm", "shape": label, "batch": batch, "m": m,
            "c": c, "k": k, "kernel_ms": t["kernel"], "plain_ms": t["plain"],
            "two_op_ms": t["two_op"], "library_ms": None,
            "kernel_device_ms": dev["kernel"],
            "two_op_device_ms": dev["two_op"],
            "max_abs_err": err, "two_op_max_abs_err": two_err,
            "flops": flops, "bytes": nbytes, **bound_ms(flops, nbytes),
            "kernel_gb_per_s": nbytes / dev["kernel"] / 1e6,
            "two_op_vs_kernel": dev["two_op"] / dev["kernel"]}


def run(batch: int = BATCH, seed: int = 0, device: str = "cuda"
        ) -> List[Dict]:
    """Every shape on ``device`` (a CPU device runs the plain version; the
    tests use it for the control flow); one record per shape."""
    gen = torch.Generator(device=device).manual_seed(seed)
    records = []
    for label, hw, c, k in SHAPES:
        records.append(measure(label, hw, c, k, batch, gen))
        torch.cuda.empty_cache()
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=BATCH)
    args = parser.parse_args(argv)
    smi = require_cuda("bn_gemm_probe")
    device = torch.cuda.get_device_name(0)
    for rec in run(args.batch):
        print(json.dumps({**rec, "device": device, "nvidia_smi": smi}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
