"""The conv probe on one CUDA card (counterpart of
``benchmarks/conv_probe.py``), two questions at ResNet34's shapes:

1. ``conv3x3``: the hand-written implicit-GEMM 3x3 convolution
   (``ops/conv3x3.py``, kernel #17) at the stage-2 and stage-3 shapes,
   ``[128, 28, 28, 128]`` and ``[128, 14, 14, 256]`` bf16, beside its plain
   version and ``F.conv2d`` (cuDNN, channels-last bf16, the call the
   ResNets make), timed in turns (plain, kernel, cuDNN, cuDNN, kernel,
   plain) on CUDA events around each call, then kernel and cuDNN again as
   device time alone (``kernel_device_ms``, ``library_device_ms``: calls
   queued behind a spin kernel, so the wrappers' host time does not count),
   with its error against the plain version.
2. ``stem_maxpool``: the gradient of the stem max pool (3x3/2, pad 1, on a
   ReLU'd ``[128, 112, 112, 64]`` bf16 map, where zeros tie) through
   ``F.max_pool2d``'s backward, which gives a window's gradient to its first
   maximum, against the equality-split backward (``MaxPoolEqSplit``), which
   splits it over the tied maxima; their times and gradient sums. Plain
   PyTorch on both sides, as the reference's two halves are plain XLA.

Prints one JSON line per shape (and the card's name and power limit);
writes nothing. Needs a CUDA card; exits with code 2 without one.

  python -m vlp_tpu_torch.probes.conv_probe [--batch 128]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from vlp_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
from vlp_tpu_torch.probes._timing import (bound_ms, device_in_turns,
                                          in_turns, require_cuda)

BATCH = 128
# (label, side, channels) of ResNet34's stage-2 and stage-3 3x3 convs at 224
SHAPES = (("stage2_28x128", 28, 128), ("stage3_14x256", 14, 256))
# the stem max pool's input at 224: side and channels
STEM = (112, 64)


def conv_inputs(batch: int, hw: int, c: int, gen: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [batch, hw, hw, c] ~ N(0, 1) and w [3, 3, c, c] ~ N(0, 1/(9c)),
    bf16, on the generator's device (the reference's draws)."""
    dev = gen.device
    x = torch.randn(batch, hw, hw, c, generator=gen, device=dev).bfloat16()
    w = (torch.randn(3, 3, c, c, generator=gen, device=dev)
         * (9 * c) ** -0.5).bfloat16()
    return x, w


def library_weight(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, C, K] -> the [K, C, 3, 3] weight of ``F.conv2d`` in the
    channels-last layout."""
    return w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)


def conv_library(x: torch.Tensor, w_cl: torch.Tensor) -> torch.Tensor:
    """One ``F.conv2d`` call (cuDNN on the card) on the NCHW view of the NHWC
    x; returns the NCHW view of a channels-last result."""
    return F.conv2d(x.permute(0, 3, 1, 2), w_cl, padding=1)


def conv_work(batch: int, hw: int, c: int, k: int) -> Tuple[int, int]:
    """(operations, bytes) of one call: x and w read once, y written once."""
    px = batch * hw * hw
    return 2 * px * 9 * c * k, 2 * (px * c + 9 * c * k + px * k)


def measure_conv(label: str, hw: int, c: int, batch: int,
                 gen: torch.Generator) -> Dict:
    x, w = conv_inputs(batch, hw, c, gen)
    w_cl = library_weight(w)
    ref = conv3x3_plain(x, w).float()
    err = (conv3x3(x, w).float() - ref).abs().max().item()
    lib = conv_library(x, w_cl).permute(0, 2, 3, 1).reshape(-1, c)
    lib_err = (lib.float() - ref).abs().max().item()
    del ref, lib
    t = in_turns(plain=lambda: conv3x3_plain(x, w),
                 kernel=lambda: conv3x3(x, w),
                 library=lambda: conv_library(x, w_cl))
    dev = device_in_turns(kernel=lambda: conv3x3(x, w),
                          library=lambda: conv_library(x, w_cl))
    flops, nbytes = conv_work(batch, hw, c, c)
    return {"probe": "conv3x3", "shape": label, "batch": batch, "hw": hw,
            "c": c, "k": c, "kernel_ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t["library"], "kernel_device_ms": dev["kernel"],
            "library_device_ms": dev["library"], "max_abs_err": err,
            "library_max_abs_err": lib_err, "flops": flops, "bytes": nbytes,
            **bound_ms(flops, nbytes),
            "kernel_tflops": flops / dev["kernel"] / 1e9,
            "library_tflops": flops / dev["library"] / 1e9}


def maxpool(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.max_pool(x, (3, 3), (2, 2), padding=((1, 1), (1, 1)))`` on
    NHWC x (-inf padding)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2,
                        padding=1).permute(0, 2, 3, 1)


def _eqsplit_grad(x: torch.Tensor, y: torch.Tensor,
                  dy: torch.Tensor) -> torch.Tensor:
    """The reference's ``_mp_bwd``: for each of the 9 taps, the inputs under
    the stride-2 window grid compared with the window max; dy split evenly
    over the ties and added back tap by tap, in fp32."""
    b, h, w, c = x.shape
    oh, ow = y.shape[1], y.shape[2]
    x32, y32 = x.float(), y.float()
    dev = x.device
    taps = []
    for oy in range(3):
        for ox in range(3):
            rows = torch.arange(oh, device=dev) * 2 + oy - 1
            cols = torch.arange(ow, device=dev) * 2 + ox - 1
            inside = ((rows >= 0) & (rows < h))[:, None] \
                & ((cols >= 0) & (cols < w))[None, :]
            rs = rows.clamp(0, h - 1)[:, None]
            cs = cols.clamp(0, w - 1)[None, :]
            taps.append((rs, cs, (x32[:, rs, cs, :] == y32)
                         & inside[None, :, :, None]))
    tie = sum(eq.float() for _, _, eq in taps)
    share = dy.float() / tie.clamp(min=1.0)
    dx = torch.zeros(b, h, w, c, dtype=torch.float32, device=dev)
    bi = torch.arange(b, device=dev)[:, None, None]
    for rs, cs, eq in taps:
        dx.index_put_((bi, rs[None], cs[None]),
                      torch.where(eq, share, torch.zeros_like(share)),
                      accumulate=True)
    return dx.to(x.dtype)


class MaxPoolEqSplit(torch.autograd.Function):
    """``maxpool`` whose backward splits a window's gradient over its tied
    maxima (the reference's ``maxpool_eqsplit``); the gradient's sum equals
    ``F.max_pool2d``'s, its distribution over ties does not."""

    @staticmethod
    def forward(ctx, x):
        y = maxpool(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        return _eqsplit_grad(x, y, dy)


def maxpool_grads(x: torch.Tensor):
    """(first-max gradient, equality-split gradient) of
    sum(maxpool(x).float() ** 2), as two functions of no argument."""
    xg = x.detach().requires_grad_()

    def first_max():
        return torch.autograd.grad(
            (maxpool(xg).float() ** 2).sum(), xg)[0]

    def eqsplit():
        return torch.autograd.grad(
            (MaxPoolEqSplit.apply(xg).float() ** 2).sum(), xg)[0]

    return first_max, eqsplit


def measure_maxpool(batch: int, gen: torch.Generator) -> Dict:
    side, c = STEM
    x = torch.relu(torch.randn(batch, side, side, c, generator=gen,
                               device=gen.device)).bfloat16()
    first_max, eqsplit = maxpool_grads(x)
    g1, g2 = first_max(), eqsplit()
    sums = (g1.float().sum().item(), g2.float().sum().item())
    del g1, g2
    t = in_turns(first_max=first_max, eqsplit=eqsplit)
    return {"probe": "stem_maxpool", "shape": f"{side}x{side}x{c}",
            "batch": batch, "first_max_grad_ms": t["first_max"],
            "eqsplit_grad_ms": t["eqsplit"],
            "speedup": t["first_max"] / t["eqsplit"],
            "grad_sum_first_max": sums[0], "grad_sum_eqsplit": sums[1]}


def run(batch: int = BATCH, seed: int = 0, device: str = "cuda"
        ) -> List[Dict]:
    """Both questions on ``device`` (a CPU device runs the plain versions;
    the tests use it for the control flow); one record per shape."""
    gen = torch.Generator(device=device).manual_seed(seed)
    records = [measure_conv(label, hw, c, batch, gen)
               for label, hw, c in SHAPES]
    torch.cuda.empty_cache()
    records.append(measure_maxpool(batch, gen))
    torch.cuda.empty_cache()
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=BATCH)
    args = parser.parse_args(argv)
    smi = require_cuda("conv_probe")
    device = torch.cuda.get_device_name(0)
    for rec in run(args.batch):
        print(json.dumps({**rec, "device": device, "nvidia_smi": smi}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
