"""Tile widths of the BN-prologue probe GEMM #18 (``bn_relu_gemm``,
``csrc/bn_relu_gemm.cu``) on one CUDA card.

#18 runs on 128 x BN tiles of the wgmma mainloop's register-A form
(``csrc/wgmma_gemm.cuh``'s ``launch_affine_relu<BN>``): the library builds
BN = 64 for K <= 64 and 128 above, so that at K = 256 two tiles of a row
block read x, the second time mostly from L2 (the fastest of the three
widths there). This script builds a small
library of its own from the same headers with ``launch_affine_relu`` at
64, 128 and 256 columns a tile (256: one block an SM, x read once), checks
that every width gives the same bits as the library's
``vlp_bn_relu_gemm`` (the K loop adds in one order whatever BN is), and
times 64 and each width up to K at the probe's three shapes at
``--batch`` (``probes/bn_gemm_probe.py``), as device time alone per call
(``probes/_timing.device_in_turns``: 20 calls queued behind a spin
kernel, the widths in turns, then reversed), beside the bound.
Prints one JSON line per shape and one with all of them and the card's
name and power limit (``nvidia-smi``). Exits with code 2 without a CUDA
device.

Usage:
    python scripts/bn_gemm_widths.py [--batch 128] [--output widths.json]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vlp_tpu_torch.ops import _build  # noqa: E402
from vlp_tpu_torch.ops._common import _stream  # noqa: E402
from vlp_tpu_torch.probes import bn_gemm_probe  # noqa: E402
from vlp_tpu_torch.probes._timing import (bound_ms,  # noqa: E402
                                          device_in_turns, require_cuda)

WIDTHS = (64, 128, 256)

SOURCE = r"""
#include "wgmma_gemm.cuh"

// out = bf16(relu(x a + b) @ w) as vlp_bn_relu_gemm computes it, at tile
// width bn (64, 128 or 256; any other returns cudaErrorInvalidValue)
extern "C" int bn_gemm_width(const void* x, const void* a, const void* b,
                             const void* w, void* out, int M, int C, int N,
                             int bn, void* stream) {
  using vlp::wg::bf16;
  using vlp::wg::launch_affine_relu;
  const bf16* xb = static_cast<const bf16*>(x);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64)
    return (int)launch_affine_relu<64>(xb, af, bf, wb, ob, M, C, N, st);
  if (bn == 128)
    return (int)launch_affine_relu<128>(xb, af, bf, wb, ob, M, C, N, st);
  if (bn == 256)
    return (int)launch_affine_relu<256>(xb, af, bf, wb, ob, M, C, N, st);
  return (int)cudaErrorInvalidValue;
}
"""


def _library():
    """The entry point above, built with the port's nvcc flags against
    ``vlp_tpu_torch/csrc``'s headers into ``build/bn_gemm_widths/``; also
    returns ptxas's report of the build."""
    out = _build.BUILD_DIR.parent / "bn_gemm_widths"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "bn_gemm_width.cu", out / "libbn_gemm_width.so"
    src.write_text(SOURCE)
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(_build.CSRC), str(src), "-o", str(lib)],
        capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.bn_gemm_width.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    dll.bn_gemm_width.restype = ctypes.c_int
    return dll, proc.stdout + proc.stderr


def widths_for(k: int):
    """The widths timed at K output columns: 64 and every width up to K."""
    return tuple(bn for bn in WIDTHS if bn <= max(k, 64))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=bn_gemm_probe.BATCH)
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    smi = require_cuda("bn_gemm_widths")
    lib = _build.load_library()
    widths, ptxas = _library()
    print("\n".join(line for line in ptxas.splitlines()
                    if "registers" in line or "spill" in line
                    or "Compiling entry" in line), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}
    for label, hw, c, k in bn_gemm_probe.SHAPES:
        m = args.batch * hw * hw
        x, a, b, w = bn_gemm_probe.gemm_inputs(m, c, k, gen)
        shipped = torch.empty(m, k, dtype=torch.bfloat16, device="cuda")
        _build.check(lib, lib.vlp_bn_relu_gemm(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
            shipped.data_ptr(), m, c, k, _stream()), "vlp_bn_relu_gemm")
        outs = {bn: torch.empty(m, k, dtype=torch.bfloat16, device="cuda")
                for bn in widths_for(k)}

        def launch(bn, out):
            err = widths.bn_gemm_width(x.data_ptr(), a.data_ptr(),
                                       b.data_ptr(), w.data_ptr(),
                                       out.data_ptr(), m, c, k, bn, _stream())
            _build.check(lib, err, f"bn_gemm_width {bn}")

        for bn, out in outs.items():
            launch(bn, out)
        torch.cuda.synchronize()
        for bn, out in outs.items():
            if not torch.equal(out, shipped):
                raise SystemExit(f"{label}: width {bn} differs from the "
                                 "library's vlp_bn_relu_gemm")
        ms = device_in_turns(**{str(bn): (lambda bn=bn, out=out: launch(
            bn, out)) for bn, out in outs.items()})
        flops, nbytes = bn_gemm_probe.gemm_work(m, c, k)
        bound = bound_ms(flops, nbytes)
        records[label] = {"m": m, "c": c, "k": k, "device_ms": ms,
                          "fastest": int(min(ms, key=ms.get)), **bound,
                          "share": {bn: bound["bound_ms"] / t
                                    for bn, t in ms.items()}}
        print(json.dumps({"shape": label, **records[label]}), flush=True)
        del x, a, b, w, shipped, outs
        torch.cuda.empty_cache()
    record = {"card": smi, "batch": args.batch, "shapes": records}
    print(json.dumps(record), flush=True)
    if args.output:
        Path(args.output).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
