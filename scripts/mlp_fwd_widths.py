"""Tile widths of the dense products with an epilogue (``csrc/dense_epi.cuh``)
on one CUDA card: the MLP forwards' two (#2 ``ln_mlp``, #9 ``fused_mlp``)
and the half-block attention forwards' two (#1 ``ln_attention``, #5
``ln_attention_windows``).

Each product runs on 128 x BN tiles of the wgmma mainloop, at the width its
sequence ships: fc1 at BN = 128 and fc2 at 64 (``csrc/mlp_fwd.cuh``'s
``kFc1Width``, ``kFc2Width``), qkv and the out-projection at
``csrc/ln_attention.cuh``'s ``kQkvWidth``, ``kOutWidth``; the library builds
only those instances. This script builds a small library of its own from
the same headers with ``launch_dense_epi`` at both widths for both
epilogues (``mlp_gemm_width``), and times each width for each form at
NesT-Small's three levels at batch 64 (M = 64 * 56^2, 64 * 28^2 and 64 *
14^2 rows; D 96, 192, 384; F = 4D):

  fc1       h = bf16(gelu(ln @ W1 + b1)), N = F, K = D
  fc2_res   y = bf16(x + (h @ W2 + b2)), N = D, K = F   (#2)
  fc2       y = bf16(h @ W2 + b2)                        (#9)
  qkv       qkv = bf16(ln @ Wqkv + bqkv), N = 3D, K = D  (#1, #5)
  out_res   y = bf16(x + (o @ Wout + bout)), N = D, K = D  (#1, #5)

as device time alone per call (``probes/_timing.device_in_turns``: 20 calls
queued behind a spin kernel, the widths in turns, then reversed), checks
that every width gives the same bits as the library's ``vlp_mlp_gemm``
(the K loop adds in one order whatever BN is), and weights each level by
its blocks per NesT-Small step (2, 2, 20). Prints one JSON line with the
times, the fastest width of each form and level, the step totals of the
shipped widths and of the fastest, and the card's name and power limit
(``nvidia-smi``). Exits with code 2 without a CUDA device.

Usage:
    python scripts/mlp_fwd_widths.py [--output widths.json]
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
from vlp_tpu_torch.probes._timing import (device_in_turns,  # noqa: E402
                                          require_cuda)

# (rows at batch 64, D, blocks per NesT-Small step); F = 4D
LEVELS = ((64 * 56 * 56, 96, 2), (64 * 28 * 28, 192, 2),
          (64 * 14 * 14, 384, 20))
WIDTHS = (64, 128)
# form -> (N / D, K / D, GELU, whether it adds the residual x, the shipped
# width: csrc/mlp_fwd.cuh's kFc1Width, kFc2Width, csrc/ln_attention.cuh's
# kQkvWidth, kOutWidth)
FORMS = {"fc1": (4, 1, True, False, 128), "fc2_res": (1, 4, False, True, 64),
         "fc2": (1, 4, False, False, 64), "qkv": (3, 1, False, False, 64),
         "out_res": (1, 1, False, True, 64)}

SOURCE = r"""
#include "dense_epi.cuh"

// out = the epilogue of a @ w as vlp_mlp_gemm computes it, at tile width
// bn (64 or 128; any other returns cudaErrorInvalidValue)
extern "C" int mlp_gemm_width(const void* a, const void* w, const void* bias,
                              const void* res, void* out, int M, int N, int K,
                              int gelu, int bn, void* stream) {
  using vlp::wg::bf16;
  using vlp::wg::launch_dense_epi;
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* wb = static_cast<const bf16*>(w);
  const float* bb = static_cast<const float*>(bias);
  const bf16* rb = static_cast<const bf16*>(res);
  bf16* ob = static_cast<bf16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64)
    return (int)(gelu ? launch_dense_epi<true, 64>(ab, wb, bb, nullptr, ob, M,
                                                   N, K, st)
                      : launch_dense_epi<false, 64>(ab, wb, bb, rb, ob, M, N,
                                                    K, st));
  if (bn == 128)
    return (int)(gelu ? launch_dense_epi<true, 128>(ab, wb, bb, nullptr, ob,
                                                    M, N, K, st)
                      : launch_dense_epi<false, 128>(ab, wb, bb, rb, ob, M, N,
                                                     K, st));
  return (int)cudaErrorInvalidValue;
}
"""


def _library():
    """The entry point above, built with the port's nvcc flags against
    ``vlp_tpu_torch/csrc``'s headers into ``build/mlp_fwd_widths/``."""
    out = _build.BUILD_DIR.parent / "mlp_fwd_widths"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "mlp_gemm_width.cu", out / "libmlp_gemm_width.so"
    src.write_text(SOURCE)
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(_build.CSRC), str(src), "-o", str(lib)],
        capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.mlp_gemm_width.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    dll.mlp_gemm_width.restype = ctypes.c_int
    return dll


def _launch(fn, lib, a, w, bias, res, out, gelu, *bn):
    """One product through ``fn`` (the library's ``vlp_mlp_gemm``, or
    ``mlp_gemm_width`` with its width ``bn``); errors named through the
    library's ``vlp_error_string``."""
    m, k = a.shape
    n = w.shape[1]
    err = fn(a.data_ptr(), w.data_ptr(), bias.data_ptr(),
             0 if res is None else res.data_ptr(), out.data_ptr(), m, n, k,
             int(gelu), *bn, _stream())
    _build.check(lib, err, f"mlp_gemm gelu {gelu} bn {bn}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    smi = require_cuda("mlp_fwd_widths")
    lib = _build.load_library()
    widths = _library().mlp_gemm_width
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    times, fastest, picked_total, fastest_total = {}, {}, {}, {}
    for level, (m, d, blocks) in enumerate(LEVELS):
        x = rand(m, d).bfloat16()
        for form, (n_of, k_of, gelu, residual, pick) in FORMS.items():
            n, k = n_of * d, k_of * d
            a = rand(m, k).bfloat16()
            w = rand(k, n, scale=k ** -0.5).bfloat16()
            bias = rand(n, scale=0.5)
            res = x if residual else None
            shipped = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
            _launch(lib.vlp_mlp_gemm, lib, a, w, bias, res, shipped, gelu)
            outs = {bn: torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
                    for bn in WIDTHS}
            for bn, out in outs.items():
                _launch(widths, lib, a, w, bias, res, out, gelu, bn)
            torch.cuda.synchronize()
            for bn, out in outs.items():
                if not torch.equal(out, shipped):
                    raise SystemExit(f"{form} D={d}: width {bn} differs from "
                                     "the library's vlp_mlp_gemm")
            ms = device_in_turns(**{
                str(bn): (lambda bn=bn, out=outs[bn]: _launch(
                    widths, lib, a, w, bias, res, out, gelu, bn))
                for bn in WIDTHS})
            key = f"nest_l{level}_{form}"
            times[key] = ms
            best = min(ms, key=ms.get)
            fastest[key] = int(best)
            picked_total[form] = picked_total.get(form, 0.0) + \
                blocks * ms[str(pick)]
            fastest_total[form] = fastest_total.get(form, 0.0) + \
                blocks * ms[best]
            print(f"{key} M={m} N={n} K={k}: " + ", ".join(
                f"BN {bn} {t:.4f} ms" for bn, t in ms.items()) +
                f" (shipped {pick})", flush=True)
            del outs, shipped, a
        del x
        torch.cuda.empty_cache()
    record = {"card": smi, "device_ms_per_call": times, "fastest": fastest,
              "step_ms_shipped": picked_total,
              "step_ms_fastest": fastest_total}
    print(json.dumps(record), flush=True)
    if args.output:
        Path(args.output).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
