"""Builds the CUDA kernels in ``vlp_tpu_torch/csrc`` at first use.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into one shared
library with a plain C interface under ``build/vlp_tpu_torch/`` at the root
of the checkout, which ``ctypes`` loads. The library's file name carries a
hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused. ptxas reports each kernel's registers and spills
(``-Xptxas -v``) into a log beside the library (``build_log``). Nothing
here runs at import time; a failed build raises with nvcc's output, and
there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vlp_tpu_torch"
# -fno-gnu-unique: the launchers' function-local statics (each kernel's
# "shared memory attribute set" flag) stay this library's own. As
# STB_GNU_UNIQUE symbols the dynamic linker would bind them to another
# loaded build's copies (scripts/ab_attention.py loads a parent checkout's
# library beside this one), and a library whose flag another had set
# launched without its attribute and failed with an invalid argument.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xcompiler", "-fno-gnu-unique",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_Z = ctypes.c_size_t
# C signatures of csrc/*.cu's exported functions: (argtypes, restype)
_SIGNATURES = {
    # x, gamma, beta, wqkv, bqkv, wout, bout, qkv, o, y, N, S, D, H, scale,
    # eps, stream
    "vlp_ln_attention": ([_P] * 10 + [_I] * 4 + [_F, _F, _P], _I),
    # x, gamma, beta, w1, b1, w2, b2, ln, h, y, M, D, F, eps, stream
    "vlp_ln_mlp": ([_P] * 10 + [_I] * 3 + [_F, _P], _I),
    # N, S, D, H -> bytes
    "vlp_ln_attention_bwd_workspace": ([_I] * 4, _Z),
    # x, gamma, beta, wqkv, wout, qkv, o, dy, dx, dgamma, dbeta, dwqkv,
    # dbqkv, dwout, dbout, ws, N, S, D, H, scale, eps, stream
    "vlp_ln_attention_bwd": ([_P] * 16 + [_I] * 4 + [_F, _F, _P], _I),
    # a, b, out, M, N, K, form, fp32, splits, stream
    "vlp_attn_bwd_gemm": ([_P] * 3 + [_I] * 6 + [_P], _I),
    # M, N, K -> split count
    "vlp_attn_bwd_splits": ([_I] * 3, _I),
    # x, gamma, beta, wqkv, bqkv, wout, bout, qkv, o, y, B, H, W, D, heads,
    # block, scale, eps, stream
    "vlp_ln_attention_windows": ([_P] * 10 + [_I] * 6 + [_F, _F, _P], _I),
    # x, gamma, beta, wqkv, wout, qkv, o, dy, dx, dgamma, dbeta, dwqkv,
    # dbqkv, dwout, dbout, ws, B, H, W, D, heads, block, scale, eps, stream
    "vlp_ln_attention_windows_bwd": ([_P] * 16 + [_I] * 6 + [_F, _F, _P],
                                     _I),
    # M, D, F -> bytes
    "vlp_ln_mlp_bwd_workspace": ([_I] * 3, _Z),
    # x, gamma, beta, w1, b1, w2, dy, dx, dgamma, dbeta, dw1, db1, dw2, db2,
    # ws, M, D, F, eps, stream
    "vlp_ln_mlp_bwd": ([_P] * 15 + [_I] * 3 + [_F, _P], _I),
    # qkv, o, N, S, D, H, scale, stream
    "vlp_attend_qkv": ([_P] * 2 + [_I] * 4 + [_F, _P], _I),
    # qkv, dout, dqkv, N, S, D, H, scale, stream
    "vlp_attend_qkv_bwd": ([_P] * 3 + [_I] * 4 + [_F, _P], _I),
    # qkv, dout, dqkv, check, bad, N, S, D, H, scale, stream
    "vlp_attend_qkv_bwd_checked": ([_P] * 5 + [_I] * 4 + [_F, _P], _I),
    # x, w1, b1, w2, b2, h, y, M, D, F, stream
    "vlp_fused_mlp": ([_P] * 7 + [_I] * 3 + [_P], _I),
    # a, w, bias, res, out, M, N, K, gelu, stream
    "vlp_mlp_gemm": ([_P] * 5 + [_I] * 4 + [_P], _I),
    # M, D, F -> bytes
    "vlp_fused_mlp_bwd_workspace": ([_I] * 3, _Z),
    # x, w1, b1, w2, dy, dx, dw1, db1, dw2, db2, ws, M, D, F, stream
    "vlp_fused_mlp_bwd": ([_P] * 11 + [_I] * 3 + [_P], _I),
    # a, w1, b1, dy, w2, h, dh, colsum, M, D, F, stream
    "vlp_mlp_dual": ([_P] * 8 + [_I] * 3 + [_P], _I),
    # img, shift, out, B, H, W, max_shift, axis, stream
    "vlp_shear_rows": ([_P] * 3 + [_I] * 5 + [_P], _I),
    # x, seeds, sigma, out, B, H, W, stream
    "vlp_add_gaussian_noise": ([_P] * 4 + [_I] * 3 + [_P], _I),
    # ctr, key, out, n, stream
    "vlp_philox4x32": ([_P] * 3 + [_I, _P], _I),
    # x, wt, y, B, H, W, C, K, stream
    "vlp_conv3x3": ([_P] * 3 + [_I] * 5 + [_P], _I),
    # x, w, z, M, K, N, stream
    "vlp_gemm_single": ([_P] * 3 + [_I] * 3 + [_P], _I),
    # x, a, b, w, out, M, C, K, stream
    "vlp_bn_relu_gemm": ([_P] * 5 + [_I] * 3 + [_P], _I),
    # x, gamma, beta, w1, b1, w2, b2, ln, h, y, M, D, F, tm, fs, ln_on,
    # gelu, residual, eps, stream
    "vlp_mlp_tile": ([_P] * 10 + [_I] * 8 + [_F, _P], _I),
    # M, D, F, tm -> bytes
    "vlp_mlp_tile_bwd_workspace": ([_I] * 4, _Z),
    # x, gamma, beta, w1, b1, w2, dy, dx, dgamma, dbeta, dw1, db1, dw2, db2,
    # ws, M, D, F, tm, fs, eps, stream
    "vlp_mlp_tile_bwd": ([_P] * 15 + [_I] * 5 + [_F, _P], _I),
    # x, gamma, beta, wqkv, bqkv, wout, bout, qkv, o, y, N, S, D, H, scale,
    # eps, mode, stream
    "vlp_attn_sched": ([_P] * 10 + [_I] * 4 + [_F, _F, _I, _P], _I),
    # qkv, o, N, S, D, H, scale, mode, stream
    "vlp_attn_sched_core": ([_P] * 2 + [_I] * 4 + [_F, _I, _P], _I),
    # S, mode -> bytes of shared memory a block of the core takes
    "vlp_attn_sched_core_smem": ([_I] * 2, _Z),
    # N, S, D, H, mode -> bytes
    "vlp_attn_sched_bwd_workspace": ([_I] * 5, _Z),
    # x, gamma, beta, wqkv, bqkv, wout, dy, dx, dgamma, dbeta, dwqkv, dbqkv,
    # dwout, dbout, ws, N, S, D, H, scale, eps, mode, stream
    "vlp_attn_sched_bwd": ([_P] * 15 + [_I] * 4 + [_F, _F, _I, _P], _I),
    # N, S, H, mode -> bytes
    "vlp_attn_sched_bwd_core_workspace": ([_I] * 4, _Z),
    # qkv, dout, o, dqkv, ws, N, S, D, H, scale, mode, stream
    "vlp_attn_sched_bwd_core": ([_P] * 5 + [_I] * 4 + [_F, _I, _P], _I),
    "vlp_error_string": ([_I], ctypes.c_char_p),
}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (``CUDA_HOME`` defaults to /usr/local/cuda),
    else the ``nvcc`` on ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found in $CUDA_HOME/bin or on PATH: the vlp_tpu_torch CUDA "
        "kernels are compiled from vlp_tpu_torch/csrc at first use and need "
        "the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvlp_tpu_torch_{digest.hexdigest()[:16]}.so"


def build_log() -> Path:
    """ptxas's report (``-Xptxas -v``) of the library's build, one section
    per source: each kernel's registers, stack frame and spill bytes."""
    return library_path().with_suffix(".log")


def build() -> Path:
    """Compiles the library unless this version of the sources is built."""
    path = library_path()
    if path.exists():
        return path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmpdir, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed, log = [], []
        for cmd, _, proc in jobs:  # wait for every job, even after a failure
            out, _ = proc.communicate()
            log.append(f"== {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed with exit code {proc.returncode}: "
                              f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(tmpdir, path.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
               *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}: "
                f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
        Path(tmp).with_suffix(".log").write_text("\n".join(log))
        os.replace(Path(tmp).with_suffix(".log"), build_log())
        os.replace(tmp, path)  # atomic: a loader never sees half a file
    return path


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raises if a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        msg = lib.vlp_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err} "
                           f"({msg})")
