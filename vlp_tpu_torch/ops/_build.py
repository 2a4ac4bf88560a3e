"""Builds the CUDA kernels in ``vlp_tpu_torch/csrc`` at first use.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``) into one shared
library with a plain C interface under ``build/vlp_tpu_torch/`` at the root
of the checkout, and ``ctypes`` loads it. The library's file name carries a
hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused. Nothing here runs at import time; a failed build
raises with nvcc's output, and there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vlp_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu's exported functions: (argtypes, restype)
_SIGNATURES = {
    # x, gamma, beta, wqkv, bqkv, wout, bout, qkv, o, y, N, S, D, H, scale,
    # eps, stream
    "vlp_ln_attention": ([_P] * 10 + [_I] * 4 + [_F, _F, _P], _I),
    # x, gamma, beta, w1, b1, w2, b2, h, y, M, D, F, eps, stream
    "vlp_ln_mlp": ([_P] * 9 + [_I] * 3 + [_F, _P], _I),
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


def build() -> Path:
    """Compiles the library unless this version of the sources is built."""
    path = library_path()
    if path.exists():
        return path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
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
