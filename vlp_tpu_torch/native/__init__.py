"""The C++ preprocessing route (``preprocess.cpp``) and its ctypes binding
(counterpart of ``vlp_tpu/native``).

The library is built at first use with ``g++`` (``$CXX`` where set) from
this directory's source under the JAX package's Makefile flags into
``build/vlp_tpu_torch/`` at the root of the checkout; its file name carries
a hash of the source, the compiler and the flags, as the CUDA kernels' does
(``ops/_build.py``), so an edited source builds anew and an unchanged one
is reused. A failed build raises with the compiler's output: there is no
quiet fallback to the NumPy path, which only ``use_native=False`` takes.
Nothing here runs at import time.
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
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vlp_tpu_torch"
# vlp_tpu/native/Makefile: CXXFLAGS, then -shared ... -lpthread
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
LINK_FLAGS = ("-lpthread",)

_U8P = ctypes.POINTER(ctypes.c_uint8)


def find_cxx() -> str:
    """``$CXX``, else the ``g++`` on ``PATH``."""
    name = os.environ.get("CXX", "g++")
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(
            f"C++ compiler {name!r} not found: the native preprocessing "
            "library is compiled from vlp_tpu_torch/native/preprocess.cpp at "
            "first use (use_native=False takes the NumPy path)")
    return path


def library_path(cxx: str) -> Path:
    digest = hashlib.sha256(" ".join((os.path.basename(cxx), *CXX_FLAGS,
                                      *LINK_FLAGS)).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvlp_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles the library unless this version of the source is built."""
    cxx = find_cxx()
    path = library_path(cxx)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, path.name)
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), *LINK_FLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(cxx)} failed with exit code "
                f"{proc.returncode}: {' '.join(cmd)}\n{proc.stderr}"
                f"{proc.stdout}")
        os.replace(tmp, path)  # atomic: a loader never sees half a file
    return path


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The native library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    lib.vlp_preprocess_image.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, _U8P]
    lib.vlp_preprocess_image.restype = None
    lib.vlp_preprocess_batch.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, _U8P,
        ctypes.c_int]
    lib.vlp_preprocess_batch.restype = None
    return lib


def _channels(c: int) -> None:
    # the C++ reads 1 channel, or R, G, B at a stride of c
    if c not in (1, 3, 4):
        raise ValueError(f"the native route takes 1, 3 or 4 channels, not "
                         f"{c}")


def preprocess_image_native(img: np.ndarray, out_size: int = 224,
                            crop: bool = False, max_crop_ratio: float = 0.05,
                            equalize: bool = True) -> np.ndarray:
    """HWC (or HW) uint8 -> [out_size, out_size] uint8."""
    lib = get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    _channels(c)
    out = np.empty((out_size, out_size), np.uint8)
    lib.vlp_preprocess_image(img.ctypes.data_as(_U8P), h, w, c, out_size,
                             int(crop), float(max_crop_ratio), int(equalize),
                             out.ctypes.data_as(_U8P))
    return out


def preprocess_batch_native(imgs: np.ndarray, out_size: int = 224,
                            crop: bool = False, max_crop_ratio: float = 0.05,
                            equalize: bool = True,
                            num_threads: Optional[int] = None) -> np.ndarray:
    """[N, H, W, C] uint8 (uniform shapes) -> [N, S, S] uint8 on a pool of
    ``num_threads`` threads (default: min(8, the host's cores))."""
    lib = get_lib()
    imgs = np.ascontiguousarray(imgs, np.uint8)
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    n, h, w, c = imgs.shape
    _channels(c)
    out = np.empty((n, out_size, out_size), np.uint8)
    threads = num_threads or min(8, os.cpu_count() or 1)
    lib.vlp_preprocess_batch(imgs.ctypes.data_as(_U8P), n, h, w, c, out_size,
                             int(crop), float(max_crop_ratio), int(equalize),
                             out.ctypes.data_as(_U8P), threads)
    return out
