"""The MLP probe kernels for Hopper: the half block's MLP, forward and
backward, and the matmul chain it is built from (counterparts of the probe
kernels ``benchmarks/mega_variants.py:make_mlp`` (#13), ``:make_mlp_bwd``
(#14) and ``benchmarks/mlp_probe.py:make_chain``/``make_single`` (#19)).

  mlp_tile:     y = bf16(x + (h @ W2 + b2)),
                h = bf16(gelu(bf16(LN(x) * gamma + beta) @ W1 + b1));
                ablations: ``gelu=False`` (h = bf16(z)), ``ln=False``
                (the first product reads x)
  mlp_tile_bwd: its backward at ``mlp_bwd_kernel_v0``'s rounding points
                (h = bf16(gelu(z)) and gelu'(z) apart, db1 from the fp32
                dh): dx bf16; dgamma, dbeta, dw1, db1, dw2, db2 all fp32
  mlp_chain:    y = bf16(bf16(g(x' @ W1)) @ W2), x' = bf16(x_hat) with
                "ln" in ``stages``, g = GELU with "gelu"; no bias, no
                residual
  mlp_single:   z = bf16(x @ W1)

x is ``[M, D]`` rows; w1 ``[D, F]`` and w2 ``[F, D]`` are ``[in, out]``;
gamma, beta, b1, b2 fp32. None lies on a model path (the JAX package runs
them only in its probe scripts); ``vlp_tpu_torch.probes.mega_probe`` and
``.mlp_probe`` time them beside the shipped ``ln_mlp`` (#2) and
``ln_mlp_bwd`` (#4) and cuBLAS.

A CUDA tensor runs ``csrc/mlp_tile.cu`` (the forward and the chain: the
shipped ``ln_mlp``'s (#2) launch sequence ``csrc/mlp_fwd.cuh``, ``ln_rows``
where there is a LayerNorm, then fc1 and fc2 as wgmma + TMA tiles with
their epilogues in registers, fc1's with the probes' accurate GELU),
``mlp_tile_bwd.cu`` (the shipped ``ln_mlp_bwd``'s (#4) launch sequence on
the same mainloop ``wgmma_gemm.cuh``, with the probe's GELU form and fp32
weight gradients) or, for the single product, ``csrc/gemm_single.cu``
(the same mainloop), or raises; a CPU tensor runs the ``*_plain``
version, which rounds where the Pallas bodies round. Each wrapper counts
its launches in ``<wrapper>.launches``.

Schedule knobs: ``tm`` rows and ``fs`` columns of [M, F] a tile, the
counterparts of the TPU scripts' ``tm`` and ``parts``. The Mosaic bodies
splitN (fc1 in column slices so GELU overlaps the next product), rowpipe
(row sub-tiles interleaved) and the production backward's fsplit order
the same sums for one in-order core; warps interleave on their own, so
here each is a tiling. Both sequences run 128-row tiles (``tm`` = 128:
two consumer warpgroups of 64, rowpipe's sub-tiles, interleaved by the
card), and ``fs`` is the width of the tile that forms h (or h and dh) over
F: Pallas's F / ``parts`` slices, each a block of its own rather than a
step of one core's loop (12 or 24 of them at F 1536); h goes through
device memory to the second product. Forward (``TILES``): fc1's tile at
128 columns (#2's width, the default) or 64 (the narrower F slice);
fc2's stays at #2's 64. Backward (``BWD_TILES``): the dual tile of
``csrc/mlp_bwd.cuh`` at 64 or 128 columns. The single product has one
instance (128 x 128 output tiles, two blocks an SM): tiles 64 and 256
columns wide were slower at the probe's shape.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops._common import (_acc, _cuda_operands, _mm, _route,
                                       _stream, gelu_grad)
from vlp_tpu_torch.ops._common import gelu as _gelu
from vlp_tpu_torch.ops.fused_block import _EPS, _ln_bwd_dx, _ln_fwd
from vlp_tpu_torch.ops.fused_mlp import check_aligned, check_bwd_operands

TILES = ((128, 128), (128, 64))
BWD_TILES = ((128, 64), (128, 128))
# the LayerNorm row passes (csrc/bwd_rows.cuh) keep a row in one warp's
# registers: D <= 1024, D % 32 == 0
MAX_D = 1024
# the chain's stages the kernel takes (those the TPU probe runs)
CHAIN_STAGES = ((), ("gelu",), ("ln", "gelu"))


def _vec(v: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    return v.reshape(1, -1).to(acc)


def mlp_tile_plain(x, gamma, beta, w1, b1, w2, b2, *, ln: bool = True,
                   gelu: bool = True) -> torch.Tensor:
    """``mlp_fwd_kernel_v0`` (``mega_variants.py:83``) in plain PyTorch."""
    dt, acc = x.dtype, _acc(x.dtype)
    x32 = x.to(acc)
    if ln:
        lnv = (_ln_fwd(x32)[0] * _vec(gamma, acc) + _vec(beta, acc)).to(dt)
    else:
        lnv = x32.to(dt)
    z = _mm(lnv, w1) + _vec(b1, acc)
    h = (_gelu(z) if gelu else z).to(dt)
    return (x32 + (_mm(h, w2) + _vec(b2, acc))).to(dt)


def mlp_tile_bwd_plain(x, gamma, beta, w1, b1, w2, dy):
    """``mlp_bwd_kernel_v0`` (``mega_variants.py:173``) in plain PyTorch:
    (dx, dgamma, dbeta, dw1, db1, dw2, db2), the parameter gradients fp32
    (``[1, n]`` vectors, ``[D, F]`` and ``[F, D]`` matrices)."""
    dt, acc = x.dtype, _acc(x.dtype)
    g = _vec(gamma, acc)
    x32 = x.to(acc)
    xh, inv = _ln_fwd(x32)
    lnv = (xh * g + _vec(beta, acc)).to(dt)
    z = _mm(lnv, w1) + _vec(b1, acc)
    h = _gelu(z).to(dt)
    dy32 = dy.to(acc)
    dyb = dy32.to(dt)
    dw2 = _mm(h.T, dyb)
    dh32 = _mm(dyb, w2.T) * gelu_grad(z)
    dh = dh32.to(dt)
    dw1 = _mm(lnv.T, dh)
    dln = _mm(dh, w1.T)
    dx = (dy32 + _ln_bwd_dx(dln * g, xh, inv)).to(dt)
    return (dx, (dln * xh).sum(0, keepdim=True), dln.sum(0, keepdim=True),
            dw1, dh32.sum(0, keepdim=True), dw2, dy32.sum(0, keepdim=True))


def mlp_chain_plain(x, w1, w2, stages: Sequence[str] = ()) -> torch.Tensor:
    """``chain_kernel`` (``mlp_probe.py:58``) in plain PyTorch."""
    dt = x.dtype
    if "ln" in stages:
        x = _ln_fwd(x.to(_acc(dt)))[0].to(dt)
    z = _mm(x, w1)
    if "gelu" in stages:
        z = _gelu(z)
    return _mm(z.to(dt), w2).to(dt)


def mlp_single_plain(x, w1) -> torch.Tensor:
    """``single_mm_kernel`` (``mlp_probe.py:86``): bf16(x @ w1)."""
    return _mm(x, w1).to(x.dtype)


def _check_shapes(name, x, w1, w2, tm, fs, tiles, vectors=(),
                  backward=False, ln=True):
    """ValueError on what the kernel does not take, whatever the device:
    x [M, D], w1 [D, F], w2 [F, D], (tm, fs) one of ``tiles``, and for the
    forward's sequence D a multiple of 32 up to ``MAX_D`` with a LayerNorm
    (``ln``; the row pass), of 8 without (the products' 16-byte rows) and F
    a multiple of 8, for the ``backward`` D and F multiples of 32, D up to
    ``MAX_D``; ``vectors`` are (tensor, length) pairs."""
    if x.dim() != 2 or w1.dim() != 2 or w1.shape[0] != x.shape[1] or (
            tuple(w2.shape) != (w1.shape[1], x.shape[1])):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w1 {tuple(w1.shape)}"
                         f", w2 {tuple(w2.shape)} are not [M, D], [D, F], "
                         "[F, D]")
    d, f = w1.shape
    for v, n in vectors:
        if v.numel() != n:
            raise ValueError(f"{name}: a vector of {v.numel()} elements "
                             f"where {n} are needed")
    if (tm, fs) not in tiles:
        raise ValueError(f"{name}: (tm, fs) = ({tm}, {fs}) is not one of the "
                         f"kernel's instances {tiles}")
    if backward:
        if d % 32 or f % 32 or d > MAX_D:
            raise ValueError(f"{name}: the kernel takes D and F multiples "
                             f"of 32 and D <= {MAX_D}; got D={d}, F={f}")
    elif (d % 32 or d > MAX_D if ln else d % 8) or f % 8:
        raise ValueError(f"{name}: the kernel takes D a multiple of 32 up to "
                         f"{MAX_D} with a LayerNorm, of 8 without, and F a "
                         f"multiple of 8; got D={d}, F={f}, LayerNorm "
                         f"{'on' if ln else 'off'}")


def mlp_tile(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor, *, ln: bool = True, gelu: bool = True,
             tm: int = 128, fs: int = 128) -> torch.Tensor:
    """x [M, D] -> y [M, D] in x's dtype; ``ln``/``gelu`` False are the
    probe's ablation bounds (not both). On the card also refuses x, w1 and
    w2 off 16-byte alignment (the products read them by TMA)."""
    d = x.shape[-1]
    _check_shapes("mlp_tile", x, w1, w2, tm, fs, TILES,
                  ((gamma, d), (beta, d), (b1, w1.shape[-1]), (b2, d)),
                  ln=ln)
    if not (ln or gelu):
        raise ValueError("mlp_tile: the kernel takes LN or GELU off, not "
                         "both")
    if not _route("mlp_tile", x):
        return mlp_tile_plain(x, gamma, beta, w1, b1, w2, b2, ln=ln,
                              gelu=gelu)
    vecs = _cuda_operands("mlp_tile", x, (w1, w2), (gamma, beta, b1, b2))
    y = _tile_cuda("mlp_tile", x, w1, w2, vecs, ln=ln, gelu=gelu,
                   residual=True, tm=tm, fs=fs)
    mlp_tile.launches += 1
    return y


def mlp_tile_bwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 dy: torch.Tensor, *, tm: int = 128, fs: int = 64):
    """Backward of ``mlp_tile``: (dx, dgamma, dbeta, dw1, db1, dw2, db2),
    dx in x's dtype, the rest fp32 (vectors ``[1, n]``). On the card also
    refuses operands off 16-byte alignment and more than 65535 blocks of
    256 rows (``fused_mlp.check_bwd_operands``)."""
    d = x.shape[-1]
    f = w1.shape[-1]
    _check_shapes("mlp_tile_bwd", x, w1, w2, tm, fs, BWD_TILES,
                  ((gamma, d), (beta, d), (b1, f)), backward=True)
    if dy.shape != x.shape:
        raise ValueError("mlp_tile_bwd: dy does not match x")
    if not _route("mlp_tile_bwd", x):
        return mlp_tile_bwd_plain(x, gamma, beta, w1, b1, w2, dy)
    gamma, beta, b1 = _cuda_operands("mlp_tile_bwd", x, (w1, w2, dy),
                                     (gamma, beta, b1))
    m = x.shape[0]
    check_bwd_operands("mlp_tile_bwd", m, x, dy, w1, w2)
    lib = _build.load_library()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dg, db, db2 = (torch.empty((1, d), **f32) for _ in range(3))
    db1 = torch.empty((1, f), **f32)
    dw1 = torch.empty((d, f), **f32)
    dw2 = torch.empty((f, d), **f32)
    ws = torch.empty(lib.vlp_mlp_tile_bwd_workspace(m, d, f, tm),
                     dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.vlp_mlp_tile_bwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dg.data_ptr(), db.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), ws.data_ptr(), m, d, f, tm, fs,
            _EPS, _stream())
    _build.check(lib, err, "mlp_tile_bwd")
    mlp_tile_bwd.launches += 1
    return dx, dg, db, dw1, db1, dw2, db2


@functools.lru_cache(maxsize=16)
def _filled(device: torch.device, n: int, value: float) -> torch.Tensor:
    """A fp32 [n] vector of ``value`` on ``device``, made once and only
    read: the chain's zero biases and its LayerNorm's unit gamma and zero
    beta, which leave z and x_hat as they are in fp32, so that the chain
    runs #2's pieces unchanged."""
    return torch.full((n,), value, dtype=torch.float32, device=device)


def _tile_cuda(name, x, w1, w2, vecs, *, ln, gelu, residual, tm, fs):
    """One call of ``vlp_mlp_tile`` (#2's launch sequence) on fp32
    ``vecs`` = (gamma, beta, b1, b2): ``ln_rows`` into an ln [M, D] scratch
    where ``ln``, fc1 (+ the accurate GELU where ``gelu``) into an h [M, F]
    scratch, fc2 (+ x where ``residual``) into y."""
    check_aligned(name, x, w1, w2)
    (m, d), f = x.shape, w1.shape[1]
    gamma, beta, b1, b2 = (v.data_ptr() for v in vecs)
    lib = _build.load_library()
    lnb = torch.empty_like(x) if ln else None
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.vlp_mlp_tile(
            x.data_ptr(), gamma, beta, w1.data_ptr(), b1, w2.data_ptr(), b2,
            lnb.data_ptr() if ln else 0, h.data_ptr(), y.data_ptr(), m, d, f,
            tm, fs, int(ln), int(gelu), int(residual), _EPS, _stream())
    _build.check(lib, err, name)
    return y


def mlp_chain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              stages: Sequence[str] = (), *, tm: int = 128,
              fs: int = 128) -> torch.Tensor:
    """x [M, D] -> bf16(bf16(g(x' @ w1)) @ w2) [M, D]; ``stages`` one of
    ``CHAIN_STAGES``. On the card also refuses x, w1 and w2 off 16-byte
    alignment."""
    if tuple(stages) not in CHAIN_STAGES:
        raise ValueError(f"mlp_chain: stages {tuple(stages)} not one of "
                         f"{CHAIN_STAGES}")
    ln = "ln" in stages
    _check_shapes("mlp_chain", x, w1, w2, tm, fs, TILES, ln=ln)
    if not _route("mlp_chain", x):
        return mlp_chain_plain(x, w1, w2, stages)
    _cuda_operands("mlp_chain", x, (w1, w2), ())
    d, f = w1.shape
    zeros = _filled(x.device, d, 0.0)
    vecs = (_filled(x.device, d, 1.0), zeros, _filled(x.device, f, 0.0),
            zeros)
    out = _tile_cuda("mlp_chain", x, w1, w2, vecs, ln=ln,
                     gelu="gelu" in stages, residual=False, tm=tm, fs=fs)
    mlp_chain.launches += 1
    return out


def mlp_single(x: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """x [M, D] -> bf16(x @ w1) [M, F] in x's dtype. Raises, whatever the
    device, unless x is [M, D] and w1 [D, F] with M >= 1 and D and F
    multiples of 8 (the 16-byte rows TMA reads)."""
    if x.dim() != 2 or w1.dim() != 2 or w1.shape[0] != x.shape[1]:
        raise ValueError(f"mlp_single: x {tuple(x.shape)} and w1 "
                         f"{tuple(w1.shape)} are not [M, D], [D, F]")
    (m, d), f = x.shape, w1.shape[1]
    if m == 0 or d == 0 or f == 0 or d % 8 or f % 8:
        raise ValueError(f"mlp_single: the kernel takes M >= 1 and D and F "
                         f"multiples of 8; got M={m}, D={d}, F={f}")
    if not _route("mlp_single", x):
        return mlp_single_plain(x, w1)
    _cuda_operands("mlp_single", x, (w1,), ())
    if (x.data_ptr() | w1.data_ptr()) % 16:
        raise ValueError("mlp_single: the kernel takes 16-byte aligned "
                         "operands")
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.vlp_gemm_single(x.data_ptr(), w1.data_ptr(), out.data_ptr(),
                                  m, d, f, _stream())
    _build.check(lib, err, "mlp_single")
    mlp_single.launches += 1
    return out


mlp_tile.launches = 0
mlp_tile_bwd.launches = 0
mlp_chain.launches = 0
mlp_single.launches = 0

KERNELS = (mlp_tile, mlp_tile_bwd, mlp_chain, mlp_single)
