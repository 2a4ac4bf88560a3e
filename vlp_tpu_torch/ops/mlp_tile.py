"""The MLP tile engine for Hopper: the half block's MLP with its hidden
activation kept on chip, forward and backward, and the matmul chain it is
built from (counterparts of the probe kernels
``benchmarks/mega_variants.py:make_mlp`` (#13), ``:make_mlp_bwd`` (#14)
and ``benchmarks/mlp_probe.py:make_chain``/``make_single`` (#19)).

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

A CUDA tensor runs ``csrc/mlp_tile.cu`` (the forward, the chain and the
single product) or ``mlp_tile_bwd.cu`` (one engine, ``mlp_tile.cuh``) or
raises; a CPU tensor runs the ``*_plain`` version, which rounds where the Pallas bodies round. Each
wrapper counts its launches in ``<wrapper>.launches``.

Schedule knobs: ``tm`` rows per block and ``fs`` columns per F slice, the
counterparts of the TPU scripts' ``tm`` and ``parts``. The Mosaic bodies
splitN (fc1 in column slices so GELU overlaps the next product), rowpipe
(row sub-tiles interleaved) and the production backward's fsplit order
the same sums for one in-order core; warps interleave on their own, so
here each is a tiling of the on-chip h: ``fs`` < F is the F-slice walk
that splitN and fsplit make (h and dh never leave the block), and
``tm`` 32 against 64 is the smaller row tile of rowpipe, each at two slice
widths. Forward instances ``TILES``, backward ``BWD_TILES`` (TM 64 with
FS 128 does not fit the backward's shared memory).
"""
from __future__ import annotations

from typing import Sequence

import torch

from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops._common import (_acc, _cuda_operands, _mm, _route,
                                       _stream, gelu_grad)
from vlp_tpu_torch.ops._common import gelu as _gelu
from vlp_tpu_torch.ops.fused_block import _EPS, _ln_bwd_dx, _ln_fwd

TILES = ((64, 64), (64, 128), (32, 64), (32, 128))
BWD_TILES = ((64, 64), (32, 64), (32, 128))
MAX_D = 384
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


def _check_shapes(name, x, w1, w2, tm, fs, tiles, vectors=()):
    """ValueError on what the kernel does not take, whatever the device:
    x [M, D], w1 [D, F], w2 [F, D] (None for the single product), D a
    multiple of 64 up to 384, F a multiple of fs, (tm, fs) an instance;
    ``vectors`` are (tensor, length) pairs."""
    if x.dim() != 2 or w1.dim() != 2 or w1.shape[0] != x.shape[1] or (
            w2 is not None and tuple(w2.shape) != (w1.shape[1], x.shape[1])):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w1 {tuple(w1.shape)}"
                         + ("" if w2 is None else f", w2 {tuple(w2.shape)}")
                         + " are not [M, D], [D, F], [F, D]")
    d, f = w1.shape
    for v, n in vectors:
        if v.numel() != n:
            raise ValueError(f"{name}: a vector of {v.numel()} elements "
                             f"where {n} are needed")
    if (tm, fs) not in tiles:
        raise ValueError(f"{name}: (tm, fs) = ({tm}, {fs}) is not one of the "
                         f"kernel's instances {tiles}")
    if d % 64 or d > MAX_D or f % fs:
        raise ValueError(f"{name}: the kernel takes D a multiple of 64 up to "
                         f"{MAX_D} and F a multiple of fs = {fs}; got D={d}, "
                         f"F={f}")


def mlp_tile(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor, *, ln: bool = True, gelu: bool = True,
             tm: int = 64, fs: int = 64) -> torch.Tensor:
    """x [M, D] -> y [M, D] in x's dtype; ``ln``/``gelu`` False are the
    probe's ablation bounds (not both)."""
    d = x.shape[-1]
    _check_shapes("mlp_tile", x, w1, w2, tm, fs, TILES,
                  ((gamma, d), (beta, d), (b1, w1.shape[-1]), (b2, d)))
    if not (ln or gelu):
        raise ValueError("mlp_tile: the kernel takes LN or GELU off, not "
                         "both")
    if not _route("mlp_tile", x):
        return mlp_tile_plain(x, gamma, beta, w1, b1, w2, b2, ln=ln,
                              gelu=gelu)
    vecs = _cuda_operands("mlp_tile", x, (w1, w2), (gamma, beta, b1, b2))
    y = _tile_cuda("mlp_tile", x, w1, w2, vecs, ln=ln, gelu=gelu, tm=tm,
                   fs=fs)
    mlp_tile.launches += 1
    return y


def mlp_tile_bwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 dy: torch.Tensor, *, tm: int = 64, fs: int = 64):
    """Backward of ``mlp_tile``: (dx, dgamma, dbeta, dw1, db1, dw2, db2),
    dx in x's dtype, the rest fp32 (vectors ``[1, n]``)."""
    d = x.shape[-1]
    f = w1.shape[-1]
    _check_shapes("mlp_tile_bwd", x, w1, w2, tm, fs, BWD_TILES,
                  ((gamma, d), (beta, d), (b1, f)))
    if dy.shape != x.shape:
        raise ValueError("mlp_tile_bwd: dy does not match x")
    if not _route("mlp_tile_bwd", x):
        return mlp_tile_bwd_plain(x, gamma, beta, w1, b1, w2, dy)
    gamma, beta, b1 = _cuda_operands("mlp_tile_bwd", x, (w1, w2, dy),
                                     (gamma, beta, b1))
    m = x.shape[0]
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


def _tile_cuda(name, x, w1, w2, vecs, *, ln, gelu, tm, fs):
    """One launch of ``vlp_mlp_tile``: with ``vecs`` = (gamma, beta, b1, b2)
    the forward with bias and residual, with ``vecs`` None the chain (its
    LayerNorm affine-free) or, ``w2`` None, the single product."""
    (m, d), f = x.shape, w1.shape[1]
    gamma, beta, b1, b2 = (v.data_ptr() for v in vecs) if vecs else (0,) * 4
    lib = _build.load_library()
    out = torch.empty((m, d if w2 is not None else f), dtype=x.dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = lib.vlp_mlp_tile(
            x.data_ptr(), gamma, beta, w1.data_ptr(), b1,
            0 if w2 is None else w2.data_ptr(), b2, out.data_ptr(), m, d, f,
            tm, fs, int(ln), int(gelu), int(bool(vecs)), int(w2 is not None),
            _EPS, _stream())
    _build.check(lib, err, name)
    return out


def mlp_chain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              stages: Sequence[str] = (), *, tm: int = 64,
              fs: int = 64) -> torch.Tensor:
    """x [M, D] -> bf16(bf16(g(x' @ w1)) @ w2) [M, D]; ``stages`` one of
    ``CHAIN_STAGES``."""
    _check_shapes("mlp_chain", x, w1, w2, tm, fs, TILES)
    if tuple(stages) not in CHAIN_STAGES:
        raise ValueError(f"mlp_chain: stages {tuple(stages)} not one of "
                         f"{CHAIN_STAGES}")
    if not _route("mlp_chain", x):
        return mlp_chain_plain(x, w1, w2, stages)
    _cuda_operands("mlp_chain", x, (w1, w2), ())
    out = _tile_cuda("mlp_chain", x, w1, w2, None, ln="ln" in stages,
                     gelu="gelu" in stages, tm=tm, fs=fs)
    mlp_chain.launches += 1
    return out


def mlp_single(x: torch.Tensor, w1: torch.Tensor, *, tm: int = 64,
               fs: int = 64) -> torch.Tensor:
    """x [M, D] -> bf16(x @ w1) [M, F]."""
    _check_shapes("mlp_single", x, w1, None, tm, fs, TILES)
    if not _route("mlp_single", x):
        return mlp_single_plain(x, w1)
    _cuda_operands("mlp_single", x, (w1,), ())
    out = _tile_cuda("mlp_single", x, w1, None, None, ln=False, gelu=False,
                     tm=tm, fs=fs)
    mlp_single.launches += 1
    return out


mlp_tile.launches = 0
mlp_tile_bwd.launches = 0
mlp_chain.launches = 0
mlp_single.launches = 0

KERNELS = (mlp_tile, mlp_tile_bwd, mlp_chain, mlp_single)
