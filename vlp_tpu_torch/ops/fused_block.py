"""Half-block kernels of the pre-LN transformer block, for Hopper, with
their backwards.

  ln_attention:         y = x + OutProj(MHSA(LN(x)))   x [N, S, D]
  ln_attention_windows: the same within each block x block window of a
                        NesT token map                  x [B, H, W, D]
  ln_mlp:               y = x + fc2(gelu(fc1(LN(x))))  x [M, D] rows

Counterparts of the Pallas kernels in ``vlp_tpu/ops/fused_block.py``
(``_lnattn_fwd``/``_lnattn_bwd``, ``_lnattn_nhwc_fwd``/``_lnattn_nhwc_bwd``
and ``_lnmlp_fwd``/``_lnmlp_bwd``). A CUDA
tensor runs the hand-written CUDA kernels of ``vlp_tpu_torch/csrc`` (built
at first use) or raises; a CPU tensor runs the plain PyTorch versions
(``*_plain``), which are also the reference the kernels are held to. All
round at the points the Pallas bodies round: LN in fp32 (two-pass variance,
eps 1e-6) cast to the activation dtype, products accumulated in fp32 with
the bias added before one cast, softmax in fp32 with the normalisation
deferred past the PV product, residual added in fp32. The backwards
recompute the LayerNorm and return the seven cotangents of the Pallas VJPs:
dx in the activation dtype, weight gradients accumulated in fp32 and cast
once to the weights' dtype, the rest fp32 ``[1, n]``.

Under autograd the public ``ln_attention``, ``ln_attention_windows`` and
``ln_mlp`` run as
``torch.autograd.Function``s whose backward is the backward kernel (CUDA)
or the plain backward (CPU; never autograd through the plain forward, since
the Pallas VJP's rounding is the reference). Weights are cast to the
activation dtype outside the Function, so their gradients come back
rounded to it and autograd's cast returns them to the fp32 parameters, as
JAX's cast VJP does. Without a gradient to record (serving under
``torch.inference_mode``) the forward runs as before, with no Function.

Each public wrapper counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops._common import (  # noqa: F401 (the gelu family:
    _acc, _cast, _check_cuda, _mm, _records_grad,  # this module's API)
    _route, _rows, _stream, gelu, gelu_and_grad, gelu_grad)
from vlp_tpu_torch.ops.block_attention import attend_qkv_plain, dqkv_f32
from vlp_tpu_torch.ops.fused_mlp import (check_aligned, check_bwd_operands,
                                         mlp_bwd_core)

_EPS = 1e-6


def _ln_fwd(x: torch.Tensor):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + _EPS)
    return xc * inv, inv  # x_hat, 1 / sigma


def _ln_bwd_dx(dxh, xh, inv):
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xh).mean(-1, keepdim=True)
    return inv * (dxh - m1 - xh * m2)


def ln_attention_plain_parts(x, gamma, beta, wqkv, bqkv, wout, bout,
                             num_heads: int):
    """Plain PyTorch ``ln_attention`` -> (y, qkv, o), rounded where the
    Pallas body rounds; qkv and o are what the CUDA forward also returns."""
    dt = x.dtype
    (gamma, beta, bqkv, bout), (wqkv, wout) = _cast(
        dt, vectors=(gamma, beta, bqkv, bout), matrices=(wqkv, wout))
    x32 = x.to(_acc(dt))
    ln = (_ln_fwd(x32)[0] * gamma + beta).to(dt)
    qkv = (_mm(ln, wqkv) + bqkv).to(dt)
    o = attend_qkv_plain(qkv, num_heads)
    return (x32 + (_mm(o, wout) + bout)).to(dt), qkv, o


def ln_attention_plain(x, gamma, beta, wqkv, bqkv, wout, bout,
                       num_heads: int) -> torch.Tensor:
    """Plain PyTorch ``ln_attention``; rounds where the Pallas body does."""
    return ln_attention_plain_parts(x, gamma, beta, wqkv, bqkv, wout, bout,
                                    num_heads)[0]


def ln_attention_bwd_plain(x, gamma, beta, wqkv, bqkv, wout, dy,
                           num_heads: int):
    """Plain backward of ``ln_attention``, the body
    ``_attn_block_bwd_rows_unified`` (``vlp_tpu/ops/fused_block.py:395``):
    ``pb = bf16(p)`` with p unnormalised, ``dov = bf16(doh / l)``,
    ``dsb = bf16(ds)``, ``dqkvb = bf16(dqkv)``, dbqkv summed from the fp32
    dqkv. Returns (dx, dgamma, dbeta, dwqkv, dbqkv, dwout, dbout)."""
    dt = x.dtype
    (gamma, beta, bqkv), (wqkv, wout) = _cast(
        dt, vectors=(gamma, beta, bqkv), matrices=(wqkv, wout))
    x32 = x.to(_acc(dt))
    xh, inv = _ln_fwd(x32)
    ln = (xh * gamma + beta).to(dt)
    qkv = (_mm(ln, wqkv) + bqkv).to(dt)
    dy32 = dy.to(_acc(dt))
    dyb = dy32.to(dt)
    o = attend_qkv_plain(qkv, num_heads)
    dwout = _mm(_rows(o).T, _rows(dyb))
    dbout = _rows(dy32).sum(0, keepdim=True)
    do = _mm(dyb, wout.T)                                    # [n, s, d]
    dqkv = dqkv_f32(qkv, do.to(dt), num_heads)
    dqkvb = dqkv.to(dt)
    dwqkv = _mm(_rows(ln).T, _rows(dqkvb))
    dbqkv = _rows(dqkv).sum(0, keepdim=True)
    dln = _mm(dqkvb, wqkv.T)
    dx = (dy32 + _ln_bwd_dx(dln * gamma, xh, inv)).to(dt)
    return (dx, _rows(dln * xh).sum(0, keepdim=True),
            _rows(dln).sum(0, keepdim=True), dwqkv.to(wqkv.dtype), dbqkv,
            dwout.to(wout.dtype), dbout)


def ln_mlp_plain(x, gamma, beta, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch ``ln_mlp``; rounds where the Pallas body does."""
    dt = x.dtype
    (gamma, beta, b1, b2), (w1, w2) = _cast(
        dt, vectors=(gamma, beta, b1, b2), matrices=(w1, w2))
    x32 = x.to(_acc(dt))
    ln = (_ln_fwd(x32)[0] * gamma + beta).to(dt)
    h = gelu(_mm(ln, w1) + b1).to(dt)
    return (x32 + (_mm(h, w2) + b2)).to(dt)


def ln_mlp_bwd_plain(x, gamma, beta, w1, b1, w2, dy):
    """Plain backward of ``ln_mlp``, the body ``_lnmlp_bwd_kernel``
    (``vlp_tpu/ops/fused_block.py:607``): ``h = bf16(z * cdf)`` from
    ``gelu_and_grad``, ``dh = bf16(dh32)``, db1 from the fp32 dh32. Returns
    (dx, dgamma, dbeta, dw1, db1, dw2, db2)."""
    dt = x.dtype
    (gamma, beta, b1), (w1, w2) = _cast(
        dt, vectors=(gamma, beta, b1), matrices=(w1, w2))
    x32 = x.to(_acc(dt))
    xh, inv = _ln_fwd(x32)
    ln = (xh * gamma + beta).to(dt)
    dy32 = dy.to(_acc(dt))
    dh32, dh, dw1, dw2 = mlp_bwd_core(ln, w1, b1, w2, dy32.to(dt))
    dln = _mm(dh, w1.T)
    dx = (dy32 + _ln_bwd_dx(dln * gamma, xh, inv)).to(dt)
    return (dx, (dln * xh).sum(0, keepdim=True), dln.sum(0, keepdim=True),
            dw1.to(w1.dtype), dh32.sum(0, keepdim=True), dw2.to(w2.dtype),
            dy32.sum(0, keepdim=True))


# -- the reference's per-shape choice ---------------------------------------
#
# Copies of the TPU kernels' VMEM arithmetic (vlp_tpu/ops/fused_block.py
# :452-473, :736-753, :861-869) at their default budgets. They say which of
# two compositions the reference computes at a shape (the half-block kernel,
# or LayerNorm and the unfused block), so that the port computes the same
# one; they are not a statement about the H100's memory, where the kernels
# would take more shapes.

def _attn_group(n: int, s: int, d: int, heads: int, itemsize: int) -> int:
    budget = 11 * 2 ** 20
    weights = 4 * d * d * itemsize + 4 * d * d * 4
    blocks = 2 * 3 * s * d * itemsize
    scratch = (s * d * (2 * 4 + 5 * itemsize + 3 * 4 + 3 * 4)
               + (heads + 2) * s * s * 4)
    for g in (16, 8, 4, 2, 1):
        if n % g == 0 and weights + g * (blocks + scratch) <= budget:
            return g
    return 0


def _mlp_tile(m: int, d: int, f: int, itemsize: int) -> int:
    budget = 15 * 1024 * 1024
    resident = 2 * d * f * itemsize + 2 * d * f * 4
    io_row = 2 * 3 * d * itemsize
    scratch_row = d * (3 * 4 + 2 * itemsize) + f * (2 * 4 + itemsize)
    for tm in (512, 256, 128, 64):
        if m % tm == 0 and resident + tm * (io_row + scratch_row) <= budget:
            return tm
    return 0


def supports_attn(n: int, s: int, d: int, num_heads: int,
                  itemsize: int = 2) -> bool:
    """Whether the reference runs ``ln_attention`` on [n, s, d] tokens."""
    return d % num_heads == 0 and \
        _attn_group(n, s, d, num_heads, itemsize) > 0


def supports_mlp(m: int, d: int, f: int, itemsize: int = 2) -> bool:
    """Whether the reference runs ``ln_mlp`` on [m, d] rows."""
    return _mlp_tile(m, d, f, itemsize) > 0


def supports_window(b: int, h: int, w: int, d: int, num_heads: int,
                    block: int, itemsize: int = 2) -> bool:
    """Whether the reference runs ``ln_attention_windows`` on a [b, h, w, d]
    map (``vlp_tpu/ops/fused_block.py:979-986``): the windows of one row
    strip must fit one program."""
    if d % num_heads or h % block or w % block:
        return False
    gw = w // block
    return _attn_group(gw, block * block, d, num_heads, itemsize) == gw


# -- NesT windows on the token map ------------------------------------------

def blockify(x: torch.Tensor, block: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, nb, block*block, C] with nb = (H/b)*(W/b)."""
    b, h, w, c = x.shape
    gh, gw = h // block, w // block
    x = x.reshape(b, gh, block, gw, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, block * block, c)


def unblockify(x: torch.Tensor, block: int, h: int, w: int) -> torch.Tensor:
    """Inverse of blockify."""
    b, _, _, c = x.shape
    gh, gw = h // block, w // block
    x = x.reshape(b, gh, gw, block, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _windows(x: torch.Tensor, block: int) -> torch.Tensor:
    """[B, H, W, D] -> the windows as samples, [B*nb, block^2, D]."""
    return blockify(x, block).reshape(-1, block * block, x.shape[-1])


def _unwindows(t: torch.Tensor, like: torch.Tensor, block: int
               ) -> torch.Tensor:
    b, h, w, d = like.shape
    return unblockify(t.reshape(b, -1, block * block, d), block, h, w)


def ln_attention_windows_plain(x, block: int, gamma, beta, wqkv, bqkv, wout,
                               bout, num_heads: int) -> torch.Tensor:
    """Plain ``ln_attention_windows`` on x [B, H, W, D]. The body
    ``_lnattn_nhwc_fwd_kernel`` (``vlp_tpu/ops/fused_block.py:928-946``) is
    ``_lnattn_fwd_kernel``'s per window, so this is ``ln_attention_plain``
    on the blockified windows."""
    return _unwindows(ln_attention_plain(_windows(x, block), gamma, beta,
                                         wqkv, bqkv, wout, bout, num_heads),
                      x, block)


def ln_attention_windows_bwd_plain(x, block: int, gamma, beta, wqkv, bqkv,
                                   wout, dy, num_heads: int):
    """Plain backward of ``ln_attention_windows``. The body
    ``_lnattn_nhwc_bwd_kernel`` (``:949-976``) runs
    ``_attn_block_bwd_rows`` per window, strip by strip, which is blockify
    order, so this is ``ln_attention_bwd_plain`` on the blockified windows.
    Returns (dx [B, H, W, D], dgamma, dbeta, dwqkv, dbqkv, dwout, dbout)."""
    dx, *rest = ln_attention_bwd_plain(
        _windows(x, block), gamma, beta, wqkv, bqkv, wout,
        _windows(dy, block), num_heads)
    return (_unwindows(dx, x, block), *rest)


# -- CUDA wrappers ----------------------------------------------------------

def _check_attn(name, x, num_heads, gamma, beta, wqkv, bqkv, wout, *rest,
                s=None):
    """Shapes the half-block attention kernels take; ``s``: tokens per
    unit, x.shape[1] unless given (the windowed kernels' block^2)."""
    d = x.shape[-1]
    s = x.shape[1] if s is None else s
    n = x.numel() // (s * d)
    if d % num_heads or d // num_heads != 32 or s > 256 or d > 1024:
        raise ValueError(
            f"{name}: the CUDA kernel takes head_dim 32, S <= 256 and "
            f"D <= 1024; got N={n}, S={s}, D={d}, heads={num_heads}")
    if wqkv.shape != (d, 3 * d) or wout.shape != (d, d) or \
            bqkv.shape[1] != 3 * d or gamma.shape[1] != d or \
            beta.shape[1] != d:
        raise ValueError(f"{name}: parameter shapes do not match D={d}")
    _check_cuda(name, x, gamma, beta, wqkv, bqkv, wout, *rest)


def _check_attn_launch(name, units, *tensors):
    """What the forward and backward sequences take beyond ``_check_attn``:
    at most 65535 units (the attention cores' grid) and 16-byte aligned
    operands (their products read them by TMA)."""
    if units > 65535:
        raise ValueError(f"{name}: the CUDA kernel takes at most 65535 "
                         f"attention units, got {units}")
    check_aligned(name, *tensors)


def _check_mlp(name, x, gamma, beta, w1, b1, w2, *rest):
    m, d = x.shape
    f = w1.shape[-1]
    if d % 32 or f % 32 or d > 1024:
        raise ValueError(f"{name}: the CUDA kernel takes D and F divisible "
                         f"by 32 and D <= 1024; got D={d}, F={f}")
    if w1.shape != (d, f) or w2.shape != (f, d) or b1.shape[1] != f or \
            gamma.shape[1] != d or beta.shape[1] != d:
        raise ValueError(f"{name}: parameter shapes do not match D={d}, "
                         f"F={f}")
    _check_cuda(name, x, gamma, beta, w1, b1, w2, *rest)


def _ln_attention_cuda(x, gamma, beta, wqkv, bqkv, wout, bout, num_heads):
    """The forward kernel on cast operands -> (y, qkv, o); qkv and o are
    the scratch the launch writes (o's buffer holds LN(x) until the core
    writes o), which the backward reads."""
    _check_attn("ln_attention", x, num_heads, gamma, beta, wqkv, bqkv, wout,
                bout)
    if bout.shape[1] != x.shape[-1]:
        raise ValueError("ln_attention: bout does not match D")
    n, s, d = x.shape
    _check_attn_launch("ln_attention", n, x, wqkv, wout)
    lib = _build.load_library()
    qkv = torch.empty((n, s, 3 * d), dtype=x.dtype, device=x.device)
    o = torch.empty((n, s, d), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.vlp_ln_attention(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wout.data_ptr(), bout.data_ptr(),
            qkv.data_ptr(), o.data_ptr(), y.data_ptr(), n, s, d, num_heads,
            (d // num_heads) ** -0.5, _EPS, _stream())
    _build.check(lib, err, "ln_attention")
    ln_attention.launches += 1
    return y, qkv, o


def _check_windows(name, x, block, num_heads, *params):
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be a [B, H, W, D] map, got "
                         f"{tuple(x.shape)}")
    b, h, w, d = x.shape
    if block <= 0 or h % block or w % block:
        raise ValueError(f"{name}: the CUDA kernel takes H and W divisible "
                         f"by the window {block}; got H={h}, W={w}")
    _check_attn(name, x, num_heads, *params, s=block * block)


def _ln_attention_windows_cuda(x, block, gamma, beta, wqkv, bqkv, wout, bout,
                               num_heads):
    """The windowed forward kernel on cast operands -> (y, qkv, o), qkv and
    o in the map's row order, which the backward reads."""
    _check_windows("ln_attention_windows", x, block, num_heads, gamma, beta,
                   wqkv, bqkv, wout, bout)
    if bout.shape[1] != x.shape[-1]:
        raise ValueError("ln_attention_windows: bout does not match D")
    b, h, w, d = x.shape
    _check_attn_launch("ln_attention_windows",
                       x.numel() // (block * block * d), x, wqkv, wout)
    lib = _build.load_library()
    qkv = torch.empty((b, h, w, 3 * d), dtype=x.dtype, device=x.device)
    o = torch.empty_like(x)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.vlp_ln_attention_windows(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wout.data_ptr(), bout.data_ptr(),
            qkv.data_ptr(), o.data_ptr(), y.data_ptr(), b, h, w, d,
            num_heads, block, (d // num_heads) ** -0.5, _EPS, _stream())
    _build.check(lib, err, "ln_attention_windows")
    ln_attention_windows.launches += 1
    return y, qkv, o


def _ln_mlp_cuda(x, gamma, beta, w1, b1, w2, b2):
    """The forward kernel (``csrc/ln_mlp.cu``) on cast operands; ln [M, D]
    and h [M, F] are the scratch of its three launches."""
    _check_mlp("ln_mlp", x, gamma, beta, w1, b1, w2, b2)
    if b2.shape[1] != x.shape[1]:
        raise ValueError("ln_mlp: b2 does not match D")
    check_aligned("ln_mlp", x, w1, w2)
    m, d = x.shape
    f = w1.shape[-1]
    lib = _build.load_library()
    ln = torch.empty_like(x)
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.vlp_ln_mlp(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ln.data_ptr(),
            h.data_ptr(), y.data_ptr(), m, d, f, _EPS, _stream())
    _build.check(lib, err, "ln_mlp")
    ln_mlp.launches += 1
    return y


def _grads_like(x, vec_dims, mat_shapes, dt):
    """Empty gradient buffers: dx like x, fp32 [1, n] vectors, weight
    gradients in the activation dtype."""
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty_like(x),
            *[torch.empty((1, n), **f32) for n in vec_dims],
            *[torch.empty(s, dtype=dt, device=x.device) for s in mat_shapes])


def ln_attention_bwd(x, gamma, beta, wqkv, bqkv, wout, dy, num_heads: int,
                     qkv=None, o=None):
    """Backward of ``ln_attention``: (dx, dgamma, dbeta, dwqkv, dbqkv,
    dwout, dbout). A CUDA tensor runs ``csrc/ln_attention_bwd.cu`` and needs
    the forward launch's ``qkv`` and ``o``; a CPU tensor recomputes them in
    ``ln_attention_bwd_plain``."""
    if not _route("ln_attention_bwd", x):
        return ln_attention_bwd_plain(x, gamma, beta, wqkv, bqkv, wout, dy,
                                      num_heads)
    dt = x.dtype
    (gamma, beta, bqkv), (wqkv, wout) = _cast(
        dt, vectors=(gamma, beta, bqkv), matrices=(wqkv, wout))
    if qkv is None or o is None:
        raise ValueError("ln_attention_bwd: the CUDA kernel reads the "
                         "forward's qkv and o")
    dy = dy.contiguous()
    _check_attn("ln_attention_bwd", x, num_heads, gamma, beta, wqkv, bqkv,
                wout, dy, qkv, o)
    n, s, d = x.shape
    if dy.shape != x.shape or qkv.shape != (n, s, 3 * d) or \
            o.shape != x.shape:
        raise ValueError("ln_attention_bwd: dy, qkv or o do not match x")
    _check_attn_launch("ln_attention_bwd", n, x, dy, qkv, o, wqkv, wout)
    lib = _build.load_library()
    dx, dg, db, dbqkv, dbout, dwqkv, dwout = _grads_like(
        x, (d, d, 3 * d, d), ((d, 3 * d), (d, d)), dt)
    ws = torch.empty(lib.vlp_ln_attention_bwd_workspace(n, s, d, num_heads),
                     dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.vlp_ln_attention_bwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(),
            wout.data_ptr(), qkv.data_ptr(), o.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dg.data_ptr(), db.data_ptr(), dwqkv.data_ptr(),
            dbqkv.data_ptr(), dwout.data_ptr(), dbout.data_ptr(),
            ws.data_ptr(), n, s, d, num_heads, (d // num_heads) ** -0.5,
            _EPS, _stream())
    _build.check(lib, err, "ln_attention_bwd")
    ln_attention_bwd.launches += 1
    return dx, dg, db, dwqkv, dbqkv, dwout, dbout


def ln_attention_windows_bwd(x, block, gamma, beta, wqkv, bqkv, wout, dy,
                             num_heads: int, qkv=None, o=None):
    """Backward of ``ln_attention_windows``: (dx, dgamma, dbeta, dwqkv,
    dbqkv, dwout, dbout). A CUDA tensor runs
    ``csrc/ln_attention_windows_bwd.cu`` and needs the forward launch's
    ``qkv`` and ``o``; a CPU tensor takes
    ``ln_attention_windows_bwd_plain``."""
    if not _route("ln_attention_windows_bwd", x):
        return ln_attention_windows_bwd_plain(x, block, gamma, beta, wqkv,
                                              bqkv, wout, dy, num_heads)
    dt = x.dtype
    (gamma, beta, bqkv), (wqkv, wout) = _cast(
        dt, vectors=(gamma, beta, bqkv), matrices=(wqkv, wout))
    if qkv is None or o is None:
        raise ValueError("ln_attention_windows_bwd: the CUDA kernel reads "
                         "the forward's qkv and o")
    dy = dy.contiguous()
    _check_windows("ln_attention_windows_bwd", x, block, num_heads, gamma,
                   beta, wqkv, bqkv, wout, dy, qkv, o)
    b, h, w, d = x.shape
    s = block * block
    if dy.shape != x.shape or qkv.shape != (b, h, w, 3 * d) or \
            o.shape != x.shape:
        raise ValueError("ln_attention_windows_bwd: dy, qkv or o do not "
                         "match x")
    _check_attn_launch("ln_attention_windows_bwd", x.numel() // (s * d), x, dy,
                    qkv, o, wqkv, wout)
    lib = _build.load_library()
    dx, dg, db, dbqkv, dbout, dwqkv, dwout = _grads_like(
        x, (d, d, 3 * d, d), ((d, 3 * d), (d, d)), dt)
    ws = torch.empty(lib.vlp_ln_attention_bwd_workspace(
        x.numel() // (s * d), s, d, num_heads), dtype=torch.uint8,
        device=x.device)
    with torch.cuda.device(x.device):
        err = lib.vlp_ln_attention_windows_bwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(),
            wout.data_ptr(), qkv.data_ptr(), o.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dg.data_ptr(), db.data_ptr(), dwqkv.data_ptr(),
            dbqkv.data_ptr(), dwout.data_ptr(), dbout.data_ptr(),
            ws.data_ptr(), b, h, w, d, num_heads, block,
            (d // num_heads) ** -0.5, _EPS, _stream())
    _build.check(lib, err, "ln_attention_windows_bwd")
    ln_attention_windows_bwd.launches += 1
    return dx, dg, db, dwqkv, dbqkv, dwout, dbout


def ln_mlp_bwd(x, gamma, beta, w1, b1, w2, dy):
    """Backward of ``ln_mlp``: (dx, dgamma, dbeta, dw1, db1, dw2, db2). A
    CUDA tensor runs ``csrc/ln_mlp_bwd.cu`` or raises
    (``fused_mlp.check_bwd_operands``); a CPU tensor
    ``ln_mlp_bwd_plain``."""
    if not _route("ln_mlp_bwd", x):
        return ln_mlp_bwd_plain(x, gamma, beta, w1, b1, w2, dy)
    dt = x.dtype
    (gamma, beta, b1), (w1, w2) = _cast(
        dt, vectors=(gamma, beta, b1), matrices=(w1, w2))
    dy = dy.contiguous()
    _check_mlp("ln_mlp_bwd", x, gamma, beta, w1, b1, w2, dy)
    if dy.shape != x.shape:
        raise ValueError("ln_mlp_bwd: dy does not match x")
    m, d = x.shape
    f = w1.shape[1]
    check_bwd_operands("ln_mlp_bwd", m, x, dy, w1, w2)
    lib = _build.load_library()
    dx, dg, db, db1, db2, dw1, dw2 = _grads_like(
        x, (d, d, f, d), ((d, f), (f, d)), dt)
    ws = torch.empty(lib.vlp_ln_mlp_bwd_workspace(m, d, f),
                     dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.vlp_ln_mlp_bwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dg.data_ptr(), db.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), ws.data_ptr(), m, d, f, _EPS,
            _stream())
    _build.check(lib, err, "ln_mlp_bwd")
    ln_mlp_bwd.launches += 1
    return dx, dg, db, dw1, db1, dw2, db2


# -- autograd ---------------------------------------------------------------

class LnAttention(torch.autograd.Function):
    """``ln_attention`` on cast operands, with the backward kernel."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wqkv, bqkv, wout, bout, num_heads):
        if x.device.type == "cuda":
            y, qkv, o = _ln_attention_cuda(x, gamma, beta, wqkv, bqkv, wout,
                                           bout, num_heads)
        else:
            y = ln_attention_plain(x, gamma, beta, wqkv, bqkv, wout, bout,
                                   num_heads)
            qkv = o = None
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, gamma, beta, wqkv, bqkv, wout, qkv, o)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, wqkv, bqkv, wout, qkv, o = ctx.saved_tensors
        return (*ln_attention_bwd(x, gamma, beta, wqkv, bqkv, wout, dy,
                                  ctx.num_heads, qkv, o), None)


class LnAttentionWindows(torch.autograd.Function):
    """``ln_attention_windows`` on cast operands, with the backward
    kernel."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wqkv, bqkv, wout, bout, num_heads,
                block):
        if x.device.type == "cuda":
            y, qkv, o = _ln_attention_windows_cuda(
                x, block, gamma, beta, wqkv, bqkv, wout, bout, num_heads)
        else:
            y = ln_attention_windows_plain(x, block, gamma, beta, wqkv, bqkv,
                                           wout, bout, num_heads)
            qkv = o = None
        ctx.num_heads, ctx.block = num_heads, block
        ctx.save_for_backward(x, gamma, beta, wqkv, bqkv, wout, qkv, o)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, wqkv, bqkv, wout, qkv, o = ctx.saved_tensors
        return (*ln_attention_windows_bwd(x, ctx.block, gamma, beta, wqkv,
                                          bqkv, wout, dy, ctx.num_heads, qkv,
                                          o), None, None)


class LnMlp(torch.autograd.Function):
    """``ln_mlp`` on cast operands, with the backward kernel."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2):
        y = _ln_mlp_cuda(x, gamma, beta, w1, b1, w2, b2) \
            if x.device.type == "cuda" else \
            ln_mlp_plain(x, gamma, beta, w1, b1, w2, b2)
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2)
        return y

    @staticmethod
    def backward(ctx, dy):
        return ln_mlp_bwd(*ctx.saved_tensors, dy)


def ln_attention(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 wqkv: torch.Tensor, bqkv: torch.Tensor, wout: torch.Tensor,
                 bout: torch.Tensor, num_heads: int) -> torch.Tensor:
    """y = x + OutProj(MHSA(LN(x))) over x [N, S, D]; wqkv [D, 3D] and
    wout [D, D] are ``[in, out]``; qkv packs q | k | v, heads-major."""
    cuda = _route("ln_attention", x)
    (gamma, beta, bqkv, bout), (wqkv, wout) = _cast(
        x.dtype, vectors=(gamma, beta, bqkv, bout), matrices=(wqkv, wout))
    args = (gamma, beta, wqkv, bqkv, wout, bout)
    if _records_grad(x, *args):
        return LnAttention.apply(x, *args, num_heads)
    if cuda:
        return _ln_attention_cuda(x, *args, num_heads)[0]
    return ln_attention_plain(x, *args, num_heads)


def ln_attention_windows(x: torch.Tensor, block: int, gamma: torch.Tensor,
                         beta: torch.Tensor, wqkv: torch.Tensor,
                         bqkv: torch.Tensor, wout: torch.Tensor,
                         bout: torch.Tensor, num_heads: int) -> torch.Tensor:
    """NesT's windowed y = x + OutProj(MHSA(LN(x))) straight on the token
    map x [B, H, W, D]: attention within each block x block window, no
    blockify or unblockify (the reference's signature, ``:1080``)."""
    cuda = _route("ln_attention_windows", x)
    (gamma, beta, bqkv, bout), (wqkv, wout) = _cast(
        x.dtype, vectors=(gamma, beta, bqkv, bout), matrices=(wqkv, wout))
    args = (gamma, beta, wqkv, bqkv, wout, bout)
    if _records_grad(x, *args):
        return LnAttentionWindows.apply(x, *args, num_heads, block)
    if cuda:
        return _ln_attention_windows_cuda(x, block, *args, num_heads)[0]
    return ln_attention_windows_plain(x, block, *args, num_heads)


def ln_mlp(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
           b2: torch.Tensor) -> torch.Tensor:
    """y = x + fc2(gelu(fc1(LN(x)))) over x [M, D] rows (LN is rowwise, so
    [N, S, D] callers flatten); w1 [D, F] and w2 [F, D] are ``[in, out]``."""
    cuda = _route("ln_mlp", x)
    (gamma, beta, b1, b2), (w1, w2) = _cast(
        x.dtype, vectors=(gamma, beta, b1, b2), matrices=(w1, w2))
    args = (gamma, beta, w1, b1, w2, b2)
    if _records_grad(x, *args):
        return LnMlp.apply(x, *args)
    if cuda:
        return _ln_mlp_cuda(x, *args)
    return ln_mlp_plain(x, *args)


ln_attention.launches = 0
ln_mlp.launches = 0
ln_attention_bwd.launches = 0
ln_mlp_bwd.launches = 0
ln_attention_windows.launches = 0
ln_attention_windows_bwd.launches = 0

KERNELS = (ln_attention, ln_mlp, ln_attention_bwd, ln_mlp_bwd,
           ln_attention_windows, ln_attention_windows_bwd)
