"""Half-block kernels of the pre-LN transformer block, for Hopper, with
their backwards.

  ln_attention: y = x + OutProj(MHSA(LN(x)))     x [N, S, D]
  ln_mlp:       y = x + fc2(gelu(fc1(LN(x))))    x [M, D] rows

Counterparts of the Pallas kernels in ``vlp_tpu/ops/fused_block.py``
(``_lnattn_fwd``/``_lnattn_bwd`` and ``_lnmlp_fwd``/``_lnmlp_bwd``). A CUDA
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

Under autograd the public ``ln_attention`` and ``ln_mlp`` run as
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

_EPS = 1e-6
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _erf(x: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz & Stegun 7.1.26 (|error| <= 1.5e-7), the form the
    Pallas kernels use (``vlp_tpu/ops/fused_mlp.py:_erf``)."""
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-a * a))


def gelu(z: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU with the A&S erf, as the Pallas forward computes it;
    within ~1e-7 of ``jax.nn.gelu(approximate=False)``."""
    return 0.5 * z * (1.0 + _erf(z * _INV_SQRT2))


def gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """d/dz [z * Phi(z)] = Phi(z) + z * phi(z)
    (``vlp_tpu/ops/fused_mlp.py:_gelu_grad``)."""
    return gelu_and_grad(z)[1]


def gelu_and_grad(z: torch.Tensor):
    """(gelu(z), gelu'(z)) from one erf, in the association of
    ``vlp_tpu/ops/fused_mlp.py:_gelu_and_grad`` (the backward's form)."""
    cdf = 0.5 * (1.0 + _erf(z * _INV_SQRT2))
    phi = torch.exp(-0.5 * z * z) * _INV_SQRT_2PI
    return z * cdf, cdf + z * phi


def _acc(dt: torch.dtype) -> torch.dtype:
    """Accumulation dtype: fp32, or fp64 for fp64 inputs (tests)."""
    return torch.float64 if dt == torch.float64 else torch.float32


def _ln_fwd(x: torch.Tensor):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + _EPS)
    return xc * inv, inv  # x_hat, 1 / sigma


def _ln_bwd_dx(dxh, xh, inv):
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xh).mean(-1, keepdim=True)
    return inv * (dxh - m1 - xh * m2)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an fp32 (fp64 for fp64) result, as
    ``preferred_element_type=float32`` gives in the Pallas bodies."""
    acc = _acc(a.dtype)
    return torch.matmul(a.to(acc), b.to(acc))


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def _cast(dt, *, vectors=(), matrices=()):
    """Weights to the activation dtype; gamma, beta and biases to fp32
    ``[1, n]`` (``vlp_tpu/ops/fused_block.py:882-912``)."""
    acc = _acc(dt)
    return ([v.reshape(1, -1).to(acc).contiguous() for v in vectors],
            [m.to(dt).contiguous() for m in matrices])


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[n, s, 3d] packed q | k | v -> q, k, v each [n, h, s, dh]."""
    n, s, d3 = t.shape
    return t.view(n, s, 3, num_heads, d3 // (3 * num_heads)).permute(
        2, 0, 3, 1, 4)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """[n, h, s, dh] -> [n, s, h * dh]."""
    n, h, s, dh = t.shape
    return t.transpose(1, 2).reshape(n, s, h * dh)


def ln_attention_plain(x, gamma, beta, wqkv, bqkv, wout, bout,
                       num_heads: int) -> torch.Tensor:
    """Plain PyTorch ``ln_attention``; rounds where the Pallas body does."""
    dt = x.dtype
    (gamma, beta, bqkv, bout), (wqkv, wout) = _cast(
        dt, vectors=(gamma, beta, bqkv, bout), matrices=(wqkv, wout))
    dh = x.shape[-1] // num_heads
    x32 = x.to(_acc(dt))
    ln = (_ln_fwd(x32)[0] * gamma + beta).to(dt)
    q, k, v = _heads((_mm(ln, wqkv) + bqkv).to(dt), num_heads)
    scores = _mm(q, k.transpose(-1, -2)) * dh ** -0.5      # [n, h, s, s]
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    o = _merge((_mm(p.to(dt), v) / p.sum(-1, keepdim=True)).to(dt))
    return (x32 + (_mm(o, wout) + bout)).to(dt)


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
    scale = (x.shape[-1] // num_heads) ** -0.5
    x32 = x.to(_acc(dt))
    xh, inv = _ln_fwd(x32)
    ln = (xh * gamma + beta).to(dt)
    q, k, v = _heads((_mm(ln, wqkv) + bqkv).to(dt), num_heads)
    dy32 = dy.to(_acc(dt))
    dyb = dy32.to(dt)
    scores = _mm(q, k.transpose(-1, -2)) * scale
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    invl = 1.0 / p.sum(-1, keepdim=True)
    pb = p.to(dt)
    o = _merge((_mm(pb, v) / p.sum(-1, keepdim=True)).to(dt))
    dwout = _mm(_rows(o).T, _rows(dyb))
    dbout = _rows(dy32).sum(0, keepdim=True)
    do = _mm(dyb, wout.T)                                    # [n, s, d]
    n, s, d = x.shape
    doh = do.to(dt).view(n, s, num_heads, -1).transpose(1, 2)
    dov = (doh.to(p.dtype) * invl).to(dt)
    dv = _mm(pb.transpose(-1, -2), dov)
    t = p * _mm(doh, v.transpose(-1, -2))
    c = t.sum(-1, keepdim=True) * invl
    dsb = ((t - p * c) * invl).to(dt)
    dq = _mm(dsb, k) * scale
    dk = _mm(dsb.transpose(-1, -2), q) * scale
    dqkv = torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1)
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
    h32, dgelu = gelu_and_grad(_mm(ln, w1) + b1)
    h = h32.to(dt)
    dy32 = dy.to(_acc(dt))
    dyb = dy32.to(dt)
    dw2 = _mm(h.T, dyb)
    dh32 = _mm(dyb, w2.T) * dgelu
    dh = dh32.to(dt)
    dw1 = _mm(ln.T, dh)
    dln = _mm(dh, w1.T)
    dx = (dy32 + _ln_bwd_dx(dln * gamma, xh, inv)).to(dt)
    return (dx, (dln * xh).sum(0, keepdim=True), dln.sum(0, keepdim=True),
            dw1.to(w1.dtype), dh32.sum(0, keepdim=True), dw2.to(w2.dtype),
            dy32.sum(0, keepdim=True))


# -- CUDA wrappers ----------------------------------------------------------

def _check_cuda(name: str, x: torch.Tensor, *tensors: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got "
                        f"{x.dtype}")
    for t in (x, *tensors):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _route(name: str, x: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain version; raises for
    any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{x.device}")


def _check_attn(name, x, num_heads, gamma, beta, wqkv, bqkv, wout, *rest):
    n, s, d = x.shape
    if d % num_heads or d // num_heads != 32 or s > 256 or d > 1024:
        raise ValueError(
            f"{name}: the CUDA kernel takes head_dim 32, S <= 256 and "
            f"D <= 1024; got N={n}, S={s}, D={d}, heads={num_heads}")
    if wqkv.shape != (d, 3 * d) or wout.shape != (d, d) or \
            bqkv.shape[1] != 3 * d or gamma.shape[1] != d or \
            beta.shape[1] != d:
        raise ValueError(f"{name}: parameter shapes do not match D={d}")
    _check_cuda(name, x, gamma, beta, wqkv, bqkv, wout, *rest)


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


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _ln_attention_cuda(x, gamma, beta, wqkv, bqkv, wout, bout, num_heads):
    """The forward kernel on cast operands -> (y, qkv, o); qkv and o are
    the scratch the launch writes, which the backward reads."""
    _check_attn("ln_attention", x, num_heads, gamma, beta, wqkv, bqkv, wout,
                bout)
    if bout.shape[1] != x.shape[-1]:
        raise ValueError("ln_attention: bout does not match D")
    n, s, d = x.shape
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


def _ln_mlp_cuda(x, gamma, beta, w1, b1, w2, b2):
    _check_mlp("ln_mlp", x, gamma, beta, w1, b1, w2, b2)
    if b2.shape[1] != x.shape[1]:
        raise ValueError("ln_mlp: b2 does not match D")
    m, d = x.shape
    f = w1.shape[-1]
    lib = _build.load_library()
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.vlp_ln_mlp(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), h.data_ptr(),
            y.data_ptr(), m, d, f, _EPS, _stream())
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
    if s > 240:
        raise ValueError(f"ln_attention_bwd: the CUDA kernel takes S <= 240 "
                         f"(its shared memory), got S={s}")
    if dy.shape != x.shape or qkv.shape != (n, s, 3 * d) or \
            o.shape != x.shape:
        raise ValueError("ln_attention_bwd: dy, qkv or o do not match x")
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


def ln_mlp_bwd(x, gamma, beta, w1, b1, w2, dy):
    """Backward of ``ln_mlp``: (dx, dgamma, dbeta, dw1, db1, dw2, db2). A
    CUDA tensor runs ``csrc/ln_mlp_bwd.cu``; a CPU tensor
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


def _records_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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

FORWARD_KERNELS = (ln_attention, ln_mlp)
KERNELS = (ln_attention, ln_mlp, ln_attention_bwd, ln_mlp_bwd)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
