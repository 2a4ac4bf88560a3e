"""Half-block kernels of the pre-LN transformer block, for Hopper.

  ln_attention: y = x + OutProj(MHSA(LN(x)))     x [N, S, D]
  ln_mlp:       y = x + fc2(gelu(fc1(LN(x))))    x [M, D] rows

Counterparts of the Pallas kernels in ``vlp_tpu/ops/fused_block.py``
(``_lnattn_fwd`` and ``_lnmlp_fwd``). A CUDA tensor runs the hand-written
CUDA kernels of ``vlp_tpu_torch/csrc`` (built at first use) or raises; a CPU
tensor runs the plain PyTorch versions ``ln_attention_plain`` and
``ln_mlp_plain``, which are also the reference the kernels are held to. Both
round at the points the Pallas bodies round: LN in fp32 (two-pass variance,
eps 1e-6) cast to the activation dtype, products accumulated in fp32 with
the bias added before one cast, softmax in fp32 with the normalisation
deferred past the PV product, residual added in fp32.

Each public wrapper counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from vlp_tpu_torch.ops import _build

_EPS = 1e-6
_INV_SQRT2 = 0.7071067811865476


def gelu(z: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU with erf by Abramowitz & Stegun 7.1.26, the form the
    Pallas kernels use (``vlp_tpu/ops/fused_mlp.py:_erf``); within ~1e-7 of
    ``jax.nn.gelu(approximate=False)``."""
    x = z * _INV_SQRT2
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf = torch.sign(x) * (1.0 - poly * torch.exp(-a * a))
    return 0.5 * z * (1.0 + erf)


def _layer_norm(x32: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor) -> torch.Tensor:
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + _EPS) * gamma + beta


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 accumulation and an fp32 result, as
    ``preferred_element_type=float32`` gives in the Pallas bodies."""
    return torch.matmul(a.float(), b.float())


def _cast(dt, *, vectors=(), matrices=()):
    """Weights to the activation dtype; gamma, beta and biases to fp32
    ``[1, n]`` (``vlp_tpu/ops/fused_block.py:882-912``)."""
    return ([v.reshape(1, -1).float().contiguous() for v in vectors],
            [m.to(dt).contiguous() for m in matrices])


def ln_attention_plain(x, gamma, beta, wqkv, bqkv, wout, bout,
                       num_heads: int) -> torch.Tensor:
    """Plain PyTorch ``ln_attention``; rounds where the Pallas body does."""
    dt = x.dtype
    (gamma, beta, bqkv, bout), (wqkv, wout) = _cast(
        dt, vectors=(gamma, beta, bqkv, bout), matrices=(wqkv, wout))
    n, s, d = x.shape
    dh = d // num_heads
    x32 = x.float()
    ln = _layer_norm(x32, gamma, beta).to(dt)
    qkv = (_mm(ln, wqkv) + bqkv).to(dt)
    q, k, v = qkv.view(n, s, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    scores = _mm(q, k.transpose(-1, -2)) * dh ** -0.5      # [n, h, s, s]
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    o = (_mm(p.to(dt), v) / p.sum(-1, keepdim=True)).to(dt)
    o = o.transpose(1, 2).reshape(n, s, d)
    return (x32 + (_mm(o, wout) + bout)).to(dt)


def ln_mlp_plain(x, gamma, beta, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch ``ln_mlp``; rounds where the Pallas body does."""
    dt = x.dtype
    (gamma, beta, b1, b2), (w1, w2) = _cast(
        dt, vectors=(gamma, beta, b1, b2), matrices=(w1, w2))
    x32 = x.float()
    ln = _layer_norm(x32, gamma, beta).to(dt)
    h = gelu(_mm(ln, w1) + b1).to(dt)
    return (x32 + (_mm(h, w2) + b2)).to(dt)


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


def ln_attention(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 wqkv: torch.Tensor, bqkv: torch.Tensor, wout: torch.Tensor,
                 bout: torch.Tensor, num_heads: int) -> torch.Tensor:
    """y = x + OutProj(MHSA(LN(x))) over x [N, S, D]; wqkv [D, 3D] and
    wout [D, D] are ``[in, out]``; qkv packs q | k | v, heads-major."""
    if not _route("ln_attention", x):
        return ln_attention_plain(x, gamma, beta, wqkv, bqkv, wout, bout,
                                  num_heads)
    n, s, d = x.shape
    if d % num_heads or d // num_heads != 32 or s > 256 or d > 1024:
        raise ValueError(
            f"ln_attention: the CUDA kernel takes head_dim 32, S <= 256 and "
            f"D <= 1024; got N={n}, S={s}, D={d}, heads={num_heads}")
    dt = x.dtype
    (gamma, beta, bqkv, bout), (wqkv, wout) = _cast(
        dt, vectors=(gamma, beta, bqkv, bout), matrices=(wqkv, wout))
    if wqkv.shape != (d, 3 * d) or wout.shape != (d, d) or \
            bqkv.shape[1] != 3 * d or {gamma.shape[1], beta.shape[1],
                                       bout.shape[1]} != {d}:
        raise ValueError("ln_attention: parameter shapes do not match D="
                         f"{d}")
    _check_cuda("ln_attention", x, gamma, beta, wqkv, bqkv, wout, bout)
    lib = _build.load_library()
    qkv = torch.empty((n, s, 3 * d), dtype=dt, device=x.device)
    o = torch.empty((n, s, d), dtype=dt, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vlp_ln_attention(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wout.data_ptr(), bout.data_ptr(),
            qkv.data_ptr(), o.data_ptr(), y.data_ptr(), n, s, d, num_heads,
            (d // num_heads) ** -0.5, _EPS, stream)
    _build.check(lib, err, "ln_attention")
    ln_attention.launches += 1
    return y


def ln_mlp(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
           b2: torch.Tensor) -> torch.Tensor:
    """y = x + fc2(gelu(fc1(LN(x)))) over x [M, D] rows (LN is rowwise, so
    [N, S, D] callers flatten); w1 [D, F] and w2 [F, D] are ``[in, out]``."""
    if not _route("ln_mlp", x):
        return ln_mlp_plain(x, gamma, beta, w1, b1, w2, b2)
    m, d = x.shape
    f = w1.shape[-1]
    if d % 32 or f % 32 or d > 1024:
        raise ValueError(f"ln_mlp: the CUDA kernel takes D and F divisible "
                         f"by 32 and D <= 1024; got D={d}, F={f}")
    dt = x.dtype
    (gamma, beta, b1, b2), (w1, w2) = _cast(
        dt, vectors=(gamma, beta, b1, b2), matrices=(w1, w2))
    if w1.shape != (d, f) or w2.shape != (f, d) or b1.shape[1] != f or \
            {gamma.shape[1], beta.shape[1], b2.shape[1]} != {d}:
        raise ValueError(f"ln_mlp: parameter shapes do not match D={d}, "
                         f"F={f}")
    _check_cuda("ln_mlp", x, gamma, beta, w1, b1, w2, b2)
    lib = _build.load_library()
    h = torch.empty((m, f), dtype=dt, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vlp_ln_mlp(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), h.data_ptr(),
            y.data_ptr(), m, d, f, _EPS, stream)
    _build.check(lib, err, "ln_mlp")
    ln_mlp.launches += 1
    return y


ln_attention.launches = 0
ln_mlp.launches = 0

KERNELS = (ln_attention, ln_mlp)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0

