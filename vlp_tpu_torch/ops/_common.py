"""Helpers shared by the kernel modules (``fused_block``,
``block_attention``, ``fused_mlp``, ``mlp_tile``, ``attn_sched``): the
exact-erf GELU of the Pallas bodies, products with an fp32 result, the
casts the Pallas wrappers apply to their operands, the packed-head views,
and the routing and checks of the CUDA wrappers (a CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain version; any other device raises).
"""
from __future__ import annotations

import torch

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


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an fp32 (fp64 for fp64) result, as
    ``preferred_element_type=float32`` gives in the Pallas bodies."""
    acc = _acc(a.dtype)
    return torch.matmul(a.to(acc), b.to(acc))


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def _cast(dt, *, vectors=(), matrices=()):
    """Weights to the activation dtype; gamma, beta and biases to fp32
    ``[1, n]`` (``vlp_tpu/ops/fused_block.py:882-912``,
    ``vlp_tpu/ops/fused_mlp.py:231-232``)."""
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


def _check_cuda(name: str, x: torch.Tensor, *tensors: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got "
                        f"{x.dtype}")
    for t in (x, *tensors):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _cuda_operands(name, x, mats, vecs):
    """Checks and flattens the operands of a CUDA launch: bf16 contiguous
    x and matrices on x's device, fp32 vectors."""
    vecs = [v.reshape(-1).contiguous() for v in vecs]
    _check_cuda(name, x, *mats, *vecs)
    if any(m.dtype != torch.bfloat16 for m in mats) or any(
            v.dtype != torch.float32 for v in vecs):
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16 weights and "
                        "fp32 vectors")
    return vecs


def _route(name: str, x: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain version; raises for
    any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{x.device}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _records_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
