"""Multi-head softmax attention over a packed projection, for Hopper, with
its backward (counterpart of ``vlp_tpu/ops/block_attention.py``).

  attend_qkv: o = softmax(q k^T * Dh^-1/2) v per head, qkv [N, S, 3D] ->
              o [N, S, D], q | k | v packed in the last dim, heads packed
              inside each D block

The kernel of the reference's unfused block path (``FusedSelfAttention``
in ``models/vit.py``): ViT-B/16 and ViT-L/16 (S = 197, Dh = 64), NesT with
``megakernel=False`` (S = 196, Dh = 32). A CUDA tensor runs
``csrc/block_attention.cu`` (forward) and ``csrc/block_attention_bwd.cu``
(backward), the register-resident cores ``csrc/mhsa_reg.cuh`` and
``csrc/mhsa_reg_bwd.cuh`` (head dim 32 or 64, S <= 256), built at first
use, or raises; a CPU tensor runs the plain versions (``attend_qkv_plain``,
``attend_qkv_bwd_plain``), which are also the reference the kernels are
held to. Both round where the Pallas bodies do: scores in fp32, p =
exp(s - max) unnormalised and cast to the activation dtype for the PV
product, the normalisation deferred past it; backward bf16(p),
bf16(do / l), bf16(ds), dq and dk scaled in fp32, one cast of dqkv.

Under autograd ``attend_qkv`` runs as a ``torch.autograd.Function`` whose
backward is the backward kernel (CUDA) or the plain backward (CPU). Each
public wrapper counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops._common import (_check_cuda, _heads, _merge, _mm,
                                       _records_grad, _route, _stream)

HEAD_DIMS = (32, 64)
MAX_SEQ = 256  # both kernels: 16 key tiles of scores in registers


def _scale(qkv: torch.Tensor, num_heads: int) -> float:
    return (qkv.shape[-1] // (3 * num_heads)) ** -0.5


def _probs(q, k, scale):
    """Unnormalised p = exp(s - max s) with s = q k^T * scale, fp32."""
    scores = _mm(q, k.transpose(-1, -2)) * scale            # [n, h, s, s]
    return torch.exp(scores - scores.amax(-1, keepdim=True))


def attend_qkv_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch ``attend_qkv``; rounds where the Pallas body
    (``block_attention.py:75-85``) does."""
    dt = qkv.dtype
    q, k, v = _heads(qkv, num_heads)
    p = _probs(q, k, _scale(qkv, num_heads))
    return _merge((_mm(p.to(dt), v) / p.sum(-1, keepdim=True)).to(dt))


def dqkv_f32(qkv: torch.Tensor, do: torch.Tensor,
             num_heads: int) -> torch.Tensor:
    """The packed [dq | dk | dv] before its cast (fp32, fp64 for fp64
    inputs): the body ``block_attention.py:109-144`` on do [N, S, D] in the
    activation dtype. The half-block backward sums its dbqkv from it."""
    dt = qkv.dtype
    n, s, d3 = qkv.shape
    scale = _scale(qkv, num_heads)
    q, k, v = _heads(qkv, num_heads)
    p = _probs(q, k, scale)
    invl = 1.0 / p.sum(-1, keepdim=True)
    pb = p.to(dt)
    doh = do.view(n, s, num_heads, -1).transpose(1, 2)
    dov = (doh.to(p.dtype) * invl).to(dt)
    dv = _mm(pb.transpose(-1, -2), dov)
    t = p * _mm(doh, v.transpose(-1, -2))
    c = t.sum(-1, keepdim=True) * invl
    dsb = ((t - p * c) * invl).to(dt)
    dq = _mm(dsb, k) * scale
    dk = _mm(dsb.transpose(-1, -2), q) * scale
    return torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1)


def attend_qkv_bwd_plain(qkv: torch.Tensor, do: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """Plain backward of ``attend_qkv``: the packed dqkv [N, S, 3D] in the
    activation dtype."""
    return dqkv_f32(qkv, do.to(qkv.dtype), num_heads).to(qkv.dtype)


# -- CUDA wrappers ----------------------------------------------------------

def _check(name: str, qkv: torch.Tensor, num_heads: int, max_seq: int,
           *rest: torch.Tensor) -> None:
    n, s, d3 = qkv.shape
    d = d3 // 3
    if d3 % 3 or d % num_heads or d // num_heads not in HEAD_DIMS or \
            s > max_seq:
        raise ValueError(
            f"{name}: the CUDA kernel takes head_dim in {HEAD_DIMS} and "
            f"S <= {max_seq}; got N={n}, S={s}, 3D={d3}, heads={num_heads}")
    _check_cuda(name, qkv, *rest)


def _attend_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    _check("attend_qkv", qkv, num_heads, MAX_SEQ)
    n, s, d3 = qkv.shape
    lib = _build.load_library()
    o = torch.empty((n, s, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.vlp_attend_qkv(qkv.data_ptr(), o.data_ptr(), n, s, d3 // 3,
                                 num_heads, _scale(qkv, num_heads),
                                 _stream())
    _build.check(lib, err, "attend_qkv")
    attend_qkv.launches += 1
    return o


def _attend_bwd_cuda(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                     check: torch.Tensor = None,
                     bad: torch.Tensor = None) -> torch.Tensor:
    do = do.contiguous()
    n, s, d3 = qkv.shape
    _check("attend_qkv_bwd", qkv, num_heads, MAX_SEQ, do)
    if do.shape != (n, s, d3 // 3) or do.dtype != qkv.dtype:
        raise ValueError(f"attend_qkv_bwd: do {do.dtype}{tuple(do.shape)} "
                         f"does not match qkv {qkv.dtype}{tuple(qkv.shape)}")
    lib = _build.load_library()
    dqkv = torch.empty_like(qkv)
    ptrs = [qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr()]
    launch = lib.vlp_attend_qkv_bwd
    if check is not None:
        ptrs += [check.data_ptr(), bad.data_ptr()]
        launch = lib.vlp_attend_qkv_bwd_checked
    with torch.cuda.device(qkv.device):
        err = launch(*ptrs, n, s, d3 // 3, num_heads, _scale(qkv, num_heads),
                     _stream())
    _build.check(lib, err, "attend_qkv_bwd")
    attend_qkv_bwd.launches += 1
    return dqkv


def attend_qkv_bwd(qkv: torch.Tensor, do: torch.Tensor,
                   num_heads: int) -> torch.Tensor:
    """Backward of ``attend_qkv``: the packed dqkv [N, S, 3D]. A CUDA tensor
    runs ``csrc/block_attention_bwd.cu``; a CPU tensor
    ``attend_qkv_bwd_plain``."""
    if not _route("attend_qkv_bwd", qkv):
        return attend_qkv_bwd_plain(qkv, do, num_heads)
    return _attend_bwd_cuda(qkv, do, num_heads)


def attend_qkv_bwd_checked(qkv: torch.Tensor, do: torch.Tensor,
                           num_heads: int):
    """(dqkv, mismatches): the backward kernel with its recompute check
    (``csrc/mhsa_reg_bwd.cuh``). Phase A writes its fp32 p and ds to a
    scratch buffer, and ``mismatches`` counts the elements of the p and ds
    that phase B recomputes which differ from them in any bit: 0 when
    phase B sees phase A's p. CUDA tensors only (the plain version has no
    phases)."""
    if qkv.device.type != "cuda":
        raise ValueError("attend_qkv_bwd_checked: checks the CUDA kernel; "
                         f"got a tensor on {qkv.device}")
    n, s, d3 = qkv.shape
    sp = -(-s // 16) * 16
    check = torch.empty(n * num_heads * 2 * sp * sp, dtype=torch.float32,
                        device=qkv.device)
    bad = torch.zeros(1, dtype=torch.int32, device=qkv.device)
    dqkv = _attend_bwd_cuda(qkv, do, num_heads, check, bad)
    return dqkv, int(bad.item())


# -- autograd ---------------------------------------------------------------

class AttendQkv(torch.autograd.Function):
    """``attend_qkv`` with the backward kernel; saves only qkv (the backward
    recomputes p, as the Pallas VJP does)."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        o = _attend_cuda(qkv, num_heads) if qkv.device.type == "cuda" \
            else attend_qkv_plain(qkv, num_heads)
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv)
        return o

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        return attend_qkv_bwd(qkv, do, ctx.num_heads), None


def attend_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Multi-head softmax attention over the packed projection output
    qkv [N, S, 3D] -> o [N, S, D] (``vlp_tpu/ops/block_attention.py:238``).
    """
    cuda = _route("attend_qkv", qkv)
    if _records_grad(qkv):
        return AttendQkv.apply(qkv, num_heads)
    if cuda:
        return _attend_cuda(qkv, num_heads)
    return attend_qkv_plain(qkv, num_heads)


attend_qkv.launches = 0
attend_qkv_bwd.launches = 0

KERNELS = (attend_qkv, attend_qkv_bwd)
