"""The attention half block's schedule variants for Hopper, forward and
backward: counterparts of the probe kernels
``benchmarks/mega_variants.py:make_attn`` (#15) and ``:make_attn_bwd``
(#16).

  attn_sched:          y = bf16(x + (o @ Wout + bout)), o = the attention
                       core of qkv = bf16(bf16(LN(x) * gamma + beta) @ Wqkv
                       + bqkv), per sample [N, S, D], 12 heads of 32 at the
                       probe's shape
  attn_sched_core:     the core alone, qkv [N, S, 3D] -> o [N, S, D]
  attn_sched_bwd:      the seven cotangents of attn_sched, recomputing LN,
                       qkv and o from x (``attn_bwd_kernel``'s signature):
                       dx bf16; dgamma, dbeta, dbqkv, dbout fp32 [1, n];
                       dWqkv [D, 3D] and dWout [D, D] fp32
  attn_sched_bwd_core: the backward's attention core alone, qkv and
                       do = bf16(dy @ Wout^T) -> (o, dqkv), both bf16

None lies on a model path (the JAX package runs them only in its schedule
lab); ``vlp_tpu_torch.probes.attn_probe`` times them beside the shipped
``ln_attention`` (#1) and ``ln_attention_bwd`` (#3) and SDPA.

Modes. The Pallas bodies reorder one sample's 12-head loop so that the
VPU softmax of one head overlaps the MXU products of another: ``v0`` (the
head loop), ``pipe`` (head h+1's QK issued before head h's softmax),
``pipe2`` (two deep: QK of h+1, softmax of h, PV of h-1), ``stage`` (all
QK, then all softmax, then all PV) and the bound ``nosm`` (softmax
replaced by bf16(s * 0.01), l = 1: another function). Backward: ``v0``
(two passes, each with its softmax recompute), ``stage2`` (the same, each
pass grouped by stage) and ``uni`` (the softmax computed once). On the
H100 the unit that is reordered is the 16-query tile within one (sample,
head) block (``csrc/attn_sched.cuh``): the same question, whether issuing
the tensor-core products of the next unit before the softmax of the
current one hides it. Every mode but ``nosm`` computes the same function
with the same roundings, so the forward modes give bit-equal y.

Rounding points (the Pallas bodies'): scores in fp32 scaled after the
product, p = exp(s - max) unnormalised and cast for the PV product; the
forward divides by l (``mega_variants.py:363``), the backward multiplies
by 1/l (``:461-463``): o = bf16((bf16(p) @ v) * (1/l)), which feeds dWout.
The backward's dov = bf16(do * (1/l)) takes the fp32 do in the Pallas body
and the bf16 do that the kernels stage (``csrc/mhsa_bwd.cuh``), one bf16
rounding apart; ``attn_sched_bwd_plain`` keeps the Pallas body's.

A CUDA tensor runs ``csrc/attn_sched.cu`` / ``attn_sched_bwd.cu`` or
raises; a CPU tensor runs the ``*_plain`` version. Shapes are refused on
either device. Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops._common import (_acc, _cast, _cuda_operands, _heads,
                                       _merge, _mm, _route, _rows, _stream)
from vlp_tpu_torch.ops.block_attention import attend_qkv_bwd_plain
from vlp_tpu_torch.ops.fused_block import _EPS, _ln_bwd_dx, _ln_fwd

MODES = ("v0", "nosm", "pipe", "pipe2", "stage")
BWD_MODES = ("v0", "stage2", "uni")
HEAD_DIM = 32
MAX_D = 1024
# Largest S of each mode: the block's 232,448 bytes of shared memory hold
# the staged q, k, v (and do) and the fp32 score rows of the schedule
# (csrc/attn_sched.cuh, attn_sched_bwd.cu)
MAX_SEQ = {"v0": 240, "nosm": 240, "pipe": 240, "pipe2": 224, "stage": 208}
MAX_SEQ_BWD = {"v0": 240, "stage2": 208, "uni": 240}


def _vecs(dt, *vectors):
    return _cast(dt, vectors=vectors)[0]


def ln_qkv_plain(x, gamma, beta, wqkv, bqkv):
    """(x32, x_hat, 1/sigma, ln, qkv) of x [N, S, D]: ln = bf16(LN(x) *
    gamma + beta), qkv = bf16(ln @ Wqkv + bqkv)."""
    dt = x.dtype
    g, b, bq = _vecs(dt, gamma, beta, bqkv)
    x32 = x.to(_acc(dt))
    xh, inv = _ln_fwd(x32)
    ln = (xh * g + b).to(dt)
    return x32, xh, inv, ln, (_mm(ln, wqkv.to(dt)) + bq).to(dt)


def attn_sched_core_plain(qkv: torch.Tensor, num_heads: int,
                          mode: str = "v0") -> torch.Tensor:
    """The core of ``attn_fwd_kernel`` (``mega_variants.py:346-364``):
    o [N, S, D] from qkv [N, S, 3D]."""
    _check_mode(mode, MODES)
    dt = qkv.dtype
    q, k, v = _heads(qkv, num_heads)
    s = _mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mode == "nosm":
        p, l = (s * 0.01).to(dt), 1.0
    else:
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p, l = p.to(dt), p.sum(-1, keepdim=True)
    return _merge((_mm(p, v) / l).to(dt))


def attn_sched_plain(x, gamma, beta, wqkv, bqkv, wout, bout, num_heads: int,
                     mode: str = "v0") -> torch.Tensor:
    """``attn_fwd_kernel`` (``mega_variants.py:331``) in plain PyTorch."""
    dt = x.dtype
    x32, _, _, _, qkv = ln_qkv_plain(x, gamma, beta, wqkv, bqkv)
    o = attn_sched_core_plain(qkv, num_heads, mode)
    return (x32 + (_mm(o, wout.to(dt)) + _vecs(dt, bout)[0])).to(dt)


def _core_bwd(qkv, do32, num_heads):
    """o and the fp32 [dq | dk | dv] of the Pallas backward body
    (``mega_variants.py:451-497``) from qkv and the fp32 do (o alone for
    do32 None)."""
    dt = qkv.dtype
    n, s, _ = qkv.shape
    q, k, v = _heads(qkv, num_heads)
    scale = q.shape[-1] ** -0.5
    sc = _mm(q, k.transpose(-1, -2)) * scale
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    invl = 1.0 / p.sum(-1, keepdim=True)
    pb = p.to(dt)
    o = _merge((_mm(pb, v) * invl).to(dt))
    if do32 is None:
        return o, None
    do32 = do32.view(n, s, num_heads, -1).transpose(1, 2)
    dov = (do32 * invl).to(dt)
    dv = _mm(pb.transpose(-1, -2), dov)
    t = p * _mm(do32.to(dt), v.transpose(-1, -2))
    c = t.sum(-1, keepdim=True) * invl
    dsb = ((t - p * c) * invl).to(dt)
    dq = _mm(dsb, k) * scale
    dk = _mm(dsb.transpose(-1, -2), q) * scale
    return o, torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1)


def attn_sched_bwd_plain(x, gamma, beta, wqkv, bqkv, wout, dy,
                         num_heads: int, mode: str = "v0"):
    """``attn_bwd_kernel`` (``mega_variants.py:410``) in plain PyTorch, the
    same function in every mode: (dx, dgamma, dbeta, dwqkv, dbqkv, dwout,
    dbout), dx in x's dtype, the rest fp32 (fp64 for fp64 inputs)."""
    _check_mode(mode, BWD_MODES)
    dt = x.dtype
    wqkv, wout = wqkv.to(dt), wout.to(dt)
    g = _vecs(dt, gamma)[0]
    _, xh, inv, ln, qkv = ln_qkv_plain(x, gamma, beta, wqkv, bqkv)
    dy32 = dy.to(_acc(dt))
    dyb = dy32.to(dt)
    do32 = _mm(dyb, wout.T)
    o, dqkv = _core_bwd(qkv, do32, num_heads)
    dqkvb = dqkv.to(dt)
    dln = _mm(dqkvb, wqkv.T)
    dx = (dy32 + _ln_bwd_dx(dln * g, xh, inv)).to(dt)
    return (dx, _rows(dln * xh).sum(0, keepdim=True),
            _rows(dln).sum(0, keepdim=True), _mm(_rows(ln).T, _rows(dqkvb)),
            _rows(dqkv).sum(0, keepdim=True), _mm(_rows(o).T, _rows(dyb)),
            _rows(dy32).sum(0, keepdim=True))


def attn_sched_bwd_core_plain(qkv, do, num_heads: int, mode: str = "v0"):
    """The kernels' attention-core backward: (o, dqkv) from qkv and the bf16
    do they stage, o = bf16((bf16(p) @ v) * (1/l)), dqkv as
    ``attend_qkv_bwd_plain``."""
    _check_mode(mode, BWD_MODES)
    return (_core_bwd(qkv, None, num_heads)[0],
            attend_qkv_bwd_plain(qkv, do, num_heads))


# -- checks -----------------------------------------------------------------

def _check_mode(mode, modes):
    if mode not in modes:
        raise ValueError(f"unknown mode {mode!r}: one of {modes}")


def _check_shapes(name, x, num_heads, mode, modes, max_seq, *, d3=False,
                  params=()):
    """ValueError on what the kernel does not take, whatever the device:
    x [N, S, D] (``d3``: [N, S, 3D]), head dim 32, S up to the mode's
    limit, D <= 1024; ``params`` are (tensor, shape) pairs, a vector's
    shape its element count."""
    _check_mode(mode, modes)
    if x.dim() != 3 or (d3 and x.shape[-1] % 3):
        raise ValueError(f"{name}: x {tuple(x.shape)} is not [N, S, "
                         f"{'3D' if d3 else 'D'}]")
    n, s, d = x.shape
    d = d // 3 if d3 else d
    if d % num_heads or d // num_heads != HEAD_DIM or s > max_seq[mode] \
            or d > MAX_D:
        raise ValueError(
            f"{name}: the CUDA kernel takes head_dim {HEAD_DIM}, S <= "
            f"{max_seq[mode]} (mode {mode}) and D <= {MAX_D}; got N={n}, "
            f"S={s}, D={d}, heads={num_heads}")
    for t, shape in params:
        want = (d * shape,) if isinstance(shape, int) else \
            tuple(d * k for k in shape)
        got = (t.numel(),) if isinstance(shape, int) else tuple(t.shape)
        if got != want:
            raise ValueError(f"{name}: parameter shape {tuple(t.shape)} "
                             f"does not match D={d}")


def _params(gamma, beta, wqkv, bqkv, wout, bout=None):
    """(tensor, shape in units of D) of the half block's parameters."""
    out = [(gamma, 1), (beta, 1), (wqkv, (1, 3)), (bqkv, 3), (wout, (1, 1))]
    return out + ([(bout, 1)] if bout is not None else [])


# -- CUDA wrappers ----------------------------------------------------------

def attn_sched(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               wqkv: torch.Tensor, bqkv: torch.Tensor, wout: torch.Tensor,
               bout: torch.Tensor, num_heads: int,
               mode: str = "v0") -> torch.Tensor:
    """x [N, S, D] -> y [N, S, D] through the core in ``mode``."""
    _check_shapes("attn_sched", x, num_heads, mode, MODES, MAX_SEQ,
                  params=_params(gamma, beta, wqkv, bqkv, wout, bout))
    if not _route("attn_sched", x):
        return attn_sched_plain(x, gamma, beta, wqkv, bqkv, wout, bout,
                                num_heads, mode)
    g, b, bq, bo = _cuda_operands("attn_sched", x, (wqkv, wout),
                                  (gamma, beta, bqkv, bout))
    n, s, d = x.shape
    lib = _build.load_library()
    qkv = torch.empty((n, s, 3 * d), dtype=x.dtype, device=x.device)
    o = torch.empty_like(x)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.vlp_attn_sched(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), wqkv.data_ptr(),
            bq.data_ptr(), wout.data_ptr(), bo.data_ptr(), qkv.data_ptr(),
            o.data_ptr(), y.data_ptr(), n, s, d, num_heads, HEAD_DIM ** -0.5,
            _EPS, MODES.index(mode), _stream())
    _build.check(lib, err, "attn_sched")
    attn_sched.launches += 1
    return y


def attn_sched_core(qkv: torch.Tensor, num_heads: int,
                    mode: str = "v0") -> torch.Tensor:
    """The forward's attention core alone: qkv [N, S, 3D] -> o [N, S, D]."""
    _check_shapes("attn_sched_core", qkv, num_heads, mode, MODES, MAX_SEQ,
                  d3=True)
    if not _route("attn_sched_core", qkv):
        return attn_sched_core_plain(qkv, num_heads, mode)
    _cuda_operands("attn_sched_core", qkv, (), ())
    n, s, d3 = qkv.shape
    lib = _build.load_library()
    o = torch.empty((n, s, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.vlp_attn_sched_core(
            qkv.data_ptr(), o.data_ptr(), n, s, d3 // 3, num_heads,
            HEAD_DIM ** -0.5, MODES.index(mode), _stream())
    _build.check(lib, err, "attn_sched_core")
    attn_sched_core.launches += 1
    return o


def attn_sched_bwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   wqkv: torch.Tensor, bqkv: torch.Tensor, wout: torch.Tensor,
                   dy: torch.Tensor, num_heads: int, mode: str = "v0"):
    """Backward of ``attn_sched`` from x and dy alone: (dx, dgamma, dbeta,
    dwqkv, dbqkv, dwout, dbout)."""
    _check_shapes("attn_sched_bwd", x, num_heads, mode, BWD_MODES,
                  MAX_SEQ_BWD, params=_params(gamma, beta, wqkv, bqkv, wout))
    if dy.shape != x.shape:
        raise ValueError("attn_sched_bwd: dy does not match x")
    if not _route("attn_sched_bwd", x):
        return attn_sched_bwd_plain(x, gamma, beta, wqkv, bqkv, wout, dy,
                                    num_heads, mode)
    g, b, bq = _cuda_operands("attn_sched_bwd", x, (wqkv, wout, dy),
                              (gamma, beta, bqkv))
    n, s, d = x.shape
    m = BWD_MODES.index(mode)
    lib = _build.load_library()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dg, db, dbout = (torch.empty((1, d), **f32) for _ in range(3))
    dbqkv = torch.empty((1, 3 * d), **f32)
    dwqkv = torch.empty((d, 3 * d), **f32)
    dwout = torch.empty((d, d), **f32)
    with torch.cuda.device(x.device):
        ws = torch.empty(lib.vlp_attn_sched_bwd_workspace(n, s, d, num_heads,
                                                          m),
                         dtype=torch.uint8, device=x.device)
        err = lib.vlp_attn_sched_bwd(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), wqkv.data_ptr(),
            bq.data_ptr(), wout.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dg.data_ptr(), db.data_ptr(), dwqkv.data_ptr(), dbqkv.data_ptr(),
            dwout.data_ptr(), dbout.data_ptr(), ws.data_ptr(), n, s, d,
            num_heads, HEAD_DIM ** -0.5, _EPS, m, _stream())
    _build.check(lib, err, "attn_sched_bwd")
    attn_sched_bwd.launches += 1
    return dx, dg, db, dwqkv, dbqkv, dwout, dbout


def attn_sched_bwd_core(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                        mode: str = "v0"):
    """The backward's attention core alone: (o, dqkv) from qkv [N, S, 3D]
    and do [N, S, D] (``v0``/``stage2``: the forward core with o =
    bf16(acc * (1/l)), then ``mhsa_bwd.cuh``; ``uni``: one kernel)."""
    _check_shapes("attn_sched_bwd_core", qkv, num_heads, mode, BWD_MODES,
                  MAX_SEQ_BWD, d3=True)
    n, s, d3 = qkv.shape
    if tuple(do.shape) != (n, s, d3 // 3):
        raise ValueError("attn_sched_bwd_core: do does not match qkv")
    if not _route("attn_sched_bwd_core", qkv):
        return attn_sched_bwd_core_plain(qkv, do, num_heads, mode)
    _cuda_operands("attn_sched_bwd_core", qkv, (do,), ())
    m = BWD_MODES.index(mode)
    lib = _build.load_library()
    o = torch.empty_like(do)
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(qkv.device):
        ws = torch.empty(lib.vlp_attn_sched_bwd_core_workspace(
            n, s, num_heads, m), dtype=torch.uint8, device=qkv.device)
        err = lib.vlp_attn_sched_bwd_core(
            qkv.data_ptr(), do.data_ptr(), o.data_ptr(), dqkv.data_ptr(),
            ws.data_ptr(), n, s, d3 // 3, num_heads, HEAD_DIM ** -0.5, m,
            _stream())
    _build.check(lib, err, "attn_sched_bwd_core")
    attn_sched_bwd_core.launches += 1
    return o, dqkv


attn_sched.launches = 0
attn_sched_core.launches = 0
attn_sched_bwd.launches = 0
attn_sched_bwd_core.launches = 0

KERNELS = (attn_sched, attn_sched_core, attn_sched_bwd, attn_sched_bwd_core)
