"""The transformer MLP fc1 -> exact GELU -> fc2 as one kernel, for Hopper,
with its backward (counterpart of ``vlp_tpu/ops/fused_mlp.py``).

  fused_mlp: y = bf16(gelu(x @ w1 + b1)) @ w2 + b2 over x [M, D] rows

The MLP of the reference's unfused block path (``MlpBlock`` in
``models/vit.py``) wherever ``supports`` holds: NesT-Small with
``megakernel=False`` at every level. A CUDA tensor runs
``csrc/fused_mlp.cu`` (forward) and ``csrc/fused_mlp_bwd.cu`` (backward),
built at first use, or raises; a CPU tensor runs the plain versions
(``fused_mlp_plain``, ``fused_mlp_bwd_plain``), which are also the
reference the kernels are held to. Both round where the Pallas bodies do:
products accumulated in fp32 with the bias added before one cast, h cast
to the activation dtype, the A&S erf; backward h = bf16(z * cdf), gelu'(z)
in fp32 up to its product, dh = bf16(dh32), weight gradients summed in
fp32 and cast once, db1 summed from the fp32 dh32.

Under autograd ``fused_mlp`` runs as a ``torch.autograd.Function`` whose
backward is the backward kernel (CUDA) or the plain backward (CPU). Weights
are cast to the activation dtype and biases to fp32 ``[1, n]`` outside the
Function, as ``vlp_tpu/ops/fused_mlp.py:231-232`` does, so autograd's cast
returns the gradients to the fp32 parameters. Each public wrapper counts
its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops._common import (_acc, _cast, _check_cuda, _mm,
                                       _records_grad, _route, _stream, gelu,
                                       gelu_and_grad)


def _tile(m: int, d: int, f: int, itemsize: int = 2) -> int:
    """The reference's row tile (``vlp_tpu/ops/fused_mlp.py:111-124``): the
    largest of 512/256/128/64 that divides ``m`` with the backward's VMEM
    accounting inside a 13 MB budget, else 0."""
    budget = 13 * 1024 * 1024
    resident = 2 * d * f * itemsize + 2 * d * f * 4
    for tm in (512, 256, 128, 64):
        if m % tm == 0 and resident + tm * f * (4 + itemsize) \
                + 3 * tm * d * 2 * itemsize <= budget:
            return tm
    return 0


def supports(m: int, d: int, f: int, itemsize: int = 2) -> bool:
    """Whether the reference runs its fused MLP kernel at this shape
    (``vlp_tpu/ops/fused_mlp.py:205-209``). A copy of the TPU kernel's
    VMEM arithmetic, not a statement about this card: it picks which of two
    compositions (this kernel, or Dense -> GELU -> Dense) the reference
    computes, and the port computes the same one."""
    return _tile(m, d, f, itemsize) > 0


def fused_mlp_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch ``fused_mlp`` (the body ``fused_mlp.py:70-76``)."""
    dt = x.dtype
    (b1, b2), (w1, w2) = _cast(dt, vectors=(b1, b2), matrices=(w1, w2))
    h = gelu(_mm(x, w1) + b1).to(dt)
    return (_mm(h, w2) + b2).to(dt)


def mlp_bwd_core(a, w1, b1, w2, dyb):
    """The MLP backward from its input ``a`` and the cotangent ``dyb``, both
    in the activation dtype, on cast operands: (dh32, dh, dw1, dw2) with
    ``h = bf16(z * cdf)`` from ``gelu_and_grad``, dh32 = (dy w2^T) gelu'(z)
    in fp32, dh its cast and the weight gradients unrounded. Shared with
    the half-block backward (``fused_block.ln_mlp_bwd_plain``)."""
    dt = a.dtype
    h32, dgelu = gelu_and_grad(_mm(a, w1) + b1)
    h = h32.to(dt)
    dw2 = _mm(h.T, dyb)
    dh32 = _mm(dyb, w2.T) * dgelu
    dh = dh32.to(dt)
    dw1 = _mm(a.T, dh)
    return dh32, dh, dw1, dw2


def fused_mlp_bwd_plain(x, w1, b1, w2, dy):
    """Plain backward of ``fused_mlp``, the body ``_bwd_kernel``
    (``vlp_tpu/ops/fused_mlp.py:79-108``). Returns (dx, dw1, db1, dw2,
    db2)."""
    dt = x.dtype
    (b1,), (w1, w2) = _cast(dt, vectors=(b1,), matrices=(w1, w2))
    dy32 = dy.to(_acc(dt))
    dh32, dh, dw1, dw2 = mlp_bwd_core(x, w1, b1, w2, dy32.to(dt))
    return (_mm(dh, w1.T).to(dt), dw1.to(w1.dtype), dh32.sum(0, keepdim=True),
            dw2.to(w2.dtype), dy32.sum(0, keepdim=True))


# -- CUDA wrappers ----------------------------------------------------------

def _check(name, x, w1, b1, w2, *rest):
    m, d = x.shape
    f = w1.shape[-1]
    if d % 32 or f % 32:
        raise ValueError(f"{name}: the CUDA kernel takes D and F divisible "
                         f"by 32; got D={d}, F={f}")
    if w1.shape != (d, f) or w2.shape != (f, d) or b1.shape != (1, f):
        raise ValueError(f"{name}: parameter shapes do not match D={d}, "
                         f"F={f}")
    _check_cuda(name, x, w1, b1, w2, *rest)


def check_aligned(name, *tensors):
    """The products of the MLP and half-block attention kernels
    (``csrc/dense_epi.cuh``, ``csrc/mlp_bwd.cuh``, ``csrc/ln_attention.cuh``)
    read their operands by TMA: 16-byte aligned operands, or raise before
    any launch."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes 16-byte aligned "
                         "operands")


def check_bwd_operands(name, m, *tensors):
    """What the MLP backward sequence (``csrc/mlp_bwd.cuh``, shared with
    ``fused_block.ln_mlp_bwd``) takes beyond the shapes: at most 65535
    blocks of 256 rows (the grid of its row partials) and 16-byte aligned
    operands (``check_aligned``). Raises before any launch."""
    if -(-m // 256) > 65535:
        raise ValueError(f"{name}: the CUDA kernel takes at most "
                         f"{65535 * 256} rows, got {m}")
    check_aligned(name, *tensors)


def _fused_mlp_cuda(x, w1, b1, w2, b2):
    """The forward kernel (``csrc/fused_mlp.cu``) on cast operands; h [M, F]
    is the scratch its first product writes and its second reads."""
    _check("fused_mlp", x, w1, b1, w2, b2)
    m, d = x.shape
    f = w1.shape[1]
    if b2.shape != (1, d):
        raise ValueError("fused_mlp: b2 does not match D")
    check_aligned("fused_mlp", x, w1, w2)
    lib = _build.load_library()
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.vlp_fused_mlp(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                w2.data_ptr(), b2.data_ptr(), h.data_ptr(),
                                y.data_ptr(), m, d, f, _stream())
    _build.check(lib, err, "fused_mlp")
    fused_mlp.launches += 1
    return y


def fused_mlp_bwd(x, w1, b1, w2, dy):
    """Backward of ``fused_mlp``: (dx, dw1, db1, dw2, db2). A CUDA tensor
    runs ``csrc/fused_mlp_bwd.cu`` or raises (``check_bwd_operands``); a
    CPU tensor ``fused_mlp_bwd_plain``."""
    if not _route("fused_mlp_bwd", x):
        return fused_mlp_bwd_plain(x, w1, b1, w2, dy)
    dt = x.dtype
    (b1,), (w1, w2) = _cast(dt, vectors=(b1,), matrices=(w1, w2))
    dy = dy.contiguous()
    _check("fused_mlp_bwd", x, w1, b1, w2, dy)
    if dy.shape != x.shape or dy.dtype != dt:
        raise ValueError("fused_mlp_bwd: dy does not match x")
    m, d = x.shape
    f = w1.shape[1]
    check_bwd_operands("fused_mlp_bwd", m, x, dy, w1, w2)
    lib = _build.load_library()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw1 = torch.empty((d, f), dtype=dt, device=x.device)
    dw2 = torch.empty((f, d), dtype=dt, device=x.device)
    db1, db2 = torch.empty((1, f), **f32), torch.empty((1, d), **f32)
    ws = torch.empty(lib.vlp_fused_mlp_bwd_workspace(m, d, f),
                     dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.vlp_fused_mlp_bwd(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), ws.data_ptr(), m, d, f,
            _stream())
    _build.check(lib, err, "fused_mlp_bwd")
    fused_mlp_bwd.launches += 1
    return dx, dw1, db1, dw2, db2


# -- autograd ---------------------------------------------------------------

class FusedMlp(torch.autograd.Function):
    """``fused_mlp`` on cast operands, with the backward kernel."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        y = _fused_mlp_cuda(x, w1, b1, w2, b2) if x.device.type == "cuda" \
            else fused_mlp_plain(x, w1, b1, w2, b2)
        ctx.save_for_backward(x, w1, b1, w2)
        return y

    @staticmethod
    def backward(ctx, dy):
        return fused_mlp_bwd(*ctx.saved_tensors, dy)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """y = gelu(x @ w1 + b1) @ w2 + b2 over x [M, D] rows; w1 [D, F] and
    w2 [F, D] are ``[in, out]``. Callers check ``supports`` first, as the
    reference's ``MlpBlock`` does."""
    cuda = _route("fused_mlp", x)
    (b1, b2), (w1, w2) = _cast(x.dtype, vectors=(b1, b2), matrices=(w1, w2))
    args = (w1, b1, w2, b2)
    if _records_grad(x, *args):
        return FusedMlp.apply(x, *args)
    if cuda:
        return _fused_mlp_cuda(x, *args)
    return fused_mlp_plain(x, *args)


fused_mlp.launches = 0
fused_mlp_bwd.launches = 0

KERNELS = (fused_mlp, fused_mlp_bwd)
