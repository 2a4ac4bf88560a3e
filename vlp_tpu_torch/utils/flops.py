"""Analytic 2*MAC FLOP counting (counterpart of
``vlp_tpu/utils/flops.py:87-101``).

The textbook count: 2 x the multiply-accumulates of every matrix product
(``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``, which
``matmul``, ``linear`` and ``einsum`` become), every convolution (output
positions x input channels a group x kernel positions) and every fused
attention (SDPA as its two products, q k^T and p v); elementwise work and
reductions count zero. The JAX count walks the jaxpr's ``dot_general`` and
``conv_general_dilated`` equations; here a ``TorchDispatchMode`` sees the
aten operations that autograd's decompositions leave, so a hand-written
kernel's autograd Function, whose forward runs its plain version on these
tensors, keeps its products in the count.

The count runs on the plain path, as the JAX count runs with
``VLP_DISABLE_PALLAS=1``: under ``FakeTensorMode`` on the CPU device, so a
kernel's wrapper takes its plain version and nothing is computed (a
full-width model at batch 128 counts in a second; its parameters may be
real or fake). Model FLOPs are the same on every path. Training FLOPs are
taken as 3 x the forward's (forward + 2 x backward), the convention of the
JAX benchmark.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

aten = torch.ops.aten


def _prod(shape) -> int:
    return math.prod(int(s) for s in shape)


def _mm(a, b) -> int:  # [.., m, k] @ [.., k, n]
    return _prod(a.shape) * int(b.shape[-1])


def _conv(args, out) -> int:
    x, w = args[0], args[1]
    transposed = len(args) > 6 and bool(args[6])
    groups = int(args[8]) if len(args) > 8 else 1
    c_in = int(w.shape[0]) // groups if transposed else int(w.shape[1])
    return _prod(out.shape) * c_in * _prod(w.shape[2:])


def _attention(args, out) -> int:
    q, k, v = args[:3]  # [.., L, E], [.., S, E], [.., S, Ev]
    return _prod(q.shape[:-1]) * int(k.shape[-2]) * (int(q.shape[-1])
                                                     + int(v.shape[-1]))


# aten overload packet -> MACs of one call from (args, output)
_MACS = {
    aten.mm: lambda a, o: _mm(a[0], a[1]),
    aten.addmm: lambda a, o: _mm(a[1], a[2]),
    aten.bmm: lambda a, o: _mm(a[0], a[1]),
    aten.baddbmm: lambda a, o: _mm(a[1], a[2]),
    aten.mv: lambda a, o: _prod(a[0].shape),
    aten.dot: lambda a, o: int(a[0].shape[0]),
    aten.convolution: lambda a, o: _conv(a, o),
    aten._convolution: lambda a, o: _conv(a, o),
}
for _name in ("_scaled_dot_product_flash_attention",
              "_scaled_dot_product_flash_attention_for_cpu",
              "_scaled_dot_product_efficient_attention",
              "_scaled_dot_product_cudnn_attention"):
    if hasattr(aten, _name):
        _MACS[getattr(aten, _name)] = lambda a, o: _attention(a, o)


class MacCounter(TorchDispatchMode):
    """Adds the MACs of every counted operation it sees to ``macs``."""

    def __init__(self) -> None:
        super().__init__()
        self.macs = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rule = _MACS.get(func.overloadpacket)
        if rule is not None:
            first = out[0] if isinstance(out, (tuple, list)) else out
            self.macs += rule(args, first)
        return out


def analytic_flops(fn: Callable, *args: Any) -> float:
    """Textbook 2*MAC FLOPs of one ``fn(*args)`` call on the plain path
    (products and convolutions only). Tensors among ``args`` (and
    parameters ``fn`` closes over) are taken by shape alone; nothing is
    computed."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True) as fake:
        args = tree_map(lambda a: fake.from_tensor(a)
                        if isinstance(a, torch.Tensor) else a, args)
        with torch.no_grad(), MacCounter() as counter:
            fn(*args)
    return 2.0 * counter.macs
