"""The port's packed-qkv attention (``vlp_tpu_torch.ops.block_attention``)
against the JAX package's Pallas kernel ``_attend`` run in interpret mode
on the CPU: the forward, and the backward against ``jax.vjp`` through the
Pallas VJP.

The same numpy inputs go to both sides. fp32 comparisons use atol 5e-5 of
the values' scale, the JAX package's own kernel-vs-plain bound
(tests/test_fused_block.py); bf16 cases allow 2^-5 (two bf16 ulps at
values below 4): both sides round at the same points and differ only in
the order of the fp32 sums, which can flip a rounding. Head dims 32 and
64, S of 1, 16, 17, NesT's 196 and ViT's 197; N 1 and 2 give the Pallas
grid one and two samples per program.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.ops.block_attention import _attend, _group_size
from vlp_tpu_torch.ops import block_attention as BA

FP32_ATOL = 5e-5
BF16_ATOL = 2.0 ** -5


def _jax_attend(qkv, heads, do):
    d = qkv.shape[-1] // 3
    scale = (d // heads) ** -0.5
    o, vjp = jax.vjp(lambda t: _attend(t, heads, scale, True), qkv)
    return o, vjp(do)[0]


@pytest.mark.parametrize("n,s,d,heads,dtype", [
    (1, 17, 64, 2, "fp32"),      # Dh 32, one sample per program
    (2, 196, 64, 2, "fp32"),     # NesT's S at Dh 32, two per program
    (2, 197, 128, 2, "fp32"),    # ViT's S at Dh 64
    (1, 196, 64, 1, "fp32"),     # Dh 64 at S 196
    (2, 197, 128, 2, "bf16"),
    (1, 17, 96, 3, "bf16"),
    (1, 1, 128, 2, "fp32"),      # S 1: one key, the CUDA kernels' edge
    (2, 16, 128, 4, "bf16"),     # S 16: one 16-key tile, Dh 32
])
def test_attend_plain_matches_jax_kernel(n, s, d, heads, dtype):
    rng = np.random.default_rng(n * 1000 + s + d)
    qkv = (rng.standard_normal((n, s, 3 * d)) * 1.5).astype(np.float32)
    qkv[:, 0] *= 4.0   # one peaked row: the softmax max matters
    do = rng.standard_normal((n, s, d)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    assert _group_size(n, s, d) == n
    want_o, want_dqkv = _jax_attend(jnp.asarray(qkv, jdt), heads,
                                    jnp.asarray(do, jdt))
    tq, tdo = torch.from_numpy(qkv).to(tdt), torch.from_numpy(do).to(tdt)
    got_o = BA.attend_qkv_plain(tq, heads)
    got_dqkv = BA.attend_qkv_bwd_plain(tq, tdo, heads)
    assert got_o.dtype == got_dqkv.dtype == tdt
    atol = BF16_ATOL if dtype == "bf16" else FP32_ATOL
    np.testing.assert_allclose(got_o.float().numpy(),
                               np.asarray(want_o, np.float32), atol=atol,
                               rtol=0)
    want = np.asarray(want_dqkv, np.float32)
    np.testing.assert_allclose(got_dqkv.float().numpy(), want,
                               atol=atol * max(1.0, np.abs(want).max()),
                               rtol=0)
    # a CPU tensor routes the public wrappers to the plain versions
    assert torch.equal(BA.attend_qkv(tq, heads), got_o)
    assert torch.equal(BA.attend_qkv_bwd(tq, tdo, heads), got_dqkv)


def test_autograd_on_cpu_returns_the_plain_backward():
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((2, 17, 192)).astype(
        np.float32)).requires_grad_()
    do = torch.from_numpy(rng.standard_normal((2, 17, 64)).astype(
        np.float32))
    BA.attend_qkv(qkv, 2).backward(do)
    assert torch.equal(qkv.grad, BA.attend_qkv_bwd_plain(qkv.detach(), do,
                                                         2))


def test_plain_backward_is_the_derivative_of_the_plain_forward():
    """In float64 nothing rounds, so the hand-written backward must be the
    exact derivative of the forward."""
    rng = np.random.default_rng(11)
    qkv = torch.from_numpy(rng.standard_normal((2, 23, 3 * 64))
                           ).requires_grad_()
    do = torch.from_numpy(rng.standard_normal((2, 23, 64)))
    BA.attend_qkv_plain(qkv, 2).backward(do)
    np.testing.assert_allclose(
        BA.attend_qkv_bwd_plain(qkv.detach(), do, 2).numpy(),
        qkv.grad.numpy(), rtol=0, atol=1e-10)


def test_unsupported_device_raises_instead_of_falling_back():
    qkv = torch.zeros(2, 16, 96, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        BA.attend_qkv(qkv, 1)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        BA.attend_qkv_bwd(qkv, torch.zeros(2, 16, 32, device="meta"), 1)


def test_phase_check_is_a_cuda_kernel_check():
    """The backward kernel's phase-B check has no plain version: a CPU
    tensor raises instead of returning the plain backward."""
    qkv = torch.zeros(2, 16, 96)
    with pytest.raises(ValueError, match="checks the CUDA kernel"):
        BA.attend_qkv_bwd_checked(qkv, torch.zeros(2, 16, 32), 1)


def test_ab_script_swaps_only_the_library_and_needs_a_card(monkeypatch):
    """``scripts/ab_attention.py`` serves the parent's library to this
    tree's wrappers (with this tree's error check) and, like the probes,
    exits with code 2 where there is no CUDA device."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "ab_attention.py"
    spec = importlib.util.spec_from_file_location("ab_attention", path)
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    lib = object()
    shim = ab._Library(lib)
    assert shim.load_library() is lib and shim.check is ab._build.check
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        ab.main(["--parent", str(path.parent)])
    assert exc.value.code == 2
