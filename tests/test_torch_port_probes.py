"""The ResNet probe kernels' plain versions (``ops/conv3x3.py``,
``ops/bn_gemm.py``) against the Pallas kernels of
``benchmarks/conv_probe.py:pallas_conv3x3`` and
``benchmarks/bn_gemm_probe.py:make_pallas`` run in TPU interpret mode on
the CPU, and the probe's equality-split max-pool backward against the
reference's ``maxpool_eqsplit``, on inputs drawn by numpy from a seed.

The probe scripts are loaded from their files (``benchmarks/`` is not a
package). Each sets ``JAX_COMPILATION_CACHE_DIR`` with ``setdefault`` when
imported; ``tests/conftest.py`` has set it before, so the tests' cache
directory stays in force.

Tolerances: both sides take bf16 operands whose products are exact in fp32
and sum them in fp32 in other orders, then round once to bf16, so an
output may differ by one bf16 rounding step of the larger of the two
(2^-7 of it, plus 2^-7 of the largest |output| for the fp32 sums' order).
The max-pool gradients are sums of the same fp32 terms in the same tap
order: equal.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vlp_tpu_torch.ops import bn_gemm as BG
from vlp_tpu_torch.ops import conv3x3 as CV
from vlp_tpu_torch.probes import bn_gemm_probe, conv_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jconv():
    return _load("conv_probe")


@pytest.fixture(scope="module")
def jbn():
    return _load("bn_gemm_probe")


def _bf16(rng, *shape, scale=1.0):
    """numpy draws rounded to bf16, as float32 arrays."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _within_one_rounding(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    step = 2.0 ** -7 * (np.maximum(np.abs(got), np.abs(want))
                        + np.abs(want).max())
    assert got.shape == want.shape
    assert (np.abs(got - want) <= step).all(), np.abs(got - want).max()


@pytest.mark.parametrize("b,hw,c,k,g", [(4, 6, 16, 32, 2), (2, 5, 32, 16, 1),
                                        (3, 4, 48, 48, 3)])
def test_plain_conv3x3_matches_pallas_interpret(jconv, b, hw, c, k, g):
    rng = np.random.default_rng(b * hw + c)
    x = _bf16(rng, b, hw, hw, c)
    w = _bf16(rng, 3, 3, c, k, scale=(9 * c) ** -0.5)
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = jconv.pallas_conv3x3(xj, wj, g)
    got = CV.conv3x3(torch.from_numpy(x).bfloat16(),
                     torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (b * hw * hw, k)
    _within_one_rounding(got.float().numpy(), want.astype(jnp.float32))
    xla = jconv.xla_conv3x3(xj, wj).reshape(-1, k)
    _within_one_rounding(got.float().numpy(), xla.astype(jnp.float32))
    # the plain version in fp32 on bf16 operands is the exact sum rounded
    # once to fp32: against XLA's fp32 conv within fp32 rounding
    got32 = CV.conv3x3(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    ref32 = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST).reshape(-1, k)
    np.testing.assert_allclose(got32, np.asarray(ref32), rtol=0,
                               atol=1e-5 * np.abs(ref32).max())


@pytest.mark.parametrize("m,c,k,tm", [(256, 32, 48, 128), (96, 64, 16, 32)])
def test_plain_bn_relu_gemm_matches_pallas_interpret(jbn, m, c, k, tm):
    rng = np.random.default_rng(m + c + k)
    x = _bf16(rng, m, c)
    a = rng.standard_normal((1, c)).astype(np.float32)
    b = rng.standard_normal((1, c)).astype(np.float32)
    w = _bf16(rng, c, k, scale=0.05)
    args = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(a), jnp.asarray(b),
            jnp.asarray(w, jnp.bfloat16))
    with pltpu.force_tpu_interpret_mode():
        want = jbn.make_pallas(m, c, k, tm)(*args)
    got = BG.bn_relu_gemm(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (m, k)
    _within_one_rounding(got.float().numpy(), want.astype(jnp.float32))
    # the two-op torch yardstick computes the same function
    two = bn_gemm_probe.two_op(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(w).bfloat16())
    _within_one_rounding(two.float().numpy(), got.float().numpy())


def test_maxpool_eqsplit_grad_matches_jax(jconv):
    rng = np.random.default_rng(5)
    # ReLU'd, so zeros tie inside windows, as at the stem
    x = np.maximum(_bf16(rng, 2, 12, 12, 16), 0.0)
    xj = jnp.asarray(x, jnp.bfloat16)

    def loss(f):
        return lambda v: jnp.sum(f(v).astype(jnp.float32) ** 2)

    want_eq = jax.grad(loss(jconv.maxpool_eqsplit))(xj)
    want_first = jax.grad(loss(jconv.maxpool_xla))(xj)
    first_max, eqsplit = conv_probe.maxpool_grads(
        torch.from_numpy(x).bfloat16())
    got_eq, got_first = eqsplit(), first_max()
    np.testing.assert_array_equal(got_eq.float().numpy(),
                                  np.asarray(want_eq.astype(jnp.float32)))
    np.testing.assert_array_equal(got_first.float().numpy(),
                                  np.asarray(want_first.astype(jnp.float32)))
    # ties split the gradient, so the two differ where a window's maximum
    # is tied, and their sums agree
    assert not torch.equal(got_eq, got_first)
    assert got_eq.float().sum().item() == pytest.approx(
        got_first.float().sum().item(), rel=1e-5)
    y = conv_probe.maxpool(torch.from_numpy(x))
    np.testing.assert_array_equal(y.numpy(),
                                  np.asarray(jconv.maxpool_xla(
                                      jnp.asarray(x))))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(2, 4, 4, 16, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 16, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="stride"):
        CV.conv3x3(x, w, stride=2)
    with pytest.raises(ValueError, match="multiples of 16"):
        CV.conv3x3(torch.zeros(2, 4, 4, 24), torch.zeros(3, 3, 24, 32))
    with pytest.raises(ValueError, match=r"\[3, 3, C, K\]"):
        CV.conv3x3(x, torch.zeros(1, 1, 16, 32))
    with pytest.raises(ValueError, match="multiples of 16"):
        BG.bn_relu_gemm(torch.zeros(4, 16), torch.zeros(16),
                        torch.zeros(16), torch.zeros(16, 8))
    with pytest.raises(ValueError, match=r"\[M, C\]"):
        BG.bn_relu_gemm(torch.zeros(4, 16), torch.zeros(32),
                        torch.zeros(16), torch.zeros(16, 16))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        CV.conv3x3(x.to("meta"), w.to("meta"))
    before = (CV.conv3x3.launches, BG.bn_relu_gemm.launches)
    CV.conv3x3(x, w)
    BG.bn_relu_gemm(torch.zeros(4, 16), torch.zeros(16), torch.zeros(16),
                    torch.zeros(16, 16))
    assert (CV.conv3x3.launches, BG.bn_relu_gemm.launches) == before


def test_probe_work_counts_at_batch_128():
    """The probes' operations and bytes at batch 128, the bound's inputs."""
    assert conv_probe.conv_work(128, 28, 128, 128) == (29595009024,
                                                        51675136)
    assert conv_probe.conv_work(128, 14, 256, 256)[0] == 29595009024
    assert bn_gemm_probe.gemm_work(128 * 56 * 56, 256, 64)[1] == 256935936
    assert bn_gemm_probe.gemm_work(128 * 28 * 28, 512, 128)[1] == 128585728


@pytest.mark.parametrize("probe", [conv_probe, bn_gemm_probe])
def test_probe_entry_points_need_a_card(monkeypatch, probe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        probe.main([])
    assert exc.value.code == 2


def test_conv_probe_runs_every_shape_with_device_times(monkeypatch):
    """The conv probe's control flow at batch 1 on the CPU (the plain
    versions and F.conv2d, one call each in place of the card's timing):
    one record per conv shape with its event and device times, bound and
    error, and the max-pool record."""
    def one_call_each(**fns):
        return {k: float(fn() is not None) for k, fn in fns.items()}

    monkeypatch.setattr(conv_probe, "in_turns", one_call_each)
    monkeypatch.setattr(conv_probe, "device_in_turns", one_call_each)
    before = CV.conv3x3.launches
    records = conv_probe.run(1, device="cpu")
    assert CV.conv3x3.launches == before
    assert [r["shape"] for r in records[:2]] == [s[0] for s in
                                                  conv_probe.SHAPES]
    for rec in records[:2]:
        assert rec["kernel_ms"] == rec["library_ms"] == 1.0
        assert rec["kernel_device_ms"] == rec["library_device_ms"] == 1.0
        assert rec["max_abs_err"] == 0.0  # the CPU ran the plain version
        assert rec["bound_ms"] > 0 and rec["flops"] > 0
        assert rec["library_max_abs_err"] < 0.1
    assert records[2]["probe"] == "stem_maxpool"
    assert records[2]["grad_sum_first_max"] == pytest.approx(
        records[2]["grad_sum_eqsplit"], rel=1e-5)


def test_bn_gemm_probe_runs_every_shape_with_device_times(monkeypatch):
    """The BN-prologue GEMM probe's control flow at batch 1 on the CPU (the
    plain versions, one call each in place of the card's timing): one
    record per shape with its event and device times, bound and errors."""
    def one_call_each(**fns):
        return {k: float(fn() is not None) for k, fn in fns.items()}

    monkeypatch.setattr(bn_gemm_probe, "in_turns", one_call_each)
    monkeypatch.setattr(bn_gemm_probe, "device_in_turns", one_call_each)
    before = BG.bn_relu_gemm.launches
    records = bn_gemm_probe.run(1, device="cpu")
    assert BG.bn_relu_gemm.launches == before
    assert [r["shape"] for r in records] == [s[0] for s in
                                             bn_gemm_probe.SHAPES]
    for rec, (_, hw, c, k) in zip(records, bn_gemm_probe.SHAPES):
        assert (rec["m"], rec["c"], rec["k"]) == (hw * hw, c, k)
        assert rec["kernel_ms"] == rec["two_op_ms"] == 1.0
        assert rec["kernel_device_ms"] == rec["two_op_device_ms"] == 1.0
        assert rec["library_ms"] is None
        assert rec["max_abs_err"] == 0.0  # the CPU ran the plain version
        assert rec["two_op_max_abs_err"] < 0.1
        assert rec["bound_by"] == "bytes" and rec["bound_ms"] > 0
