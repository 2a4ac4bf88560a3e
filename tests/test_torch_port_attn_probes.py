"""The attention schedule probes' plain versions (``ops/attn_sched.py``)
against the Pallas kernels of ``benchmarks/mega_variants.py``
(``make_attn``: #15, ``make_attn_bwd``: #16) run in TPU interpret mode on
the CPU, on inputs drawn by numpy from a seed and rounded to bf16 (biases
and beta nonzero, gamma not 1); the probe's work counts, refusals and
control flow.

The script is loaded from its file (``benchmarks/`` is not a package). Its
Pallas bodies read the module globals ``HEADS``, ``DH``, ``S`` and
``SCALE`` when they are traced, so the tests set them on the loaded module
for the small size (2 heads of 32, S 20, N 3).

Tolerances: both sides take bf16 operands whose products are exact in fp32,
sum them in fp32 in other orders and round to bf16 at the same points, and
XLA's and PyTorch's exp may differ by an ulp. A bf16 output (y, dx) may
differ by one rounding step of the larger of the two (2^-7 of it, plus
2^-7 of the largest |output| for the fp32 sums' order). The backward's fp32
outputs are sums over rows: dbout sums dy alone, 1e-4 of its largest
|value|; dgamma, dbeta, dWqkv and dWout sum products with bf16 values
(ln, o, dqkv) whose rounding the fp32 order can flip by one bf16 step (2^-8
of the value, in a few elements), which moves a sum by up to one step of
that term: 2^-8 of the output's largest |value|. dbqkv sums the fp32 dqkv
over the rows; its dq and dk parts are sums of products with the bf16 ds,
whose flipped roundings move them in the same way: 2^-8 of its largest
|value|. (dbk is zero in exact arithmetic, softmax being invariant to a
shift of a row, so its part is rounding noise far below that.)
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vlp_tpu_torch.ops import attn_sched as AS
from vlp_tpu_torch.ops.block_attention import (attend_qkv_bwd_plain,
                                               attend_qkv_plain)
from vlp_tpu_torch.probes import attn_probe
from vlp_tpu_torch.probes._timing import bound_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADS, DH, SEQ, N = 2, 32, 20, 3
D = HEADS * DH
BWD_NAMES = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwout", "dbout")
FP32_REL = {"dgamma": 2.0 ** -8, "dbeta": 2.0 ** -8, "dwqkv": 2.0 ** -8,
            "dbqkv": 2.0 ** -8, "dwout": 2.0 ** -8, "dbout": 1e-4}


@pytest.fixture(scope="module")
def jmega():
    spec = importlib.util.spec_from_file_location(
        "jax_mega_variants_attn",
        os.path.join(REPO, "benchmarks", "mega_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.HEADS, mod.DH, mod.S, mod.SCALE = HEADS, DH, SEQ, DH ** -0.5
    return mod


def _bf16(rng, *shape, scale=1.0):
    """numpy draws rounded to bf16, as float32 arrays."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _inputs(seed):
    """x, gamma, beta, wqkv, bqkv, wout, bout, dy: bf16-valued fp32 arrays
    for x, the weights and dy; fp32 [1, n] vectors."""
    rng = np.random.default_rng(seed)
    vec = lambda n, s: (rng.standard_normal((1, n)) * s).astype(  # noqa
        np.float32)
    return (_bf16(rng, N, SEQ, D), 1.0 + vec(D, 0.2), vec(D, 0.5),
            _bf16(rng, D, 3 * D, scale=2 * D ** -0.5), vec(3 * D, 0.5),
            _bf16(rng, D, D, scale=D ** -0.5), vec(D, 0.5),
            _bf16(rng, N, SEQ, D))


def _jax(arrays, bf16_at):
    return [jnp.asarray(a, jnp.bfloat16) if i in bf16_at else jnp.asarray(a)
            for i, a in enumerate(arrays)]


def _torch(arrays, bf16_at):
    return [torch.from_numpy(a).bfloat16() if i in bf16_at
            else torch.from_numpy(a) for i, a in enumerate(arrays)]


def _within_one_rounding(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    step = 2.0 ** -7 * (np.maximum(np.abs(got), np.abs(want))
                        + np.abs(want).max())
    assert got.shape == want.shape
    assert (np.abs(got - want) <= step).all(), np.abs(got - want).max()


@pytest.mark.parametrize("mode", AS.MODES)
def test_plain_attn_sched_matches_pallas_make_attn(jmega, mode):
    arrays = _inputs(AS.MODES.index(mode))[:7]
    with pltpu.force_tpu_interpret_mode():
        want = jmega.make_attn(mode)(*_jax(arrays, (0, 3, 5)))
    got = AS.attn_sched(*_torch(arrays, (0, 3, 5)), HEADS, mode)
    assert got.dtype == torch.bfloat16 and got.shape == (N, SEQ, D)
    _within_one_rounding(got.float().numpy(), want.astype(jnp.float32))


@pytest.mark.parametrize("mode", AS.BWD_MODES)
def test_plain_attn_sched_bwd_matches_pallas_make_attn_bwd(jmega, mode):
    x, g, b, wq, bq, wo, _, dy = _inputs(10 + AS.BWD_MODES.index(mode))
    arrays = (x, g, b, wq, bq, wo, dy)
    bf16_at = (0, 3, 5, 6)
    with pltpu.force_tpu_interpret_mode():
        want = jmega.make_attn_bwd(mode)(*_jax(arrays, bf16_at))
    got = AS.attn_sched_bwd(*_torch(arrays, bf16_at), HEADS, mode)
    for name, gt, wt in zip(BWD_NAMES, got, want):
        wt = np.asarray(wt.astype(jnp.float32))
        assert tuple(gt.shape) == wt.shape, name
        if name == "dx":
            assert gt.dtype == torch.bfloat16
            _within_one_rounding(gt.float().numpy(), wt)
        else:
            assert gt.dtype == torch.float32, name
            np.testing.assert_allclose(gt.numpy(), wt, rtol=0,
                                       atol=FP32_REL[name] * np.abs(wt).max(),
                                       err_msg=name)


@pytest.mark.parametrize("mode", [m for m in AS.MODES if m != "nosm"])
def test_plain_core_equals_attend_qkv_plain(mode):
    """The same function with the same division point as the port's
    ``attend_qkv_plain``: equal bit for bit on the same qkv."""
    x, g, b, wq, bq, _, _, _ = _torch(_inputs(20), (0, 3, 5))
    qkv = AS.ln_qkv_plain(x, g, b, wq, bq)[-1]
    o = AS.attn_sched_core(qkv, HEADS, mode)
    assert o.dtype == torch.bfloat16 and o.shape == (N, SEQ, D)
    assert torch.equal(o, attend_qkv_plain(qkv, HEADS))


def test_nosm_core_is_the_scaled_scores_bound():
    x, g, b, wq, bq, _, _, _ = _torch(_inputs(21), (0, 3, 5))
    qkv = AS.ln_qkv_plain(x, g, b, wq, bq)[-1].float()
    o = AS.attn_sched_core(qkv, HEADS, "nosm")
    q, k, v = qkv.view(N, SEQ, 3, HEADS, DH).permute(2, 0, 3, 1, 4)
    p = (q @ k.transpose(-1, -2)) * DH ** -0.5 * 0.01
    want = (p @ v).transpose(1, 2).reshape(N, SEQ, D)
    torch.testing.assert_close(o, want, rtol=1e-5, atol=1e-6)


def test_bwd_core_plain_is_the_recip_o_and_attend_qkv_bwd():
    """The kernels' backward core: o multiplies by 1/l (one bf16 rounding
    from the forward's o in some elements), dqkv is #8's."""
    x, g, b, wq, bq, _, _, dy = _torch(_inputs(22), (0, 3, 5, 7))
    qkv = AS.ln_qkv_plain(x, g, b, wq, bq)[-1]
    for mode in AS.BWD_MODES:
        o, dqkv = AS.attn_sched_bwd_core(qkv, dy, HEADS, mode)
        assert o.dtype == dqkv.dtype == torch.bfloat16
        assert dqkv.shape == (N, SEQ, 3 * D)
        _within_one_rounding(o.float().numpy(),
                             attend_qkv_plain(qkv, HEADS).float().numpy())
        assert torch.equal(dqkv, attend_qkv_bwd_plain(qkv, dy, HEADS))


def test_fp32_weight_gradients_and_recip_o_feed_dwout():
    """dWqkv and dWout come back fp32, as the Pallas outputs do; dWout is
    o^T dy with the backward's o = bf16((bf16(p) @ v) * (1/l))."""
    x, g, b, wq, bq, wo, _, dy = _torch(_inputs(23), (0, 3, 5, 7))
    outs = AS.attn_sched_bwd(x, g, b, wq, bq, wo, dy, HEADS, "uni")
    assert [t.dtype for t in outs] == [torch.bfloat16] + [torch.float32] * 6
    assert outs[3].shape == (D, 3 * D) and outs[5].shape == (D, D)
    qkv = AS.ln_qkv_plain(x, g, b, wq, bq)[-1]
    o = AS.attn_sched_bwd_core(qkv, dy, HEADS)[0]
    want = o.reshape(-1, D).float().T @ dy.reshape(-1, D).float()
    torch.testing.assert_close(outs[5], want, rtol=1e-6, atol=1e-5)


def test_probe_work_counts_and_bounds_at_batch_128():
    fwd = attn_probe.attn_work(128, 196, 384)
    bwd = attn_probe.attn_work(128, 196, 384, backward=True)
    assert fwd == (37147901952, 39724032)
    assert bwd == (104044953600, 61358592)
    for work, ms in ((fwd, 0.0376), (bwd, 0.1052)):
        b = bound_ms(*work)
        assert b["bound_by"] == "operations"
        assert b["bound_ms"] == pytest.approx(ms, rel=2e-3)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, g, b, wq, bq, wo, bo, dy = _torch(_inputs(24), (0, 3, 5, 7))
    params = (g, b, wq, bq, wo, bo)
    with pytest.raises(ValueError, match="head_dim 32"):
        AS.attn_sched(x, *params, 4)
    with pytest.raises(ValueError, match="unknown mode"):
        AS.attn_sched(x, *params, HEADS, "uni")
    with pytest.raises(ValueError, match="unknown mode"):
        AS.attn_sched_bwd(x, *params[:5], dy, HEADS, "pipe")
    with pytest.raises(ValueError, match="unknown mode"):
        AS.attn_sched_core_plain(x, HEADS, "batched")
    long = torch.zeros(1, 225, D, dtype=torch.bfloat16)
    for mode, fine in (("pipe", True), ("pipe2", False), ("stage", False)):
        if fine:
            AS.attn_sched(long, *params, HEADS, mode)
        else:
            with pytest.raises(ValueError, match="S <= "):
                AS.attn_sched(long, *params, HEADS, mode)
    with pytest.raises(ValueError, match="S <= 240"):
        AS.attn_sched_bwd(torch.zeros(1, 241, D, dtype=torch.bfloat16),
                          *params[:5], torch.zeros(1, 241, D), HEADS, "uni")
    with pytest.raises(ValueError, match="S <= 208"):
        AS.attn_sched_bwd_core(torch.zeros(1, 209, 3 * D), torch.zeros(
            1, 209, D), HEADS, "stage2")
    wide = torch.zeros(1, 4, 1056, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D <= 1024"):
        AS.attn_sched_core(torch.zeros(1, 4, 3 * 1056), 33)
    with pytest.raises(ValueError, match="D <= 1024"):
        AS.attn_sched(wide, *params, 33)
    with pytest.raises(ValueError, match="parameter shape"):
        AS.attn_sched(x, g, b, wo, bq, wo, bo, HEADS)
    with pytest.raises(ValueError, match="parameter shape"):
        AS.attn_sched(x, g, b, wq, bq, wo, bq, HEADS)
    with pytest.raises(ValueError, match="dy does not match"):
        AS.attn_sched_bwd(x, *params[:5], dy[:1], HEADS)
    with pytest.raises(ValueError, match="do does not match"):
        AS.attn_sched_bwd_core(torch.zeros(N, SEQ, 3 * D), dy[:1], HEADS)
    with pytest.raises(ValueError, match=r"\[N, S, 3D\]"):
        AS.attn_sched_core(torch.zeros(N, SEQ, 3 * D + 1), HEADS)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        AS.attn_sched_core(torch.zeros(N, SEQ, 3 * D, device="meta"), HEADS)
    before = [k.launches for k in AS.KERNELS]
    AS.attn_sched(x, *params, HEADS, "stage")
    AS.attn_sched_core(torch.zeros(N, SEQ, 3 * D), HEADS, "pipe2")
    AS.attn_sched_bwd(x, *params[:5], dy, HEADS, "stage2")
    AS.attn_sched_bwd_core(torch.zeros(N, SEQ, 3 * D), dy, HEADS, "uni")
    assert [k.launches for k in AS.KERNELS] == before


def test_probe_entry_point_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        attn_probe.main([])
    assert exc.value.code == 2


def test_probe_runs_every_mode(monkeypatch):
    """The control flow at batch 1 on the CPU (the plain versions, one call
    each in place of the card's timing): one record per mode and one per
    shipped kernel, each with its times, bound and error."""
    monkeypatch.setattr(attn_probe, "in_turns", lambda **fns: {
        k: float(fn() is not None) for k, fn in fns.items()})
    records = attn_probe.run(1, device="cpu")
    assert [(r["probe"], r["variant"]) for r in records] == [
        *(("attn_fwd", m) for m in AS.MODES),
        ("attn_fwd", "ln_attention #1 (shipped)"),
        *(("attn_bwd", m) for m in AS.BWD_MODES),
        ("attn_bwd", "ln_attention_bwd #3 (shipped, reads #1's qkv and o, "
                     "recomputes neither)")]
    fwd = attn_probe.attn_work(1, 196, 384)
    bwd = attn_probe.attn_work(1, 196, 384, backward=True)
    for rec in records:
        assert rec["kernel_ms"] == rec["plain_ms"] == 1.0
        assert (rec["flops"], rec["bytes"]) == (
            fwd if rec["probe"] == "attn_fwd" else bwd)
        assert rec["bound_ms"] > 0 and "max_rel_err" in rec
        if "#" not in rec["variant"]:
            assert rec["core_ms"] == rec["sdpa_ms"] == 1.0
            if rec["variant"] == "nosm":
                assert rec["max_abs_err"] is None
            else:  # the CPU ran the plain version
                assert rec["max_abs_err"] == rec["max_rel_err"] == 0.0
