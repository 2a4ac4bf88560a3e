"""The MLP probe kernels' plain versions (``ops/mlp_tile.py``) against the
Pallas kernels of ``benchmarks/mega_variants.py`` (``make_mlp``,
``make_mlp_bwd``: #13, #14) and ``benchmarks/mlp_probe.py``
(``make_chain``, ``make_single``: #19) run in TPU interpret mode on the
CPU, on inputs drawn by numpy from a seed and rounded to bf16; the probes'
work counts, refusals and control flow.

The scripts are loaded from their files (``benchmarks/`` is not a package).
``mlp_probe.py`` reads its module globals ``M``, ``D`` and ``F`` when a
kernel is built, so the tests set them on the loaded module for the small
size.

Tolerances: both sides take bf16 operands whose products are exact in fp32
and sum them in fp32 in other orders (the Pallas schedules splitN, rowpipe
and fsplit differ from v0 only in that order), then round to bf16 at the
same points; a bf16 output may differ by one rounding step of the larger of
the two (2^-7 of it, plus 2^-7 of the largest |output| for the fp32 sums'
order). The backward's fp32 outputs are sums over every row in another
order: db1 and db2 sum fp32 values only, 1e-4 of each output's largest
|value|. dgamma, dbeta, dW1 and dW2 sum products with the bf16 h or dh,
whose rounding the fp32 order (and an ulp of XLA's and PyTorch's exp) can
flip by one bf16 step (2^-8 of the value, in a few of the M * F elements),
which moves a sum by up to one step of that term: 2^-8 of the output's
largest |value| (seen: up to 4.4e-4).
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vlp_tpu_torch.ops import mlp_tile as MT
from vlp_tpu_torch.probes import mega_probe, mlp_probe
from vlp_tpu_torch.probes._timing import bound_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_REL = {"db1": 1e-4, "db2": 1e-4, "dgamma": 2.0 ** -8, "dbeta": 2.0 ** -8,
            "dw1": 2.0 ** -8, "dw2": 2.0 ** -8}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jmega():
    return _load("mega_variants")


@pytest.fixture(scope="module")
def jchain():
    return _load("mlp_probe")


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


def _mlp_inputs(seed, m, d):
    """x, gamma, beta, w1, b1, w2, b2, dy: bf16-valued fp32 arrays for x,
    the weights and dy; fp32 [1, n] vectors."""
    rng = np.random.default_rng(seed)
    f = 4 * d
    vec = lambda n, s: (rng.standard_normal((1, n)) * s).astype(  # noqa
        np.float32)
    return (_bf16(rng, m, d), 1.0 + vec(d, 0.1), vec(d, 0.1),
            _bf16(rng, d, f, scale=d ** -0.5), vec(f, 0.02),
            _bf16(rng, f, d, scale=f ** -0.5), vec(d, 0.02),
            _bf16(rng, m, d))


def _jax_args(arrays, bf16_at):
    return [jnp.asarray(a, jnp.bfloat16) if i in bf16_at else jnp.asarray(a)
            for i, a in enumerate(arrays)]


def _torch_args(arrays, bf16_at):
    return [torch.from_numpy(a).bfloat16() if i in bf16_at
            else torch.from_numpy(a) for i, a in enumerate(arrays)]


@pytest.mark.parametrize("body,tm,kw,flags", [
    ("v0", 64, {"gelu": True, "ln": True}, {}),
    ("v0", 128, {"gelu": False, "ln": True}, {"gelu": False}),
    ("v0", 64, {"gelu": True, "ln": False}, {"ln": False}),
    ("splitn", 128, {"parts": 2}, {}),
    ("rowpipe", 128, {"parts": 2}, {}),
])
def test_plain_mlp_tile_matches_pallas_make_mlp(jmega, body, tm, kw, flags):
    m, d = 256, 64
    arrays = _mlp_inputs(len(body) + tm, m, d)[:7]
    bf16_at = (0, 3, 5)
    kernel = {"v0": jmega.mlp_fwd_kernel_v0,
              "splitn": jmega.mlp_fwd_kernel_splitn,
              "rowpipe": jmega.mlp_fwd_kernel_rowpipe}[body]
    if body == "v0":
        kw = dict(kw, gelu=jmega._gelu if kw["gelu"] else None)
    with pltpu.force_tpu_interpret_mode():
        want = jmega.make_mlp(kernel, tm=tm, **kw)(*_jax_args(arrays,
                                                               bf16_at))
    got = MT.mlp_tile(*_torch_args(arrays, bf16_at), **flags)
    assert got.dtype == torch.bfloat16 and got.shape == (m, d)
    _within_one_rounding(got.float().numpy(), want.astype(jnp.float32))


@pytest.mark.parametrize("body,tm", [("v0", 64), ("v0", 128),
                                     ("fsplit", 64)])
def test_plain_mlp_tile_bwd_matches_pallas_make_mlp_bwd(jmega, body, tm):
    m, d = 256, 64
    x, g, b, w1, b1, w2, _, dy = _mlp_inputs(7 + tm, m, d)
    arrays = (x, g, b, w1, b1, w2, dy)
    bf16_at = (0, 3, 5, 6)
    if body == "v0":
        call = jmega.make_mlp_bwd(jmega.mlp_bwd_kernel_v0, tm=tm)
    else:
        call = jmega.make_mlp_bwd(jmega.mlp_bwd_kernel_fsplit, tm=tm, parts=2)
    with pltpu.force_tpu_interpret_mode():
        want = call(*_jax_args(arrays, bf16_at))
    got = MT.mlp_tile_bwd(*_torch_args(arrays, bf16_at))
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for name, gt, wt in zip(names, got, want):
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


@pytest.mark.parametrize("m,tm,stages", [
    (256, 64, ()), (256, 128, ("gelu",)), (256, 64, ("ln", "gelu")),
    (320, 128, ()), (320, 128, ("ln", "gelu"))])
def test_plain_mlp_chain_matches_pallas_make_chain(jchain, m, tm, stages):
    """At M = 320 and tm = 128 the Pallas grid (M // tm = 2) writes rows
    0-255 only: the rows it writes are compared."""
    d = 64
    f = 4 * d
    jchain.M, jchain.D, jchain.F = m, d, f
    x, _, _, w1, _, w2, _, _ = _mlp_inputs(m + tm + len(stages), m, d)
    with pltpu.force_tpu_interpret_mode():
        want = jchain.make_chain(tm, stages)(
            *_jax_args((x, w1, w2), (0, 1, 2)))
    got = MT.mlp_chain(*_torch_args((x, w1, w2), (0, 1, 2)), stages)
    assert got.dtype == torch.bfloat16 and got.shape == (m, d)
    rows = m // tm * tm
    _within_one_rounding(got[:rows].float().numpy(),
                         want[:rows].astype(jnp.float32))


@pytest.mark.parametrize("m,tm", [(256, 64), (320, 128)])
def test_plain_mlp_single_matches_pallas_make_single(jchain, m, tm):
    d = 128
    f = 4 * d
    jchain.M, jchain.D, jchain.F = m, d, f
    x, _, _, w1, _, _, _, _ = _mlp_inputs(m + tm, m, d)
    with pltpu.force_tpu_interpret_mode():
        want = jchain.make_single(tm)(*_jax_args((x, w1), (0, 1)))
    got = MT.mlp_single(*_torch_args((x, w1), (0, 1)))
    assert got.dtype == torch.bfloat16 and got.shape == (m, f)
    rows = m // tm * tm
    _within_one_rounding(got[:rows].float().numpy(),
                         want[:rows].astype(jnp.float32))


def test_probe_work_counts_and_bounds_at_batch_128():
    m = 128 * 196
    fwd = mega_probe.mlp_work(m, 384, 1536)
    bwd = mega_probe.mlp_work(m, 384, 1536, backward=True)
    chain = mlp_probe.chain_work(m, 384, 1536)
    single = mlp_probe.chain_work(m, 384, 1536, single=True)
    assert fwd[0] == chain[0] == 59190018048
    assert bwd[0] == 147975045120
    assert single == (29595009024, 97517568)
    for work, ms in ((fwd, 0.0599), (chain, 0.0599), (bwd, 0.1496),
                     (single, 0.0299)):
        b = bound_ms(*work)
        assert b["bound_by"] == "operations"
        assert b["bound_ms"] == pytest.approx(ms, rel=2e-3)
    assert single[1] / 3.35e12 * 1e3 == pytest.approx(0.0291, rel=2e-3)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(8, 64, dtype=torch.bfloat16)
    g, b = torch.ones(64), torch.zeros(64)
    w1 = torch.zeros(64, 256, dtype=torch.bfloat16)
    w2 = torch.zeros(256, 64, dtype=torch.bfloat16)
    b1 = torch.zeros(256)
    with pytest.raises(ValueError, match="multiple of 64"):
        MT.mlp_single(torch.zeros(8, 96), torch.zeros(96, 384))
    with pytest.raises(ValueError, match="up to 384"):
        MT.mlp_single(torch.zeros(8, 448), torch.zeros(448, 1792))
    with pytest.raises(ValueError, match="multiple of fs"):
        MT.mlp_single(x, torch.zeros(64, 96, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="instances"):
        MT.mlp_tile_bwd(x, g, b, w1, b1, w2, x, tm=64, fs=128)
    with pytest.raises(ValueError, match="instances"):
        MT.mlp_tile(x, g, b, w1, b1, w2, b, tm=128)
    with pytest.raises(ValueError, match="not both"):
        MT.mlp_tile(x, g, b, w1, b1, w2, b, ln=False, gelu=False)
    with pytest.raises(ValueError, match="stages"):
        MT.mlp_chain(x, w1, w2, ("ln",))
    with pytest.raises(ValueError, match=r"\[M, D\]"):
        MT.mlp_chain(x, w1, w1)
    with pytest.raises(ValueError, match="vector"):
        MT.mlp_tile(x, g, b, w1, g, w2, b)
    with pytest.raises(ValueError, match="dy does not match"):
        MT.mlp_tile_bwd(x, g, b, w1, b1, w2, x[:4])
    with pytest.raises(ValueError, match="no kernel or plain version"):
        MT.mlp_single(x.to("meta"), w1.to("meta"))
    before = [k.launches for k in MT.KERNELS]
    MT.mlp_tile(x, g, b, w1, b1, w2, b)
    MT.mlp_tile_bwd(x, g, b, w1, b1, w2, x)
    MT.mlp_chain(x, w1, w2, ("ln", "gelu"))
    MT.mlp_single(x, w1)
    assert [k.launches for k in MT.KERNELS] == before


@pytest.mark.parametrize("probe", [mega_probe, mlp_probe])
def test_probe_entry_points_need_a_card(monkeypatch, probe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        probe.main([])
    assert exc.value.code == 2


@pytest.mark.parametrize("probe,count", [(mega_probe, 11), (mlp_probe, 16)])
def test_probe_runs_every_variant(monkeypatch, probe, count):
    """The control flow at batch 1 on the CPU (the kernels' plain versions,
    one call each in place of the card's timing): one record per variant,
    each with its times, bound and error."""
    monkeypatch.setattr(probe, "in_turns", lambda **fns: {
        k: float(fn() is not None) for k, fn in fns.items()})
    records = probe.run(1, device="cpu")
    assert len(records) == count
    for rec in records:
        assert rec["kernel_ms"] == rec["plain_ms"] == 1.0
        assert rec["bound_ms"] > 0 and rec["flops"] > 0
        assert "max_rel_err" in rec  # chip_smoke holds it to its bound
        if rec["max_abs_err"] is not None and "#" not in rec["variant"]:
            # the CPU ran the plain version
            assert rec["max_abs_err"] == rec["max_rel_err"] == 0.0


def test_probe_errors_are_absolute_and_relative_to_each_reference():
    refs = (torch.tensor([1.0, -4.0]), torch.tensor([0.5, 0.25]))
    outs = (torch.tensor([1.0, -3.0]), torch.tensor([0.25, 0.25]))
    err = mega_probe.errors(outs, refs)
    assert err == {"max_abs_err": 1.0, "max_rel_err": 0.5}
