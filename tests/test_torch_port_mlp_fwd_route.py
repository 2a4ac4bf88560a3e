"""The CUDA route of the MLP forwards #2 (``ln_mlp``) and #9
(``fused_mlp``) without a card, and the GELU of their epilogue.

The route: with the library and the stream replaced by a recorder, each
wrapper allocates its scratch at (M, D, F) (h [M, F] and, for #2, ln
[M, D], the LayerNorm pass's output that the first product reads), makes
one call of its C entry point with the operands' pointers in the order of
the C signature, and counts one launch; what the CUDA kernel does not take
(operands off 16-byte alignment, which its products read by TMA, fp32
operands, D or F not divisible by 32) raises before any call.

The GELU: the epilogue (``csrc/gelu.cuh:gelu_cdf_pdf``) forms h = z *
Phi(z) with Phi = 0.5 + sign(z) * (0.5 - 0.5 * poly * e), the A&S erf's
polynomial and e = exp(-z^2 / 2); the reference
(``vlp_tpu.ops.fused_mlp._gelu``) forms 0.5 * z * (1 + erf(z / sqrt 2)).
A torch mirror of the epilogue's form (torch's exp and division in place
of the card's approximations, which ``scripts/gelu_epilogue_gap.py``
measures on the card) is held to the reference in bf16 over z in [-12, 12].
"""
import contextlib
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.ops import fused_mlp as JFM
from vlp_tpu_torch.ops import fused_block as TFB
from vlp_tpu_torch.ops import fused_mlp as TFM


class _FakeLibrary:
    """Records the forward entry points' arguments in place of the card."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name not in ("vlp_ln_mlp", "vlp_fused_mlp"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    for mod in (TFB, TFM):
        monkeypatch.setattr(mod, "_route", lambda name, x: True)
        monkeypatch.setattr(mod, "_stream", lambda: 7)
        monkeypatch.setattr(mod._build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return lib


@pytest.fixture
def allocations(monkeypatch):
    """{data_ptr: (shape, dtype)} of every tensor made by ``torch.empty``
    or ``torch.empty_like`` while the test runs."""
    made = {}
    empty, empty_like = torch.empty, torch.empty_like

    def record(fn):
        def make(*args, **kwargs):
            t = fn(*args, **kwargs)
            made[t.data_ptr()] = (tuple(t.shape), t.dtype)
            return t
        return make
    monkeypatch.setattr(torch, "empty", record(empty))
    monkeypatch.setattr(torch, "empty_like", record(empty_like))
    return made


def _operands(m, d, f, dtype=torch.bfloat16):
    """x [m, d], w1 [d, f], w2 [f, d] in ``dtype``; gamma, beta, b2 [d] and
    b1 [f] fp32."""
    return (torch.zeros(m, d, dtype=dtype), torch.zeros(d, f, dtype=dtype),
            torch.zeros(f, d, dtype=dtype), torch.ones(d), torch.zeros(d),
            torch.zeros(f), torch.zeros(d))


# NesT level 0 rows at batch 8; serving's ragged 37 images at level 2; one
# row
SHAPES = [(25088, 96, 384), (37 * 196, 384, 1536), (1, 32, 128)]


@pytest.mark.parametrize("m,d,f", SHAPES)
def test_ln_mlp_cuda_route_passes_its_operands(fake, allocations, m, d, f):
    x, w1, w2, g, b, b1, b2 = _operands(m, d, f)
    before = TFB.ln_mlp.launches
    y = TFB.ln_mlp(x, g, b, w1, b1, w2, b2)
    assert TFB.ln_mlp.launches == before + 1
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    (name, args), = fake.calls
    assert name == "vlp_ln_mlp"
    # x, gamma, beta, w1, b1, w2, b2 (the vectors cast to fp32 [1, n]); the
    # scratch ln and h; y; then M, D, F, eps, stream
    assert args[0] == x.data_ptr() and args[3] == w1.data_ptr() and \
        args[5] == w2.data_ptr()
    assert allocations[args[7]] == ((m, d), torch.bfloat16)  # ln
    assert allocations[args[8]] == ((m, f), torch.bfloat16)  # h
    assert args[9] == y.data_ptr()
    assert len({args[7], args[8], args[9], x.data_ptr()}) == 4
    assert args[10:13] == (m, d, f)
    assert args[13] == pytest.approx(1e-6) and args[14] == 7


@pytest.mark.parametrize("m,d,f", SHAPES)
def test_fused_mlp_cuda_route_passes_its_operands(fake, allocations, m, d,
                                                  f):
    x, w1, w2, _, _, b1, b2 = _operands(m, d, f)
    before = TFM.fused_mlp.launches
    y = TFM.fused_mlp(x, w1, b1, w2, b2)
    assert TFM.fused_mlp.launches == before + 1
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    (name, args), = fake.calls
    assert name == "vlp_fused_mlp"
    # x, w1, b1, w2, b2; the scratch h; y; M, D, F, stream
    assert args[0] == x.data_ptr() and args[1] == w1.data_ptr() and \
        args[3] == w2.data_ptr()
    assert allocations[args[5]] == ((m, f), torch.bfloat16)  # h
    assert args[6] == y.data_ptr() and args[5] != args[6]
    assert args[7:10] == (m, d, f) and args[10] == 7


def _misaligned(t):
    """``t``'s values in a buffer 2 bytes off a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


REFUSALS = [("x_misaligned", "16-byte aligned"),
            ("w1_misaligned", "16-byte aligned"),
            ("w2_misaligned", "16-byte aligned"),
            ("fp32", "bfloat16"),
            ("d48", "divisible by 32"),
            ("f200", "divisible by 32")]


def _refused_operands(case):
    m, d, f = 40, 64, 256
    if case == "d48":
        d = 48
    if case == "f200":
        f = 200
    x, w1, w2, g, b, b1, b2 = _operands(
        m, d, f, torch.float32 if case == "fp32" else torch.bfloat16)
    mis = {"x": x, "w1": w1, "w2": w2}
    if case.endswith("misaligned"):
        name = case.split("_")[0]
        mis[name] = _misaligned(mis[name])
    return mis["x"], mis["w1"], mis["w2"], g, b, b1, b2


@pytest.mark.parametrize("case,match", REFUSALS)
def test_ln_mlp_cuda_route_refuses(fake, case, match):
    x, w1, w2, g, b, b1, b2 = _refused_operands(case)
    before = TFB.ln_mlp.launches
    with pytest.raises((ValueError, TypeError), match=match):
        TFB.ln_mlp(x, g, b, w1, b1, w2, b2)
    assert fake.calls == [] and TFB.ln_mlp.launches == before


@pytest.mark.parametrize("case,match", REFUSALS)
def test_fused_mlp_cuda_route_refuses(fake, case, match):
    x, w1, w2, _, _, b1, b2 = _refused_operands(case)
    before = TFM.fused_mlp.launches
    with pytest.raises((ValueError, TypeError), match=match):
        TFM.fused_mlp(x, w1, b1, w2, b2)
    assert fake.calls == [] and TFM.fused_mlp.launches == before


def _gelu_epilogue_mirror(z: torch.Tensor) -> torch.Tensor:
    """``csrc/gelu.cuh:gelu_cdf_pdf``'s h = z * Phi(z) in torch fp32."""
    a = z.abs() * 0.7071067811865476
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    e = torch.exp(-0.5 * z * z)
    return z * (0.5 + torch.copysign(0.5 - 0.5 * poly * e, z))


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in their order: the card's measure of the
    same gap, ``scripts/gelu_epilogue_gap.py:_ordered``."""
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "gelu_epilogue_gap.py"
    spec = importlib.util.spec_from_file_location("gelu_epilogue_gap", path)
    gap = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gap)
    return gap._ordered(x)


def _tanh_gelu(z: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU: a wrong form for these kernels."""
    return 0.5 * z * (1.0 + torch.tanh(
        0.7978845608028654 * (z + 0.044715 * z ** 3)))


# Segments of the sweep over [-12, 12] (2^20 points each, evenly spaced,
# and 2^16 normal draws scaled to the segment, from a seed). For z >= -4
# the two forms differ by a few fp32 ulps of Phi >= 3e-5, which can flip
# one bf16 rounding: 1 ulp. Below, both forms take Phi as a difference of
# nearly equal fp32 numbers (the mirror 0.5 - 0.5 poly e, whose rounding
# errs by up to 2^-26; the reference 1 + erf with erf = -(1 - poly e),
# rounded near 1, up to 2^-25, halved), so they may differ by 2^-25 in
# Phi, |z| 2^-25 in h: tens of bf16 ulps of an h near 1e-6 (z = -4.95: 19
# ulps). There the bound is that absolute gap, doubled, plus one ulp, and
# where h lies 16 times above it (z in [-4.8, -4]), a relative gap of 1/8
# as well. Below z = -6 the true |h| < 6e-9 lies under that floor and both
# forms give h = 0 (so does a tanh-form GELU): no fp32 form of this shape
# is told apart there, and the segments from -6 up are what catch a wrong
# one (test_gelu_bounds_reject_the_tanh_form).
SEGMENTS = [(-12.0, -6.0), (-6.0, -4.0), (-4.0, -2.0), (-2.0, 0.0),
            (0.0, 2.0), (2.0, 12.0)]


def _sweep(lo: float, hi: float) -> np.ndarray:
    rng = np.random.default_rng(int(1000 * (lo + 12)))
    return np.concatenate([
        np.linspace(lo, hi, 2 ** 20, dtype=np.float32),
        np.clip(lo + (hi - lo) * np.abs(rng.standard_normal(2 ** 16)) / 4,
                lo, hi).astype(np.float32)])


def _gelu_bound_failures(lo: float, z: np.ndarray, h32: torch.Tensor):
    """The bounds above that ``h32`` (fp32 GELU of ``z``, segment from
    ``lo``) breaks against ``vlp_tpu.ops.fused_mlp._gelu``, by name."""
    ref32 = torch.from_numpy(
        np.asarray(JFM._gelu(jnp.asarray(z)), np.float32).copy())
    tz = torch.from_numpy(z.copy())
    ref, mine = ref32.bfloat16(), h32.bfloat16()
    if lo >= -4.0:
        ulps = (_ordered(mine) - _ordered(ref)).abs()
        return [] if ulps.max().item() <= 1 else ["1 ulp"]
    failed = []
    floor = tz.abs() * 2.0 ** -24
    gap32 = (h32 - ref32).abs()
    if not (gap32 <= floor).all():
        failed.append("fp32 gap")
    spacing = (mine.float().abs() * 2.0 ** -7).clamp_min(2.0 ** -133)
    if not ((mine.float() - ref.float()).abs() <= floor + spacing).all():
        failed.append("bf16 gap")
    above = ref32.abs() >= 16 * floor
    if not (gap32[above] <= ref32.abs()[above] / 8).all():
        failed.append("relative gap")
    return failed


@pytest.mark.parametrize("lo,hi", SEGMENTS)
def test_gelu_epilogue_mirror_matches_the_reference_in_bf16(lo, hi):
    z = _sweep(lo, hi)
    assert _gelu_bound_failures(
        lo, z, _gelu_epilogue_mirror(torch.from_numpy(z.copy()))) == []


# The bounds tell the tanh form from the erf form in [-6, -2] (by up to
# thousands of bf16 ulps); above -2 the two lie within 1 ulp of each other,
# below -6 both give 0.
@pytest.mark.parametrize("lo,hi", [(-6.0, -4.0), (-4.0, -2.0)])
def test_gelu_bounds_reject_the_tanh_form(lo, hi):
    z = _sweep(lo, hi)
    failed = _gelu_bound_failures(lo, z, _tanh_gelu(torch.from_numpy(
        z.copy())))
    assert failed == (["1 ulp"] if lo >= -4.0 else
                      ["fp32 gap", "bf16 gap", "relative gap"])
