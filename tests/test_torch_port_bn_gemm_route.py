"""The CUDA route of the BN-prologue probe GEMM #18 (``bn_relu_gemm``)
without a card, and the sources it is built from.

With the library and the stream replaced by a recorder, the wrapper makes
the output [M, K] as its only allocation, passes x, a, b, w and the output
by pointer in the order of the C signature (``vlp_tpu_torch/ops/_build.py``'s
``_SIGNATURES``; a and b as given, [C] or [1, C], or as views of longer
vectors) and counts one launch. What the kernel does not take raises
before any call: fp32 x, bf16 a or b, C or K not a multiple of 16, C above
``MAX_C`` (the a/b table in shared memory) and x, w or the output off
16-byte alignment (TMA reads and writes them).

The kernel runs on the wgmma + TMA mainloop's register-A form
(``csrc/wgmma_gemm.cuh``'s ``AffineReluRows``); the wmma engine that it ran
on before, ``csrc/implicit_gemm.cuh``, is gone, and with it every
``nvcuda::wmma`` in ``csrc/``: its ``cp.async`` helpers live in
``csrc/common.cuh``. ``scripts/ab_probes.py`` calls a parent checkout's
``vlp_bn_relu_gemm`` by this C signature.
"""
import contextlib
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops import bn_gemm as BG

CSRC = _build.CSRC


class _FakeLibrary:
    """Records ``vlp_bn_relu_gemm`` in place of the card."""

    def __init__(self):
        self.calls = []

    def vlp_bn_relu_gemm(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(BG, "_route", lambda name, x: True)
    monkeypatch.setattr(BG, "_stream", lambda: 7)
    monkeypatch.setattr(BG._build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return lib


@pytest.fixture
def allocations(monkeypatch):
    """{data_ptr: (shape, dtype)} of every tensor made by ``torch.empty``
    while the test runs."""
    made = {}
    empty = torch.empty

    def make(*args, **kwargs):
        t = empty(*args, **kwargs)
        made[t.data_ptr()] = (tuple(t.shape), t.dtype)
        return t
    monkeypatch.setattr(torch, "empty", make)
    return made


def _operands(m, c, k, dtype=torch.bfloat16):
    """x [m, c] and w [c, k] in ``dtype``; a and b [1, c] fp32."""
    return (torch.zeros(m, c, dtype=dtype), torch.ones(1, c),
            torch.zeros(1, c), torch.zeros(c, k, dtype=dtype))


def _misaligned(t):
    """``t``'s values in a buffer 2 bytes off a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


def test_signature_table_matches_the_wrappers_call():
    """x, a, b, w, out, then M, C, K and the stream: the arguments the
    parent's entry point of the same name takes too."""
    args, ret = _build._SIGNATURES["vlp_bn_relu_gemm"]
    assert args == [_build._P] * 5 + [_build._I] * 3 + [_build._P]
    assert ret is _build._I


# (M, C, K): the probe's three at batch 1, the odd chip_smoke check, one
# row, C at the limit
SHAPES = [(3136, 256, 64), (784, 512, 128), (3136, 64, 256), (189, 48, 80),
          (1, 16, 16), (77, BG.MAX_C, 16)]


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("m,c,k", SHAPES)
def test_cuda_route_passes_its_operands(fake, allocations, m, c, k, flat):
    x, a, b, w = _operands(m, c, k)
    if flat:
        a, b = a.reshape(-1), b.reshape(-1)
    before = BG.bn_relu_gemm.launches
    y = BG.bn_relu_gemm(x, a, b, w)
    assert BG.bn_relu_gemm.launches == before + 1
    (args,) = fake.calls
    assert y.shape == (m, k) and y.dtype == torch.bfloat16
    assert args == (x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
                    y.data_ptr(), m, c, k, 7)
    # the output is the only allocation: no scratch, no copy of a or b
    assert allocations == {y.data_ptr(): ((m, k), torch.bfloat16)}


def test_cuda_route_passes_views_of_longer_vectors(fake, allocations):
    """a and b as the first C of longer vectors whose tail holds NaN: their
    own pointers reach the kernel, which reads C channels of each."""
    x, _, _, w = _operands(189, 48, 80)
    long_a = torch.full((1, 112), float("nan"))
    long_b = torch.full((1, 112), float("nan"))
    y = BG.bn_relu_gemm(x, long_a[:, :48], long_b[:, :48], w)
    (args,) = fake.calls
    assert args[1:3] == (long_a.data_ptr(), long_b.data_ptr())
    assert args[6] == 48 and y.shape == (189, 80)
    assert list(allocations) == [y.data_ptr()]


REFUSALS = [("x_fp32", TypeError, "bfloat16"),
            ("a_bf16", TypeError, "fp32 a, b"),
            ("c24", ValueError, "multiples of 16"),
            ("k8", ValueError, "multiples of 16"),
            ("c_above_limit", ValueError, f"C up to {BG.MAX_C}"),
            ("x_misaligned", ValueError, "16-byte aligned"),
            ("w_misaligned", ValueError, "16-byte aligned"),
            ("x_strided", ValueError, "contiguous")]


def _refused(case):
    m, c, k = {"c24": (8, 24, 16), "k8": (8, 16, 8),
               "c_above_limit": (8, BG.MAX_C + 16, 16)}.get(case, (8, 64, 32))
    x, a, b, w = _operands(m, c, k, torch.float32 if case == "x_fp32"
                           else torch.bfloat16)
    if case == "a_bf16":
        a = a.bfloat16()
    if case == "x_misaligned":
        x = _misaligned(x)
    if case == "w_misaligned":
        w = _misaligned(w)
    if case == "x_strided":
        x = torch.zeros(c, m, dtype=torch.bfloat16).t()
    return x, a, b, w


@pytest.mark.parametrize("case,exc,match", REFUSALS)
def test_cuda_route_refuses_before_any_call(fake, case, exc, match):
    before = BG.bn_relu_gemm.launches
    with pytest.raises(exc, match=match):
        BG.bn_relu_gemm(*_refused(case))
    assert fake.calls == [] and BG.bn_relu_gemm.launches == before


def test_cuda_route_refuses_a_misaligned_output(fake, monkeypatch):
    """The output is written by 16-byte stores from the kernel's
    registers: an allocation off 16 bytes raises before the call."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: _misaligned(
        empty(*a, **k)))
    with pytest.raises(ValueError, match="16-byte aligned"):
        BG.bn_relu_gemm(*_operands(8, 64, 32))
    assert fake.calls == []


def test_the_plain_version_takes_any_c_on_the_cpu():
    """``MAX_C`` is the kernel's shared-memory table; the CPU runs the plain
    version and takes C above it."""
    x, a, b, w = _operands(2, BG.MAX_C + 16, 16)
    assert BG.bn_relu_gemm(x, a, b, w).shape == (2, 16)


def test_max_c_is_the_kernels_table():
    """``MAX_C`` is ``csrc/wgmma_gemm.cuh``'s ``kMaxAffineChannels``, and the
    table holds (a, b) in fp32 for each."""
    src = (CSRC / "wgmma_gemm.cuh").read_text()
    assert int(re.search(r"constexpr int kMaxAffineChannels = (\d+);",
                         src).group(1)) == BG.MAX_C
    assert "kTableBytes = 8 * kMaxAffineChannels" in src


SOURCES = sorted(p.name for p in CSRC.glob("*.cu*"))


@pytest.mark.parametrize("name", SOURCES)
def test_no_source_uses_the_wmma_engine(name):
    """No source includes the deleted ``implicit_gemm.cuh`` or ``<mma.h>``
    or uses ``nvcuda::wmma`` or the engine's ``igemm`` namespace."""
    src = (CSRC / name).read_text()
    assert not re.search(r'#include\s*[<"](implicit_gemm\.cuh|mma\.h)[>"]',
                         src)
    assert "nvcuda" not in src and "wmma::" not in src
    assert "igemm" not in src


def test_the_wmma_engine_is_deleted_and_its_copies_live_in_common():
    assert not (CSRC / "implicit_gemm.cuh").exists()
    common = (CSRC / "common.cuh").read_text()
    for helper in ("void cp_async16(void* dst, const void* src",
                   "void cp_async_commit()", "void cp_async_wait()"):
        assert helper in common
    assert "cp.async.cg.shared.global" in common
    assert "cp.async.wait_group" in common
    for name in ("mhsa_reg.cuh", "mhsa_reg_bwd.cuh"):
        src = (CSRC / name).read_text()
        assert "cp_async_wait<" in src and "cp_async_commit()" in src


def test_bn_relu_gemm_runs_the_register_a_form():
    """#18's entry point launches the mainloop's register-A form at 64 and
    128 columns a tile; the policy declares the transform and its table."""
    src = (CSRC / "bn_relu_gemm.cu").read_text()
    assert '#include "wgmma_gemm.cuh"' in src
    assert "launch_affine_relu<64>" in src
    assert "launch_affine_relu<128>" in src
    head = (CSRC / "wgmma_gemm.cuh").read_text()
    policy = head[head.index("struct AffineReluRows {"):]
    policy = policy[:policy.index("\n};\n")]
    assert "static constexpr bool kTransformA = true;" in policy
    assert "__fadd_rn(__fmul_rn(" in policy and "fmaxf(" in policy
    assert "MmaRS<BN, Src::kTnspB>::run(" in head
    assert "ldmatrix_x4(" in head


def _ab_probes():
    path = Path(__file__).resolve().parents[1] / "scripts" / "ab_probes.py"
    spec = importlib.util.spec_from_file_location("ab_probes", path)
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    return ab


def test_ab_probes_takes_18_from_the_parents_library():
    """In the parent's turns #18 runs the parent's ``vlp_bn_relu_gemm``
    through this tree's wrapper, at the probe's three shapes (the probe's
    draws, here at batch 1 on the CPU)."""
    ab = _ab_probes()
    assert "vlp_bn_relu_gemm" in ab.PARENT_ENTRY_POINTS
    from vlp_tpu_torch.probes import bn_gemm_probe
    ops = ab.bn_inputs(1, torch.Generator().manual_seed(0))
    assert list(ops) == [s[0] for s in bn_gemm_probe.SHAPES]
    for (x, a, b, w), (_, hw, c, k) in zip(ops.values(),
                                            bn_gemm_probe.SHAPES):
        assert x.shape == (hw * hw, c) and w.shape == (c, k)
        assert a.shape == b.shape == (1, c) and a.dtype == torch.float32


def test_ab_probes_compares_the_builds_registers():
    """The registers of the mainloop's and the cores' instances in two
    ptxas reports: the same, the changed, and those in one build only."""
    ab = _ab_probes()

    def log(entries):
        return "\n".join(
            f"ptxas info    : Compiling entry function '{k}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {k}\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            f"loads\nptxas info    : Used {r} registers, used 1 barriers"
            for k, r in entries.items())
    conv = ("_ZN3vlp2wg17wgmma_gemm_kernelIN43_GLOBAL__N__{}_10_conv3x3_cu_"
            "{}8ConvTapsELi128E")
    parent = {"_Z17wgmma_gemm_kernelI9DenseRows": 90,
              "_Z15mhsa_reg_kernelILi32E": 145,
              "_Z12igemm_kernelI10AffineRows": 128,
              "_Z7ln_rows": 40,
              conv.format("fefed07c", "9fdffba7"): 90}
    change = {"_Z17wgmma_gemm_kernelI9DenseRows": 90,
              "_Z15mhsa_reg_kernelILi32E": 150,
              "_Z17wgmma_gemm_kernelI14AffineReluRows": 94,
              conv.format("0a1b2c3d", "4e5f6a7b"): 90}
    got = ab.compare_registers(log(parent), log(change))
    # the conv instance is one kernel whose file hash changed
    assert got == {"same": 2,
                   "differ": {"_Z15mhsa_reg_kernelILi32E": [145, 150]},
                   "only_parent": 0, "only_change": 1}
