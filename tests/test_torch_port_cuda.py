"""The CUDA kernels (half blocks and their backwards, the windowed half
block on a NesT token map and its backward, the packed-qkv attention and
the fused MLP with their backwards, the products of the backwards on the
wgmma mainloop each on its own (the MLP backwards' dual tile at both
widths among them), shear, noise, the ResNet probe
kernels conv3x3 and bn_relu_gemm (the mainloop's register-A form: reruns
bit-equal, a and b read only up to C), the MLP probe kernels mlp_tile, its
backward, mlp_chain and mlp_single (the last and conv3x3 on the wgmma
mainloop, reruns bit-equal), the MLP forwards' products on the wgmma
mainloop each on its own and #2/#9 at serving's ragged rows, #2's h
against #4's dual tile's, and the attention schedule probes
attn_sched and its backward in every mode) against their plain PyTorch
versions,
on the card. Marked ``gpu``: without a CUDA
device every test here skips. Needs no JAX, so it runs on a machine without
it:

  python -m pytest --noconftest -p no:cacheprovider -m gpu \
      tests/test_torch_port_cuda.py -q

Shapes include ragged row counts (M not a multiple of the 64-row tile) and
short sequences, which NesT-Small's own shapes do not reach. Bounds as in
chip_smoke.py: kernel and plain version round to bf16 at the same points
and differ by fp32 summation order, so up to two bf16 ulps (2^-6) of the
largest output forward, and 2^-6 of each cotangent's largest |value|
backward; against the fp32 plain version (TF32 off) 2^-5 forward and
2^-4 backward (chip_smoke.BOUND_VS_PLAIN_FP32, BOUND_BWD_FP32); shear is
exact; noise within 2^-13 (chip_smoke.BOUND_NOISE).
"""
import pytest
import torch

from vlp_tpu_torch.ops import attn_sched as AS
from vlp_tpu_torch.ops import block_attention as BA
from vlp_tpu_torch.ops import bn_gemm as BG
from vlp_tpu_torch.ops import conv3x3 as CV
from vlp_tpu_torch.ops import fused_block as FB
from vlp_tpu_torch.ops import fused_mlp as FM
from vlp_tpu_torch.ops import mlp_tile as MT
from vlp_tpu_torch.ops import noise as NZ
from vlp_tpu_torch.ops import shear as SH

pytestmark = pytest.mark.gpu
BOUND = 2.0 ** -6
BOUND_FP32 = 2.0 ** -5
BOUND_BWD_FP32 = 2.0 ** -4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def _rel_err(out, ref):
    """max |out - ref| over max |ref|; where ref is all zeros (dq and dk at
    S = 1, a softmax over one key), any nonzero out is an infinite error."""
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(torch.finfo().tiny)).item()


@pytest.mark.parametrize("n,s,d,heads", [(3, 196, 64, 2), (5, 17, 32, 1),
                                         (2, 64, 384, 12), (7, 200, 96, 3),
                                         (2, 256, 64, 2)])  # largest S
def test_ln_attention_kernel_matches_plain(cuda, n, s, d, heads):
    """#1's y, and the qkv and o it leaves for the backward, against the
    plain pieces; o bit-equal to #7 ``attend_qkv`` on the same qkv (one
    core); a rerun bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(n * s + d)
    x = _rand(gen, n, s, d).bfloat16()
    params = (1.0 + _rand(gen, d, scale=0.1), _rand(gen, d, scale=0.1),
              # 3x the lecun scale: peaked softmax rows
              _rand(gen, d, 3 * d, scale=3 * d ** -0.5),
              _rand(gen, 3 * d, scale=0.02),
              _rand(gen, d, d, scale=d ** -0.5), _rand(gen, d, scale=0.02))
    before = FB.ln_attention.launches
    out = FB.ln_attention(x, *params, heads)
    torch.cuda.synchronize()
    assert FB.ln_attention.launches == before + 1
    ref = FB.ln_attention_plain(x, *params, heads)
    assert torch.isfinite(out.float()).all()
    assert _rel_err(out, ref) <= BOUND
    (g, b, bq, bo), (wq, wo) = FB._cast(
        torch.bfloat16, vectors=(params[0], params[1], params[3], params[5]),
        matrices=(params[2], params[4]))
    parts = FB._ln_attention_cuda(x, g, b, wq, bq, wo, bo, heads)
    assert torch.equal(parts[0], out)
    for got, want in zip(parts, FB.ln_attention_plain_parts(x, *params,
                                                            heads)):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert _rel_err(got, want) <= BOUND
    assert torch.equal(parts[2], BA.attend_qkv(parts[1], heads))
    again = FB._ln_attention_cuda(x, g, b, wq, bq, wo, bo, heads)
    assert all(torch.equal(a, c) for a, c in zip(parts, again))


@pytest.mark.parametrize("m,d,f", [(100, 64, 256), (1568, 96, 384),
                                   (33, 384, 1536)])
def test_ln_mlp_kernel_matches_plain(cuda, m, d, f):
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    x = _rand(gen, m, d).bfloat16()
    params = (1.0 + _rand(gen, d, scale=0.1), _rand(gen, d, scale=0.1),
              _rand(gen, d, f, scale=d ** -0.5), _rand(gen, f, scale=0.02),
              _rand(gen, f, d, scale=f ** -0.5), _rand(gen, d, scale=0.02))
    before = FB.ln_mlp.launches
    out = FB.ln_mlp(x, *params)
    torch.cuda.synchronize()
    assert FB.ln_mlp.launches == before + 1
    ref = FB.ln_mlp_plain(x, *params)
    assert torch.isfinite(out.float()).all()
    assert _rel_err(out, ref) <= BOUND


def test_cuda_tensor_never_takes_the_plain_path(cuda):
    """A CUDA tensor the kernel does not take raises; it does not fall back
    to the plain version."""
    d = 64
    x = torch.zeros(2, 16, d, device=cuda)  # float32: the kernel takes bf16
    w = torch.zeros(d, 3 * d, device=cuda)
    wo = torch.zeros(d, d, device=cuda)
    v = torch.zeros(d, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        FB.ln_attention(x, v, v, w, torch.zeros(3 * d, device=cuda), wo, v, 2)
    with pytest.raises(ValueError, match="head_dim 32"):
        FB.ln_attention(x.bfloat16(), v, v, w,
                        torch.zeros(3 * d, device=cuda), wo, v, 4)


def _attn_params(gen, d, scale=1.0):
    (g, b, bq, bo), (wq, wo) = FB._cast(
        torch.bfloat16,
        vectors=(1.0 + _rand(gen, d, scale=0.1), _rand(gen, d, scale=0.1),
                 _rand(gen, 3 * d, scale=0.02), _rand(gen, d, scale=0.02)),
        matrices=(_rand(gen, d, 3 * d, scale=scale * d ** -0.5),
                  _rand(gen, d, d, scale=d ** -0.5)))
    return g, b, wq, bq, wo, bo


def _forward_scratch(x, g, b, wq, bq, wo, bo, heads):
    """The forward kernel's qkv and o, which the backward kernel reads (both
    take S <= 256)."""
    return FB._ln_attention_cuda(x, g, b, wq, bq, wo, bo, heads)[1:]


@pytest.mark.parametrize("n,s,d,heads", [(3, 196, 64, 2), (5, 17, 32, 1),
                                         (2, 64, 384, 12), (7, 200, 96, 3),
                                         (2, 240, 64, 2),
                                         (2, 256, 64, 2),   # largest S
                                         (3, 1, 64, 2),     # one token
                                         (4, 16, 32, 1)])   # one key tile
def test_ln_attention_bwd_kernel_matches_plain(cuda, n, s, d, heads):
    gen = torch.Generator(device=cuda).manual_seed(n * s + d + 1)
    x = _rand(gen, n, s, d).bfloat16()
    dy = _rand(gen, n, s, d).bfloat16()
    g, b, wq, bq, wo, bo = _attn_params(gen, d, scale=3.0)
    qkv, o = _forward_scratch(x, g, b, wq, bq, wo, bo, heads)
    before = FB.ln_attention_bwd.launches
    outs = FB.ln_attention_bwd(x, g, b, wq, bq, wo, dy, heads, qkv, o)
    torch.cuda.synchronize()
    assert FB.ln_attention_bwd.launches == before + 1
    refs = FB.ln_attention_bwd_plain(x, g, b, wq, bq, wo, dy, heads)
    for out, ref in zip(outs, refs):
        assert out.shape == ref.shape and out.dtype == ref.dtype
        assert torch.isfinite(out.float()).all()
        assert _rel_err(out, ref) <= BOUND
    again = FB.ln_attention_bwd(x, g, b, wq, bq, wo, dy, heads, qkv, o)
    assert all(torch.equal(a, b) for a, b in zip(outs, again))  # no atomics


@pytest.mark.parametrize("m,d,f", [(100, 64, 256), (1568, 96, 384),
                                   (33, 384, 1536),
                                   (200704, 96, 384)])  # NesT level 0
def test_ln_mlp_bwd_kernel_matches_plain(cuda, m, d, f):
    gen = torch.Generator(device=cuda).manual_seed(m + d + 1)
    x = _rand(gen, m, d).bfloat16()
    dy = _rand(gen, m, d).bfloat16()
    (g, b, b1), (w1, w2) = FB._cast(
        torch.bfloat16,
        vectors=(1.0 + _rand(gen, d, scale=0.1), _rand(gen, d, scale=0.1),
                 _rand(gen, f, scale=0.02)),
        matrices=(_rand(gen, d, f, scale=d ** -0.5),
                  _rand(gen, f, d, scale=f ** -0.5)))
    before = FB.ln_mlp_bwd.launches
    outs = FB.ln_mlp_bwd(x, g, b, w1, b1, w2, dy)
    torch.cuda.synchronize()
    assert FB.ln_mlp_bwd.launches == before + 1
    refs = FB.ln_mlp_bwd_plain(x, g, b, w1, b1, w2, dy)
    for out, ref in zip(outs, refs):
        assert out.shape == ref.shape and out.dtype == ref.dtype
        assert torch.isfinite(out.float()).all()
        assert _rel_err(out, ref) <= BOUND
    again = FB.ln_mlp_bwd(x, g, b, w1, b1, w2, dy)
    assert all(torch.equal(a, b) for a, b in zip(outs, again))


def test_autograd_runs_the_backward_kernels(cuda):
    """Autograd through the public wrappers on CUDA tensors launches the
    backward kernels and returns their cotangents to fp32 parameters."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    n, s, d, heads = 4, 196, 96, 3
    x = _rand(gen, n, s, d).bfloat16().requires_grad_()
    leaves = [t.clone().requires_grad_() for t in (
        1.0 + _rand(gen, d, scale=0.1), _rand(gen, d, scale=0.1),
        _rand(gen, d, 3 * d, scale=d ** -0.5), _rand(gen, 3 * d, scale=0.02),
        _rand(gen, d, d, scale=d ** -0.5), _rand(gen, d, scale=0.02))]
    dy = _rand(gen, n, s, d).bfloat16()
    before = FB.ln_attention_bwd.launches
    FB.ln_attention(x, *leaves, heads).backward(dy)
    assert FB.ln_attention_bwd.launches == before + 1
    want = FB.ln_attention_bwd_plain(x.detach(), *[t.detach()
                                                   for t in leaves[:5]],
                                     dy, heads)
    assert _rel_err(x.grad, want[0]) <= BOUND
    for leaf, w in zip(leaves, want[1:]):
        assert leaf.grad.dtype == torch.float32
        assert _rel_err(leaf.grad, w.reshape(leaf.shape)) <= BOUND


def _gemm_form(form, a, b, m, n, k, fp32, splits):
    """One launch of #3/#6's product ``form`` (0: a @ b^T, 1: split-K
    partials of a^T @ b) through ``vlp_attn_bwd_gemm``."""
    from vlp_tpu_torch.ops import _build
    lib = _build.load_library()
    shape = (splits, m, n) if form == 1 else (m, n)
    out = torch.empty(shape, device=a.device,
                      dtype=torch.float32 if fp32 else torch.bfloat16)
    err = lib.vlp_attn_bwd_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                m, n, k, form, fp32, splits, FB._stream())
    _build.check(lib, err, "attn_bwd_gemm")
    torch.cuda.synchronize()
    return out


# #3/#6's products on the wgmma mainloop, each form on its own: K-major B
# (the weights read as they lie) to bf16 (do) and to fp32 (dln), and M-major
# A with split-K fp32 partials (dWout, dWqkv), at M of 1, 77 and 1037 rows,
# widths 96 and 288, and split counts that do not divide the 64-row steps.
# Against torch.matmul in fp32 (TF32 off) of the same bf16 operands: fp32
# outputs differ by summation order alone (1e-5 of the largest |value|);
# bf16 outputs add one rounding (BOUND).
@pytest.mark.parametrize("m,n,k,fp32", [
    (1, 96, 96, 0), (77, 96, 96, 0), (1037, 288, 96, 0), (1037, 96, 96, 0),
    (1, 96, 288, 1), (77, 288, 288, 1), (1037, 96, 288, 1),
    # #10's dx = bf16(dh @ W1^T) and #4's dln at NesT's widths (K = F = 4D)
    (1037, 96, 384, 0), (77, 192, 768, 0), (1, 384, 1536, 0),
    (1037, 96, 384, 1)])
def test_backward_gemm_k_major_b_matches_matmul(cuda, m, n, k, fp32):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = _rand(gen, m, k).bfloat16()
    w = _rand(gen, n, k, scale=k ** -0.5).bfloat16()
    ref = a.float() @ w.float().T
    out = _gemm_form(0, a, w, m, n, k, fp32, 1)
    assert out.shape == (m, n) and torch.isfinite(out.float()).all()
    assert _rel_err(out, ref) <= (1e-5 if fp32 else BOUND)
    assert torch.equal(_gemm_form(0, a, w, m, n, k, fp32, 1), out)


@pytest.mark.parametrize("rows,m,n,splits", [
    (1, 96, 96, 1), (77, 96, 288, 2), (1037, 96, 96, 3), (1037, 288, 96, 5),
    (1037, 288, 288, 17), (1037, 96, 288, None)])
def test_backward_gemm_m_major_a_split_k_matches_matmul(cuda, rows, m, n,
                                                        splits):
    """a [rows, m]^T @ b [rows, n]: split z sums the rows of its 64-row
    steps [z * per, (z + 1) * per), per = ceil(steps / splits), each partial
    held on its own; None: the sequence's own split count."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from vlp_tpu_torch.ops import _build
    if splits is None:
        splits = _build.load_library().vlp_attn_bwd_splits(m, n, rows)
    gen = torch.Generator(device=cuda).manual_seed(rows + m + n)
    a = _rand(gen, rows, m).bfloat16()
    b = _rand(gen, rows, n).bfloat16()
    out = _gemm_form(1, a, b, m, n, rows, 1, splits)
    steps = -(-rows // 64)
    per = -(-steps // splits)
    for z in range(splits):
        lo, hi = 64 * per * z, min(rows, 64 * per * (z + 1))
        ref = a[lo:hi].float().T @ b[lo:hi].float()
        assert _rel_err(out[z], ref) <= 1e-5, z
    assert _rel_err(out.sum(0), a.float().T @ b.float()) <= 1e-5
    assert torch.equal(_gemm_form(1, a, b, m, n, rows, 1, splits), out)


@pytest.mark.parametrize("b,h,w,axis", [
    (3, 17, 30, 1), (3, 17, 30, 0), (2, 224, 224, 0), (2, 224, 224, 1),
    # the training steps' and the VLP bench's batches, one image, H != W,
    # widths that are not a multiple of 4 (the scalar row path)
    (64, 224, 224, 1), (128, 224, 224, 0), (1, 224, 224, 1),
    (1, 224, 224, 0), (2, 96, 160, 1), (2, 96, 160, 0), (2, 224, 225, 1),
    (2, 224, 225, 0), (2, 5, 33, 1), (2, 9, 31, 1), (2, 31, 9, 0)])
def test_shear_kernel_equals_plain(cuda, b, h, w, axis):
    gen = torch.Generator(device=cuda).manual_seed(b + h + w + axis)
    img = _rand(gen, b, h, w) * 100.0
    shift = _rand(gen, b, h if axis == 1 else w, scale=12.0)
    before = SH.shear_rows.launches
    out = SH.shear_rows(img, shift, 10, axis)
    assert SH.shear_rows.launches == before + 1
    assert torch.equal(out, SH.shear_rows_plain(img, shift, 10, axis))


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("kind", ["warp", "edge", "beyond", "misaligned"])
def test_shear_kernel_equals_plain_at_the_warps_and_edge_shifts(cuda, axis,
                                                                 kind):
    """The warp's own ramps (``warp.shear_shifts``), shifts of exactly
    +-max_shift and integral ones (fraction 0), max_shift beyond the line,
    and an image off 16-byte alignment (the row kernel's 4-byte path):
    bit-equal to the plain version, one launch a call."""
    from vlp_tpu_torch.ops.warp import default_max_shift, shear_shifts
    gen = torch.Generator(device=cuda).manual_seed(axis)
    b, h, w = 4, 224, 224
    ms = default_max_shift(h, w)
    img = torch.randint(0, 256, (b, h, w), generator=gen,
                        device=cuda).float()
    if kind == "warp":
        theta = (torch.rand(b, generator=gen, device=cuda) - 0.5) * 1.05
        t = (torch.rand(2, b, generator=gen, device=cuda) - 0.5) * 40.0
        shift = shear_shifts(theta, t[0], t[1], theta * 0.1, h, w)[1 - axis]
    elif kind == "edge":
        shift = torch.randint(-ms, ms + 1, (b, h), generator=gen,
                              device=cuda).float()
        shift[:, 0::3], shift[:, 1::3] = float(ms), -float(ms)
    else:
        shift = _rand(gen, b, h, scale=2.0 * ms)
    if kind == "beyond":
        ms = w + 17
    if kind == "misaligned":
        flat = torch.empty(b * h * w + 1, device=cuda)
        flat[1:] = img.reshape(-1)
        img = flat[1:].view(b, h, w)
        assert img.data_ptr() % 16
    before = SH.shear_rows.launches
    out = SH.shear_rows(img, shift, ms, axis)
    assert SH.shear_rows.launches == before + 1
    assert torch.equal(out, SH.shear_rows_plain(img, shift, ms, axis))


@pytest.mark.parametrize("b,h,w", [
    (3, 33, 46),      # h * w / 2 = 759 words: a ragged last group
    (2, 224, 224),    # 112 words a row: the 16-byte path
    (2, 224, 226),    # 113 words a row: words cross rows, the scalar path
    (1, 8, 8), (1, 7, 16), (65, 2, 24)])
def test_noise_kernel_words_values_and_identity(cuda, b, h, w):
    got = NZ.philox4x32(torch.tensor([[0x243f6a88, 0x85a308d3, 0x13198a2e,
                                       0x03707344]], device=cuda),
                        torch.tensor([[0xa4093822, 0x299f31d0]],
                                     device=cuda))
    assert [int(v) for v in got[0]] == [0xd16cfe09, 0x94fdcceb, 0x5001e420,
                                        0x24126ea1]
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.rand(b, h, w, generator=gen, device=cuda) * 255.0
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, 2), generator=gen,
                          device=cuda, dtype=torch.int32)
    sigma = torch.rand(b, generator=gen, device=cuda)
    sigma[0] = 0.0
    before = NZ.add_gaussian_noise.launches
    out = NZ.add_gaussian_noise(x, seeds, sigma)
    assert NZ.add_gaussian_noise.launches == before + 1
    assert torch.equal(out[0], x[0])
    ref = NZ.add_gaussian_noise_plain(x, seeds, sigma)
    assert (out - ref).abs().max().item() <= 2.0 ** -13


def test_noise_kernel_off_alignment_takes_the_scalar_path(cuda):
    """x off 16-byte alignment at W 224 runs the 4-byte path, with the
    same values."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, h, w = 2, 224, 224
    flat = torch.rand(b * h * w + 1, generator=gen, device=cuda) * 255.0
    x = flat[1:].view(b, h, w)
    assert x.data_ptr() % 16
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, 2), generator=gen,
                          device=cuda, dtype=torch.int32)
    sigma = torch.ones(b, device=cuda)
    out = NZ.add_gaussian_noise(x, seeds, sigma)
    assert (out - NZ.add_gaussian_noise_plain(x, seeds, sigma)).abs() \
        .max().item() <= 2.0 ** -13
    assert torch.equal(out, NZ.add_gaussian_noise(x.contiguous().clone(),
                                                  seeds, sigma))


def test_shear_kernel_refuses_lines_longer_than_shared_memory(cuda):
    img = torch.zeros(1, SH.MAX_COLUMN + 1, 4, device=cuda)
    before = SH.shear_rows.launches
    with pytest.raises(ValueError, match="stages lines"):
        SH.shear_rows(img, torch.zeros(1, 4, device=cuda), 3, 0)
    with pytest.raises(ValueError, match="stages lines"):
        SH.shear_rows(torch.zeros(1, 2, SH.MAX_ROW + 4, device=cuda),
                      torch.zeros(1, 2, device=cuda), 3, 1)
    assert SH.shear_rows.launches == before
    # the longest lines run, bit-equal
    for axis, shape in ((0, (1, SH.MAX_COLUMN, 36)),
                        (1, (1, 3, SH.MAX_ROW))):
        gen = torch.Generator(device=cuda).manual_seed(axis)
        img = torch.rand(*shape, generator=gen, device=cuda)
        shift = _rand(gen, 1, shape[2 - axis], scale=50.0)
        assert torch.equal(SH.shear_rows(img, shift, 60, axis),
                           SH.shear_rows_plain(img, shift, 60, axis))


def test_backward_and_augmentation_kernels_raise_on_cuda(cuda):
    """A CUDA tensor the kernels do not take raises in the backward and the
    augmentation kernels too; it never reaches a plain version."""
    d = 64
    x = torch.zeros(2, 16, d, device=cuda)  # float32: the kernel takes bf16
    vec = torch.zeros(1, d, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        FB.ln_attention_bwd(x, vec, vec, torch.zeros(d, 3 * d, device=cuda),
                            torch.zeros(1, 3 * d, device=cuda),
                            torch.zeros(d, d, device=cuda), x, 2, x, x)
    xb = torch.zeros(2, 257, d, device=cuda, dtype=torch.bfloat16)
    wb = torch.zeros(d, 3 * d, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="S <= 256"):
        FB.ln_attention_bwd(xb, vec, vec, wb,
                            torch.zeros(1, 3 * d, device=cuda),
                            torch.zeros(d, d, device=cuda,
                                        dtype=torch.bfloat16),
                            xb, 2, torch.zeros(2, 257, 3 * d, device=cuda,
                                               dtype=torch.bfloat16), xb)
    rows = torch.zeros(8, d, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        FB.ln_mlp_bwd(rows, vec, vec, torch.zeros(d, 4 * d, device=cuda),
                      torch.zeros(1, 4 * d, device=cuda),
                      torch.zeros(4 * d, d, device=cuda), rows)
    img = torch.zeros(2, 8, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="fp32"):
        SH.shear_rows(img, torch.zeros(2, 8, device=cuda,
                                       dtype=torch.float64), 4)
    with pytest.raises(TypeError, match="int32 seeds"):
        NZ.add_gaussian_noise(torch.zeros(2, 8, 8, device=cuda),
                              torch.zeros(2, 2, device=cuda,
                                          dtype=torch.int64),
                              torch.zeros(2, device=cuda))


@pytest.mark.parametrize("n,s,d,heads", [
    (2, 197, 768, 12), (3, 196, 96, 3), (5, 17, 128, 2), (2, 256, 64, 1),
    (2, 224, 128, 2), (2, 240, 64, 2),
    # the register-resident kernels' edges: S 1 and one 16-key tile, no
    # ragged tile (S 208), 16 tiles at head dim 32, ViT-L/16's width
    (3, 1, 64, 1), (3, 1, 96, 3), (2, 16, 128, 2), (2, 16, 64, 2),
    (2, 208, 128, 2), (2, 256, 128, 4), (2, 197, 1024, 16)])
def test_attend_qkv_kernels_match_plain(cuda, n, s, d, heads):
    """Forward and backward of the packed-qkv attention (#7, #8) at head
    dims 64 and 32, ragged S and the largest S (256) both take, with one
    query row scaled x8 so that the max subtraction matters; reruns of the
    backward are bit-identical, and the p and ds that its phase B
    recomputes are phase A's bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(n * s + d + 2)
    # 3x a unit scale: peaked softmax rows
    qkv = _rand(gen, n, s, 3 * d, scale=3.0)
    qkv[:, s // 2, :d] *= 8.0
    qkv = qkv.bfloat16()
    do = _rand(gen, n, s, d).bfloat16()
    before = BA.attend_qkv.launches
    out = BA.attend_qkv(qkv, heads)
    torch.cuda.synchronize()
    assert BA.attend_qkv.launches == before + 1
    assert torch.isfinite(out.float()).all()
    assert _rel_err(out, BA.attend_qkv_plain(qkv, heads)) <= BOUND
    before = BA.attend_qkv_bwd.launches
    dqkv = BA.attend_qkv_bwd(qkv, do, heads)
    torch.cuda.synchronize()
    assert BA.attend_qkv_bwd.launches == before + 1
    assert torch.isfinite(dqkv.float()).all()
    ref = BA.attend_qkv_bwd_plain(qkv, do, heads)
    for part in range(3):  # dq, dk, dv each against its own largest value
        sl = slice(part * d, (part + 1) * d)
        assert _rel_err(dqkv[..., sl], ref[..., sl]) <= BOUND
    assert torch.equal(dqkv, BA.attend_qkv_bwd(qkv, do, heads))
    checked, mismatches = BA.attend_qkv_bwd_checked(qkv, do, heads)
    assert mismatches == 0
    assert torch.equal(checked, dqkv)


@pytest.mark.parametrize("s,d,heads", [(197, 768, 12), (196, 96, 3),
                                       (17, 128, 2), (256, 64, 1)])
def test_attend_qkv_kernels_keep_units_apart(cuda, s, d, heads):
    """o and dqkv of the first units do not change when more units (other
    samples) join the launch: nothing leaks between the units and heads
    that share a block or an SM."""
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    qkv = _rand(gen, 7, s, 3 * d, scale=3.0).bfloat16()
    do = _rand(gen, 7, s, d).bfloat16()
    o_small = BA.attend_qkv(qkv[:2].contiguous(), heads)
    dqkv_small = BA.attend_qkv_bwd(qkv[:2].contiguous(), do[:2].contiguous(),
                                   heads)
    o_all = BA.attend_qkv(qkv, heads)
    dqkv_all = BA.attend_qkv_bwd(qkv, do, heads)
    assert torch.equal(o_all[:2], o_small)
    assert torch.equal(dqkv_all[:2], dqkv_small)
    assert torch.equal(o_all[5:], BA.attend_qkv(qkv[5:].contiguous(), heads))
    assert torch.equal(dqkv_all[5:], BA.attend_qkv_bwd(
        qkv[5:].contiguous(), do[5:].contiguous(), heads))


@pytest.mark.parametrize("m,d,f", [(1568, 96, 384), (100, 64, 256),
                                   (512, 384, 1536),
                                   (200704, 96, 384)])  # NesT level 0
def test_fused_mlp_kernels_match_plain(cuda, m, d, f):
    """Forward and backward of the fused MLP (#9, #10), every cotangent,
    ragged rows included; reruns of the backward are bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(m + d + 3)
    x = _rand(gen, m, d).bfloat16()
    dy = _rand(gen, m, d).bfloat16()
    (b1, b2), (w1, w2) = FB._cast(
        torch.bfloat16, vectors=(_rand(gen, f, scale=0.02),
                                 _rand(gen, d, scale=0.02)),
        matrices=(_rand(gen, d, f, scale=d ** -0.5),
                  _rand(gen, f, d, scale=f ** -0.5)))
    before = FM.fused_mlp.launches
    out = FM.fused_mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert FM.fused_mlp.launches == before + 1
    assert _rel_err(out, FM.fused_mlp_plain(x, w1, b1, w2, b2)) <= BOUND
    before = FM.fused_mlp_bwd.launches
    outs = FM.fused_mlp_bwd(x, w1, b1, w2, dy)
    torch.cuda.synchronize()
    assert FM.fused_mlp_bwd.launches == before + 1
    for got, ref in zip(outs, FM.fused_mlp_bwd_plain(x, w1, b1, w2, dy)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert torch.isfinite(got.float()).all()
        assert _rel_err(got, ref) <= BOUND
    again = FM.fused_mlp_bwd(x, w1, b1, w2, dy)
    assert all(torch.equal(a, b) for a, b in zip(outs, again))


def _mlp_dual(a, w1, b1, dy, w2):
    """One launch of #4/#10's dual tile through ``vlp_mlp_dual``: (h, dh,
    the column sums of dh32 per 128-row tile)."""
    from vlp_tpu_torch.ops import _build
    lib = _build.load_library()
    m, f = a.shape[0], w1.shape[1]
    h = torch.empty(m, f, device=a.device, dtype=torch.bfloat16)
    dh = torch.empty_like(h)
    col = torch.empty(-(-m // 128), f, device=a.device)
    err = lib.vlp_mlp_dual(a.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                           dy.data_ptr(), w2.data_ptr(), h.data_ptr(),
                           dh.data_ptr(), col.data_ptr(), m, a.shape[1], f,
                           FB._stream())
    _build.check(lib, err, "mlp_dual")
    torch.cuda.synchronize()
    return h, dh, col


# #4/#10's dual tile on its own: h = bf16(z * cdf) and dh =
# bf16((dy @ W2^T) * gelu'(z)), z = a @ W1 + b1, against torch.matmul
# pieces in fp32 (TF32 off) on the same bf16 operands (one rounding apart:
# BOUND), and the fp32 column sums of dh32 over each 128-row tile (the same
# terms in another order: 1e-4 of the largest). Ragged M (1, 77, 1037 rows:
# a partial last tile, its rows masked out of the sums), D 96/192/384 (D 96
# a ragged 64-deep step) at F = 4D, and F 352 and 160, which end inside a
# 64-wide tile; reruns bit-equal.
@pytest.mark.parametrize("m,d,f", [(1, 96, 384), (77, 192, 768),
                                   (1037, 384, 1536), (1037, 96, 384),
                                   (1037, 96, 352), (77, 64, 160)])
def test_mlp_dual_tile_matches_matmul_pieces(cuda, m, d, f):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(m + d + f)
    a = _rand(gen, m, d).bfloat16()
    dy = _rand(gen, m, d).bfloat16()
    w1 = _rand(gen, d, f, scale=d ** -0.5).bfloat16()
    w2 = _rand(gen, f, d, scale=f ** -0.5).bfloat16()
    b1 = _rand(gen, f, scale=0.5)  # a dropped bias shows
    h, dh, col = _mlp_dual(a, w1, b1, dy, w2)
    h32, dgelu = FM.gelu_and_grad(a.float() @ w1.float() + b1)
    dh32 = (dy.float() @ w2.float().T) * dgelu
    assert _rel_err(h, h32.bfloat16()) <= BOUND
    assert _rel_err(dh, dh32.bfloat16()) <= BOUND
    tiles = torch.stack([t.sum(0) for t in dh32.split(128)])
    assert col.shape == tiles.shape and _rel_err(col, tiles) <= 1e-4
    again = _mlp_dual(a, w1, b1, dy, w2)
    assert all(torch.equal(x, y) for x, y in zip((h, dh, col), again))


def _mlp_gemm(a, w, bias, res, gelu):
    """One product of the MLP forwards (#2, #9) through ``vlp_mlp_gemm``:
    bf16(gelu(a @ w + bias)) where ``gelu``, else bf16(a @ w + bias), or
    bf16(res + (a @ w + bias)) where ``res`` is given."""
    from vlp_tpu_torch.ops import _build
    lib = _build.load_library()
    m, k = a.shape
    n = w.shape[1]
    out = torch.empty(m, n, device=a.device, dtype=torch.bfloat16)
    err = lib.vlp_mlp_gemm(a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                           0 if res is None else res.data_ptr(),
                           out.data_ptr(), m, n, k, int(gelu), FB._stream())
    _build.check(lib, err, "mlp_gemm")
    torch.cuda.synchronize()
    return out


# The forwards' products on the wgmma mainloop, each on its own, against
# torch.matmul pieces in fp32 (TF32 off) on the same bf16 operands, rounded
# once (BOUND): fc1 (N = F = 4D, K = D, bias + GELU) and fc2 (N = D, K = F,
# bias, or bias + the residual added in fp32 before the rounding) at ragged
# M (1, 77, 1037 rows: a partial last tile) and D 96/192/384 (D 96 a ragged
# 64-deep step for fc1 and a quarter-empty 128-wide tile for fc2); biases
# drawn at scale 1 so a dropped bias shows; reruns bit-equal. epi 0 is fc1,
# 1 fc2 without the residual (#9), 2 fc2 with it (#2).
@pytest.mark.parametrize("epi", [0, 1, 2])
@pytest.mark.parametrize("d", [96, 192, 384])
@pytest.mark.parametrize("m", [1, 77, 1037])
def test_mlp_forward_products_match_matmul_pieces(cuda, m, d, epi):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(m + d + epi)
    f = 4 * d
    x = _rand(gen, m, d).bfloat16()
    if epi == 0:
        a, w, bias = x, _rand(gen, d, f, scale=d ** -0.5).bfloat16(), \
            _rand(gen, f)
    else:
        a, w, bias = _rand(gen, m, f).bfloat16(), \
            _rand(gen, f, d, scale=f ** -0.5).bfloat16(), _rand(gen, d)
    res = x if epi == 2 else None
    out = _mlp_gemm(a, w, bias, res, epi == 0)
    z = a.float() @ w.float() + bias
    ref = (FM.gelu(z) if epi == 0 else z + x.float() if epi == 2
           else z).bfloat16()
    assert out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    assert _rel_err(out, ref) <= BOUND
    assert torch.equal(out, _mlp_gemm(a, w, bias, res, epi == 0))


# #2 and #9 at serving's ragged rows: a request of 37 images at each NesT
# level (37 * 56^2, 37 * 28^2, 37 * 14^2 rows; none a multiple of 128)
@pytest.mark.parametrize("m,d", [(37 * 3136, 96), (37 * 784, 192),
                                 (37 * 196, 384)])
def test_mlp_forwards_match_plain_at_serving_rows(cuda, m, d):
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    f = 4 * d
    x = _rand(gen, m, d).bfloat16()
    g, b = 1.0 + _rand(gen, d, scale=0.1), _rand(gen, d, scale=0.1)
    (b1, b2), (w1, w2) = FB._cast(
        torch.bfloat16, vectors=(_rand(gen, f, scale=0.02),
                                 _rand(gen, d, scale=0.02)),
        matrices=(_rand(gen, d, f, scale=d ** -0.5),
                  _rand(gen, f, d, scale=f ** -0.5)))
    for name, kern, plain in (
            ("ln_mlp", lambda: FB.ln_mlp(x, g, b, w1, b1, w2, b2),
             lambda: FB.ln_mlp_plain(x, g, b, w1, b1, w2, b2)),
            ("fused_mlp", lambda: FM.fused_mlp(x, w1, b1, w2, b2),
             lambda: FM.fused_mlp_plain(x, w1, b1, w2, b2))):
        counter = FB.ln_mlp if name == "ln_mlp" else FM.fused_mlp
        before = counter.launches
        out = kern()
        torch.cuda.synchronize()
        assert counter.launches == before + 1, name
        assert torch.isfinite(out.float()).all(), name
        assert _rel_err(out, plain()) <= BOUND, name
        assert torch.equal(out, kern()), name


def _bf16_ulps(a, b):
    """Distance of two bf16 tensors in steps of the format."""
    def ordered(x):
        k = x.view(torch.int16).to(torch.int32)
        return torch.where(k < 0, -(k & 0x7FFF), k)
    return (ordered(a) - ordered(b)).abs()


# #2's h (the forward's bias + GELU epilogue, gelu.cuh) against the h that
# #4's dual tile recomputes from the same ln (mlp_bwd.cuh): one GELU
# function on the same z, so at most one bf16 ulp apart (the two products
# may contract the epilogue's arithmetic differently); NesT's three levels
# at 8 images and a ragged row count
@pytest.mark.parametrize("m,d", [(8 * 3136, 96), (8 * 784, 192),
                                 (8 * 196 + 37, 384)])
def test_ln_mlp_h_is_the_dual_tiles_h(cuda, m, d):
    from vlp_tpu_torch.ops import _build
    gen = torch.Generator(device=cuda).manual_seed(m)
    f = 4 * d
    x = _rand(gen, m, d).bfloat16()
    dy = _rand(gen, m, d).bfloat16()
    (g, b, b1, b2), (w1, w2) = FB._cast(
        torch.bfloat16, vectors=(1.0 + _rand(gen, d, scale=0.1),
                                 _rand(gen, d, scale=0.1), _rand(gen, f),
                                 _rand(gen, d, scale=0.02)),
        matrices=(_rand(gen, d, f, scale=d ** -0.5),
                  _rand(gen, f, d, scale=f ** -0.5)))
    lib = _build.load_library()
    ln, h, y = (torch.empty(m, n, device=cuda, dtype=torch.bfloat16)
                for n in (d, f, d))
    err = lib.vlp_ln_mlp(x.data_ptr(), g.data_ptr(), b.data_ptr(),
                         w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                         b2.data_ptr(), ln.data_ptr(), h.data_ptr(),
                         y.data_ptr(), m, d, f, 1e-6, FB._stream())
    _build.check(lib, err, "ln_mlp")
    torch.cuda.synchronize()
    assert torch.equal(y, FB.ln_mlp(x, g, b, w1, b1, w2, b2))
    h_dual = _mlp_dual(ln, w1, b1, dy, w2)[0]
    assert _bf16_ulps(h, h_dual).max().item() <= 1


def test_unfused_autograd_runs_the_kernels_and_raises_on_what_they_refuse(
        cuda):
    """Autograd through attend_qkv and fused_mlp on CUDA tensors launches
    the backward kernels; a CUDA tensor the kernels do not take raises."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    qkv = _rand(gen, 2, 197, 3 * 128).bfloat16().requires_grad_()
    do = _rand(gen, 2, 197, 128).bfloat16()
    before = BA.attend_qkv_bwd.launches
    BA.attend_qkv(qkv, 2).backward(do)
    assert BA.attend_qkv_bwd.launches == before + 1
    assert _rel_err(qkv.grad, BA.attend_qkv_bwd_plain(qkv.detach(), do, 2)
                    ) <= BOUND
    x = _rand(gen, 128, 96).bfloat16().requires_grad_()
    leaves = [t.requires_grad_() for t in (
        _rand(gen, 96, 384, scale=96 ** -0.5), _rand(gen, 384, scale=0.02),
        _rand(gen, 384, 96, scale=384 ** -0.5), _rand(gen, 96, scale=0.02))]
    before = FM.fused_mlp_bwd.launches
    FM.fused_mlp(x, *leaves).sum().backward()
    assert FM.fused_mlp_bwd.launches == before + 1
    assert all(t.grad is not None and t.grad.dtype == torch.float32
               for t in leaves)
    with pytest.raises(ValueError, match="head_dim"):
        BA.attend_qkv(torch.zeros(2, 16, 3 * 96, device=cuda,
                                  dtype=torch.bfloat16), 1)
    with pytest.raises(ValueError, match="S <= 256"):
        BA.attend_qkv(torch.zeros(2, 257, 3 * 64, device=cuda,
                                  dtype=torch.bfloat16), 1)
    with pytest.raises(ValueError, match="S <= 256"):
        BA.attend_qkv_bwd(torch.zeros(2, 257, 3 * 64, device=cuda,
                                      dtype=torch.bfloat16),
                          torch.zeros(2, 257, 64, device=cuda,
                                      dtype=torch.bfloat16), 1)
    with pytest.raises(TypeError, match="bfloat16"):
        BA.attend_qkv(torch.zeros(2, 16, 3 * 64, device=cuda), 1)
    with pytest.raises(TypeError, match="bfloat16"):
        FM.fused_mlp(torch.zeros(8, 64, device=cuda),
                     torch.zeros(64, 256, device=cuda),
                     torch.zeros(256, device=cuda),
                     torch.zeros(256, 64, device=cuda),
                     torch.zeros(64, device=cuda))


@pytest.mark.parametrize("b,h,w,d,block,heads", [
    (2, 56, 56, 96, 14, 3),    # NesT-Small's levels, 4, 2 and 1 windows a
    (3, 28, 28, 192, 14, 6),   # strip
    (2, 14, 14, 384, 14, 12),
    (4, 8, 12, 64, 4, 2),      # S 16
    (2, 30, 45, 32, 15, 1),    # S 225: a ragged last 16-row tile
    (2, 32, 16, 64, 16, 2),    # S 256: the largest window
])
def test_ln_attention_windows_kernels_match_plain_and_blockified(
        cuda, b, h, w, d, block, heads):
    """#5 and #6 against their plain versions, every cotangent; against #1
    and #3 on the blockified map, y, qkv, o, dx and dbqkv bit-equal (the
    same arithmetic per row and per window; dbqkv sums the windows in
    blockify order), the other weight gradients within the bound (their
    sums over rows run in map order); reruns of #6 bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(b * h * w + d)
    x = _rand(gen, b, h, w, d).bfloat16()
    dy = _rand(gen, b, h, w, d).bfloat16()
    g, bt, wq, bq, wo, bo = _attn_params(gen, d, scale=3.0)
    before = FB.ln_attention_windows.launches
    y, qkv, o = FB._ln_attention_windows_cuda(x, block, g, bt, wq, bq, wo,
                                              bo, heads)
    torch.cuda.synchronize()
    assert FB.ln_attention_windows.launches == before + 1
    assert y.shape == x.shape and qkv.shape == (b, h, w, 3 * d)
    assert _rel_err(y, FB.ln_attention_windows_plain(
        x, block, g, bt, wq, bq, wo, bo, heads)) <= BOUND
    t, tdy = FB._windows(x, block), FB._windows(dy, block)
    y1, qkv1, o1 = FB._ln_attention_cuda(t, g, bt, wq, bq, wo, bo, heads)
    assert torch.equal(y, FB._unwindows(y1, x, block))
    assert torch.equal(qkv, FB._unwindows(qkv1, qkv, block))
    assert torch.equal(o, FB._unwindows(o1, x, block))

    before = FB.ln_attention_windows_bwd.launches
    outs = FB.ln_attention_windows_bwd(x, block, g, bt, wq, bq, wo, dy,
                                       heads, qkv, o)
    torch.cuda.synchronize()
    assert FB.ln_attention_windows_bwd.launches == before + 1
    refs = FB.ln_attention_windows_bwd_plain(x, block, g, bt, wq, bq, wo, dy,
                                             heads)
    for out, ref in zip(outs, refs):
        assert out.shape == ref.shape and out.dtype == ref.dtype
        assert torch.isfinite(out.float()).all()
        assert _rel_err(out, ref) <= BOUND
    again = FB.ln_attention_windows_bwd(x, block, g, bt, wq, bq, wo, dy,
                                        heads, qkv, o)
    assert all(torch.equal(a, b) for a, b in zip(outs, again))  # no atomics
    blocked = FB.ln_attention_bwd(t, g, bt, wq, bq, wo, tdy, heads, qkv1, o1)
    assert torch.equal(outs[0], FB._unwindows(blocked[0], x, block))
    assert torch.equal(outs[4], blocked[4])
    for out, ref in zip(outs[1:], blocked[1:]):
        assert _rel_err(out, ref) <= BOUND


def test_ln_attention_windows_autograd_and_refusals(cuda):
    """Autograd through ``ln_attention_windows`` on CUDA tensors launches
    the backward kernel; a CUDA map the kernels do not take raises (head
    dim other than 32, H or W not a multiple of the window, a
    non-contiguous map, S above 256 backward)."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    b, h, w, d, block, heads = 2, 28, 28, 96, 14, 3
    x = _rand(gen, b, h, w, d).bfloat16().requires_grad_()
    leaves = [t.clone().requires_grad_() for t in (
        1.0 + _rand(gen, d, scale=0.1), _rand(gen, d, scale=0.1),
        _rand(gen, d, 3 * d, scale=d ** -0.5), _rand(gen, 3 * d, scale=0.02),
        _rand(gen, d, d, scale=d ** -0.5), _rand(gen, d, scale=0.02))]
    dy = _rand(gen, b, h, w, d).bfloat16()
    before = FB.ln_attention_windows_bwd.launches
    FB.ln_attention_windows(x, block, *leaves, heads).backward(dy)
    assert FB.ln_attention_windows_bwd.launches == before + 1
    want = FB.ln_attention_windows_bwd_plain(
        x.detach(), block, *[t.detach() for t in leaves[:5]], dy, heads)
    assert _rel_err(x.grad, want[0]) <= BOUND
    for leaf, w_ in zip(leaves, want[1:]):
        assert leaf.grad.dtype == torch.float32
        assert _rel_err(leaf.grad, w_.reshape(leaf.shape)) <= BOUND

    d = 64
    g, bt, wq, bq, wo, bo = _attn_params(gen, d)
    zeros = dict(device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 32"):
        FB.ln_attention_windows(torch.zeros(2, 8, 8, d, **zeros), 4, g, bt,
                                wq, bq, wo, bo, 4)
    for hh, ww in ((8, 10), (10, 8)):
        with pytest.raises(ValueError, match="divisible by the window"):
            FB.ln_attention_windows(torch.zeros(2, hh, ww, d, **zeros), 4,
                                    g, bt, wq, bq, wo, bo, 2)
    with pytest.raises(ValueError, match="contiguous"):
        FB.ln_attention_windows(
            torch.zeros(2, 8, d, 8, **zeros).transpose(2, 3), 4, g, bt, wq,
            bq, wo, bo, 2)
    with pytest.raises(TypeError, match="bfloat16"):
        FB.ln_attention_windows(torch.zeros(2, 8, 8, d, device=cuda), 4, g,
                                bt, wq, bq, wo, bo, 2)
    xs = torch.zeros(1, 17, 17, d, **zeros)
    with pytest.raises(ValueError, match="S <= 256"):
        FB.ln_attention_windows_bwd(xs, 17, g, bt, wq, bq, wo, xs, 2,
                                    torch.zeros(1, 17, 17, 3 * d, **zeros),
                                    xs)


# conv3x3 and bn_relu_gemm round once, at the output, from fp32 sums taken
# in another order than the plain version's: one bf16 step (2^-8 of the
# largest output) plus the sums' difference; BOUND covers it.
# The four edge shapes (C and K not multiples of the 64-wide slice and the
# 128-wide tile, a one-pixel map, a one-pixel-high map) and the probe's two.
@pytest.mark.parametrize("b,h,w,c,k", [(3, 7, 9, 48, 80), (1, 1, 1, 16, 16),
                                       (5, 4, 33, 16, 144),
                                       (2, 28, 28, 128, 128),
                                       (128, 28, 28, 128, 128),
                                       (128, 14, 14, 256, 256)])
def test_conv3x3_kernel_matches_plain_at_the_edges(cuda, b, h, w, c, k):
    gen = torch.Generator(device=cuda).manual_seed(b * h * w + c)
    x = _rand(gen, b, h, w, c).bfloat16()
    wt = _rand(gen, 3, 3, c, k, scale=(9 * c) ** -0.5).bfloat16()
    before = CV.conv3x3.launches
    y = CV.conv3x3(x, wt)
    torch.cuda.synchronize()
    assert CV.conv3x3.launches == before + 1
    ref = CV.conv3x3_plain(x, wt)
    assert y.shape == (b * h * w, k) and torch.isfinite(y.float()).all()
    assert _rel_err(y, ref) <= BOUND
    y4, r4 = y.view(b, h, w, k), ref.view(b, h, w, k)
    for edge in (y4[:, 0] - r4[:, 0], y4[:, -1] - r4[:, -1],
                 y4[:, :, 0] - r4[:, :, 0], y4[:, :, -1] - r4[:, :, -1]):
        assert edge.float().abs().max() <= BOUND * r4.float().abs().max()
    assert torch.equal(CV.conv3x3(x, wt), y)


# #18 on the register-A form: C of 16, 48 (inside one 64-deep step, the
# rest zero-filled by TMA) and multiples of 64 up to the table's limit; K
# of 16, 80 (a ragged 128-wide tile), 64, 128 and 256; ragged M and one row
@pytest.mark.parametrize("m,c,k", [(189, 48, 80), (1, 16, 16),
                                   (4097, 256, 64), (1000, 64, 256),
                                   (1037, 16, 256), (300, 48, 16),
                                   (4097, 512, 128), (77, 192, 80),
                                   (1037, BG.MAX_C, 16), (1, 64, 256)])
def test_bn_relu_gemm_kernel_matches_plain(cuda, m, c, k):
    gen = torch.Generator(device=cuda).manual_seed(m + c + k)
    x = _rand(gen, m, c).bfloat16()
    a, b = _rand(gen, 1, c), _rand(gen, 1, c)
    wt = _rand(gen, c, k, scale=0.05).bfloat16()
    before = BG.bn_relu_gemm.launches
    y = BG.bn_relu_gemm(x, a, b, wt)
    torch.cuda.synchronize()
    assert BG.bn_relu_gemm.launches == before + 1
    assert y.shape == (m, k) and torch.isfinite(y.float()).all()
    assert _rel_err(y, BG.bn_relu_gemm_plain(x, a, b, wt)) <= BOUND
    torch.backends.cuda.matmul.allow_tf32 = False
    assert _rel_err(y, BG.bn_relu_gemm_plain(x.float(), a, b,
                                             wt.float())) <= BOUND_FP32
    assert torch.equal(BG.bn_relu_gemm(x, a, b, wt), y)


@pytest.mark.parametrize("m,c,k", [(189, 48, 80), (1037, 16, 256),
                                   (4097, 256, 64)])
def test_bn_relu_gemm_reads_no_channel_past_c(cuda, m, c, k):
    """a and b as the first C of vectors 64 longer whose tail holds NaN:
    the kernel copies C channels of each and zeros past them, so the
    output is finite and the same bits as with a and b alone."""
    gen = torch.Generator(device=cuda).manual_seed(m * c + k)
    x = _rand(gen, m, c).bfloat16()
    a, b = _rand(gen, c), _rand(gen, c)
    wt = _rand(gen, c, k, scale=0.05).bfloat16()
    long_a = torch.full((c + 64,), float("nan"), device=cuda)
    long_b = torch.full((c + 64,), float("nan"), device=cuda)
    long_a[:c], long_b[:c] = a, b
    y = BG.bn_relu_gemm(x, long_a[:c], long_b[:c], wt)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all()
    assert torch.equal(y, BG.bn_relu_gemm(x, a, b, wt))
    assert _rel_err(y, BG.bn_relu_gemm_plain(x, a, b, wt)) <= BOUND


def test_bn_relu_gemm_refuses_what_its_kernel_does_not_take(cuda):
    """C past the a/b table and x or w off 16-byte alignment raise before
    any launch (TMA reads x and w)."""
    vec = torch.zeros(BG.MAX_C + 16, device=cuda)
    big = torch.zeros(8, BG.MAX_C + 16, device=cuda, dtype=torch.bfloat16)
    w_big = torch.zeros(BG.MAX_C + 16, 16, device=cuda, dtype=torch.bfloat16)
    flat = torch.zeros(8 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(64, 16, device=cuda, dtype=torch.bfloat16)
    w_flat = torch.zeros(64 * 16 + 1, device=cuda, dtype=torch.bfloat16)
    x = flat[:-1].view(8, 64)
    before = BG.bn_relu_gemm.launches
    with pytest.raises(ValueError, match="C up to"):
        BG.bn_relu_gemm(big, vec, vec, w_big)
    with pytest.raises(ValueError, match="16-byte aligned"):
        BG.bn_relu_gemm(flat[1:].view(8, 64), vec[:64], vec[:64], w)
    with pytest.raises(ValueError, match="16-byte aligned"):
        BG.bn_relu_gemm(x, vec[:64], vec[:64], w_flat[1:].view(64, 16))
    assert BG.bn_relu_gemm.launches == before


def test_probe_kernels_raise_on_what_they_refuse(cuda):
    x = torch.zeros(2, 4, 4, 16, device=cuda, dtype=torch.bfloat16)
    wt = torch.zeros(3, 3, 16, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        CV.conv3x3(x.float(), wt)
    with pytest.raises(TypeError, match="bfloat16 weights"):
        CV.conv3x3(x, wt.float())
    with pytest.raises(ValueError, match="contiguous"):
        CV.conv3x3(x.transpose(1, 2), wt)
    with pytest.raises(ValueError, match="stride"):
        CV.conv3x3(x, wt, stride=2)
    with pytest.raises(ValueError, match="multiples of 16"):
        CV.conv3x3(torch.zeros(2, 4, 4, 8, device=cuda, dtype=torch.bfloat16),
                   torch.zeros(3, 3, 8, 16, device=cuda,
                               dtype=torch.bfloat16))
    rows = torch.zeros(8, 16, device=cuda, dtype=torch.bfloat16)
    vec = torch.zeros(16, device=cuda)
    w16 = torch.zeros(16, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="fp32 a, b"):
        BG.bn_relu_gemm(rows, vec.bfloat16(), vec, w16)
    with pytest.raises(ValueError, match="tensors on"):
        BG.bn_relu_gemm(rows, vec.cpu(), vec, w16)


def _mlp_tile_params(gen, d, f):
    # b1 and b2 at scale 1: a dropped or misindexed bias moves y by about as
    # much as the MLP branch does, far past BOUND
    return (1.0 + _rand(gen, d, scale=0.1), _rand(gen, d, scale=0.1),
            _rand(gen, d, f, scale=d ** -0.5).bfloat16(), _rand(gen, f),
            _rand(gen, f, d, scale=f ** -0.5).bfloat16(), _rand(gen, d))


# #13 and #19a on #2's launch sequence: both instances, every flag
# combination and chain stage, against the plain version in bf16 and in
# fp32 (TF32 off), reruns bit-equal. Rows past a whole 128-row tile (every
# M here), widths below the probe's (D 64, 96, 192; F 352 is 2.75 tiles of
# 128), and D 40, which only the forms without a LayerNorm take.
@pytest.mark.parametrize("m,d,f", [(3136, 384, 1536), (1037, 384, 1536),
                                   (77, 192, 768), (100, 64, 256),
                                   (1037, 96, 352), (77, 40, 160)])
def test_mlp_tile_forward_kernels_match_plain(cuda, m, d, f):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    x = _rand(gen, m, d).bfloat16()
    params = _mlp_tile_params(gen, d, f)
    p32 = [t.float() for t in params]
    w1, w2 = params[2], params[4]
    flags = [(ln, gelu) for ln, gelu in ((True, True), (True, False),
                                         (False, True)) if ln <= (d % 32 == 0)]
    chains = [s for s in MT.CHAIN_STAGES if "ln" not in s or d % 32 == 0]
    for tm, fs in MT.TILES:
        for ln, gelu in flags:
            before = MT.mlp_tile.launches
            y = MT.mlp_tile(x, *params, ln=ln, gelu=gelu, tm=tm, fs=fs)
            torch.cuda.synchronize()
            assert MT.mlp_tile.launches == before + 1
            at = (tm, fs, ln, gelu)
            assert y.shape == (m, d) and torch.isfinite(y.float()).all()
            assert _rel_err(y, MT.mlp_tile_plain(
                x, *params, ln=ln, gelu=gelu)) <= BOUND, at
            assert _rel_err(y, MT.mlp_tile_plain(
                x.float(), *p32, ln=ln, gelu=gelu)) <= BOUND_FP32, at
            assert torch.equal(MT.mlp_tile(x, *params, ln=ln, gelu=gelu,
                                           tm=tm, fs=fs), y), at
        for stages in chains:
            before = MT.mlp_chain.launches
            y = MT.mlp_chain(x, w1, w2, stages, tm=tm, fs=fs)
            torch.cuda.synchronize()
            assert MT.mlp_chain.launches == before + 1
            at = (tm, fs, stages)
            assert y.shape == (m, d) and torch.isfinite(y.float()).all()
            assert _rel_err(y, MT.mlp_chain_plain(x, w1, w2, stages)) \
                <= BOUND, at
            assert _rel_err(y, MT.mlp_chain_plain(
                x.float(), p32[2], p32[4], stages)) <= BOUND_FP32, at
            assert torch.equal(MT.mlp_chain(x, w1, w2, stages, tm=tm,
                                            fs=fs), y), at


# The single product on the wgmma mainloop: M of one row, ragged and the
# probe's 25088, and K and N that are not multiples of the 64-deep slice or
# the 128-wide tile.
@pytest.mark.parametrize("m,k,n", [(1, 384, 1536), (77, 384, 1536),
                                   (1037, 384, 1536), (25088, 384, 1536),
                                   (77, 200, 264), (1037, 8, 72)])
def test_mlp_single_kernel_matches_plain_and_reruns_bit_equal(cuda, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = _rand(gen, m, k).bfloat16()
    w1 = _rand(gen, k, n, scale=k ** -0.5).bfloat16()
    before = MT.mlp_single.launches
    z = MT.mlp_single(x, w1)
    torch.cuda.synchronize()
    assert MT.mlp_single.launches == before + 1
    assert z.shape == (m, n) and torch.isfinite(z.float()).all()
    assert _rel_err(z, MT.mlp_single_plain(x, w1)) <= BOUND
    assert torch.equal(MT.mlp_single(x, w1), z)


@pytest.mark.parametrize("m,d,f", [(3136, 384, 1536), (1037, 384, 1536),
                                   (77, 192, 768), (100, 64, 256),
                                   (1037, 96, 352)])  # F: 2.75 tiles at 128
def test_mlp_tile_bwd_kernel_matches_plain_and_reruns_bit_equal(cuda, m, d,
                                                                 f):
    """Every instance against the plain version in bf16 and in fp32 (TF32
    off), one launch a call, a rerun bit-equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(m + d + 1)
    x = _rand(gen, m, d).bfloat16()
    g, b, w1, b1, w2, _ = _mlp_tile_params(gen, d, f)
    dy = _rand(gen, m, d).bfloat16()
    refs = MT.mlp_tile_bwd_plain(x, g, b, w1, b1, w2, dy)
    refs32 = MT.mlp_tile_bwd_plain(x.float(), g, b, w1.float(), b1,
                                   w2.float(), dy.float())
    for tm, fs in MT.BWD_TILES:
        before = MT.mlp_tile_bwd.launches
        outs = MT.mlp_tile_bwd(x, g, b, w1, b1, w2, dy, tm=tm, fs=fs)
        torch.cuda.synchronize()
        assert MT.mlp_tile_bwd.launches == before + 1
        again = MT.mlp_tile_bwd(x, g, b, w1, b1, w2, dy, tm=tm, fs=fs)
        for name, out, ref, ref32, rerun in zip(
                ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"), outs,
                refs, refs32, again):
            assert out.shape == ref.shape and out.dtype == ref.dtype, name
            assert torch.isfinite(out.float()).all(), name
            assert _rel_err(out, ref) <= BOUND, (tm, fs, name)
            assert _rel_err(out, ref32) <= BOUND_BWD_FP32, (tm, fs, name)
            assert torch.equal(out, rerun), (tm, fs, name)


def test_mlp_probe_kernels_raise_on_what_they_refuse(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = _rand(gen, 64, 64).bfloat16()
    g, b, w1, b1, w2, b2 = _mlp_tile_params(gen, 64, 256)
    with pytest.raises(TypeError, match="bfloat16"):
        MT.mlp_tile(x.float(), g, b, w1, b1, w2, b2)
    with pytest.raises(TypeError, match="bfloat16 weights"):
        MT.mlp_tile(x, g, b, w1.float(), b1, w2, b2)
    with pytest.raises(TypeError, match="fp32 vectors"):
        MT.mlp_tile_bwd(x, g.bfloat16(), b, w1, b1, w2, x)
    with pytest.raises(ValueError, match="contiguous"):
        MT.mlp_chain(x, w1.t().contiguous().t(), w2)
    with pytest.raises(ValueError, match="tensors on"):
        MT.mlp_single(x, w1.cpu())
    with pytest.raises(ValueError, match="16-byte aligned"):
        MT.mlp_single(torch.zeros(64 * 64 + 4, device=cuda,
                                  dtype=torch.bfloat16)[4:].view(64, 64), w1)
    with pytest.raises(ValueError, match="instances"):
        MT.mlp_tile_bwd(x, g, b, w1, b1, w2, x, tm=64, fs=128)
    off = torch.zeros(64 * 64 + 4, device=cuda,
                      dtype=torch.bfloat16)[4:].view(64, 64)
    before = [k.launches for k in MT.KERNELS]
    with pytest.raises(ValueError, match="16-byte aligned"):
        MT.mlp_tile_bwd(off, g, b, w1, b1, w2, x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        MT.mlp_tile_bwd(x, g, b, w1, b1, w2, off)
    # #13 and #19a: #2's sequence reads x, w1 and w2 by TMA; its instances
    # (tm, fs) and limits (D a multiple of 32 up to 1024 with a LayerNorm,
    # of 8 without; F of 8)
    w1_off = torch.zeros(64 * 256 + 4, device=cuda,
                         dtype=torch.bfloat16)[4:].view(64, 256)
    w2_off = torch.zeros(256 * 64 + 4, device=cuda,
                         dtype=torch.bfloat16)[4:].view(256, 64)
    for ops in ((off, w1, w2), (x, w1_off, w2), (x, w1, w2_off)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            MT.mlp_tile(ops[0], g, b, ops[1], b1, ops[2], b2)
        with pytest.raises(ValueError, match="16-byte aligned"):
            MT.mlp_chain(*ops, ("ln", "gelu"))
    with pytest.raises(ValueError, match="instances"):
        MT.mlp_tile(x, g, b, w1, b1, w2, b2, tm=64, fs=64)
    with pytest.raises(ValueError, match="instances"):
        MT.mlp_chain(x, w1, w2, tm=32, fs=128)
    x40 = torch.zeros(64, 40, device=cuda, dtype=torch.bfloat16)
    w40 = torch.zeros(40, 160, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 32 up to 1024"):
        MT.mlp_chain(x40, w40, w40.T.contiguous(), ("ln", "gelu"))
    with pytest.raises(ValueError, match="F a multiple of 8"):
        MT.mlp_chain(x, w1[:, :252].contiguous(), w2[:252].contiguous())
    assert [k.launches for k in MT.KERNELS] == before


def _attn_sched_params(gen, d):
    # biases and beta at scale 1, gamma not 1: a dropped bias or affine
    # moves y and the cotangents far past BOUND
    return (1.0 + _rand(gen, d, scale=0.2), _rand(gen, d),
            _rand(gen, d, 3 * d, scale=d ** -0.5).bfloat16(),
            _rand(gen, 3 * d), _rand(gen, d, d, scale=d ** -0.5).bfloat16(),
            _rand(gen, d))


# The attention schedule probes: every mode at the probe's width (D 384, 12
# heads) at S 196, a ragged S and the largest, and a narrow one.
@pytest.mark.parametrize("n,s,d", [(4, 196, 384), (4, 37, 384), (3, 208, 64),
                                   (2, 256, 384)])
def test_attn_sched_kernels_match_plain_and_agree_across_modes(cuda, n, s, d):
    """Every mode against its plain version; the softmax modes' y bit-equal
    to each other and to #1's (v0 launches what #1 launches)."""
    heads = d // 32
    gen = torch.Generator(device=cuda).manual_seed(n + s + d)
    x = _rand(gen, n, s, d).bfloat16()
    params = _attn_sched_params(gen, d)
    p32 = [t.float() for t in params]
    ys = {}
    for mode in AS.MODES:
        before = AS.attn_sched.launches
        y = AS.attn_sched(x, *params, heads, mode)
        torch.cuda.synchronize()
        assert AS.attn_sched.launches == before + 1
        assert y.shape == x.shape and torch.isfinite(y.float()).all()
        assert _rel_err(y, AS.attn_sched_plain(x, *params, heads, mode)) \
            <= BOUND, mode
        assert _rel_err(y, AS.attn_sched_plain(x.float(), *p32, heads,
                                               mode)) <= 2 * BOUND, mode
        qkv = AS.ln_qkv_plain(x, *params[:4])[-1]
        assert _rel_err(AS.attn_sched_core(qkv, heads, mode),
                        AS.attn_sched_core_plain(qkv, heads, mode)) \
            <= BOUND, mode
        ys[mode] = y
    for mode in ("pipe", "pipe2", "stage"):
        assert torch.equal(ys[mode], ys["v0"]), mode
    assert torch.equal(ys["v0"], FB.ln_attention(x, *params, heads))


def test_attn_sched_refuses_misaligned_operands_and_65536_samples(cuda):
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = _rand(gen, 2, 40, 64).bfloat16()
    params = list(_attn_sched_params(gen, 64))
    off = torch.zeros(x.numel() + 4, device=cuda,
                      dtype=torch.bfloat16)[4:].view(x.shape)
    w_off = torch.zeros(params[2].numel() + 4, device=cuda,
                        dtype=torch.bfloat16)[4:].view(params[2].shape)
    before = (AS.attn_sched.launches, AS.attn_sched_core.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        AS.attn_sched(off, *params, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        AS.attn_sched(x, *params[:2], w_off, *params[3:], 2)
    qkv = torch.zeros(2 * 40 * 192 + 4, device=cuda,
                      dtype=torch.bfloat16)[4:].view(2, 40, 192)
    with pytest.raises(ValueError, match="16-byte aligned"):
        AS.attn_sched_core(qkv, 2)
    many = torch.zeros(65536, 1, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 65535"):
        AS.attn_sched(many, *params, 2)
    with pytest.raises(ValueError, match="at most 65535"):
        AS.attn_sched_core(torch.zeros(65536, 1, 192, device=cuda,
                                       dtype=torch.bfloat16), 2)
    assert (AS.attn_sched.launches, AS.attn_sched_core.launches) == before


@pytest.mark.parametrize("n,s,d", [(4, 196, 384), (4, 37, 384), (3, 208, 64)])
def test_attn_sched_bwd_kernels_match_plain_and_rerun_bit_equal(cuda, n, s,
                                                                d):
    """Every mode against the plain version in bf16 and in fp32 (TF32
    off), one launch a call, a rerun bit-equal; the core alone (uni's o
    from the register core's own p) against its plain version, and every
    mode's o bit-equal (v0's and stage2's from the forward core with
    kRecip)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    heads = d // 32
    gen = torch.Generator(device=cuda).manual_seed(n + s + d + 1)
    x = _rand(gen, n, s, d).bfloat16()
    params = _attn_sched_params(gen, d)[:5]
    dy = _rand(gen, n, s, d).bfloat16()
    refs = AS.attn_sched_bwd_plain(x, *params, dy, heads)
    refs32 = AS.attn_sched_bwd_plain(x.float(), *[t.float() for t in params],
                                     dy.float(), heads)
    qkv = AS.ln_qkv_plain(x, *params[:4])[-1]
    core_refs = AS.attn_sched_bwd_core_plain(qkv, dy, heads)
    core_o = {}
    for mode in AS.BWD_MODES:
        before = AS.attn_sched_bwd.launches
        outs = AS.attn_sched_bwd(x, *params, dy, heads, mode)
        torch.cuda.synchronize()
        assert AS.attn_sched_bwd.launches == before + 1
        again = AS.attn_sched_bwd(x, *params, dy, heads, mode)
        for name, out, ref, ref32, rerun in zip(
                ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwout", "dbout"),
                outs, refs, refs32, again):
            assert out.shape == ref.shape and out.dtype == ref.dtype, name
            assert torch.isfinite(out.float()).all(), (mode, name)
            assert _rel_err(out, ref) <= BOUND, (mode, name)
            assert _rel_err(out, ref32) <= BOUND_BWD_FP32, (mode, name)
            assert torch.equal(out, rerun), (mode, name)
        before = AS.attn_sched_bwd_core.launches
        core = AS.attn_sched_bwd_core(qkv, dy, heads, mode)
        torch.cuda.synchronize()
        assert AS.attn_sched_bwd_core.launches == before + 1
        for name, out, ref in zip(("o", "dqkv"), core, core_refs):
            assert out.shape == ref.shape and out.dtype == ref.dtype, name
            assert _rel_err(out, ref) <= BOUND, (mode, name)
        core_o[mode] = core[0]
    for mode in ("stage2", "uni"):
        assert torch.equal(core_o[mode], core_o["v0"]), mode


@pytest.mark.parametrize("s,modes", [(241, AS.BWD_MODES),
                                     (256, AS.BWD_MODES),
                                     (240, AS.BWD_MODES),
                                     (1, AS.BWD_MODES)])
def test_attn_sched_bwd_takes_each_modes_largest_s(cuda, s, modes):
    """Every mode runs the register cores (S <= 256): uni the backward's
    alone, v0 and stage2 the forward's first for o. At S 1 dq and dk are
    zero."""
    n, d = 2, 64
    gen = torch.Generator(device=cuda).manual_seed(s)
    x = _rand(gen, n, s, d).bfloat16()
    params = _attn_sched_params(gen, d)[:5]
    dy = _rand(gen, n, s, d).bfloat16()
    refs = AS.attn_sched_bwd_plain(x, *params, dy, 2)
    for mode in modes:
        outs = AS.attn_sched_bwd(x, *params, dy, 2, mode)
        torch.cuda.synchronize()
        for name, out, ref in zip(
                ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwout", "dbout"),
                outs, refs):
            assert torch.isfinite(out.float()).all(), (mode, name)
            if s > 1 or name not in ("dwqkv", "dbqkv"):
                assert _rel_err(out, ref) <= BOUND, (mode, name)


def test_attn_sched_bwd_refuses_misaligned_operands(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = _rand(gen, 2, 40, 64).bfloat16()
    params = _attn_sched_params(gen, 64)[:5]
    off = torch.zeros(x.numel() + 4, device=cuda,
                      dtype=torch.bfloat16)[4:].view(x.shape)
    qkv = _rand(gen, 2, 40, 192).bfloat16()
    before = (AS.attn_sched_bwd.launches, AS.attn_sched_bwd_core.launches)
    for args in ((off, *params, x), (x, *params, off)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            AS.attn_sched_bwd(*args, 2, "uni")
    with pytest.raises(ValueError, match="16-byte aligned"):
        AS.attn_sched_bwd_core(qkv, off, 2, "uni")
    assert (AS.attn_sched_bwd.launches,
            AS.attn_sched_bwd_core.launches) == before


def test_attn_sched_cuda_never_takes_the_plain_path(cuda, monkeypatch):
    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain path")

    for name in ("attn_sched_plain", "attn_sched_core_plain",
                 "attn_sched_bwd_plain", "attn_sched_bwd_core_plain"):
        monkeypatch.setattr(AS, name, no_plain)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = _rand(gen, 2, 40, 64).bfloat16()
    params = _attn_sched_params(gen, 64)
    qkv = _rand(gen, 2, 40, 192).bfloat16()
    for mode in AS.MODES:
        AS.attn_sched(x, *params, 2, mode)
        AS.attn_sched_core(qkv, 2, mode)
    for mode in AS.BWD_MODES:
        AS.attn_sched_bwd(x, *params[:5], x, 2, mode)
        AS.attn_sched_bwd_core(qkv, x, 2, mode)
    torch.cuda.synchronize()
    with pytest.raises(TypeError, match="bfloat16"):
        AS.attn_sched(x.float(), *params, 2)
    with pytest.raises(TypeError, match="fp32 vectors"):
        AS.attn_sched_bwd(x, params[0].bfloat16(), *params[1:5], x, 2)
    with pytest.raises(ValueError, match="tensors on"):
        AS.attn_sched_bwd_core(qkv, x.cpu(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        AS.attn_sched_core(qkv.transpose(0, 1).contiguous().transpose(0, 1),
                           2)


@pytest.mark.parametrize("zero_row", [None, 3])
def test_vlp_tinybert_step_launches_the_augmentation_kernels(cuda,
                                                             zero_row):
    """The pretrain step (ResNet34 + TinyBERT at batch 8, 224 px, 40-token
    ragged captions, bf16, the experiment's shear and noise) on the card:
    3 ``shear_rows`` + 1 ``add_gaussian_noise`` launches and no other
    kernel of the port, finite loss and gradients; a caption whose mask is
    all zeros gives finite embeddings in training and in eval."""
    import dataclasses

    import numpy as np

    from vlp_tpu_torch.config import PRETRAIN, TRAIN_EXPERIMENTS
    from vlp_tpu_torch.train.setup import (build_training,
                                           random_pretrain_batch)
    from vlp_tpu_torch.train.step import to_device, train_steps

    tcfg = dataclasses.replace(TRAIN_EXPERIMENTS[PRETRAIN], batch_size=8)
    task, state, step = build_training(tcfg, cuda, 10)
    batch = random_pretrain_batch(np.random.default_rng(0), 8, 224, 40)
    if zero_row is not None:
        batch["attention_mask"][zero_row] = 0
    kernels = (*FB.KERNELS, *BA.KERNELS, *FM.KERNELS, SH.shear_rows,
               NZ.add_gaussian_noise, *CV.KERNELS, *BG.KERNELS,
               *MT.KERNELS, *AS.KERNELS)
    for k in kernels:
        k.launches = 0
    (aux,) = train_steps(step, state, [batch])
    torch.cuda.synchronize()
    assert {k.__name__: k.launches for k in kernels if k.launches} == {
        "shear_rows": 3, "add_gaussian_noise": 1}
    assert torch.isfinite(aux["loss"]) and torch.isfinite(
        aux["txt_emb"]).all()
    assert all(torch.isfinite(p.grad).all()
               for p in task.model.parameters())
    out = task.eval_fn(to_device(batch, cuda))
    assert all(torch.isfinite(out[k]).all()
               for k in ("img_emb", "txt_emb", "loss"))
