"""The CUDA kernels (half blocks and their backwards, the windowed half
block on a NesT token map and its backward, the packed-qkv attention and
the fused MLP with their backwards, shear, noise, the ResNet probe
kernels conv3x3 and bn_relu_gemm, the MLP probe kernels mlp_tile, its
backward, mlp_chain and mlp_single (the last and conv3x3 on the wgmma
mainloop, reruns bit-equal), and the attention schedule probes
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
backward; shear is exact; noise within 2^-13 (chip_smoke.BOUND_NOISE).
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
                                         (2, 64, 384, 12), (7, 200, 96, 3)])
def test_ln_attention_kernel_matches_plain(cuda, n, s, d, heads):
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


@pytest.mark.parametrize("n,s,d,heads", [(3, 196, 64, 2), (5, 17, 32, 1),
                                         (2, 64, 384, 12), (7, 200, 96, 3),
                                         (2, 240, 64, 2)])  # largest S
def test_ln_attention_bwd_kernel_matches_plain(cuda, n, s, d, heads):
    gen = torch.Generator(device=cuda).manual_seed(n * s + d + 1)
    x = _rand(gen, n, s, d).bfloat16()
    dy = _rand(gen, n, s, d).bfloat16()
    g, b, wq, bq, wo, bo = _attn_params(gen, d, scale=3.0)
    _, qkv, o = FB._ln_attention_cuda(x, g, b, wq, bq, wo, bo, heads)
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
                                   (33, 384, 1536)])
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


@pytest.mark.parametrize("b,h,w,axis", [(3, 17, 30, 1), (3, 17, 30, 0),
                                        (2, 224, 224, 0)])
def test_shear_kernel_equals_plain(cuda, b, h, w, axis):
    gen = torch.Generator(device=cuda).manual_seed(b + h + w + axis)
    img = _rand(gen, b, h, w) * 100.0
    shift = _rand(gen, b, h if axis == 1 else w, scale=12.0)
    before = SH.shear_rows.launches
    out = SH.shear_rows(img, shift, 10, axis)
    assert SH.shear_rows.launches == before + 1
    assert torch.equal(out, SH.shear_rows_plain(img, shift, 10, axis))


def test_noise_kernel_words_values_and_identity(cuda):
    got = NZ.philox4x32(torch.tensor([[0x243f6a88, 0x85a308d3, 0x13198a2e,
                                       0x03707344]], device=cuda),
                        torch.tensor([[0xa4093822, 0x299f31d0]],
                                     device=cuda))
    assert [int(v) for v in got[0]] == [0xd16cfe09, 0x94fdcceb, 0x5001e420,
                                        0x24126ea1]
    gen = torch.Generator(device=cuda).manual_seed(4)
    b, h, w = 3, 33, 46          # h * w / 2 = 759 words: a ragged last group
    x = torch.rand(b, h, w, generator=gen, device=cuda) * 255.0
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, 2), generator=gen,
                          device=cuda, dtype=torch.int32)
    sigma = torch.tensor([0.0, 1.0, 0.01], device=cuda)
    before = NZ.add_gaussian_noise.launches
    out = NZ.add_gaussian_noise(x, seeds, sigma)
    assert NZ.add_gaussian_noise.launches == before + 1
    assert torch.equal(out[0], x[0])
    ref = NZ.add_gaussian_noise_plain(x, seeds, sigma)
    assert (out - ref).abs().max().item() <= 2.0 ** -13


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
    xb = torch.zeros(2, 256, d, device=cuda, dtype=torch.bfloat16)
    wb = torch.zeros(d, 3 * d, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="S <= 240"):
        FB.ln_attention_bwd(xb, vec, vec, wb,
                            torch.zeros(1, 3 * d, device=cuda),
                            torch.zeros(d, d, device=cuda,
                                        dtype=torch.bfloat16),
                            xb, 2, torch.zeros(2, 256, 3 * d, device=cuda,
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
                                   (512, 384, 1536)])
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
])
def test_ln_attention_windows_kernels_match_plain_and_blockified(
        cuda, b, h, w, d, block, heads):
    """#5 and #6 against their plain versions, every cotangent; against #1
    and #3 on the blockified map, y, dx and dbqkv bit-equal (the same
    arithmetic per row and per window; dbqkv sums the windows in blockify
    order), the other weight gradients within the bound (their sums over
    rows run in map order); reruns of #6 bit-identical."""
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
    non-contiguous map, S above 240 backward)."""
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
    xs = torch.zeros(1, 16, 16, d, **zeros)
    with pytest.raises(ValueError, match="S <= 240"):
        FB.ln_attention_windows_bwd(xs, 16, g, bt, wq, bq, wo, xs, 2,
                                    torch.zeros(1, 16, 16, 3 * d, **zeros),
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


@pytest.mark.parametrize("m,c,k", [(189, 48, 80), (1, 16, 16),
                                   (4097, 256, 64), (1000, 64, 256)])
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


# The MLP tile engine: every instance, every flag combination. Rows past a
# whole tile (M = 1037, 77) and widths below the probe's (D 64, 192).
@pytest.mark.parametrize("m,d,f", [(3136, 384, 1536), (1037, 384, 1536),
                                   (77, 192, 768), (100, 64, 256)])
def test_mlp_tile_forward_kernels_match_plain(cuda, m, d, f):
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    x = _rand(gen, m, d).bfloat16()
    g, b, w1, b1, w2, b2 = _mlp_tile_params(gen, d, f)
    for tm, fs in MT.TILES:
        for ln, gelu in ((True, True), (True, False), (False, True)):
            before = MT.mlp_tile.launches
            y = MT.mlp_tile(x, g, b, w1, b1, w2, b2, ln=ln, gelu=gelu, tm=tm,
                            fs=fs)
            torch.cuda.synchronize()
            assert MT.mlp_tile.launches == before + 1
            ref = MT.mlp_tile_plain(x, g, b, w1, b1, w2, b2, ln=ln,
                                    gelu=gelu)
            assert y.shape == (m, d) and torch.isfinite(y.float()).all()
            assert _rel_err(y, ref) <= BOUND, (tm, fs, ln, gelu)
        for stages in MT.CHAIN_STAGES:
            y = MT.mlp_chain(x, w1, w2, stages, tm=tm, fs=fs)
            torch.cuda.synchronize()
            assert _rel_err(y, MT.mlp_chain_plain(x, w1, w2, stages)) \
                <= BOUND, (tm, fs, stages)


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
                                   (77, 192, 768), (100, 64, 256)])
def test_mlp_tile_bwd_kernel_matches_plain_and_reruns_bit_equal(cuda, m, d,
                                                                 f):
    gen = torch.Generator(device=cuda).manual_seed(m + d + 1)
    x = _rand(gen, m, d).bfloat16()
    g, b, w1, b1, w2, _ = _mlp_tile_params(gen, d, f)
    dy = _rand(gen, m, d).bfloat16()
    refs = MT.mlp_tile_bwd_plain(x, g, b, w1, b1, w2, dy)
    for tm, fs in MT.BWD_TILES:
        before = MT.mlp_tile_bwd.launches
        outs = MT.mlp_tile_bwd(x, g, b, w1, b1, w2, dy, tm=tm, fs=fs)
        torch.cuda.synchronize()
        assert MT.mlp_tile_bwd.launches == before + 1
        again = MT.mlp_tile_bwd(x, g, b, w1, b1, w2, dy, tm=tm, fs=fs)
        for name, out, ref, rerun in zip(
                ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"), outs,
                refs, again):
            assert out.shape == ref.shape and out.dtype == ref.dtype, name
            assert torch.isfinite(out.float()).all(), name
            assert _rel_err(out, ref) <= BOUND, (tm, fs, name)
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


def _attn_sched_params(gen, d):
    # biases and beta at scale 1, gamma not 1: a dropped bias or affine
    # moves y and the cotangents far past BOUND
    return (1.0 + _rand(gen, d, scale=0.2), _rand(gen, d),
            _rand(gen, d, 3 * d, scale=d ** -0.5).bfloat16(),
            _rand(gen, 3 * d), _rand(gen, d, d, scale=d ** -0.5).bfloat16(),
            _rand(gen, d))


# The attention schedule probes: every mode at the probe's width (D 384, 12
# heads) at S 196 and a ragged S, and a narrow one.
@pytest.mark.parametrize("n,s,d", [(4, 196, 384), (4, 37, 384), (3, 208, 64)])
def test_attn_sched_kernels_match_plain_and_agree_across_modes(cuda, n, s, d):
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


@pytest.mark.parametrize("n,s,d", [(4, 196, 384), (4, 37, 384), (3, 208, 64)])
def test_attn_sched_bwd_kernels_match_plain_and_rerun_bit_equal(cuda, n, s,
                                                                d):
    heads = d // 32
    gen = torch.Generator(device=cuda).manual_seed(n + s + d + 1)
    x = _rand(gen, n, s, d).bfloat16()
    params = _attn_sched_params(gen, d)[:5]
    dy = _rand(gen, n, s, d).bfloat16()
    refs = AS.attn_sched_bwd_plain(x, *params, dy, heads)
    qkv = AS.ln_qkv_plain(x, *params[:4])[-1]
    core_refs = AS.attn_sched_bwd_core_plain(qkv, dy, heads)
    for mode in AS.BWD_MODES:
        before = AS.attn_sched_bwd.launches
        outs = AS.attn_sched_bwd(x, *params, dy, heads, mode)
        torch.cuda.synchronize()
        assert AS.attn_sched_bwd.launches == before + 1
        again = AS.attn_sched_bwd(x, *params, dy, heads, mode)
        for name, out, ref, rerun in zip(
                ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwout", "dbout"),
                outs, refs, again):
            assert out.shape == ref.shape and out.dtype == ref.dtype, name
            assert torch.isfinite(out.float()).all(), (mode, name)
            assert _rel_err(out, ref) <= BOUND, (mode, name)
            assert torch.equal(out, rerun), (mode, name)
        core = AS.attn_sched_bwd_core(qkv, dy, heads, mode)
        for name, out, ref in zip(("o", "dqkv"), core, core_refs):
            assert _rel_err(out, ref) <= BOUND, (mode, name)


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
