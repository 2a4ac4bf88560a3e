"""The CUDA kernels (half blocks and their backwards, the windowed half
block on a NesT token map and its backward, the packed-qkv attention and
the fused MLP with their backwards, shear, noise, and the ResNet probe
kernels conv3x3 and bn_relu_gemm) against their plain PyTorch versions, on
the card. Marked ``gpu``: without a CUDA
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

from vlp_tpu_torch.ops import block_attention as BA
from vlp_tpu_torch.ops import bn_gemm as BG
from vlp_tpu_torch.ops import conv3x3 as CV
from vlp_tpu_torch.ops import fused_block as FB
from vlp_tpu_torch.ops import fused_mlp as FM
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
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


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


@pytest.mark.parametrize("n,s,d,heads", [(2, 197, 768, 12), (3, 196, 96, 3),
                                         (5, 17, 128, 2), (2, 256, 64, 1),
                                         (2, 224, 128, 2), (2, 240, 64, 2)])
def test_attend_qkv_kernels_match_plain(cuda, n, s, d, heads):
    """Forward and backward of the packed-qkv attention (#7, #8) at head
    dims 64 and 32, ragged S and the largest S each takes; reruns of the
    backward are bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(n * s + d + 2)
    # 3x a unit scale: peaked softmax rows
    qkv = _rand(gen, n, s, 3 * d, scale=3.0).bfloat16()
    do = _rand(gen, n, s, d).bfloat16()
    before = BA.attend_qkv.launches
    out = BA.attend_qkv(qkv, heads)
    torch.cuda.synchronize()
    assert BA.attend_qkv.launches == before + 1
    assert _rel_err(out, BA.attend_qkv_plain(qkv, heads)) <= BOUND
    if s > BA.MAX_SEQ_BWD[d // heads]:
        return
    before = BA.attend_qkv_bwd.launches
    dqkv = BA.attend_qkv_bwd(qkv, do, heads)
    torch.cuda.synchronize()
    assert BA.attend_qkv_bwd.launches == before + 1
    ref = BA.attend_qkv_bwd_plain(qkv, do, heads)
    for part in range(3):  # dq, dk, dv each against its own largest value
        sl = slice(part * d, (part + 1) * d)
        assert _rel_err(dqkv[..., sl], ref[..., sl]) <= BOUND
    assert torch.equal(dqkv, BA.attend_qkv_bwd(qkv, do, heads))


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
    with pytest.raises(ValueError, match="S <= 224"):
        BA.attend_qkv_bwd(torch.zeros(2, 240, 3 * 64, device=cuda,
                                      dtype=torch.bfloat16),
                          torch.zeros(2, 240, 64, device=cuda,
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
@pytest.mark.parametrize("b,h,w,c,k", [(3, 7, 9, 48, 80), (1, 1, 1, 16, 16),
                                       (5, 4, 33, 16, 144),
                                       (2, 28, 28, 128, 128)])
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
