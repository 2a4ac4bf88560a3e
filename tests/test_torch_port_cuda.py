"""The CUDA half-block kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: without a CUDA device every test here skips. Needs no
JAX, so it runs on a machine without it:

  python -m pytest --noconftest -p no:cacheprovider -m gpu \
      tests/test_torch_port_cuda.py -q

Shapes include ragged row counts (M not a multiple of the 64-row tile) and
short sequences, which NesT-Small's own shapes do not reach. Bounds as in
chip_smoke.py: kernel and plain version round to bf16 at the same points
and differ by fp32 summation order, so up to two bf16 ulps (2^-6) of the
largest output.
"""
import pytest
import torch

from vlp_tpu_torch.ops import fused_block as FB

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
