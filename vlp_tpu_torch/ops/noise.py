"""Per-sample Gaussian noise, ``x + sigma[b] * N(0, 1)`` (counterpart of
``vlp_tpu/ops/pallas_noise.py``).

The TPU kernel draws its bits from the TPU's hardware PRNG
(``pltpu.prng_random_bits``). Here a Philox4x32-10 stream takes its place,
keyed by the sample's two seed words. Counter layout, for sample ``b`` of an
``[B, H, W]`` batch (``W`` even, ``half = W / 2``):

  word ``w = y * half + x`` (``x < half``) is output ``w mod 4`` of
  Philox4x32-10 at counter ``(w div 4, 0, 0, 0)`` under the key
  ``(seeds[b, 0], seeds[b, 1])`` read as uint32;

and word ``w`` gives one Box-Muller pair: the cos branch lands at
``(y, x)``, the sin branch at ``(y, x + half)``, the TPU kernel's layout.
The stream is deterministic in the seeds but differs from the TPU's and from
threefry (ROADMAP.md Queue 3). A CUDA tensor runs
``csrc/noise.cu`` or raises; a CPU tensor runs ``add_gaussian_noise_plain``,
which computes the same Philox words in int64 torch ops (the 32x32-bit
products in 16-bit limbs, since their 64-bit results overflow int64) so the
kernel can be held to it word for word.
"""
from __future__ import annotations

import torch

from vlp_tpu_torch.ops import _build

_TWO_PI = 6.283185307179586
_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of ``a * b`` for a 32-bit constant ``a`` and
    int64 tensors ``b`` in [0, 2^32), in 16-bit limbs."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll, lh, hl, hh = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_plain(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 (Random123): ``ctr`` [n, 4] and ``key`` [n, 2] int64
    in [0, 2^32) -> [n, 4] int64 words in [0, 2^32)."""
    c = [ctr[:, i] for i in range(4)]
    k0, k1 = key[:, 0], key[:, 1]
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return torch.stack(c, dim=1)


def bits_to_gaussian_pair(bits: torch.Tensor):
    """32-bit words (any integer dtype; only the low 32 bits are read) ->
    two iid N(0, 1) fields by Box-Muller over the two 16-bit halves, the
    formula of ``vlp_tpu/ops/pallas_noise.py:bits_to_gaussian_pair``
    (``+2^-17`` keeps the log finite)."""
    u1 = (bits & 0xFFFF).float() * (2.0 ** -16) + (2.0 ** -17)
    u2 = ((bits >> 16) & 0xFFFF).float() * (2.0 ** -16)
    r = torch.sqrt(-2.0 * torch.log(u1))
    t = _TWO_PI * u2
    return r * torch.cos(t), r * torch.sin(t)


def _check(x: torch.Tensor, seeds: torch.Tensor, sigma: torch.Tensor):
    b, _, w = x.shape
    if w % 2:
        raise ValueError(f"add_gaussian_noise needs an even width, got {w}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"add_gaussian_noise: x {tuple(x.shape)} has 2^31 "
                         "or more elements; the kernel indexes in 32 bits")
    if seeds.shape != (b, 2) or sigma.shape != (b,):
        raise ValueError(f"add_gaussian_noise: seeds must be [{b}, 2] and "
                         f"sigma [{b}], got {tuple(seeds.shape)} and "
                         f"{tuple(sigma.shape)}")


def noise_words_plain(seeds: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The ``h * w / 2`` Philox words of each sample, [B, h, w/2] int64."""
    nwords = h * (w // 2)
    groups = -(-nwords // 4)
    b = seeds.shape[0]
    key = seeds.long() & _M32                                   # [B, 2]
    ctr = torch.zeros(b * groups, 4, dtype=torch.long, device=seeds.device)
    ctr[:, 0] = torch.arange(groups, device=seeds.device).repeat(b)
    words = philox4x32_plain(ctr, key.repeat_interleave(groups, 0))
    return words.reshape(b, groups * 4)[:, :nwords].reshape(b, h, w // 2)


def add_gaussian_noise_plain(x: torch.Tensor, seeds: torch.Tensor,
                             sigma: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``add_gaussian_noise``: the same words as the kernel."""
    _check(x, seeds, sigma)
    _, h, w = x.shape
    zc, zs = bits_to_gaussian_pair(noise_words_plain(seeds, h, w))
    s = sigma.float()[:, None, None]
    return x + s * torch.cat([zc, zs], dim=-1)


def add_gaussian_noise(x: torch.Tensor, seeds: torch.Tensor,
                       sigma: torch.Tensor) -> torch.Tensor:
    """x [B, H, W] fp32 + sigma[b] * N(0, 1); seeds [B, 2] int32 (64 bits
    of seed per sample), sigma [B] fp32 (0 leaves the sample unchanged).
    Even W only (one Box-Muller pair per word)."""
    _check(x, seeds, sigma)
    if x.device.type == "cpu":
        return add_gaussian_noise_plain(x, seeds, sigma)
    if x.device.type != "cuda":
        raise ValueError(f"add_gaussian_noise: no kernel or plain version "
                         f"for device {x.device}")
    if x.dtype != torch.float32 or seeds.dtype != torch.int32 or \
            sigma.dtype != torch.float32:
        raise TypeError("add_gaussian_noise: the CUDA kernel takes fp32 x "
                        "and sigma and int32 seeds")
    for t in (x, seeds, sigma):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("add_gaussian_noise: operands must be "
                             "contiguous and on one device")
    b, h, w = x.shape
    lib = _build.load_library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.vlp_add_gaussian_noise(
            x.data_ptr(), seeds.data_ptr(), sigma.data_ptr(), out.data_ptr(),
            b, h, w, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "add_gaussian_noise")
    add_gaussian_noise.launches += 1
    return out


def philox4x32(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """The kernel's Philox4x32-10 on ``ctr`` [n, 4] and ``key`` [n, 2]
    (int64 in [0, 2^32)); a CUDA tensor runs ``csrc/noise.cu``'s device
    function, so tests can hold it to known-answer vectors and to
    ``philox4x32_plain``. Not a launch of the noise kernel."""
    if ctr.device.type != "cuda":
        return philox4x32_plain(ctr, key)
    c32 = ctr.to(torch.int64).bitwise_and(_M32).to(torch.int32).contiguous()
    k32 = key.to(torch.int64).bitwise_and(_M32).to(torch.int32).contiguous()
    out = torch.empty_like(c32)
    lib = _build.load_library()
    with torch.cuda.device(ctr.device):
        err = lib.vlp_philox4x32(c32.data_ptr(), k32.data_ptr(),
                                 out.data_ptr(), c32.shape[0],
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "philox4x32")
    return out.long() & _M32


add_gaussian_noise.launches = 0
