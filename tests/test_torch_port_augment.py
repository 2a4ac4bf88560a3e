"""The port's augmentation (``vlp_tpu_torch.ops.{shear,warp,noise,augment}``)
against the JAX package on the CPU, Pallas in interpret mode.

Tolerances:
- ``shear_rows``: 1e-4 on values up to 255 (about 8 fp32 ulps there). Both
  compute the same fp32 shift, floor and lerp; XLA may contract the lerp's
  multiply-add into an FMA where PyTorch rounds each step.
- The 3-shear warp: 1e-3. As above per pass, plus the zoom product summed in
  another order by XLA's einsum than by two torch matmuls.
- The gather warp: 5e-3. The inverse map's sin/cos/tan differ by an ulp
  between XLA and PyTorch, which moves a sample point by ~1e-5 pixels, on
  intensity slopes of up to 255 per pixel.
- Box-Muller: 2e-6 absolute on |z| <= 4.8 (log, sqrt, cos and sin each
  within an ulp or two of each other in the two libraries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.ops import augment as JA
from vlp_tpu.ops import pallas_noise as JN
from vlp_tpu.ops import pallas_shear as JS
from vlp_tpu.ops import warp as JW
from vlp_tpu_torch.ops import augment as TA
from vlp_tpu_torch.ops import noise as TN
from vlp_tpu_torch.ops import shear as TS
from vlp_tpu_torch.ops import warp as TW


def _images(seed, b, h, w):
    return np.random.default_rng(seed).integers(
        0, 256, (b, h, w)).astype(np.float32)


@pytest.mark.parametrize("b,h,w,max_shift", [
    (3, 16, 24, 9), (2, 64, 64, 26),
    # W % 4 in {1, 2, 3}: the widths the CUDA row kernel takes 4 bytes at a
    # time; max_shift >= W: taps reach past both ends of the line
    (2, 9, 29, 7), (2, 11, 30, 7), (3, 8, 31, 12), (2, 10, 20, 24),
    (2, 6, 13, 13)])
def test_shear_rows_plain_matches_jax_kernel(b, h, w, max_shift):
    img = _images(b + h, b, h, w)
    rng = np.random.default_rng(w)
    # beyond +-max_shift too: the clip is part of the op
    shift = (rng.standard_normal((b, h)) * max_shift * 0.8).astype(
        np.float32)
    want = np.asarray(JS.shear_axis1_batched(
        jnp.asarray(img), jnp.asarray(shift), max_shift, interpret=True))
    got = TS.shear_rows_plain(torch.from_numpy(img), torch.from_numpy(shift),
                              max_shift)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # a CPU tensor routes the public wrapper to the plain version
    assert torch.equal(TS.shear_rows(torch.from_numpy(img),
                                     torch.from_numpy(shift), max_shift), got)


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("b,h,w,max_shift", [(2, 7, 30, 9), (2, 13, 225, 20),
                                             (1, 5, 6, 8)])
def test_shear_rows_plain_matches_jax_at_edge_shifts(b, h, w, max_shift,
                                                     axis):
    """Shifts of exactly +-max_shift and integral ones (fraction 0), along
    rows and (against the JAX kernel on the transpose) along columns."""
    img = _images(b * w + axis, b, h, w)
    n = h if axis == 1 else w
    shift = np.random.default_rng(n).integers(
        -max_shift, max_shift + 1, (b, n)).astype(np.float32)
    shift[:, 0::3], shift[:, 1::3] = max_shift, -max_shift
    rows = img if axis == 1 else np.ascontiguousarray(img.transpose(0, 2, 1))
    want = np.asarray(JS.shear_axis1_batched(
        jnp.asarray(rows), jnp.asarray(shift), max_shift, interpret=True))
    if axis == 0:
        want = want.transpose(0, 2, 1)
    got = TS.shear_rows_plain(torch.from_numpy(img), torch.from_numpy(shift),
                              max_shift, axis)
    # fraction 0: each output is one tap times 1 plus the next times 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_shear_columns_equal_rows_of_the_transpose():
    img = torch.from_numpy(_images(1, 2, 12, 20))
    shift = torch.linspace(-9.0, 9.0, 40).reshape(2, 20)
    cols = TS.shear_rows(img, shift, 8, axis=0)
    rows = TS.shear_rows(img.transpose(1, 2).contiguous(), shift, 8, axis=1)
    assert torch.equal(cols, rows.transpose(1, 2))
    with pytest.raises(ValueError, match="along axis 1"):
        TS.shear_rows(img, shift, 8, axis=1)


def _warp_params(b, seed):
    rng = np.random.default_rng(seed)
    return [np.asarray(v, np.float32) for v in (
        rng.uniform(-np.pi / 6, np.pi / 6, b),   # theta
        rng.uniform(1.0, 1.3, b),                # zoom
        rng.uniform(-20, 20, b),                 # tx
        rng.uniform(-20, 20, b),                 # ty
        rng.uniform(-0.08, 0.08, b))]            # shear (rad)


def test_affine_warp_shear_matches_jax():
    img = _images(4, 3, 64, 64)
    params = _warp_params(3, 5)
    want = np.asarray(JW.affine_warp_shear(jnp.asarray(img),
                                           *map(jnp.asarray, params)))
    got = TW.affine_warp_shear(torch.from_numpy(img),
                               *map(torch.from_numpy, params))
    assert got.shape == (3, 64, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_zoom_matrix_matches_jax():
    zoom = np.asarray([1.0, 1.17, 1.3], np.float32)
    want = np.stack([np.asarray(JW._zoom_matrix(64, jnp.float32(z)))
                     for z in zoom])
    got = TW._zoom_matrix(64, torch.from_numpy(zoom))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_gather_warp_matches_jax():
    img = _images(6, 3, 64, 64)
    theta, zoom, tx, ty, shear = _warp_params(3, 7)
    want = np.asarray(jax.vmap(JA._warp_one)(
        jnp.asarray(img), *map(jnp.asarray, (tx, ty, theta, zoom, shear))))
    got = TA._warp_one(torch.from_numpy(img),
                       *map(torch.from_numpy, (tx, ty, theta, zoom, shear)))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=0)


def test_bits_to_gaussian_pair_matches_jax():
    words = np.random.default_rng(8).integers(
        0, 2 ** 32, 50000, dtype=np.uint64)
    words = np.concatenate([words, [0, 0xFFFF, 0xFFFF0000, 0xFFFFFFFF]])
    jc, js = JN.bits_to_gaussian_pair(jnp.asarray(
        words.astype(np.uint32).view(np.int32)))
    tc, ts = TN.bits_to_gaussian_pair(torch.from_numpy(
        words.astype(np.int64)))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6, rtol=0)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0), "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    out = TN.philox4x32_plain(torch.tensor([ctr], dtype=torch.long),
                              torch.tensor([key], dtype=torch.long))
    assert " ".join(f"{int(v):08x}" for v in out[0]) == want


def test_noise_layout_identity_and_moments():
    b, h, w = 3, 32, 48
    x = torch.from_numpy(_images(9, b, h, w))
    seeds = torch.tensor([[1, 2], [1, 2], [-5, 7]], dtype=torch.int32)
    sigma = torch.tensor([0.0, 1.0, 1.0])
    out = TN.add_gaussian_noise(x, seeds, sigma)
    assert torch.equal(out[0], x[0])                 # sigma 0: identity
    # sample 1's noise is the Box-Muller pair of its words, cos | sin
    words = TN.noise_words_plain(seeds, h, w)
    zc, zs = TN.bits_to_gaussian_pair(words[1])
    assert torch.equal(out[1], x[1] + torch.cat([zc, zs], -1))
    # word w = y * (W/2) + x is output w mod 4 at counter w div 4
    flat = words[2].reshape(-1)
    ctr = torch.tensor([[5, 0, 0, 0]], dtype=torch.long)
    key = torch.tensor([[(-5) & 0xFFFFFFFF, 7]], dtype=torch.long)
    assert torch.equal(flat[20:24], TN.philox4x32_plain(ctr, key)[0])
    # deterministic in the seeds, and other seeds give another field
    assert torch.equal(TN.add_gaussian_noise(x, seeds, sigma), out)
    z = (out[2] - x[2]).reshape(-1)
    assert not torch.equal(z, (out[1] - x[1]).reshape(-1))
    zz = torch.cat([zc, zs], -1).reshape(-1).double()
    # 768 draws: mean within 4 standard errors, variance within 20%
    assert abs(zz.mean()) < 4 / np.sqrt(zz.numel())
    assert abs(zz.var() - 1) < 0.2
    with pytest.raises(ValueError, match="even width"):
        TN.add_gaussian_noise(x[:, :, :47].contiguous(), seeds, sigma)


@pytest.mark.parametrize("b,h,w", [(2, 16, 226), (2, 7, 30), (3, 4, 6),
                                   (1, 3, 10)])
def test_noise_plain_placement_matches_jax_pairs(b, h, w):
    """At W/2 % 4 != 0 (113, 15, 3, 5 words a row, so a Philox call's four
    words cross rows) the plain version puts word (y, x)'s pair, by JAX's
    ``bits_to_gaussian_pair`` on the same words, at (y, x) and (y, x +
    W/2). Bound 2^-13 as on the card: the pairs within 2e-6 of each other
    and one rounding of x + z at |x| < 256."""
    x = torch.from_numpy(_images(w, b, h, w))
    seeds = torch.from_numpy(np.random.default_rng(h).integers(
        -2 ** 31, 2 ** 31, (b, 2)).astype(np.int32))
    sigma = torch.tensor([1.0, 0.5, 2.0][:b])
    words = TN.noise_words_plain(seeds, h, w)
    half = w // 2
    # the counter layout across a row's end: words 4g..4g+3 are the four
    # outputs of counter g, wherever the rows break
    flat = words.reshape(b, -1)
    g = half // 4 + 1 if half > 4 else 1
    key = (seeds.long() & 0xFFFFFFFF)[:1]
    ctr = torch.tensor([[g, 0, 0, 0]], dtype=torch.long)
    assert torch.equal(flat[0, 4 * g:4 * g + 4],
                       TN.philox4x32_plain(ctr, key)[0][:flat.shape[1]
                                                        - 4 * g])
    zc, zs = JN.bits_to_gaussian_pair(jnp.asarray(
        words.numpy().astype(np.uint32).view(np.int32)))
    z = np.concatenate([np.asarray(zc), np.asarray(zs)], axis=-1)
    want = x.numpy() + sigma.numpy()[:, None, None] * z
    got = TN.add_gaussian_noise_plain(x, seeds, sigma)
    np.testing.assert_allclose(got.numpy(), want, atol=2.0 ** -13, rtol=0)


def _refuse_allocation(monkeypatch, module):
    def refuse(*a, **k):
        raise AssertionError("allocated or loaded")

    for name in ("empty", "empty_like"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(module._build, "load_library", refuse)


@pytest.mark.parametrize("axis", [1, 0])
def test_shear_refuses_2_31_elements_before_any_allocation(monkeypatch,
                                                           axis):
    """B * H * W >= 2^31 is refused on any device before a tensor is made
    or the library loaded (the kernel indexes in 32 bits): meta tensors,
    and a CPU view of one element that the plain version would otherwise
    take; one column fewer passes that check and meets the device's."""
    img = torch.zeros(2048, 1024, 1024, device="meta")
    shift = torch.zeros(2048, 1024, device="meta")
    view = torch.zeros(1, 1, 1).expand(2048, 1024, 1024)
    cpu_shift = torch.zeros(1, 1).expand(2048, 1024)
    smaller = torch.zeros(2048, 1024, 1023, device="meta")
    small_shift = shift[:, :1024 if axis else 1023]
    _refuse_allocation(monkeypatch, TS)
    before = TS.shear_rows.launches
    for im, sh in ((img, shift), (view, cpu_shift)):
        with pytest.raises(ValueError, match="2\\^31"):
            TS.shear_rows(im, sh, 8, axis)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        TS.shear_rows(smaller, small_shift, 8, axis)
    assert TS.shear_rows.launches == before


def test_noise_refuses_2_31_elements_before_any_allocation(monkeypatch):
    seeds = torch.zeros(2048, 2, dtype=torch.int32, device="meta")
    sigma = torch.zeros(2048, device="meta")
    big = torch.zeros(2048, 1024, 1024, device="meta")
    smaller = torch.zeros(2048, 1024, 1022, device="meta")
    _refuse_allocation(monkeypatch, TN)
    before = TN.add_gaussian_noise.launches
    with pytest.raises(ValueError, match="2\\^31"):
        TN.add_gaussian_noise(big, seeds, sigma)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        TN.add_gaussian_noise(smaller, seeds, sigma)
    assert TN.add_gaussian_noise.launches == before


def test_augmentation_wrappers_count_no_launch_off_the_card():
    """A CPU tensor runs the plain version and counts no launch; a device
    with neither a kernel nor a plain version raises."""
    img = torch.zeros(2, 8, 12)
    before = (TS.shear_rows.launches, TN.add_gaussian_noise.launches)
    TS.shear_rows(img, torch.zeros(2, 8), 4, 1)
    TN.add_gaussian_noise(img, torch.zeros(2, 2, dtype=torch.int32),
                          torch.ones(2))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        TS.shear_rows(img.to("meta"), torch.zeros(2, 12, device="meta"), 4,
                      0)
    assert (TS.shear_rows.launches,
            TN.add_gaussian_noise.launches) == before


def test_sample_params_rates_ranges_and_shear_on_translate():
    cfg = TA.AugmentConfig(shear_deg=5.0)
    gen = torch.Generator().manual_seed(0)
    n = 20000
    tx, ty, theta, zoom, shear, flip, noise_std = TA._sample_params(
        gen, cfg, n, "cpu")
    fired = tx != 0
    # Bernoulli rates within 4 standard errors of p
    for on, p in ((fired, 0.3), (theta != 0, 0.3), (zoom != 1, 0.3),
                  (flip, 0.3), (noise_std > 0, 0.5)):
        assert abs(on.float().mean().item() - p) < 4 * np.sqrt(p * (1 - p)
                                                               / n)
    assert torch.equal(fired, ty != 0)
    assert torch.equal(fired, shear != 0)            # one RandAffined draw
    assert tx.abs().max() <= 20 and ty.abs().max() <= 20
    assert theta.abs().max() <= np.pi / 6
    assert zoom.min() >= 1.0 and zoom.max() <= 1.3
    assert zoom[zoom != 1].min() >= 1.1
    assert shear.abs().max() <= 5 * np.pi / 180
    assert noise_std.max() <= 0.01
    # the magnitude does not depend on the gate: fired draws span the range
    assert tx[fired].abs().max() > 19 and tx[fired].abs().min() < 1
    # no shear without shear_deg
    gen.manual_seed(0)
    assert (TA._sample_params(gen, TA.AugmentConfig(), n, "cpu")[4]
            == 0).all()


def test_disabled_augmentation_is_normalize_only():
    imgs = torch.from_numpy(_images(10, 4, 16, 16).astype(np.uint8))
    cfg = TA.AugmentConfig(enabled=False)
    got = TA.augment_and_normalize(imgs, torch.Generator(), 120.0, 50.0,
                                   cfg, dtype=torch.float32)
    want = TA.normalize_only(imgs, 120.0, 50.0, dtype=torch.float32)
    assert torch.equal(got, want) and got.shape == (4, 16, 16, 3)


@pytest.mark.parametrize("method", ["shear", "gather"])
def test_augment_with_explicit_params_matches_jax(monkeypatch, method):
    """Same parameters on both sides and sigma 0: the deterministic part of
    the pipeline (warp, flip, normalise, channel repeat) agrees. For
    ``gather`` the port's pipeline runs its plain reference ``_warp_one`` in
    place of the 3-shear warp, against JAX's gather method."""
    b = 4
    imgs = _images(11, b, 64, 64).astype(np.uint8)
    theta, zoom, tx, ty, shear = _warp_params(b, 12)
    flip = np.asarray([True, False, True, False])
    sigma = np.zeros(b, np.float32)
    params = (tx, ty, theta, zoom, shear, flip, sigma)
    monkeypatch.setattr(JA, "_sample_params",
                        lambda *a: tuple(map(jnp.asarray, params)))
    monkeypatch.setattr(TA, "_sample_params",
                        lambda *a: tuple(map(torch.from_numpy, params)))
    if method == "gather":
        monkeypatch.setattr(
            TA, "affine_warp_shear",
            lambda x, theta, zoom, tx, ty, shear: TA._warp_one(
                x, tx, ty, theta, zoom, shear))
    JA.augment_and_normalize.clear_cache()
    try:
        want = np.asarray(JA.augment_and_normalize(
            jnp.asarray(imgs), jax.random.key(0), jnp.float32(120.0),
            jnp.float32(50.0), JA.AugmentConfig(method=method, shear_deg=5.0),
            dtype=jnp.float32))
    finally:
        JA.augment_and_normalize.clear_cache()
    got = TA.augment_and_normalize(
        torch.from_numpy(imgs), torch.Generator().manual_seed(0), 120.0,
        50.0, TA.AugmentConfig(shear_deg=5.0), dtype=torch.float32)
    assert got.shape == want.shape == (b, 64, 64, 3)
    # the warp's bound in intensity units, divided by std 50
    atol = {"shear": 1e-3, "gather": 5e-3}[method] / 50
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def _identity_params(b, sigma):
    zero = torch.zeros(b)
    return (zero, zero, zero, zero + 1.0, zero, torch.zeros(b, dtype=bool),
            torch.as_tensor(sigma, dtype=torch.float32))


def test_odd_width_takes_the_dense_draw_with_the_given_sigma(monkeypatch):
    """At an odd width the kernel (which pairs columns) is never called: the
    reference's dense normal draw is added, ``noise_std`` per sample. With
    the warp the identity, the noise is the difference from sigma 0, whose
    draw adds exactly 0. Square, as an odd ``data.image_size`` gives (the
    zoom, here and in the reference, takes square images)."""
    b, h, w = 8, 35, 35
    imgs = torch.from_numpy(_images(12, b, h, w).astype(np.uint8))

    def refuse(*a, **k):
        raise AssertionError("add_gaussian_noise called at an odd width")

    monkeypatch.setattr(TA, "add_gaussian_noise", refuse)
    sigma = np.array([0.0, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 3.0], np.float32)
    out = {}
    for key, s in (("noisy", sigma), ("clean", np.zeros(b, np.float32))):
        monkeypatch.setattr(TA, "_sample_params",
                            lambda *a, s=s: _identity_params(b, s))
        before = TN.add_gaussian_noise.launches
        out[key] = TA.augment_and_normalize(
            imgs, torch.Generator().manual_seed(0), 0.0, 1.0,
            out_channels=1, dtype=torch.float32)[..., 0]
        assert TN.add_gaussian_noise.launches == before
        assert out[key].shape == (b, h, w)
    noise = (out["noisy"] - out["clean"]).reshape(b, -1).double()
    assert torch.equal(noise[0], torch.zeros_like(noise[0]))
    n = h * w
    for i in range(1, b):
        # mean within 5 standard errors; the standard deviation within
        # 5 of its standard errors (sigma / sqrt(2 n)), about 10%
        assert abs(noise[i].mean().item()) <= 5 * sigma[i] / n ** 0.5
        assert noise[i].std().item() == pytest.approx(
            sigma[i], rel=5 / (2 * n) ** 0.5)


def test_even_width_still_takes_the_noise_kernel(monkeypatch):
    b = 3
    imgs = torch.from_numpy(_images(13, b, 34, 34).astype(np.uint8))
    calls = []

    def record(x, seeds, sigma):
        calls.append((tuple(x.shape), tuple(seeds.shape)))
        return TN.add_gaussian_noise(x, seeds, sigma)

    monkeypatch.setattr(TA, "add_gaussian_noise", record)
    monkeypatch.setattr(TA, "_sample_params",
                        lambda *a: _identity_params(b, [1.0, 0.0, 2.0]))
    got = TA.augment_and_normalize(imgs, torch.Generator().manual_seed(0),
                                   0.0, 1.0, dtype=torch.float32)
    assert calls == [((b, 34, 34), (b, 2))]
    assert got.shape == (b, 34, 34, 3) and bool(torch.isfinite(got).all())


def test_augment_probe_runs_every_case_on_the_cpu(monkeypatch):
    """``probes/augment_probe.py``'s control flow at batch 2 on a 32-pixel
    image (the plain versions, ``F.grid_sample`` and ``torch.normal``, one
    call each in place of the card's timing): every case with its times,
    host time, bound and shares; the grid_sample yardstick computes the
    shear's function (within 1e-2 on values up to 255)."""
    from vlp_tpu_torch.probes import augment_probe as AP

    def one_call_each(**fns):
        return {k: float(fn() is not None) for k, fn in fns.items()}

    for name in ("in_turns", "device_in_turns", "cold_in_turns"):
        monkeypatch.setattr(AP, name, one_call_each)
    before = (TS.shear_rows.launches, TN.add_gaussian_noise.launches)
    records = AP.run((2,), device="cpu", size=32)
    assert (TS.shear_rows.launches,
            TN.add_gaussian_noise.launches) == before
    assert [r["case"] for r in records] == [
        "shear_ax1_ramp", "shear_ax0_ramp", "shear_ax1_random",
        "shear_ax0_random", "noise"]
    for rec in records:
        assert rec["shape"] == [2, 32, 32] and rec["max_abs_err"] == 0.0
        for who in ("kernel", "library"):
            for how in ("event", "warm", "cold"):
                assert rec[f"{who}_{how}_ms"] == 1.0
        assert rec["host_ms"] == 0.0
        lines = 2 * 32 if rec["case"] != "noise" else 0
        extra = 4 * lines if lines else 12 * 2
        assert rec["bytes"] == 8 * 2 * 32 * 32 + extra
        assert rec["bound_ms"] == pytest.approx(rec["bytes"] / 3.35e9)
        assert rec["kernel_share_cold"] == rec["bound_ms"]
        if rec["case"] == "noise":
            assert rec["library_max_abs_err"] is None
        else:
            assert rec["library_max_abs_err"] < 1e-2


def test_augment_probe_warp_shifts_are_the_warps_ramps():
    """The probe's ramp cases are ``shear_shifts`` of draws over the
    augmentation's ranges: |rows' slope| <= tan(15 deg) + tan(5 deg),
    |columns' slope| <= sin(30 deg)."""
    from vlp_tpu_torch.probes import augment_probe as AP
    gen = torch.Generator().manual_seed(0)
    theta, tx, ty, shear = AP.warp_params(256, gen)
    assert theta.abs().max() <= np.pi / 6 and tx.abs().max() <= 20
    s1, s2, s3 = TW.shear_shifts(theta, tx, ty, shear, 224, 224)
    assert s1.shape == s3.shape == s2.shape == (256, 224)
    slope = lambda s: (s[:, 1:] - s[:, :-1]).abs().max().item()  # noqa: E731
    assert slope(s2) <= 0.5 + 1e-5
    assert slope(s1) <= np.tan(np.pi / 12) + np.tan(np.pi / 36) + 1e-5
    assert slope(s3) <= np.tan(np.pi / 12) + 1e-5


def test_augment_probe_and_ab_script_need_a_card(monkeypatch):
    """The probe and ``scripts/ab_augment.py`` exit with code 2 without a
    CUDA device; in the parent's turns the A/B script takes only
    ``vlp_shear_rows`` and ``vlp_add_gaussian_noise`` from the parent's
    library."""
    import importlib.util
    from pathlib import Path
    from vlp_tpu_torch.probes import augment_probe as AP
    path = Path(__file__).resolve().parents[1] / "scripts" / "ab_augment.py"
    spec = importlib.util.spec_from_file_location("ab_augment", path)
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    own = type("Own", (), {"vlp_shear_rows": "own shear",
                           "vlp_add_gaussian_noise": "own noise",
                           "vlp_error_string": "own errors"})()
    other = type("Other", (), {"vlp_shear_rows": "parent shear",
                               "vlp_add_gaussian_noise": "parent noise"})()
    mixed = ab._Library(ab._Mixed(own, other, ab.PARENT_ENTRY_POINTS))
    lib = mixed.load_library()
    assert lib.vlp_shear_rows == "parent shear"
    assert lib.vlp_add_gaussian_noise == "parent noise"
    assert lib.vlp_error_string == "own errors"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((AP.main, []), (ab.main, ["--parent", "."])):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2


def test_variant_script_builds_on_the_shipped_sources(monkeypatch):
    """``scripts/augment_variants.py`` compiles the shipped ``shear.cu`` and
    ``noise.cu`` into its library (variant 0 of each family is the shipped
    kernel) and, like the probes, exits with code 2 without a CUDA
    device."""
    import importlib.util
    from pathlib import Path
    path = (Path(__file__).resolve().parents[1] / "scripts"
            / "augment_variants.py")
    spec = importlib.util.spec_from_file_location("augment_variants", path)
    av = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(av)
    assert '#include "shear.cu"' in av.SOURCE
    assert '#include "noise.cu"' in av.SOURCE
    assert "return vlp_shear_rows(" in av.SOURCE
    assert "return vlp_add_gaussian_noise(" in av.SOURCE
    assert (av.ROWS[0], av.COLS[0], av.NOISE[0]) == ("r1w8", "w8u4", "p1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        av.main([])
    assert exc.value.code == 2
