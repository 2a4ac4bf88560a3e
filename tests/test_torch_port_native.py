"""The port's C++ preprocessing route (``vlp_tpu_torch/native``) against the
JAX package's library (``vlp_tpu.native``) and the NumPy path, on the CPU.

The two libraries are built from the same source under the same flags, so
their outputs are byte-equal (exact). The C++ route is within one uint8
step of the NumPy path without equalisation, and with it where no gray
level lies on a histogram bin edge (the reference's parity); where levels
do, the routes bin them apart, in both packages alike, and differ by at
most ``chip_smoke_data.bin_edge_bound``. A failed build raises with the
compiler's output, and the library's name follows its source.
"""
import os
import stat

import numpy as np
import pytest

from vlp_tpu.data import preprocess_host as jph
from vlp_tpu.native import preprocess_batch_native as jbatch
from vlp_tpu.native import preprocess_image_native as jimage
from vlp_tpu_torch import native
from vlp_tpu_torch.data import preprocess_host

# (h, w, channels, out_size): tall, wide, square; shrinking and enlarging
SHAPES = [(37, 50, 1, 32), (300, 200, 3, 224), (130, 260, 1, 64),
          (96, 96, 3, 96), (20, 14, 1, 48), (513, 257, 3, 224)]


def _image(rng, h, w, c):
    """Gray levels over the whole 0-255 range: no level on a bin edge."""
    smooth = np.add.outer(np.arange(h), np.arange(w))[..., None] % 256
    return ((smooth + rng.integers(0, 40, (h, w, c))) % 256).astype(np.uint8)


@pytest.mark.parametrize("crop", [False, True])
@pytest.mark.parametrize("equalize", [False, True])
def test_library_is_byte_equal_to_the_jax_packages(crop, equalize):
    rng = np.random.default_rng(int(crop) * 2 + int(equalize))
    for h, w, c, s in SHAPES:
        img = _image(rng, h, w, c)
        ours = native.preprocess_image_native(img, s, crop, 0.05, equalize)
        theirs = jimage(img, s, crop, 0.05, equalize)
        assert ours.dtype == np.uint8 and ours.shape == (s, s)
        assert np.array_equal(ours, theirs), (h, w, c, s)
    # a constant image, and an HW array
    flat = np.full((40, 30), 77, np.uint8)
    assert np.array_equal(native.preprocess_image_native(flat, 16, crop, 0.05,
                                                         equalize),
                          jimage(flat, 16, crop, 0.05, equalize))


def test_batch_route_is_the_image_route_and_the_jax_packages():
    rng = np.random.default_rng(7)
    imgs = np.stack([_image(rng, 60, 44, 3) for _ in range(5)])
    ours = native.preprocess_batch_native(imgs, 32, crop=True,
                                          num_threads=3)
    assert np.array_equal(ours, jbatch(imgs, 32, crop=True, num_threads=3))
    for i in range(5):
        assert np.array_equal(ours[i], native.preprocess_image_native(
            imgs[i], 32, crop=True))
    # two channels would make the C++ read past the image
    with pytest.raises(ValueError, match="1, 3 or 4 channels"):
        native.preprocess_image_native(imgs[0, :, :, :2])
    with pytest.raises(ValueError, match="1, 3 or 4 channels"):
        native.preprocess_batch_native(imgs[..., :2])


@pytest.mark.parametrize("crop", [False, True])
def test_native_route_is_within_one_step_of_the_numpy_path(crop):
    rng = np.random.default_rng(11 + crop)
    for h, w, c, s in SHAPES:
        img = _image(rng, h, w, c)
        fast = preprocess_host.preprocess_image(img, s, crop=crop,
                                                use_native=True)
        plain = preprocess_host.preprocess_image(img, s, crop=crop)
        assert np.abs(fast.astype(int) - plain.astype(int)).max() <= 1
        assert np.array_equal(fast, jph.preprocess_image(
            img, s, crop=crop, use_native=True))


def _isolated(monkeypatch, tmp_path, cxx):
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.get_lib.cache_clear()


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch,
                                                         tmp_path):
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'preprocess.cpp:1: error: broken' >&2\n"
                    "exit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    try:
        _isolated(monkeypatch, tmp_path, fake)
        with pytest.raises(RuntimeError, match="(?s)exit code 3.*broken"):
            native.get_lib()
        # no quiet fallback: the cache build raises too
        with pytest.raises(RuntimeError, match="broken"):
            preprocess_host.ImageCache.build(["x.png"], str(tmp_path / "c"))
        assert not list((tmp_path / "build").glob("*.so"))
        _isolated(monkeypatch, tmp_path, tmp_path / "no-such-compiler")
        with pytest.raises(RuntimeError, match="not found"):
            native.get_lib()
    finally:
        native.get_lib.cache_clear()


def test_library_name_follows_the_source_and_builds_once(monkeypatch,
                                                         tmp_path):
    src = tmp_path / "preprocess.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    cxx = native.find_cxx()
    first = native.library_path(cxx)
    assert first.parent == tmp_path / "build"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert native.library_path(cxx) != first
    built = native.build()
    mtime = os.stat(built).st_mtime_ns
    assert native.build() == built and os.stat(built).st_mtime_ns == mtime


def test_equalised_routes_differ_where_the_bins_differ_in_both_packages():
    """Where an image's gray levels fall on histogram bin edges, the C++
    route (the JAX package's binning) and ``np.histogram`` bin them apart,
    and the two routes differ by more than one step: the same in both
    packages, and within ``chip_smoke_data.bin_edge_bound``."""
    import chip_smoke_data

    rng = np.random.default_rng(0)
    widest = 0
    for i in range(40):
        h, w = (int(v) for v in rng.integers(200, 400, 2))
        img = chip_smoke_data.radiograph(rng, h, w, 1)
        fast = native.preprocess_image_native(img, 64)
        plain = preprocess_host.preprocess_image(img, 64)
        assert np.array_equal(fast, jimage(img, 64))
        assert np.array_equal(plain, jph.preprocess_image(img, 64))
        gap = int(np.abs(fast.astype(int) - plain.astype(int)).max())
        assert gap <= chip_smoke_data.bin_edge_bound(
            preprocess_host.to_grayscale(img))
        # without equalisation the routes stay within one step
        assert np.abs(native.preprocess_image_native(img, 64,
                                                     equalize=False)
                      .astype(int) - preprocess_host.preprocess_image(
                          img, 64, equalize=False)).max() <= 1
        widest = max(widest, gap)
    assert widest > 1
