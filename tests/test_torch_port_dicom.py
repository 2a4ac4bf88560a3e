"""The port's DICOM tools (``vlp_tpu_torch/data/dicom_tools.py``), its PNG
writer (``data/png.py``) and the k-fold data module's interface
(``data/base.py``) against the JAX package's, on the CPU: the windowing
byte-equal on arrays drawn by numpy from a seed, the PNGs read back by
the port's reader and by cv2, and the refusals where pydicom is not
installed, with the JAX package's messages."""
import cv2
import numpy as np
import pytest

from vlp_tpu.data import dicom_tools as jdicom
from vlp_tpu.data.base import KFoldDataModule as JKFold
from vlp_tpu_torch.data import dicom_tools
from vlp_tpu_torch.data.base import KFoldDataModule
from vlp_tpu_torch.data.datamodule import DownstreamData, PretrainData
from vlp_tpu_torch.data.png import read_png, write_png

try:
    import pydicom  # noqa: F401
    HAVE_PYDICOM = True
except ImportError:
    HAVE_PYDICOM = False


@pytest.mark.parametrize("case", ["minmax", "window", "monochrome1",
                                  "flat", "zero_width", "float"])
def test_window_to_uint8_is_byte_equal_to_jax(case):
    rng = np.random.default_rng(7)
    pixels = rng.integers(-1024, 3072, (37, 53)).astype(np.int16)
    kw = {}
    if case == "window":
        kw = dict(window_center=400.0, window_width=1800.0)
    elif case == "monochrome1":
        kw = dict(window_center=300.0, window_width=900.0,
                  photometric="MONOCHROME1")
    elif case == "flat":
        pixels = np.full((8, 9), 517, np.uint16)
    elif case == "zero_width":
        kw = dict(window_center=10.0, window_width=0.0)
    elif case == "float":
        pixels = rng.normal(100.0, 40.0, (20, 30))
    want = jdicom.window_to_uint8(pixels, **kw)
    got = dicom_tools.window_to_uint8(pixels, **kw)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_writer_reads_back_through_both_decoders(channels, tmp_path):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (23, 41, channels), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img[:, :, 0] if channels == 1 else img)
    cv = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if channels == 1:
        assert np.array_equal(cv, img[:, :, 0])
        assert np.array_equal(read_png(path), img)
    elif channels == 2:  # cv2 reads gray + alpha as BGRA
        assert np.array_equal(cv[:, :, 0], img[:, :, 0])
        assert np.array_equal(read_png(path)[:, :, 0], img[:, :, 0])
    else:
        assert np.array_equal(cv[:, :, :3][:, :, ::-1], img[:, :, :3])
        assert np.array_equal(read_png(path), img[:, :, :3])


def test_windowed_png_round_trip(tmp_path):
    """A window's output written as the converter writes it."""
    pixels = np.random.default_rng(8).integers(0, 4096, (64, 48))
    img = dicom_tools.window_to_uint8(pixels, 2000.0, 3000.0)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    assert np.array_equal(read_png(path)[:, :, 0], img)


@pytest.mark.skipif(HAVE_PYDICOM, reason="pydicom is installed")
def test_without_pydicom_both_tools_raise_the_jax_messages(tmp_path):
    for port, jax_fn, args in (
            (dicom_tools.convert_dicom_dir, jdicom.convert_dicom_dir,
             (str(tmp_path), str(tmp_path / "out"))),
            (lambda d: list(dicom_tools.filter_xray_modality(d)),
             lambda d: list(jdicom.filter_xray_modality(d)),
             (str(tmp_path),))):
        with pytest.raises(RuntimeError) as want:
            jax_fn(*args)
        with pytest.raises(RuntimeError) as got:
            port(*args)
        assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="pydicom"):
        dicom_tools.main([str(tmp_path), str(tmp_path / "out")])


def test_data_modules_are_kfold_data_modules():
    assert issubclass(DownstreamData, KFoldDataModule)
    assert issubclass(PretrainData, KFoldDataModule)
    assert KFoldDataModule.__abstractmethods__ == JKFold.__abstractmethods__
    with pytest.raises(TypeError):
        KFoldDataModule()
