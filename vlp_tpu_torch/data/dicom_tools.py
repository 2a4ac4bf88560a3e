"""Offline DICOM tooling: DICOM -> PNG conversion and the x-ray modality
filter (counterpart of ``vlp_tpu/data/dicom_tools.py``; reference
scripts/dicom_to_png.py:22-58 and src/helper_scripts/filter_out_x_rays.py).

``window_to_uint8`` is the windowing to uint8, byte-equal to the JAX
package's. ``convert_dicom_dir`` and ``filter_xray_modality`` need
pydicom and raise with the JAX package's messages where it is not
installed; the PNGs are written by ``data/png.write_png`` (numpy and
``zlib``), where the JAX package uses cv2.

Usage: python -m vlp_tpu_torch.data.dicom_tools <input_dir> <output_dir>
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from vlp_tpu_torch.data.png import write_png
from vlp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def window_to_uint8(pixels: np.ndarray,
                    window_center: Optional[float] = None,
                    window_width: Optional[float] = None,
                    photometric: str = "MONOCHROME2") -> np.ndarray:
    """DICOM windowing -> uint8 grayscale. Without a window, min/max
    scaling (dicom2jpg's default for projection radiographs); MONOCHROME1
    inverts."""
    x = np.asarray(pixels, np.float64)
    if window_center is not None and window_width is not None \
            and window_width > 0:
        lo = window_center - window_width / 2.0
        hi = window_center + window_width / 2.0
    else:
        lo, hi = float(x.min()), float(x.max())
    if hi <= lo:
        out = np.zeros_like(x)
    else:
        out = (np.clip(x, lo, hi) - lo) / (hi - lo) * 255.0
    if photometric == "MONOCHROME1":
        out = 255.0 - out
    return np.rint(out).astype(np.uint8)


def _pydicom(message: str):
    try:
        import pydicom
    except ImportError as e:
        raise RuntimeError(message) from e
    return pydicom


def convert_dicom_dir(input_dir: str, output_dir: str) -> Dict[str, int]:
    """Every readable DICOM under ``input_dir`` as a PNG at the same
    relative path under ``output_dir``; returns ``{'converted': n,
    'failed': m}`` (a file that does not read or convert is counted and
    logged, as the reference does)."""
    pydicom = _pydicom(
        "pydicom is not installed in this image; DICOM conversion is "
        "gated (reference uses dicom2jpg+pydicom offline)")
    os.makedirs(output_dir, exist_ok=True)
    stats = {"converted": 0, "failed": 0}
    for root, _, files in os.walk(input_dir):
        for fname in files:
            path = os.path.join(root, fname)
            try:
                ds = pydicom.dcmread(path)
                wc = getattr(ds, "WindowCenter", None)
                ww = getattr(ds, "WindowWidth", None)
                if isinstance(wc, pydicom.multival.MultiValue):
                    wc, ww = float(wc[0]), float(ww[0])
                img = window_to_uint8(
                    ds.pixel_array,
                    float(wc) if wc is not None else None,
                    float(ww) if ww is not None else None,
                    str(getattr(ds, "PhotometricInterpretation",
                                "MONOCHROME2")))
                rel = os.path.relpath(path, input_dir)
                out = os.path.join(output_dir,
                                   os.path.splitext(rel)[0] + ".png")
                os.makedirs(os.path.dirname(out), exist_ok=True)
                write_png(out, img)
                stats["converted"] += 1
            except Exception as e:  # a corrupt file is counted, not fatal
                logger.warning("failed to convert %s: %s", path, e)
                stats["failed"] += 1
    logger.info("DICOM conversion: %s", stats)
    return stats


def filter_xray_modality(input_dir: str,
                         keep_modalities: Tuple[str, ...] = ("CR",)
                         ) -> Iterable[str]:
    """The paths under ``input_dir`` whose DICOM Modality is in
    ``keep_modalities`` (the reference keeps conventional radiographs,
    ``CR``); files that do not read as DICOM are skipped."""
    pydicom = _pydicom("pydicom is not installed in this image")
    for root, _, files in os.walk(input_dir):
        for fname in files:
            path = os.path.join(root, fname)
            try:
                ds = pydicom.dcmread(path, stop_before_pixels=True)
            except Exception:  # not a DICOM file
                continue
            if str(getattr(ds, "Modality", "")) in keep_modalities:
                yield path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m vlp_tpu_torch.data."
                                "dicom_tools", description=__doc__)
    p.add_argument("input_dir")
    p.add_argument("output_dir")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    convert_dicom_dir(args.input_dir, args.output_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
