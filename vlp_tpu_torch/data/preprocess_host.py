"""Deterministic host-side image preprocessing (the port's own copy of the
NumPy path of ``vlp_tpu/data/preprocess_host.py:52-188``).

  decode -> grayscale (ITU-R 601 luma) -> histogram equalisation (MONAI
  ``equalize_hist``, 256 bins) -> optional crop of the larger dimension
  (<= 5%) -> pad to square with the edge averages -> resize (area)
  -> round and clip to uint8

The arithmetic is the reference's ``use_native=False`` path; its C++
``native/`` route is not ported. The reference decodes and resizes with
cv2 (``IMREAD_UNCHANGED``, ``INTER_AREA``) and falls back to PIL; so does
this copy, importing either only inside ``decode_image`` and ``resize``,
so that importing the serving path loads neither. Without both, those two
functions raise ``ImportError``; ``Predictor.predict_arrays`` takes
preprocessed uint8 images and needs no decoder.
"""
from __future__ import annotations

import numpy as np


def _cv2():
    """cv2, or None when it is not installed (PIL is the fallback)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _pil_image():
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError(
            "decoding or resizing an image file needs cv2 (opencv-python) or "
            "PIL (pillow), and neither is installed; "
            "Predictor.predict_arrays takes preprocessed uint8 images "
            "without them") from err
    return Image


def decode_image(path: str) -> np.ndarray:
    """Decode to HWC uint8 (1 or 3 channels; alpha dropped)."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(f"Failed to decode image {path}")
        if img.ndim == 3 and img.shape[2] == 4:
            img = img[:, :, :3]  # DropChanneld(channel 3): strip alpha
        if img.ndim == 3 and img.shape[2] == 3:
            img = img[:, :, ::-1]  # BGR -> RGB
    else:
        pil = _pil_image().open(path)
        if pil.mode == "RGBA":
            pil = pil.convert("RGB")
        img = np.asarray(pil)
    if img.ndim == 2:
        img = img[:, :, None]
    return np.ascontiguousarray(img, dtype=np.uint8)


def to_grayscale(img: np.ndarray) -> np.ndarray:
    """HWC uint8 -> HW float32, luma weights (torchvision Grayscale)."""
    img = img.astype(np.float32)
    if img.shape[2] == 1:
        return img[:, :, 0]
    return img[:, :, 0] * 0.299 + img[:, :, 1] * 0.587 + img[:, :, 2] * 0.114


def equalize_hist(img: np.ndarray, num_bins: int = 256, vmin: float = 0.0,
                  vmax: float = 255.0) -> np.ndarray:
    """MONAI HistogramNormalized semantics: cumulative histogram rescaled to
    [vmin, vmax], pixel values interpolated against bin centers."""
    flat = img.reshape(-1)
    hist, edges = np.histogram(flat, bins=num_bins)
    centers = (edges[:-1] + edges[1:]) / 2.0
    cum = hist.cumsum().astype(np.float64)
    lo, hi = cum.min(), cum.max()
    if hi > lo:
        cum = (cum - lo) / (hi - lo) * (vmax - vmin) + vmin
    else:  # constant image
        cum = np.full_like(cum, vmin)
    return np.interp(flat, centers, cum).reshape(img.shape).astype(np.float32)


def crop_larger_dimension(img: np.ndarray,
                          maximum_crop_ratio: float = 0.05) -> np.ndarray:
    """HW float. Symmetric crop of the larger dim by <= ratio, never past
    square; ``crop // 2`` off both ends."""
    h, w = img.shape
    if h == w:
        return img
    if h > w:
        crop = int(h * maximum_crop_ratio)
        if h - crop < w:
            crop = h - w
        each = crop // 2
        return img[each:h - each, :]
    crop = int(w * maximum_crop_ratio)
    if w - crop < h:
        crop = w - h
    each = crop // 2
    return img[:, each:w - each]


def pad_to_square_edge_average(img: np.ndarray) -> np.ndarray:
    """HW float. Pad the shorter dim to square, each side filled with the
    mean of its nearest edge row or column."""
    h, w = img.shape
    if h == w:
        return img
    diff = abs(h - w)
    if h > w:
        left, right = diff // 2, diff - diff // 2
        lval = float(img[:, 0].mean())
        rval = float(img[:, -1].mean())
        return np.concatenate(
            [np.full((h, left), lval, np.float32), img,
             np.full((h, right), rval, np.float32)], axis=1)
    top, bottom = diff // 2, diff - diff // 2
    tval = float(img[0, :].mean())
    bval = float(img[-1, :].mean())
    return np.concatenate(
        [np.full((top, w), tval, np.float32), img,
         np.full((bottom, w), bval, np.float32)], axis=0)


def resize(img: np.ndarray, size: int) -> np.ndarray:
    if img.shape == (size, size):
        return img
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, (size, size),
                          interpolation=cv2.INTER_AREA).astype(np.float32)
    image = _pil_image()
    return np.asarray(image.fromarray(img).resize((size, size),
                                                  image.BILINEAR),
                      dtype=np.float32)


def preprocess_image(path_or_array, image_size: int = 224,
                     crop: bool = False, maximum_crop_ratio: float = 0.05,
                     equalize: bool = True) -> np.ndarray:
    """The whole deterministic pipeline -> [image_size, image_size] uint8,
    from a path or an HW / HWC uint8 array."""
    if isinstance(path_or_array, str):
        img = decode_image(path_or_array)
    else:
        img = np.asarray(path_or_array)
        if img.ndim == 2:
            img = img[:, :, None]
    gray = to_grayscale(img)
    if equalize:
        gray = equalize_hist(gray)
    if crop:
        gray = crop_larger_dimension(gray, maximum_crop_ratio)
    gray = pad_to_square_edge_average(gray)
    gray = resize(gray, image_size)
    return np.clip(np.rint(gray), 0, 255).astype(np.uint8)
