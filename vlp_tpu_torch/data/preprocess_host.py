"""Deterministic host-side image preprocessing and the image cache (the
port's own copy of ``vlp_tpu/data/preprocess_host.py``).

  decode -> grayscale (ITU-R 601 luma) -> histogram equalisation (MONAI
  ``equalize_hist``, 256 bins) -> optional crop of the larger dimension
  (<= 5%) -> pad to square with the edge averages -> resize (area)
  -> round and clip to uint8

``preprocess_image`` runs the NumPy path by default, as the JAX package's
does, and with ``use_native=True`` the C++ route (``vlp_tpu_torch/native``:
the same source as the JAX package's, so the same bytes; within one uint8
step of the NumPy path, except where an image's gray levels fall on
histogram bin edges, which the C++ route bins upwards and
``np.histogram`` against its float32 edges: there the two routes' caches
differ by a few steps, in both packages). The reference decodes and
resizes with cv2
(``IMREAD_UNCHANGED``, ``INTER_AREA``); so does this copy where cv2 is
installed, importing it only inside ``decode_image`` and ``resize``, so
that importing the serving path loads it not. Without cv2, ``resize``
runs ``resize_area``, cv2's ``INTER_AREA`` written out in numpy with its
float32 operations in cv2's order (bit-equal to cv2 on the square float
images this pipeline resizes, up and down, ``tests/test_torch_port_data.
py``): the machine with the card need not have cv2, and the synthetic
corpora are made there. ``decode_image`` falls back to PIL, then to ``data/png.py``'s
8-bit PNG reader, which gives cv2's pixels and refuses what it cannot
read (a JPEG among them) naming cv2 and PIL; ``decoder()`` says which
route is in use. ``Predictor.predict_arrays`` takes preprocessed uint8
images and needs no decoder.

``ImageCache`` holds a corpus of preprocessed images: in memory
(``from_arrays``, the synthetic corpora) or as the ``imgcache_<key>.npy``
memmap and its JSON under the JAX package's key (the options, the route
and the paths), which ``build`` writes (through ``.tmp.npy`` and a rename)
and ``open`` reads, so either package opens the other's cache;
``fold_mean_std`` gives a fold's scalar mean and std, cached as JSON under
the same key as the JAX package's.
"""
from __future__ import annotations

import json
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from vlp_tpu_torch.data.png import read_png
from vlp_tpu_torch.data.splits import hash_list_of_strings


def _cv2():
    """cv2, or None when it is not installed (PIL is the fallback)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _pil_image():
    """PIL's ``Image``, or None when it is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def decoder() -> str:
    """The route ``decode_image`` takes here: cv2, PIL, or the numpy PNG
    reader."""
    if _cv2() is not None:
        return "cv2"
    return "PIL" if _pil_image() is not None else "png (numpy + zlib)"


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
    elif _pil_image() is not None:
        pil = _pil_image().open(path)
        if pil.mode == "RGBA":
            pil = pil.convert("RGB")
        img = np.asarray(pil)
    else:
        img = read_png(path)
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
    """HW float32 -> [size, size] float32, cv2 ``INTER_AREA``."""
    if img.shape == (size, size):
        return img
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, (size, size),
                          interpolation=cv2.INTER_AREA).astype(np.float32)
    return resize_area(img, size)


def _linear_taps(ssize: int, dsize: int):
    """cv2's coefficients of ``INTER_AREA`` where an axis is enlarged: a
    source index and the weights of it and the next."""
    inv = dsize / ssize
    scale = 1.0 / inv
    sx = np.empty(dsize, np.int64)
    fx = np.empty(dsize, np.float32)
    for dx in range(dsize):
        s = math.floor(dx * scale)
        f = np.float32((dx + 1) - (s + 1) * inv)
        f = np.float32(0) if f <= 0 else np.float32(f - math.floor(f))
        if s < 0:
            f, s = np.float32(0), 0
        if s >= ssize - 1:
            f, s = np.float32(0), ssize - 1
        sx[dx], fx[dx] = s, f
    return sx, np.minimum(sx + 1, ssize - 1), np.float32(1) - fx, fx


def _area_taps(ssize: int, dsize: int):
    """cv2's ``computeResizeAreaTab``: (destination, source, weight) of
    each overlap of a shrunk axis, in cv2's order."""
    scale = 1.0 / (dsize / ssize)
    taps = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            taps.append((dx, sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            taps.append((dx, sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            taps.append((dx, sx2, np.float32(min(fsx2 - sx2, 1.0, cell)
                                             / cell)))
    return taps


def resize_area(img: np.ndarray, size: int) -> np.ndarray:
    """cv2.resize(img, (size, size), interpolation=INTER_AREA) of an HW
    float32 image in numpy: block means where both axes shrink by whole
    factors, overlap-weighted sums where both shrink, else cv2's linear
    taps; float32 sums in cv2's order."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    if h >= size and w >= size:
        if h == w == 2 * size:
            # cv2's 2 x 2 means: 4-wide vectors add the row pairs, the
            # columns past the last whole vector add the four in turn
            a, b = img[0::2, 0::2], img[0::2, 1::2]
            c, d = img[1::2, 0::2], img[1::2, 1::2]
            out = ((a + b) + (c + d)) * np.float32(0.25)
            tail = size // 4 * 4
            out[:, tail:] = (((a + b) + c) + d)[:, tail:] * np.float32(0.25)
            return out
        if h % size == 0 and w % size == 0:
            ky, kx = h // size, w // size
            blocks = img.reshape(size, ky, size, kx).transpose(
                0, 2, 1, 3).reshape(size, size, ky * kx)
            acc = np.zeros((size, size), np.float32)
            n, i = ky * kx, 0
            while i <= n - 4:  # cv2 adds four taps, then the sum
                acc = acc + (blocks[..., i] + blocks[..., i + 1]
                             + blocks[..., i + 2] + blocks[..., i + 3])
                i += 4
            for i in range(i, n):
                acc = acc + blocks[..., i]
            return acc * np.float32(1.0 / n)
        rows = np.zeros((h, size), np.float32)
        for dx, sx, a in _area_taps(w, size):
            rows[:, dx] += img[:, sx] * a
        out = np.zeros((size, size), np.float32)
        acc, prev = None, None
        for dy, sy, b in _area_taps(h, size):
            if dy != prev:
                if prev is not None:
                    out[prev] = acc
                acc, prev = b * rows[sy], dy
            else:
                acc = acc + b * rows[sy]
        out[prev] = acc
        return out
    sx0, sx1, a0, a1 = _linear_taps(w, size)
    sy0, sy1, b0, b1 = _linear_taps(h, size)
    rows = img[:, sx0] * a0 + img[:, sx1] * a1
    return b0[:, None] * rows[sy0] + b1[:, None] * rows[sy1]


def preprocess_image(path_or_array, image_size: int = 224,
                     crop: bool = False, maximum_crop_ratio: float = 0.05,
                     equalize: bool = True, use_native: bool = False
                     ) -> np.ndarray:
    """The whole deterministic pipeline -> [image_size, image_size] uint8,
    from a path or an HW / HWC uint8 array; ``use_native=True`` runs it in
    the C++ library (built at first use; a failed build raises)."""
    if isinstance(path_or_array, str):
        img = decode_image(path_or_array)
    else:
        img = np.asarray(path_or_array)
        if img.ndim == 2:
            img = img[:, :, None]
    if use_native:
        from vlp_tpu_torch.native import preprocess_image_native

        return preprocess_image_native(img, image_size, crop,
                                       maximum_crop_ratio, equalize)
    gray = to_grayscale(img)
    if equalize:
        gray = equalize_hist(gray)
    if crop:
        gray = crop_larger_dimension(gray, maximum_crop_ratio)
    gray = pad_to_square_edge_average(gray)
    gray = resize(gray, image_size)
    return np.clip(np.rint(gray), 0, 255).astype(np.uint8)


def _cache_key(paths: Sequence[str], image_size: int, crop: bool,
               maximum_crop_ratio: float, equalize: bool, native: bool):
    """(options fingerprint, key) of a cache: the JAX package's."""
    opts = (f"size={image_size}|crop={crop}"
            f"|ratio={maximum_crop_ratio}|eq={equalize}")
    return opts, hash_list_of_strings([opts, f"native={bool(native)}"]
                                      + list(paths))


class ImageCache:
    """A [N, S, S] uint8 corpus of deterministically preprocessed images
    (in memory, or the ``.npy`` memmap ``build`` writes), with the image
    paths in its row order and the preprocessing options' fingerprint that
    ``fold_mean_std`` keys on."""

    def __init__(self, data: np.ndarray, paths: Sequence[str],
                 options_key: Optional[str] = None) -> None:
        self.data = data
        self.paths = list(paths)
        self.options_key = options_key or f"size={data.shape[1]}"

    @property
    def image_size(self) -> int:
        return self.data.shape[1]

    def __len__(self) -> int:
        return self.data.shape[0]

    def gather(self, indices: Sequence[int]) -> np.ndarray:
        return self.data[np.asarray(indices, dtype=np.int64)]

    @classmethod
    def build(cls, paths: Sequence[str], cache_dir: str,
              image_size: int = 224, crop: bool = False,
              maximum_crop_ratio: float = 0.05, equalize: bool = True,
              num_workers: int = 0, use_native: bool = True
              ) -> "ImageCache":
        """The cache of these paths under these options in ``cache_dir``:
        opened where it exists (this package's or the JAX package's),
        else each image preprocessed (``use_native``: by the C++ route,
        which is part of the key; on ``num_workers`` threads where > 0)
        into ``imgcache_<key>.tmp.npy``, which is then renamed, and its
        ``.json`` written. One process builds a cache at a time: the ranks
        of a data mesh leave it to rank 0 and ``open`` it after a
        barrier."""
        os.makedirs(cache_dir, exist_ok=True)
        if use_native:
            from vlp_tpu_torch.native import get_lib

            get_lib()  # built once, before any worker thread
        opts, key = _cache_key(paths, image_size, crop, maximum_crop_ratio,
                               equalize, use_native)
        npy = os.path.join(cache_dir, f"imgcache_{key}.npy")
        meta = os.path.join(cache_dir, f"imgcache_{key}.json")
        if os.path.exists(npy) and os.path.exists(meta):
            return cls.open(paths, cache_dir, image_size, crop,
                            maximum_crop_ratio, equalize, use_native)
        n = len(paths)
        arr = np.lib.format.open_memmap(npy + ".tmp.npy", mode="w+",
                                        dtype=np.uint8,
                                        shape=(n, image_size, image_size))

        def work(path):
            return preprocess_image(
                path, image_size=image_size, crop=crop,
                maximum_crop_ratio=maximum_crop_ratio, equalize=equalize,
                use_native=use_native)

        if num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(num_workers) as ex:
                for i, out in enumerate(ex.map(work, paths)):
                    arr[i] = out
        else:
            for i, p in enumerate(paths):
                arr[i] = work(p)
        arr.flush()
        del arr
        os.replace(npy + ".tmp.npy", npy)
        with open(meta, "w") as fh:
            json.dump({"num_images": n, "image_size": image_size,
                       "crop": crop, "equalize": equalize}, fh)
        return cls(np.load(npy, mmap_mode="r"), paths, options_key=opts)

    @classmethod
    def open(cls, paths: Sequence[str], cache_dir: str, image_size: int = 224,
             crop: bool = False, maximum_crop_ratio: float = 0.05,
             equalize: bool = True, native: bool = True) -> "ImageCache":
        """The cache ``build`` (this package's or the JAX package's) wrote
        for these paths and options (``native``: whether it used the C++
        route, which is part of the key) under ``cache_dir``:
        ``imgcache_<key>.npy`` memory-mapped, with its ``.json``. Raises
        ``FileNotFoundError`` where it was not built."""
        opts, key = _cache_key(paths, image_size, crop, maximum_crop_ratio,
                               equalize, native)
        npy = os.path.join(cache_dir, f"imgcache_{key}.npy")
        meta = os.path.join(cache_dir, f"imgcache_{key}.json")
        if not (os.path.exists(npy) and os.path.exists(meta)):
            raise FileNotFoundError(
                f"no image cache {npy} (+ .json) for these {len(paths)} "
                "paths and options")
        with open(meta) as fh:
            info = json.load(fh)
        data = np.load(npy, mmap_mode="r")
        if data.shape != (info["num_images"], image_size, image_size) \
                or len(paths) != info["num_images"]:
            raise ValueError(f"{npy}: shape {data.shape} does not match its "
                             f"metadata {info} and {len(paths)} paths")
        return cls(data, paths, options_key=opts)

    @classmethod
    def from_arrays(cls, images: np.ndarray,
                    paths: Optional[Sequence[str]] = None) -> "ImageCache":
        """In-memory cache (synthetic fixtures / tests)."""
        images = np.asarray(images, dtype=np.uint8)
        if paths is None:
            paths = [f"synthetic://{i}" for i in range(len(images))]
        return cls(images, paths)


def fold_mean_std(cache: ImageCache, indices: Sequence[int],
                  cache_dir: Optional[str] = None) -> Tuple[float, float]:
    """Scalar mean/std over all fold-train images on the raw 0..255 scale
    (reference DownstreamDataModule.py:203-253), exact by streaming fp64
    sums; cached to ``<cache_dir>/<sha256(options, paths)>.json``, the
    JAX package's key and file."""
    idx = [int(i) for i in indices]
    stat_path = None
    if cache_dir is not None:
        key = hash_list_of_strings(
            [cache.options_key] + [cache.paths[i] for i in idx])
        stat_path = os.path.join(cache_dir, f"{key}.json")
        if os.path.exists(stat_path):
            with open(stat_path) as fh:
                d = json.load(fh)
            return float(d["mean"]), float(d["std"])
    total = total_sq = 0.0
    count = 0
    for i in idx:
        x = cache.data[i].astype(np.float64)
        total += x.sum()
        total_sq += (x * x).sum()
        count += x.size
    mean = total / count
    std = float(np.sqrt(max(total_sq / count - mean * mean, 0.0)))
    if stat_path is not None:
        # written whole and renamed: the ranks of a data mesh compute the
        # same file at once and may read it while another writes
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{stat_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump({"mean": mean, "std": std}, fh)
        os.replace(tmp, stat_path)
    return float(mean), std
