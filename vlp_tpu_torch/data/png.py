"""An 8-bit PNG reader and writer in numpy and ``zlib``: the image decoder
where neither cv2 nor PIL is installed (the machine with the card need not
have them), and the writer of the DICOM tools' PNGs and of test corpora.

It reads non-interlaced 8-bit gray, gray + alpha, RGB and RGBA PNGs, all
five row filters, and gives what ``cv2.imread(path, IMREAD_UNCHANGED)``
gives after the JAX package's ``decode_image`` has dropped the alpha and
turned BGR into RGB: gray as [H, W, 1], gray + alpha as [H, W, 3] (cv2
reads it as BGRA, the gray in each colour), RGB and RGBA as [H, W, 3]. It
refuses every other PNG (16-bit, fewer bits, palette, interlaced) and
every file that is not a PNG, naming the decoders that read them. Like
cv2 it ignores a transparent colour (``tRNS``: its alpha is dropped) and
a truecolour image's suggested palette. ``write_png`` writes 8-bit gray,
gray + alpha, RGB and RGBA, every row with filter 0 (none).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class PNGError(ValueError):
    pass


def _refuse(path: str, what: str) -> PNGError:
    return PNGError(f"{path}: {what}; the numpy PNG reader takes 8-bit "
                    "gray, gray + alpha, RGB and RGBA PNGs without "
                    "interlacing: install cv2 (opencv-python) or PIL (pillow)"
                    " to decode it")


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise _refuse(path, "a truncated chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise _refuse(path, "no IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The rows of ``raw`` ([h, 1 + stride]: a filter byte, then the row)
    with their filters undone."""
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the row above row 1
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:]
        up = out[y]
        if kind == 0:
            row = line
        elif kind == 1:  # Sub: a running sum along each channel, mod 256
            row = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            row = line + up
        elif kind in (3, 4):  # Average, Paeth: left to right in Python
            vals, prev = line.tolist(), up.tolist()
            for x in range(stride):
                a = vals[x - bpp] if x >= bpp else 0
                if kind == 3:
                    p = (a + prev[x]) >> 1
                else:
                    p = _paeth(a, prev[x], prev[x - bpp] if x >= bpp else 0)
                vals[x] = (vals[x] + p) & 0xFF
            row = np.asarray(vals, np.uint8)
        else:
            raise PNGError(f"unknown PNG row filter {kind}")
        out[y + 1] = row
    return out[1:]


def read_png(path: str) -> np.ndarray:
    """Decode ``path`` to HWC uint8 (1 or 3 channels; alpha dropped)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(SIGNATURE):
        raise _refuse(path, "not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise _refuse(path, "no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8:
        raise _refuse(path, f"{depth}-bit samples")
    if colour not in _CHANNELS:
        raise _refuse(path, f"colour type {colour} (3: a palette)")
    if interlace:
        raise _refuse(path, "Adam7 interlacing")
    channels = _CHANNELS[colour]
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise _refuse(path, f"{raw.size} bytes of image data for {w} x {h}")
    img = _unfilter(raw.reshape(h, stride + 1), h, stride,
                    channels).reshape(h, w, channels)
    if channels == 2:  # cv2 reads gray + alpha as BGRA
        img = np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, img: np.ndarray, level: int = 1) -> None:
    """An 8-bit PNG of ``img``: [H, W] or [H, W, 1] gray, [H, W, 2] gray +
    alpha, [H, W, 3] RGB or [H, W, 4] RGBA; every row filter 0, the data
    zlib-compressed at ``level``."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.zeros((h, 1 + w * c), np.uint8)
    rows[:, 1:] = img.reshape(h, w * c)
    with open(path, "wb") as fh:
        fh.write(SIGNATURE
                 + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour,
                                               0, 0, 0))
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                 + _chunk(b"IEND", b""))
