"""Tonemap and image IO (numpy only), as ``spath_tpu/utils/image.py``.

Tonemap of the reference: clamp to [0,1], scale by 255, add 0.5 and
truncate to uint8 (round half up), alpha 0 in RGBA (``src/scene.h:32-39``).
The HDR operators of ``tonemap`` go beyond the reference. PNG and binary
PPM writers, and a reader for the PNGs the writer makes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_rgb_u8(img) -> np.ndarray:
    """Float RGB (any shape ending in 3) → uint8, reference rounding."""
    img = np.asarray(img, np.float32)
    c = np.clip(img, 0.0, 1.0) * np.float32(255.0) + np.float32(0.5)
    return c.astype(np.uint8)  # truncation == round-half-up after +0.5


def to_rgba_u8(img) -> np.ndarray:
    """Float RGB → uint8 RGBA with alpha 0 (``src/scene.h:38``)."""
    rgb = to_rgb_u8(img)
    alpha = np.zeros(rgb.shape[:-1] + (1,), np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)


#: The operators of ``tonemap`` (``render --tonemap``).
TONEMAP_MODES = ("clamp", "reinhard", "aces", "gamma22")


def tonemap(img, mode: str = "clamp", exposure: float = 1.0) -> np.ndarray:
    """Linear HDR radiance (``render_radiance``, unclamped) → display
    [0, 1], after a linear ``exposure`` multiplier, in float32:

    - clamp: the reference's, clip to [0, 1];
    - reinhard: x / (1 + x);
    - aces: Narkowicz's ACES filmic fit;
    - gamma22: clamp, then gamma 1/2.2.
    """
    x = np.asarray(img, np.float32) * np.float32(exposure)
    if mode == "clamp":
        return np.clip(x, 0.0, 1.0)
    if mode == "reinhard":
        return np.clip(x / (1.0 + x), 0.0, 1.0)
    if mode == "aces":
        a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        return np.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)
    if mode == "gamma22":
        return np.clip(x, 0.0, 1.0) ** np.float32(1.0 / 2.2)
    raise ValueError(f"unknown tonemap mode {mode!r}; one of {TONEMAP_MODES}")


def write_ppm(path: str, img) -> None:
    """Write a float or uint8 RGB image as binary PPM (P6)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_rgb_u8(arr)
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(arr[..., :3].tobytes())


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img) -> None:
    """Write a float or uint8 RGB image as an 8-bit RGB PNG."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_rgb_u8(arr)
    arr = arr[..., :3]
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB PNG with unfiltered rows, as ``write_png`` writes
    it, into a ``(H, W, 3)`` uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", body[:10])
            if (depth, colour) != (8, 2):
                raise ValueError(f"{path}: not 8-bit RGB")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows are not supported")
    return rows[:, 1:].reshape(h, w, 3).copy()
