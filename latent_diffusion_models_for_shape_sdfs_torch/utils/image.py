"""Minimal dependency-free PNG writing and reading (NumPy + zlib).

8-bit RGB / grayscale, zlib-compressed, filter type 0 per scanline: the
simplest spec-conformant encoder; every viewer reads it. The port's copy
of the JAX package's `utils/image.py`, so both write the same bytes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray) -> bytes:
    """uint8 [H,W] (gray) or [H,W,3] (RGB) -> PNG file bytes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"expected uint8, got {img.dtype}")
    if img.ndim == 2:
        color_type, channels = 0, 1
        img = img[..., None]
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type, channels = 2, 3
    else:
        raise ValueError(f"expected [H,W] or [H,W,3], got {img.shape}")
    h, w = img.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def read_png(path) -> np.ndarray:
    """Decode PNGs written by png_bytes (8-bit, filter-0 scanlines,
    single IDAT) — enough for roundtrip tests and reading our own
    preview artifacts; not a general PNG reader."""
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, w = 8, b"", None
    while pos < len(data):
        (ln,), tag = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or ctype not in (0, 2):
                raise ValueError("only 8-bit gray/RGB supported")
            channels = 3 if ctype == 2 else 1
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * channels + 1
    rows = []
    for y in range(h):
        row = raw[y * stride:(y + 1) * stride]
        if row[0] != 0:
            raise ValueError("only filter 0 supported")
        rows.append(np.frombuffer(row[1:], np.uint8))
    img = np.stack(rows).reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img
