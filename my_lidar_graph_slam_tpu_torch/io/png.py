"""A small PNG writer and reader on NumPy, ``zlib`` and ``struct``.

No JAX counterpart: the JAX package writes its images with PIL, which the
port does not depend on. :func:`write_png` writes 8-bit RGB images, one
IDAT chunk, every row with filter type 0. :func:`read_png` reads back
what it writes: it checks every chunk's CRC and the image data's length,
and refuses any other kind of PNG (another color type or bit depth,
interlacing, a row filter other than 0) with ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_HEADER = ">IIBBBBB"   # width, height, depth, color type, compression,
#                        filter method, interlace
_RGB = 2


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data +
            struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 [H, W, 3] RGB image; row 0 is the top."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("expected a [H, W, 3] uint8 image")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                         axis=1)
    return (SIGNATURE +
            _chunk(b"IHDR", struct.pack(_HEADER, w, h, 8, _RGB, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def decode_png(data: bytes) -> np.ndarray:
    """uint8 [H, W, 3] of a PNG written by :func:`encode_png`."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat, pos = None, [], 8
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        end = pos + 12 + length
        if end > len(data):
            raise ValueError("truncated PNG")
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(_HEADER, body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos = end
    if header is None or header[2:] != (8, _RGB, 0, 0, 0):
        raise ValueError(f"unsupported PNG header {header}")
    w, h = header[:2]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + 3 * w):
        raise ValueError("PNG image data has the wrong length")
    rows = raw.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("PNG rows use a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
