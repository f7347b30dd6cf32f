"""PNG output for rendered frames.

The numpy PNG writer of `mafrixraytracing_tpu/film/image.py`, copied because
importing any module of that package imports JAX. It raises `ValueError` on
a malformed array instead of asserting. Uses PIL when present, else a
dependency-free zlib encoder.
"""
from __future__ import annotations

import struct as _struct
import zlib

import numpy as np


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as PNG."""
    arr = np.ascontiguousarray(np.asarray(rgb_u8, dtype=np.uint8))
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got shape {arr.shape}")
    try:
        from PIL import Image
    except ImportError:
        with open(path, "wb") as f:
            f.write(_encode_png_zlib(arr))
        return
    Image.fromarray(arr, "RGB").save(path)


def _encode_png_zlib(arr: np.ndarray) -> bytes:
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = _struct.pack(">I", len(data)) + tag + data
        return c + _struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = _struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
