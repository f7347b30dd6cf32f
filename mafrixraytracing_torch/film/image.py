"""PNG output for rendered frames, and image input for textures.

Port of `mafrixraytracing_tpu/film/image.py`, copied because importing any
module of that package imports JAX. The encoders raise `ValueError` on a
malformed array instead of asserting, and take a uint8 tensor on any device
as well as a numpy array. They use PIL when present, else a dependency-free
zlib encoder; `read_image` needs PIL.
"""
from __future__ import annotations

import io
import struct as _struct
import zlib

import numpy as np
import torch


def _rgb_u8(rgb_u8) -> np.ndarray:
    if isinstance(rgb_u8, torch.Tensor):
        rgb_u8 = rgb_u8.detach().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(rgb_u8, dtype=np.uint8))
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got shape {arr.shape}")
    return arr


def encode_png(rgb_u8) -> bytes:
    """Encode an (H, W, 3) uint8 array or tensor as PNG bytes (the in-memory
    sink of the live preview, `film.preview`)."""
    arr = _rgb_u8(rgb_u8)
    try:
        from PIL import Image
    except ImportError:
        return _encode_png_zlib(arr)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="PNG")
    return buf.getvalue()


def write_png(path: str, rgb_u8) -> None:
    """Write an (H, W, 3) uint8 array or tensor as PNG."""
    png = encode_png(rgb_u8)
    with open(path, "wb") as f:
        f.write(png)


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


def read_image(path: str) -> np.ndarray:
    """Decode an image file to float32 (H, W, 3) in [0, 1] (texture loading,
    reference `TextureFromFile`, `Core/Texture.fs:30-44`; the reference flips
    vertically there, here row 0 stays at the top and the flip happens at
    sampling time, since OBJ vt has v up). Needs PIL."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("read_image decodes images with PIL (Pillow), which "
                          "is not installed") from e
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
