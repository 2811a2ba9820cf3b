"""A PNG writer from ``zlib`` and ``struct`` (the machine with the card has
no PIL): 8-bit grayscale or RGB, every scanline with filter type 0."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_COLOR_TYPE = {1: 0, 3: 2}  # channels -> PNG colour type (grayscale, truecolour)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))


def png_bytes(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3) uint8 → the bytes of a PNG file."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8 images, got {image.dtype}")
    pixels = image if image.ndim == 3 else image[..., None]
    height, width, channels = pixels.shape
    if channels not in _COLOR_TYPE:
        raise ValueError(f"PNG writer takes (H, W) or (H, W, 3) images, got {image.shape}")
    rows = np.concatenate([np.zeros((height, 1), np.uint8), pixels.reshape(height, width * channels)], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, _COLOR_TYPE[channels], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(image))
