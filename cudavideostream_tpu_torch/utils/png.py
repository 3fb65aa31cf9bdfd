"""Minimal dependency-free PNG writer (zlib + struct only).

The reference's visual leg is ``cv::imshow`` (``client/opencv.cpp:68-69``,
server aux thread ``threads.cpp:149-164``); this headless environment
ships committed image artifacts instead, and PPM dumps are too large to
commit. 8-bit RGB, no interlace, one IDAT.

A copy of the JAX package's ``utils/png.py`` (host-only NumPy, zlib and
struct): both write the same file bytes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB array as a PNG file."""
    rgb = np.asarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3), got {rgb.shape}")
    h, w, _ = rgb.shape
    # filter byte 0 (None) per scanline
    raw = np.empty((h, 1 + w * 3), dtype=np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = rgb.reshape(h, w * 3)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 9)))
        f.write(_chunk(b"IEND", b""))


def bgr_frame_to_rgb(frame: np.ndarray, height: int, width: int) -> np.ndarray:
    """Flat BGR24 frame bytes -> (H, W, 3) RGB array (the wire and the
    reference's cv::Mat are BGR; PNG wants RGB)."""
    img = np.asarray(frame, dtype=np.uint8).reshape(height, width, 3)
    return img[:, :, ::-1]
