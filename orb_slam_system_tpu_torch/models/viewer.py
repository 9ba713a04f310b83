"""Image writers of the JAX package's headless viewer
(orb_slam_system_tpu/models/viewer.py:145-175): binary PGM and a PNG
encoder on the standard library's zlib. The tests and chip_smoke.py lay
synthetic sequences out on disk with them; the rest of the viewer (frame
annotation, map export, the live page) is not ported yet.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_pgm(path: str, img: np.ndarray):
    """Write a u8 grayscale image as binary PGM (no external codecs)."""
    img = np.clip(img, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


def encode_png(img: np.ndarray) -> bytes:
    """Encode a u8 grayscale [H,W] or RGB [H,W,3] image as PNG with
    stdlib zlib only. A uint16 [H,W] array is written as a 16-bit
    grayscale PNG with its values kept (a TUM depth map); the JAX encoder
    clips every input to u8."""
    H, W = img.shape[:2]
    if img.dtype == np.uint16 and img.ndim == 2:
        bit_depth, color_type = 16, 0
        rows = img.astype(">u2")
    else:
        img = np.clip(img, 0, 255).astype(np.uint8)
        bit_depth, color_type = 8, (2 if img.ndim == 3 else 0)
        rows = img
    raw = b"".join(b"\x00" + rows[i].tobytes() for i in range(H))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", W, H, bit_depth, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
