"""Film: tonemap and dependency-free PNG output (stdlib zlib)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(img_linear: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """Linear radiance (H,W,3) -> uint8 sRGB-ish (simple gamma)."""
    img = np.clip(np.asarray(img_linear, np.float32), 0.0, 1.0)
    img = img ** (1.0 / gamma)
    return (img * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img_u8: np.ndarray) -> None:
    """Write (H,W,3) uint8 to PNG.  Row 0 of the array is the BOTTOM image
    row (camera convention); PNG stores top-down, so we flip here."""
    img = np.ascontiguousarray(img_u8[::-1])
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as fh:
        fh.write(png)


def save(path: str, img_linear: np.ndarray, gamma: float = 2.2) -> None:
    write_png(path, tonemap(img_linear, gamma))
