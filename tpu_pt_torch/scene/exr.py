"""Minimal OpenEXR scanline I/O (stdlib ``struct`` / ``zlib`` and numpy)
for environment maps: the port's copy of ``tpu_pt/scene/exr.py``.

Reads the subset of OpenEXR that covers lat-long radiance maps:

  * single-part scanline images (no tiles, no deep data, no multi-part)
  * NO_COMPRESSION, ZIP_COMPRESSION (16-scanline blocks) and ZIPS (1-line)
  * HALF / FLOAT / UINT channels; any line order (chunk y is absolute)
  * R/G/B[(A)] channels, or a single luminance channel (replicated to RGB)

``write_exr`` emits ZIP-compressed or uncompressed FLOAT or HALF scanline
files (valid OpenEXR).  Anything outside the subset raises ValueError with
the offending feature named.  Host code: arrays in, arrays out.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 0x01312F76
_PIXEL_DTYPE = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_NO_COMPRESSION = 0
_ZIPS_COMPRESSION = 2
_ZIP_COMPRESSION = 3
_LINES_PER_CHUNK = {_NO_COMPRESSION: 1, _ZIPS_COMPRESSION: 1,
                    _ZIP_COMPRESSION: 16}


def _read_cstr(buf: bytes, pos: int) -> tuple[str, int]:
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_header(buf: bytes, pos: int):
    """Parse attributes until the empty-name terminator.  Returns
    (attrs dict name -> (type, raw bytes), next pos)."""
    attrs = {}
    while True:
        name, pos = _read_cstr(buf, pos)
        if not name:
            return attrs, pos
        atype, pos = _read_cstr(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (atype, buf[pos:pos + size])
        pos += size


def _parse_channels(raw: bytes):
    """chlist -> list of (name, numpy dtype) in FILE ORDER (the order
    channels are interleaved within each scanline)."""
    chans = []
    pos = 0
    while True:
        name, pos = _read_cstr(raw, pos)
        if not name:
            return chans
        ptype, _plin, xs, ys = struct.unpack_from("<iiii", raw, pos)
        pos += 16
        if ptype not in _PIXEL_DTYPE:
            raise ValueError(f"EXR channel {name!r}: unknown pixel type {ptype}")
        if (xs, ys) != (1, 1):
            raise ValueError(f"EXR channel {name!r}: subsampling {xs}x{ys} "
                             "unsupported")
        chans.append((name, _PIXEL_DTYPE[ptype]))


def _unpredict(data: bytes) -> bytes:
    """Invert OpenEXR's ZIP post-deflate transform: byte-delta predictor
    followed by even/odd de-interleave."""
    t = np.frombuffer(data, np.uint8).astype(np.int32)
    t = np.cumsum(np.concatenate([t[:1], t[1:] - 128]), dtype=np.int64)
    t = (t & 0xFF).astype(np.uint8)
    half = (len(t) + 1) // 2
    out = np.empty(len(t), np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def _predict(data: bytes) -> bytes:
    """Forward transform for writing (interleave + delta)."""
    src = np.frombuffer(data, np.uint8)
    half = (len(src) + 1) // 2
    t = np.empty(len(src), np.uint8)
    t[:half] = src[0::2]
    t[half:] = src[1::2]
    d = t.astype(np.int32)
    d[1:] = d[1:] - d[:-1] + 128
    return (d & 0xFF).astype(np.uint8).tobytes()


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR -> (H, W, 3) float32, top row first."""
    with open(path, "rb") as fh:
        buf = fh.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    flags = version >> 8
    if version & 0xFF != 2:
        raise ValueError(f"EXR version {version & 0xFF} unsupported")
    if flags & 0x2:
        raise ValueError("tiled EXR unsupported (scanline only)")
    if flags & (0x8 | 0x10):
        raise ValueError("deep/multi-part EXR unsupported")

    attrs, pos = _parse_header(buf, 8)
    chans = _parse_channels(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    if comp not in _LINES_PER_CHUNK:
        names = {0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ",
                 5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB"}
        raise ValueError(f"EXR compression {names.get(comp, comp)} "
                         "unsupported (NONE/ZIP/ZIPS only)")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    lines = _LINES_PER_CHUNK[comp]
    n_chunks = -(-h // lines)

    # Scanline offset table (absolute file offsets).
    offsets = struct.unpack_from(f"<{n_chunks}q", buf, pos)

    bytes_per_px = sum(dt.itemsize for _, dt in chans)
    img = {name: np.zeros((h, w), np.float32) for name, _ in chans}
    for off in offsets:
        (y, size) = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8:off + 8 + size]
        row0 = y - y0
        n_rows = min(lines, h - row0)
        raw_len = n_rows * w * bytes_per_px
        if comp in (_ZIP_COMPRESSION, _ZIPS_COMPRESSION) and size < raw_len:
            data = _unpredict(zlib.decompress(data))
        if len(data) != raw_len:
            raise ValueError(f"EXR chunk at y={y}: {len(data)} bytes, "
                             f"expected {raw_len}")
        p = 0
        for r in range(n_rows):
            for name, dt in chans:
                n = w * dt.itemsize
                row = np.frombuffer(data, dt, count=w, offset=p)
                img[name][row0 + r] = row.astype(np.float32)
                p += n

    names = {n.upper(): n for n, _ in chans}
    if "R" in names and "G" in names and "B" in names:
        out = np.stack([img[names["R"]], img[names["G"]], img[names["B"]]],
                       axis=-1)
    elif len(chans) >= 1:
        out = np.repeat(img[chans[0][0]][..., None], 3, axis=2)
    else:
        raise ValueError("EXR has no channels")
    return np.ascontiguousarray(out, np.float32)


def _attr(name: str, atype: str, data: bytes) -> bytes:
    return (name.encode() + b"\0" + atype.encode() + b"\0"
            + struct.pack("<i", len(data)) + data)


def write_exr(path: str, img: np.ndarray, half: bool = False,
              compress: bool = True) -> None:
    """Write (H, W, 3) float data as a scanline EXR (ZIP or NONE
    compression; FLOAT or HALF channels), top row first."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    dt = np.dtype("<f2") if half else np.dtype("<f4")
    comp = _ZIP_COMPRESSION if compress else _NO_COMPRESSION
    lines = _LINES_PER_CHUNK[comp]

    chan_entries = b""
    for name in ("B", "G", "R"):  # alphabetical, the canonical order
        chan_entries += (name.encode() + b"\0"
                         + struct.pack("<iiii", 1 if half else 2, 0, 1, 1))
    chan_entries += b"\0"

    header = b""
    header += _attr("channels", "chlist", chan_entries)
    header += _attr("compression", "compression", bytes([comp]))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\0")
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    # Channel-interleaved scanline payloads, chunked.
    bgr = img[..., ::-1].astype(dt)               # rows of B, G, R planes
    chunks = []
    for c0 in range(0, h, lines):
        n_rows = min(lines, h - c0)
        rows = b"".join(bgr[c0 + r, :, c].tobytes()
                        for r in range(n_rows) for c in range(3))
        if comp == _ZIP_COMPRESSION:
            z = zlib.compress(_predict(rows))
            rows = z if len(z) < len(rows) else rows
        chunks.append(struct.pack("<ii", c0, len(rows)) + rows)

    n_chunks = len(chunks)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<ii", _MAGIC, 2))
        fh.write(header)
        table_pos = 8 + len(header)
        off = table_pos + 8 * n_chunks
        for ch in chunks:
            fh.write(struct.pack("<q", off))
            off += len(ch)
        for ch in chunks:
            fh.write(ch)
