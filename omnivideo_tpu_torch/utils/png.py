"""A PNG reader and writer written from the format (ISO/IEC 15948), with
`zlib` from the standard library: the card's machine has no Pillow.

`read_png` takes 8-bit RGB or RGBA, not interlaced, the scanline filters
0-4 undone; anything else raises ValueError, naming what it found.
`write_png` writes 8-bit RGB or RGBA with filter 0 on every row.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # colour type → channels: truecolour, truecolour with alpha


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + n


def _unfilter_row(kind: int, raw: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline's bytes with its filter undone (prev: the row above)."""
    if kind == 0:
        return raw
    if kind == 2:  # Up
        return raw + prev
    if kind == 1:  # Sub: a running sum per byte of the pixel, mod 256
        return np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint64).astype(np.uint8).ravel()
    out = bytearray(raw.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:  # Average
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        elif kind == 4:  # Paeth
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown scanline filter {kind}")
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path) -> np.ndarray:
    """An 8-bit RGB or RGBA, non-interlaced PNG → [H, W, 3 or 4] uint8."""
    data = Path(path).read_bytes()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: PNG with bit depth {depth}, colour type {colour}, interlace "
                         f"{interlace}; only 8-bit RGB or RGBA, not interlaced, is read")
    ch = _CHANNELS[colour]
    stride = width * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: {raw.size} image bytes for {width}x{height}x{ch}")
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, ch)
    return out.reshape(height, width, ch)


def write_png(path, image: np.ndarray) -> Path:
    """[H, W, 3 or 4] uint8 → an 8-bit RGB(A) PNG, filter 0 on every row."""
    image = np.ascontiguousarray(image, np.uint8)
    height, width, ch = image.shape
    colour = {3: 2, 4: 6}[ch]
    rows = np.concatenate([np.zeros((height, 1), np.uint8), image.reshape(height, -1)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    blob = (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))
    Path(path).write_bytes(blob)
    return Path(path)
