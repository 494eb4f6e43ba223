"""Pure-Python MJPEG-in-AVI muxer/demuxer (the port's own copy of
omnivideo_tpu/utils/avi.py): the playable video file written where no mp4
encoder exists. Each frame is an independent baseline JPEG, encoded and
decoded by Pillow (imported inside the functions that need it); the
container is struct packing. Standard players (VLC, mpv, ffplay,
QuickTime) open the result directly, unlike the raw .npz last resort.

Layout written (single 'vids' stream, AVIF_HASINDEX):

    RIFF('AVI ')
      LIST('hdrl')  avih + LIST('strl'){ strh('vids'/'MJPG') + strf(BMIH) }
      LIST('movi')  '00dc' JPEG bytes per frame (word-aligned)
      idx1          one keyframe entry per frame
"""

from __future__ import annotations

import io
import struct
from typing import List, Tuple

import numpy as np

_AVIF_HASINDEX = 0x00000010
_AVIIF_KEYFRAME = 0x00000010


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(list_type: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", list_type + payload)


def _encode_jpeg(frame: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_mjpeg_avi(path: str, frames: np.ndarray, fps: int = 16,
                    quality: int = 92) -> str:
    """frames: [T, H, W, 3] uint8 → MJPEG AVI at `path`. Returns `path`."""
    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8:
        raise ValueError(f"expected uint8 frames [T, H, W, 3], got {frames.dtype} {frames.shape}")
    T, H, W = frames.shape[:3]
    jpegs: List[bytes] = [_encode_jpeg(f, quality) for f in frames]
    max_sz = max(len(j) for j in jpegs)

    avih = struct.pack(
        "<14I",
        int(round(1_000_000 / max(fps, 1))),  # dwMicroSecPerFrame
        max_sz * fps,                         # dwMaxBytesPerSec (upper bound)
        0,                                    # dwPaddingGranularity
        _AVIF_HASINDEX,                       # dwFlags
        T,                                    # dwTotalFrames
        0,                                    # dwInitialFrames
        1,                                    # dwStreams
        max_sz,                               # dwSuggestedBufferSize
        W, H,
        0, 0, 0, 0,                           # dwReserved[4]
    )
    strh = (
        b"vids" + b"MJPG"
        + struct.pack(
            "<10I",
            0, 0, 0,          # flags, priority+language, initial frames
            1, fps,           # scale, rate → fps frames/s
            0, T,             # start, length (frames)
            max_sz,           # suggested buffer size
            0xFFFFFFFF,       # quality (default)
            0,                # sample size (0 = varying)
        )
        + struct.pack("<4h", 0, 0, W, H)  # rcFrame
    )
    strf = struct.pack(
        "<I2i2H2I2i2I",
        40, W, H, 1, 24, int.from_bytes(b"MJPG", "little"),
        W * H * 3, 0, 0, 0, 0,
    )
    hdrl = _list(b"hdrl", _chunk(b"avih", avih)
                 + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))

    movi_payload = b"movi"
    idx_entries = []
    for j in jpegs:
        # idx1 offsets are relative to the start of the 'movi' fourcc
        idx_entries.append((len(movi_payload) - 4, len(j)))
        movi_payload += _chunk(b"00dc", j)
    movi = _chunk(b"LIST", movi_payload)

    idx1 = b"".join(
        b"00dc" + struct.pack("<3I", _AVIIF_KEYFRAME, off + 4, sz)
        for off, sz in idx_entries
    )

    riff_payload = b"AVI " + hdrl + movi + _chunk(b"idx1", idx1)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)
    return path


def read_mjpeg_avi(path: str) -> Tuple[np.ndarray, float]:
    """Demux an MJPEG AVI written by `write_mjpeg_avi` (or any player/tool
    producing plain 00dc/00db JPEG chunks) → ([T, H, W, 3] uint8, fps)."""
    from PIL import Image

    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")

    fps = 16.0
    frames: List[np.ndarray] = []

    def walk(buf: bytes):
        nonlocal fps
        pos = 0
        while pos + 8 <= len(buf):
            fourcc = buf[pos:pos + 4]
            (size,) = struct.unpack("<I", buf[pos + 4:pos + 8])
            payload = buf[pos + 8:pos + 8 + size]
            if fourcc == b"LIST":
                walk(payload[4:])
            elif fourcc == b"avih" and size >= 4:
                (usec,) = struct.unpack("<I", payload[:4])
                if usec:
                    fps = 1_000_000 / usec
            elif fourcc in (b"00dc", b"00db") and size > 0:
                frames.append(np.asarray(
                    Image.open(io.BytesIO(payload)).convert("RGB")))
            pos += 8 + size + (size % 2)

    walk(data[12:])
    if not frames:
        raise ValueError(f"{path}: no MJPEG frames found")
    return np.stack(frames), fps
