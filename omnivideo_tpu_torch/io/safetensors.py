"""A safetensors reader written from the file format, without the
`safetensors` package (the card's machine may not have it).

A file is an 8-byte little-endian header length n, then n bytes of JSON
`{name: {"dtype", "shape", "data_offsets": [begin, end]}}` (plus an optional
`"__metadata__"` of strings), then the raw little-endian buffer; the offsets
count from the end of the header.

Each tensor is read once, straight into its own memory: on the CPU with
`readinto` into the new tensor, on a card through one pinned staging buffer
of `STAGING_BYTES`, so a 62 GB checkpoint is never held in host memory,
let alone twice. The file is not mapped: on the card's machine a mapped
file stayed resident in full while it was read, `MADV_DONTNEED` or not
(`PERF.md` §6: the resident set rose by 2.83 GB over the load of
a 2.84 GB expert). BF16 stays `torch.bfloat16`; a tensor at any byte
offset reads the same.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple, Union

import torch

from ..device import resolve_device

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
STAGING_BYTES = 64 << 20  # host bytes staged per copy to a card

PathLike = Union[str, Path]


def read_header(path: PathLike) -> Tuple[Dict[str, dict], Dict[str, str], int]:
    """(tensor entries by name, `__metadata__` (or {}), the byte offset
    where the data buffer starts)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", head)
        raw = f.read(n)
    if len(raw) != n:
        raise ValueError(f"{path}: header of {n} bytes is cut short")
    header = json.loads(raw)
    meta = header.pop("__metadata__", None) or {}
    for name, e in header.items():
        if e["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {e['dtype']}, which is not read")
    return header, meta, 8 + n


def _read_into(f, dst: torch.Tensor) -> None:
    """Fill the uint8 CPU tensor `dst` from the file's current position."""
    view, got = memoryview(dst.numpy()), 0
    while got < len(view):
        n = f.readinto(view[got:])
        if not n:
            raise ValueError(f"{f.name}: the file ends inside a tensor")
        got += n


def iter_safetensors(path: PathLike, device="cuda", prefix_filter: Optional[str] = None
                     ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) for every tensor of one file (those whose names start
    with `prefix_filter`, if given), in file order, each in memory of its
    own on `device`."""
    dev = resolve_device(device)
    header, _, start = read_header(path)
    entries = sorted(((e["data_offsets"][0], name, e) for name, e in header.items()
                      if not prefix_filter or name.startswith(prefix_filter)),
                     key=lambda t: t[0])
    size = Path(path).stat().st_size
    staging = None
    with open(path, "rb", buffering=0) as f:
        for _, name, e in entries:
            begin, end = (start + o for o in e["data_offsets"])
            dtype, shape = DTYPES[e["dtype"]], tuple(e["shape"])
            out = torch.empty(shape, dtype=dtype, device=dev)
            if end > size or end - begin != out.numel() * out.element_size():
                raise ValueError(f"{path}: {name} {e} does not fit the file")
            raw = out.reshape(-1).view(torch.uint8)
            f.seek(begin)
            if dev.type == "cpu":
                _read_into(f, raw)
            else:
                if staging is None:
                    staging = torch.empty(STAGING_BYTES, dtype=torch.uint8, pin_memory=True)
                for off in range(0, raw.numel(), STAGING_BYTES):
                    n = min(STAGING_BYTES, raw.numel() - off)
                    _read_into(f, staging[:n])
                    raw[off:off + n].copy_(staging[:n])
            yield name, out


def load_safetensors(path: PathLike, device="cuda", prefix_filter: Optional[str] = None
                     ) -> Dict[str, torch.Tensor]:
    """Every tensor of one file (optionally only names starting with
    `prefix_filter`) on `device`."""
    return dict(iter_safetensors(path, device, prefix_filter))
