"""A safetensors reader written from the file format, without the
`safetensors` package (the card's machine may not have it).

A file is an 8-byte little-endian header length n, then n bytes of JSON
`{name: {"dtype", "shape", "data_offsets": [begin, end]}}` (plus an optional
`"__metadata__"` of strings), then the raw little-endian buffer; the offsets
count from the end of the header.

Each tensor is read once, straight into its own memory: on the CPU with
`readinto` into the new tensor, on a card through two pinned staging
buffers of `STAGING_BYTES`, each with an event, so the read of the next
chunk overlaps the copy of the last one and a 62 GB checkpoint is never
held in host memory, let alone twice. `take` reads a slice of chosen
tensors (ranges along one dim, concatenated: a rank's columns of an
expert bank, io/hf_reader.py): the whole bytes pass through the staging
buffers and only the slice is copied to the card. The file is not mapped: on the card's machine a mapped
file stayed resident in full while it was read, `MADV_DONTNEED` or not
(`PERF.md` §6: the resident set rose by 2.83 GB over the load of
a 2.84 GB expert). BF16 stays `torch.bfloat16`; a tensor at any byte
offset reads the same. `into` reads chosen tensors straight into host
memory the caller owns (a streamed DiT's page-locked block buffers).
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple, Union

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


# take(name, shape) → None (the whole tensor) or (dim, [(start, stop), ...]):
# those ranges along dim, concatenated in order
Take = Callable[[str, Tuple[int, ...]], Optional[Tuple[int, Sequence[Tuple[int, int]]]]]


class _Staging:
    """Two host buffers (and, for slices, two packing buffers), page-locked
    for a card, used in turn: a buffer is refilled only after the event
    recorded behind its last copy to the card has passed."""

    def __init__(self, dev: torch.device):
        self.dev, self.turn, self.pin = dev, 0, dev.type == "cuda"
        self.bufs = [self._buffer() for _ in range(2)]
        self.packs = [None, None]
        self.events = [None, None]

    def _buffer(self) -> torch.Tensor:
        return torch.empty(STAGING_BYTES, dtype=torch.uint8, pin_memory=self.pin)

    def next(self) -> int:
        i, self.turn = self.turn, self.turn ^ 1
        if self.events[i] is not None:
            self.events[i].synchronize()
        return i

    def pack(self, i: int) -> torch.Tensor:
        if self.packs[i] is None:
            self.packs[i] = self._buffer()
        return self.packs[i]

    def copy(self, i: int, dst: torch.Tensor, src: torch.Tensor) -> None:
        """dst ← src (in buffer i), asynchronously to a card."""
        dst.copy_(src, non_blocking=self.pin)
        if self.pin:
            self.events[i] = torch.cuda.Event()
            self.events[i].record(torch.cuda.current_stream(self.dev))


def _read_whole(f, raw: torch.Tensor, staging: Optional[_Staging]) -> None:
    """The tensor's bytes at the file's position into `raw` (uint8)."""
    if raw.device.type == "cpu":
        _read_into(f, raw)
        return
    for off in range(0, raw.numel(), STAGING_BYTES):
        n = min(STAGING_BYTES, raw.numel() - off)
        i = staging.next()
        _read_into(f, staging.bufs[i][:n])
        staging.copy(i, raw[off:off + n], staging.bufs[i][:n])


def _read_slice(f, out: torch.Tensor, shape, dim: int, ranges, staging: _Staging) -> None:
    """The file's tensor of `shape` at the file's position, its `ranges`
    along `dim` concatenated into `out`: whole slabs (one index of the dims
    before `dim`; a Qwen3-VL bank's largest is 3 MB) are staged, their
    ranges packed, the packed rows copied."""
    es = out.element_size()
    outer, size = math.prod(shape[:dim]), shape[dim]
    inner = math.prod(shape[dim + 1:]) * es  # bytes per index of dim
    taken, slab = out.shape[dim], size * inner
    if slab > STAGING_BYTES:
        raise ValueError(f"a slice along dim {dim} of {tuple(shape)} reads slabs of {slab} bytes, "
                         f"more than a staging buffer's {STAGING_BYTES}")
    dst = out.reshape(outer, -1).view(torch.uint8)  # [outer, taken · inner]
    per = STAGING_BYTES // slab  # slabs a staging buffer holds
    for o0 in range(0, outer, per):
        rows = min(per, outer - o0)
        i = staging.next()
        buf = staging.bufs[i][:rows * slab]
        _read_into(f, buf)
        src = buf.view(rows, size, inner)
        pack = staging.pack(i)[:rows * taken * inner].view(rows, taken, inner)
        at = 0
        for a, b in ranges:
            pack[:, at:at + b - a] = src[:, a:b]
            at += b - a
        staging.copy(i, dst[o0:o0 + rows], pack.view(rows, -1))


def _take_ranges(shape, want) -> Tuple[int, list, Tuple[int, ...]]:
    dim, ranges = want
    ranges = [(int(a), int(b)) for a, b in ranges]
    if not all(0 <= a < b <= shape[dim] for a, b in ranges):
        raise ValueError(f"ranges {ranges} of dim {dim} do not fit {tuple(shape)}")
    taken = list(shape)
    taken[dim] = sum(b - a for a, b in ranges)
    return dim, ranges, tuple(taken)


def iter_safetensors(path: PathLike, device="cuda", prefix_filter: Optional[str] = None,
                     into: Optional[Callable[[str], Optional[torch.Tensor]]] = None,
                     take: Optional[Take] = None) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) for every tensor of one file (those whose names start
    with `prefix_filter`, if given), in file order, each in memory of its
    own on `device`; where into(name) gives a CPU tensor of the same dtype
    and size, the tensor is read into that one instead; where take(name,
    shape) names ranges along a dim, only those (`Take`)."""
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
            if end > size or end - begin != math.prod(shape) * dtype.itemsize:
                raise ValueError(f"{path}: {name} {e} does not fit the file")
            want = take(name, shape) if take is not None else None
            if want is not None:
                dim, ranges, taken = _take_ranges(shape, want)
                out = torch.empty(taken, dtype=dtype, device=dev)
            else:
                out = into(name) if into is not None else None
                if (out is None or out.device.type != "cpu" or out.dtype != dtype
                        or out.numel() != math.prod(shape) or not out.is_contiguous()):
                    out = torch.empty(shape, dtype=dtype, device=dev)
            if staging is None and (want is not None or out.device.type != "cpu"):
                staging = _Staging(dev)
            f.seek(begin)
            if want is not None:
                _read_slice(f, out, shape, dim, ranges, staging)
            else:
                _read_whole(f, out.reshape(-1).view(torch.uint8), staging)
            yield name, out
            del out  # the caller's reference is the only one while the next is read


def load_safetensors(path: PathLike, device="cuda", prefix_filter: Optional[str] = None
                     ) -> Dict[str, torch.Tensor]:
    """Every tensor of one file (optionally only names starting with
    `prefix_filter`) on `device`."""
    return dict(iter_safetensors(path, device, prefix_filter))
