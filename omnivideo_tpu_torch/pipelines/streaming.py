"""DiT blocks streamed from host memory through a few device slots (port of
omnivideo_tpu/pipelines/streaming.py).

On an 80 GB card this is what makes a model larger than the card run on
one: both T2V-A14B experts (57 GB of bf16) denoise with a window of blocks
on the card, and the streamed trainers (training/streaming.py) keep a
block stack, its gradients and its optimizer state in host memory.

- `BlockPacker` lays a block's tensors out in ONE flat host buffer (each
  tensor a view at a fixed, 256-byte aligned offset; int8 payloads and
  their f32 scales under `quant`), page-locked on a CUDA machine, so a block
  crosses PCIe in one copy. The page lock is `cudaHostRegister` of exactly
  the buffer's bytes (`HostBuffer`): torch's pinned allocator rounds every
  request up to a power of two, which would take 1.07 GB of host memory
  for each 0.71 GB A14B block.
- `BlockStreamingExecutor` runs the blocks through a ring of `window`
  preallocated device slots in the packer's layout. A dedicated copy stream
  fills a slot (`copy_(..., non_blocking=True)` from the pinned buffer) and
  records an event on which the compute stream waits before it runs the
  block; the compute stream records an event after the block's launches on
  which the copy stream waits before it refills that slot. Without the
  second wait a copy would overwrite weights a block is still reading: a
  silently wrong video, not a crash. `group` runs g consecutive blocks per
  copy and launch unit (one event pair a group; the numbers do not change).
  Every block runs through one template `WanBlock` built on the meta device,
  its parameters bound to the slot's views by `torch.func.functional_call`,
  so every block takes the resident block's code and kernels.
- On CUDA a host block that is not page-locked raises (a non-blocking copy
  from pageable memory quietly becomes synchronous), as does a slot not on
  the card. CPU tensors (the tests) run the same schedule without streams.
- `residentize`: a schedule of at most two distinct (aliased) blocks
  repeated keeps each on the card after its first copy (JAX's rule);
  `release()` frees those copies and the slots.

`wan_dit_stream_apply` is WanDiT.forward with the block loop replaced by the
executor (the prologue and head are the module's own methods), and
`split_host_params` moves a resident WanDiT's blocks into packed host
blocks and frees them on the device. `random_streamed_dit` builds a WanDiT
whose blocks never touch the card beyond one parameter's draw, with the
draws of the resident seeded init.
"""

from __future__ import annotations

import math
import mmap
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..configs.base import WanDiTConfig
from ..device import resolve_device
from ..models.wan_dit import WanBlock, WanDiT
from ..ops.quant import Q8, Leaf, dequantize_block, quantize_block

ALIGN = 256  # bytes: every packed tensor starts at a multiple


class HostBuffer:
    """One host allocation of exactly `nbytes` (`data`) in pages of its own
    (an anonymous mapping), page-locked when `pin` by cudaHostRegister and
    unregistered when the buffer is dropped. Its own pages: two registered
    ranges never share one, and the tensor's storage starts at the
    registered address, where `is_pinned` looks."""

    PAGE = 4096
    pinned_bytes = 0  # page-locked bytes held by live buffers, process-wide

    def __init__(self, nbytes: int, pin: bool):
        size = max(-(-nbytes // self.PAGE) * self.PAGE, self.PAGE)
        self._map = mmap.mmap(-1, size)
        self.data = torch.frombuffer(self._map, dtype=torch.uint8, count=nbytes) if nbytes \
            else torch.empty(0, dtype=torch.uint8)
        self._registered = 0
        if pin and nbytes:
            rc = torch.cuda.cudart().cudaHostRegister(self.data.data_ptr(), size, 0)
            if int(rc) != 0:
                raise RuntimeError(f"cudaHostRegister of {size} host bytes failed ({rc})")
            self._registered = size
            HostBuffer.pinned_bytes += size

    def __del__(self):
        if self._registered:
            HostBuffer.pinned_bytes -= self._registered
            self._registered = 0
            try:
                torch.cuda.cudart().cudaHostUnregister(self.data.data_ptr())
            except Exception:  # interpreter shutdown: CUDA may be torn down already
                pass


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class BlockPacker:
    """The layout of a block ({name: tensor or Q8}) in one flat byte buffer:
    (name, part, dtype, shape, offset) per tensor, in the block's order."""

    def __init__(self, example: Dict[str, Leaf]):
        self.specs: List[Tuple[str, Optional[str], torch.dtype, tuple, int]] = []
        self.q8_dtypes: Dict[str, torch.dtype] = {}
        off = 0
        for name, leaf in example.items():
            if isinstance(leaf, Q8):
                self.q8_dtypes[name] = leaf.dtype
                parts = (("q8", leaf.q8), ("scale", leaf.scale))
            else:
                parts = ((None, leaf),)
            for part, t in parts:
                self.specs.append((name, part, t.dtype, tuple(t.shape), off))
                off += -(-_nbytes(t) // ALIGN) * ALIGN
        self.nbytes = off

    def views(self, buf: torch.Tensor) -> Dict[str, Leaf]:
        """The block as views of `buf` (uint8 [nbytes], any device)."""
        out: Dict[str, Leaf] = {}
        parts: Dict[str, dict] = {}
        for name, part, dt, shape, off in self.specs:
            n = math.prod(shape) * torch.empty((), dtype=dt).element_size()
            v = buf[off:off + n].view(dt).view(shape)
            if part is None:
                out[name] = v
            else:
                p = parts.setdefault(name, {})
                p[part] = v
                if len(p) == 2:
                    out[name] = Q8(p["q8"], p["scale"], self.q8_dtypes[name])
        return out

    def empty(self, pin: bool) -> "PackedBlock":
        return PackedBlock(self, HostBuffer(self.nbytes, pin))

    def pack(self, block: Dict[str, Leaf], pin: bool) -> "PackedBlock":
        """A host copy of `block` (tensors on any one device) in this layout;
        a card's block is laid out there first and crosses in one copy."""
        pb = self.empty(pin)
        first = next(iter(block.values()))
        dev = (first.q8 if isinstance(first, Q8) else first).device
        stage = pb.data if dev.type == "cpu" else torch.empty(self.nbytes, dtype=torch.uint8,
                                                              device=dev)
        fill_block(self.views(stage), block)
        if stage is not pb.data:
            pb.data.copy_(stage)
        return pb


def fill_block(dst: Dict[str, Leaf], src: Dict[str, Leaf]) -> None:
    """Copy `src`'s tensors (Q8 parts too) into the same names of `dst`."""
    for name, leaf in src.items():
        d = dst[name]
        if isinstance(leaf, Q8):
            d.q8.copy_(leaf.q8)
            d.scale.copy_(leaf.scale)
        else:
            d.copy_(leaf)


class PackedBlock:
    """A block in host memory: its packer and its flat buffer."""

    __slots__ = ("packer", "host")

    def __init__(self, packer: BlockPacker, host: HostBuffer):
        self.packer, self.host = packer, host

    @property
    def data(self) -> torch.Tensor:
        return self.host.data

    @property
    def nbytes(self) -> int:
        return self.packer.nbytes

    def block(self) -> Dict[str, Leaf]:
        return self.packer.views(self.host.data)


def block_template(cfg: WanDiTConfig, names: Sequence[str] = ()) -> WanBlock:
    """The one WanBlock, on the meta device, that every streamed block runs
    through; an adapter is attached where `names` hold its `.lora_a`."""
    from ..training.lora import set_adapter

    tpl = WanBlock(cfg, torch.float32, torch.device("meta"))
    for n in names:
        if n.endswith(".lora_a"):
            lin = tpl.get_submodule(n[: -len(".lora_a")])
            d_out, d_in = lin.weight.shape
            z = torch.empty((), device="meta")
            set_adapter(lin, z.expand(d_in, 1), z.expand(1, d_out), z)
    return tpl


def run_block(template: WanBlock, params: Dict[str, torch.Tensor], x: torch.Tensor, aux,
              qk_impl: str, ew_impl: str) -> torch.Tensor:
    """One block's forward with `params` bound to the template."""
    return functional_call(template, params, (x, aux), {"qk_impl": qk_impl, "ew_impl": ew_impl},
                           strict=True)


class DeviceRing:
    """`window` device slots of `nbytes`, filled from page-locked host bytes
    on a copy stream: load → (compute waits) acquire → release (the copy
    stream's next load into the slot waits for it). On the CPU the copies
    are plain and the waits vanish."""

    def __init__(self, nbytes: int, window: int, device: torch.device):
        self.device, self.window = device, window
        self.slots = [torch.empty(nbytes, dtype=torch.uint8, device=device)
                      for _ in range(window)]
        self.cuda = device.type == "cuda"
        self.timing = False  # record copy events (BlockStreamingExecutor.timing)
        if self.cuda:
            self.copy = torch.cuda.Stream(device)
            self.ready = [torch.cuda.Event() for _ in range(window)]
            self.freed = [torch.cuda.Event() for _ in range(window)]
            self.in_use = [False] * window
            # the slots may be memory the compute stream freed with kernels still
            # queued on it: no copy may write them before the compute stream is here
            self.born = torch.cuda.Event()
            self.born.record(torch.cuda.current_stream(device))
        self.trace: List[dict] = []

    def load(self, k: int, srcs: Sequence[Tuple[torch.Tensor, int]]) -> None:
        """Copy each (host uint8 tensor, byte offset) into slot k."""
        slot = self.slots[k]
        if slot.device.type != self.device.type:
            raise RuntimeError(f"slot {k} is on {slot.device}, not {self.device}")
        if not self.cuda:
            for src, off in srcs:
                slot[off:off + src.numel()].copy_(src)
            return
        for src, _ in srcs:
            if not src.is_pinned():
                raise RuntimeError("a streamed host buffer is not page-locked: its "
                                   "non-blocking copy would run synchronously")
        with torch.cuda.stream(self.copy):
            self.copy.wait_event(self.freed[k] if self.in_use[k] else self.born)
            rec = None
            if self.timing:
                rec = {"copy": [torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True)],
                       "bytes": sum(s.numel() for s, _ in srcs)}
                rec["copy"][0].record(self.copy)
            for src, off in srcs:
                slot[off:off + src.numel()].copy_(src, non_blocking=True)
            if rec is not None:
                rec["copy"][1].record(self.copy)
                self.trace.append(rec)
            self.ready[k].record(self.copy)
        self.in_use[k] = True

    def acquire(self, k: int) -> torch.Tensor:
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(self.ready[k])
        return self.slots[k]

    def release(self, k: int) -> None:
        if self.cuda:
            self.freed[k].record(torch.cuda.current_stream(self.device))


def overlap_stats(trace: List[dict], base) -> dict:
    """Copy GB/s and the share of copy time hidden behind compute, from
    events recorded on the two streams (`base` recorded first)."""
    if not trace:
        return {}
    torch.cuda.synchronize()
    t = lambda ev: base.elapsed_time(ev)  # noqa: E731
    comp = [(t(r["compute"][0]), t(r["compute"][1])) for r in trace if "compute" in r]
    copy_ms, exposed, nbytes = 0.0, 0.0, 0
    for r in trace:
        a, b = t(r["copy"][0]), t(r["copy"][1])
        copy_ms += b - a
        nbytes += r["bytes"]
        covered = sum(max(0.0, min(b, c1) - max(a, c0)) for c0, c1 in comp)
        exposed += max(0.0, (b - a) - covered)
    compute_ms = sum(c1 - c0 for c0, c1 in comp)
    return {"copies": len(trace), "copy_gb": nbytes / 1e9, "copy_ms": copy_ms,
            "copy_gb_per_s": nbytes / 1e6 / copy_ms if copy_ms else None,
            "compute_ms": compute_ms,
            "hidden_share": 1.0 - exposed / copy_ms if copy_ms else None}


def quantized_blocks(blocks: Sequence[PackedBlock], device: torch.device) -> List[PackedBlock]:
    """int8 copies of packed blocks (aliased entries once), quantised on
    `device` (the card quantises as the host does: f32 amax, division and
    round-half-even), packed page-locked on a CUDA machine."""
    pin = device.type == "cuda"
    cache: Dict[int, PackedBlock] = {}
    packer = None
    for b in blocks:
        if id(b) in cache:
            continue
        q = quantize_block(b.packer.views(b.data.to(device, non_blocking=pin)))  # one copy in
        packer = packer or BlockPacker(q)
        cache[id(b)] = packer.pack(q, pin)
    return [cache[id(b)] for b in blocks]


class BlockStreamingExecutor:
    """Streams packed host blocks through a ring of device slots, the copy
    of the next unit overlapping the compute of this one (module
    docstring). `window` counts slots (units of `group` blocks); window 1
    serialises copy and compute, the slot-reuse race detector."""

    def __init__(self, cfg: WanDiTConfig, host_blocks: Sequence[PackedBlock], window: int = 2,
                 qk_impl: str = "kernel", ew_impl: str = "unfused", device="cuda",
                 residentize: bool = True, quant: Optional[str] = None, group: int = 1):
        if window < 1 or group < 1:
            raise ValueError(f"window {window} and group {group} must be ≥ 1")
        if quant not in (None, "int8"):
            raise ValueError(f"stream quant {quant!r} not in (None, 'int8')")
        self.cfg, self.window, self.group, self.quant = cfg, window, group, quant
        self.qk_impl, self.ew_impl = qk_impl, ew_impl
        self.device = resolve_device(device)
        blocks = list(host_blocks)
        if quant:
            blocks = quantized_blocks(blocks, self.device)
        self.host_blocks = blocks
        self.packer = blocks[0].packer
        if any(b.packer.specs != self.packer.specs for b in blocks):
            raise ValueError("streamed blocks must share one layout")
        if self.device.type == "cuda" and not all(b.data.is_pinned() for b in blocks):
            raise RuntimeError("streamed host blocks must be page-locked on a CUDA machine")
        self.template = block_template(cfg, [s[0] for s in self.packer.specs])
        uniq = {id(b) for b in blocks}
        self._residentize = residentize and len(uniq) <= 2 and len(blocks) > len(uniq)
        self._resident: Dict[int, torch.Tensor] = {}
        self._ring: Optional[DeviceRing] = None
        self.timing = False  # record copy/compute events per unit (overlap_stats)
        self.stats: List[dict] = []  # overlap_stats of each timed run_blocks

    @property
    def block_bytes(self) -> int:
        return self.packer.nbytes

    def release(self) -> None:
        """Free the slots and any residentized blocks on the device."""
        self._resident = {}
        self._ring = None

    def _params(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        views = self.packer.views(buf)
        return dequantize_block(views) if self.quant else views

    def run_blocks(self, h: torch.Tensor, aux) -> torch.Tensor:
        """h [B, L, dim] at the residual dtype → after every block."""
        blocks, g = self.host_blocks, self.group
        n, nb = len(blocks), self.packer.nbytes
        if self._residentize:
            for b in blocks:
                dev = self._resident.get(id(b))
                if dev is None:
                    dev = self._resident[id(b)] = b.data.to(self.device)
                h = run_block(self.template, self._params(dev), h, aux, self.qk_impl,
                              self.ew_impl)
            return h
        units = [list(range(i, min(i + g, n))) for i in range(0, n, g)]
        W = min(self.window, len(units))
        if self._ring is None or len(self._ring.slots) != W:
            self._ring = DeviceRing(nb * g, W, self.device)
        ring = self._ring
        ring.timing, ring.trace = self.timing and ring.cuda, []
        base = None
        if ring.timing:
            base = torch.cuda.Event(enable_timing=True)
            base.record()

        def load(u):
            ring.load(u % W, [(blocks[i].data, j * nb) for j, i in enumerate(units[u])])

        for u in range(W):
            load(u)
        for u, unit in enumerate(units):
            k = u % W
            slot = ring.acquire(k)
            rec = ring.trace[u] if ring.timing else None
            if rec is not None:
                rec["compute"] = [torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True)]
                rec["compute"][0].record()
            for j, _ in enumerate(unit):
                h = run_block(self.template, self._params(slot[j * nb:(j + 1) * nb]), h, aux,
                              self.qk_impl, self.ew_impl)
            if rec is not None:
                rec["compute"][1].record()
            ring.release(k)
            if u + W < len(units):
                load(u + W)
        if ring.timing:
            self.stats.append(overlap_stats(ring.trace, base))
        return h


def wan_dit_stream_apply(resident: WanDiT, executor: BlockStreamingExecutor, x: torch.Tensor,
                         t: torch.Tensor, context: torch.Tensor, seq_len: Optional[int] = None,
                         context_embedded: bool = False,
                         residual_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """WanDiT.forward (no SP, no remat, f32 carry) with the blocks streamed
    by `executor` (its qk_impl and ew_impl): the same prologue and head."""
    pro = resident.prologue(x, t, context, seq_len, context_embedded)
    bandwidth = residual_dtype is not None and residual_dtype != torch.float32
    hf = executor.run_blocks(pro.h.to(residual_dtype if bandwidth else torch.float32), pro.aux)
    return resident._head(hf.float(), pro.e, pro.grid, executor.ew_impl)


def block_tensors(blk: nn.Module) -> Dict[str, torch.Tensor]:
    """A block's parameters and buffers by name, detached."""
    return {**{n: p.detach() for n, p in blk.named_parameters()},
            **{n: b for n, b in blk.named_buffers()}}


@torch.no_grad()
def split_host_params(wan: WanDiT) -> Tuple[WanDiT, List[PackedBlock]]:
    """Move `wan`'s blocks into packed host blocks (page-locked when the
    model is on a card) and leave meta tensors in their place, which frees
    them on the device: (the now resident-only module, the host blocks).
    Blocks that are one module repeated pack once (JAX's aliased-stack
    rule). A module already streamed returns its host blocks."""
    if wan.streamed:
        return wan, wan.host_blocks
    pin = wan.patch_embedding.weight.device.type == "cuda"
    packer = BlockPacker(block_tensors(wan.blocks[0]))
    cache: Dict[int, PackedBlock] = {}
    for blk in wan.blocks:
        if id(blk) not in cache:
            cache[id(blk)] = packer.pack(block_tensors(blk), pin)
    host = [cache[id(b)] for b in wan.blocks]
    wan.blocks.to("meta")
    wan.host_blocks = host
    return wan, host


def empty_host_blocks(wan: WanDiT) -> List[PackedBlock]:
    """Fresh packed host blocks in the layout of `wan`'s (meta) blocks."""
    pin = wan.patch_embedding.weight.device.type == "cuda"
    packer = BlockPacker(block_tensors(wan.blocks[0]))
    return [packer.empty(pin) for _ in wan.blocks]


def host_block_targets(wan: WanDiT) -> Dict[str, torch.Tensor]:
    """{'blocks.i.<name>': view into host block i}, to load into."""
    return {f"blocks.{i}.{n}": v for i, b in enumerate(wan.host_blocks)
            for n, v in b.block().items()}


@torch.no_grad()
def random_streamed_dit(cfg: WanDiTConfig, dtype: torch.dtype = torch.bfloat16, device="cuda",
                        generator: Optional[torch.Generator] = None) -> WanDiT:
    """A seeded WanDiT whose blocks are packed host blocks: the resident
    init's draws in its order (each block parameter drawn in f32 on
    `device`, cast there and copied into its host view), so the weights
    equal `WanDiT(cfg, dtype, device, generator)`'s."""
    wan = WanDiT(cfg, dtype=dtype, device=device, blocks_device="meta")
    wan.host_blocks = empty_host_blocks(wan)
    targets = host_block_targets(wan)
    wan.init_weights(generator, sink=lambda name, t: targets[name].copy_(
        t.to(targets[name].dtype)))
    return wan
