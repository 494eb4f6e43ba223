"""Training a DiT whose block stack lives in host memory (port of
omnivideo_tpu/training/streaming.py).

Full fine-tuning of one T2V-A14B expert needs ~229 GB of f32 parameters,
gradients and AdamW moments, more than any one card holds. `StreamedTrainer`
keeps the blocks, their gradients and their optimizer state in page-locked
host buffers (pipelines/streaming.py's packed layout) and runs the plain
flow-matching step of training/trainer.py `make_train_step` (the same draws,
CFG dropout, target and weights) as passes over the stack:

- forward: the blocks stream through a ring of device slots on a copy
  stream (pipelines/streaming.py `DeviceRing`) and run through the training
  attention kernel, as the resident step's forward does (the inference
  kernel takes bf16 only); each block's input is saved, and with
  `act_offload` (the default) copied to host on the copy stream;
- pass A, in reverse: each block streams in again and is recomputed with
  its parameters, its input and the conditioning as leaves,
  `torch.autograd.grad` giving (d_params, d_x, d_e0, d_ctx); d_params goes
  to host, d_e0 and d_ctx accumulate on the device with the f32 sum of
  squares of the global norm; the resident leaves' gradients come from the
  prologue's and the head's own backward (WanDiT.prologue / `_head`);
- pass B: one clip factor from the true global norm (g · clip / norm when
  norm ≥ clip, as `Optimizer.update` applies it), then the same rule
  objects (`_AdamWRule`, `_AdafactorRule`) update each block on the device,
  which streams its parameters, gradients and state in and its parameters
  and state back; the count advances once a step.

`grad_clip=0` fuses the update into pass A (the block's parameters are on
the device already) and drops pass B. `stream_quant="int8"` is the transfer
diet: both parameter streams carry int8 copies of the host masters
(ops/quant.py; quantised once a step), gradients are quantised on the
device before their copy to the host, and the block update runs on the
host CPU with the same rule objects against the masters, which keep their
dtype. The block rules see block-relative leaf names, so adafactor's
statistics are per block, as JAX's per-block optax update keeps them.

`StreamedLoRATrainer` streams only the frozen base (bf16, or int8 with
`base_quant`) and keeps the adapters and their optimizer state on the
device; the exact clip applies after pass A, so it has no pass B.

Every block runs through the template WanBlock of pipelines/streaming.py
with the unfused attention chain, i.e. the training flash kernels (rows
3b, 4 and 5) on the card. Host buffers that are not page-locked raise on a
CUDA device, as in the executor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import PipelineConfig
from ..device import resolve_device
from ..models.wan_dit import WanDiT
from ..ops.quant import dequantize_block, quantize_block
from ..pipelines.streaming import (
    BlockPacker,
    DeviceRing,
    HostBuffer,
    PackedBlock,
    block_template,
    fill_block,
    quantized_blocks,
    run_block,
    split_host_params,
)
from .trainer import (
    Draws,
    Optimizer,
    TrainConfig,
    _AdafactorRule,
    _AdamWRule,
    _flow_table,
    lr_schedule,
    sample_draws,
)

_OPT_KEYS = ("mu", "nu", "v", "v_row", "v_col")


def _flat_opt(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A rule's state → {'<key>::<leaf>': tensor} (the packed layout)."""
    return {f"{k}::{n}": t for k in _OPT_KEYS if k in state for n, t in state[k].items()}


def _unflat_opt(flat: Dict[str, torch.Tensor], like: Dict[str, Any]) -> Dict[str, Any]:
    out = {k: v for k, v in like.items() if k not in _OPT_KEYS}
    for key, t in flat.items():
        k, n = key.split("::", 1)
        out.setdefault(k, {})[n] = t
    for k in _OPT_KEYS:
        if k in like:
            out.setdefault(k, {})
    return out


class _Mover:
    """The trainers' device↔host copies on one copy stream (the param
    ring's): a copy waits for the compute that made its source, and the
    compute waits for a copy before it reads the destination."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.copy = torch.cuda.Stream(device) if self.cuda else None

    def _check(self, host: torch.Tensor) -> None:
        if self.cuda and not host.is_pinned():
            raise RuntimeError("a streamed host buffer is not page-locked")

    def to_host(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """dst (host) ← src (device), asynchronously; `sync` before reading."""
        if not self.cuda:
            dst.copy_(src)
            return
        self._check(dst)
        ev = torch.cuda.Event()
        ev.record()
        with torch.cuda.stream(self.copy):
            self.copy.wait_event(ev)
            dst.copy_(src, non_blocking=True)
        src.record_stream(self.copy)

    def to_device(self, src: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """(a device copy of host `src`, the event to `wait` on)."""
        if not self.cuda:
            return src.clone(), None
        self._check(src)
        out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        ev = torch.cuda.Event()
        ev.record()  # out may be memory the compute stream just freed
        with torch.cuda.stream(self.copy):
            self.copy.wait_event(ev)
            out.copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.copy)
        return out, done

    def wait(self, ev) -> None:
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)

    def sync(self) -> None:
        if self.cuda:
            self.copy.synchronize()


def _stream(ring: DeviceRing, order: List[int], srcs, fn) -> None:
    """For i in `order`: load srcs(i) [(host uint8, offset)] into a slot a
    window ahead, then fn(i, slot) on the compute stream."""
    W = len(ring.slots)
    for u in range(min(W, len(order))):
        ring.load(u % W, srcs(order[u]))
    for u, i in enumerate(order):
        k = u % W
        fn(i, ring.acquire(k))
        ring.release(k)
        if u + W < len(order):
            ring.load(k, srcs(order[u + W]))


@dataclasses.dataclass
class StreamedTrainState:
    """resident: the DiT with its blocks on the host (device-resident
    embeddings, time projection and head, updated in place); resident_opt:
    their rule state; host_blocks / host_opts: each block's parameters and
    rule state, packed in host memory; step: the update count."""

    resident: WanDiT
    resident_opt: Dict[str, Any]
    host_blocks: List[PackedBlock]
    host_opts: List[PackedBlock]
    step: int = 0

    def to_checkpoint(self) -> dict:
        return {"kind": "streamed", "resident": _resident_sd(self.resident),
                "resident_opt": self.resident_opt,
                "blocks": [b.data for b in self.host_blocks],
                "opts": [o.data for o in self.host_opts], "step": self.step}

    def load_checkpoint(self, blob: dict) -> None:
        _check_kind(blob, "streamed")
        _load_resident(self.resident, blob["resident"])
        self.resident_opt = _to_device(blob["resident_opt"], self.resident.patch_embedding.weight.device)
        for dst, src in zip(self.host_blocks + self.host_opts, blob["blocks"] + blob["opts"]):
            dst.data.copy_(src)
        self.step = int(blob["step"])


def _resident_sd(wan: WanDiT) -> Dict[str, torch.Tensor]:
    return {n: p.detach().cpu() for n, p in wan.resident_parameters()}


@torch.no_grad()
def _load_resident(wan: WanDiT, sd: Dict[str, torch.Tensor]) -> None:
    own = dict(wan.resident_parameters())
    if set(own) != set(sd):
        raise KeyError(f"checkpoint's resident leaves differ: {sorted(set(own) ^ set(sd))[:8]}")
    for n, p in own.items():
        p.copy_(sd[n])


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree


def _check_kind(blob: dict, kind: str) -> None:
    if blob.get("kind") != kind:
        raise ValueError(f"checkpoint holds a {blob.get('kind', 'resident')!r} state, not {kind!r}")


class StreamedTrainer:
    """The plain flow-matching step (training/trainer.py `make_train_step`)
    over a DiT whose blocks live in host memory (module docstring).

    train_step(state, batch, draws=None) → (state, {'loss', 'grad_norm'});
    batch {'latents', 'context', 'uncond_context' (optional)}; without
    draws they come from `generator` (a CPU generator seeded 0 if None)."""

    def __init__(self, cfg: PipelineConfig, tc: TrainConfig, act_offload: bool = True,
                 device="cuda", stream_quant: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        if tc.grad_accum_steps != 1:
            raise ValueError("the streamed trainer takes one micro-batch a step")
        if tc.trainable_filters:
            raise ValueError("the streamed trainer trains every parameter "
                             "(StreamedLoRATrainer trains adapters)")
        if stream_quant not in (None, "int8"):
            raise ValueError(f"stream_quant {stream_quant!r} not in (None, 'int8')")
        if tc.optimizer not in Optimizer.RULES:
            raise ValueError(f"optimizer {tc.optimizer!r} not in {Optimizer.RULES}")
        self.cfg, self.tc = cfg, tc
        self.dit_cfg = cfg.dit.replace(text_len=cfg.max_context_len)
        self.act_offload = act_offload
        self.device = resolve_device(device)
        self.stream_quant = stream_quant
        self.gen = generator if generator is not None else torch.Generator().manual_seed(0)
        sched = lr_schedule(tc)
        self.rule = (_AdamWRule(tc, sched) if tc.optimizer == "adamw"
                     else _AdafactorRule(tc, sched))
        self.flow = _flow_table(tc, self.device)
        self.mover = _Mover(self.device)
        self._rings: Dict[int, DeviceRing] = {}
        self._acts: List[Optional[HostBuffer]] = []
        self._host_bufs: Dict[tuple, List[PackedBlock]] = {}  # grads, q8 copies: made once
        self._prefetched: Dict[int, Tuple[torch.Tensor, Any]] = {}
        self.template = block_template(self.dit_cfg)

    # -- state ---------------------------------------------------------------
    def init_state(self, wan: WanDiT) -> StreamedTrainState:
        """wan: the DiT with its master params (resident, or streamed by
        pipelines/streaming.py); its blocks move to host (page-locked on a
        card) and each block's rule state starts at zero there."""
        wan, blocks = split_host_params(wan)
        for _, p in wan.resident_parameters():
            p.requires_grad_(True)
        opt0 = self.rule.init(list(blocks[0].block().items()))
        packer = BlockPacker(_flat_opt(opt0))
        self._opt_like = opt0
        pin = self.device.type == "cuda"
        opts = []
        for _ in blocks:
            o = packer.empty(pin)
            o.data.zero_()
            opts.append(o)
        return StreamedTrainState(wan, self.rule.init(wan.resident_parameters()), blocks, opts, 0)

    def _ring(self, nbytes: int) -> DeviceRing:
        ring = self._rings.get(nbytes)
        if ring is None:
            ring = self._rings[nbytes] = DeviceRing(nbytes, 2, self.device)
            if self.mover.cuda:
                ring.copy = self.mover.copy  # one copy stream: write-backs precede reloads
        return ring

    def _opt_views(self, buf: torch.Tensor, packer: BlockPacker) -> Dict[str, Any]:
        return _unflat_opt(packer.views(buf), self._opt_like)

    # -- the step ------------------------------------------------------------
    def _inputs(self, wan: WanDiT, batch: Dict[str, torch.Tensor], draws: Optional[Draws]):
        dev = self.device
        batch = {k: v.to(dev) for k, v in batch.items()}
        latents = batch["latents"].float()
        if draws is None:
            draws = sample_draws(self.gen, latents.shape, self.tc)
        tid, noise, drop = draws
        context = batch["context"]
        if self.tc.cfg_dropout > 0 and "uncond_context" in batch:
            context = torch.where(drop.to(dev)[:, None, None], batch["uncond_context"], context)
        flow = self.flow
        t = flow.timesteps[tid.to(dev)]
        noise = noise.to(dev)
        noisy = flow.add_noise(latents, noise, t)
        target = flow.training_target(latents, noise, t)
        weights = flow.training_weight(t)
        return noisy.to(wan.param_dtype), t, context, target, weights

    def _save_act(self, i: int, h: torch.Tensor):
        """Block i's input: kept, or (act_offload) copied to a host buffer."""
        if not self.act_offload:
            return h
        while len(self._acts) <= i:
            self._acts.append(None)
        nb = h.numel() * h.element_size()
        if self._acts[i] is None or self._acts[i].data.numel() != nb:
            self._acts[i] = HostBuffer(nb, self.mover.cuda)
        dst = self._acts[i].data.view(h.dtype).view(h.shape)
        self.mover.to_host(h, dst)
        return dst

    def _next_act(self, saved: List[Any], i: int) -> torch.Tensor:
        """Block i's saved input on the device (pass A walks i downwards:
        with act_offload, block i−1's copy is started here, ahead of use)."""
        if not self.act_offload:
            return saved[i]
        pre = self._prefetched.pop(i, None) or self.mover.to_device(saved[i])
        if i > 0:
            self._prefetched[i - 1] = self.mover.to_device(saved[i - 1])
        self.mover.wait(pre[1])
        return pre[0]

    def _host_set(self, kind: str, packer: BlockPacker, n: int) -> List[PackedBlock]:
        """n host buffers of `packer`'s layout, page-locked on a card, made
        on first use and reused every step (registering host memory costs
        about as much as copying it)."""
        key = (kind, packer.nbytes, n)
        if key not in self._host_bufs:
            self._host_bufs[key] = [packer.empty(self.mover.cuda) for _ in range(n)]
        return self._host_bufs[key]

    def _q8_blocks(self, blocks: List[PackedBlock]) -> List[PackedBlock]:
        """The int8 stream copies of the host masters, made once a step."""
        qs = [quantize_block(b.block()) for b in blocks]
        out = self._host_set("q8", BlockPacker(qs[0]), len(blocks))
        for q, dst in zip(qs, out):
            fill_block(dst.block(), q)
        return out

    def _block_params(self, slot_views) -> Dict[str, torch.Tensor]:
        return dequantize_block(slot_views) if self.stream_quant else slot_views

    def _prologue(self, wan: WanDiT, noisy, t, context, grad: bool):
        with torch.set_grad_enabled(grad):
            pro = wan.prologue(noisy, t, context)
            hf0 = pro.h.float()
        aux = pro.aux._replace(e0=pro.aux.e0.detach(), context=pro.aux.context.detach())
        return pro, hf0, aux

    def _forward(self, stream: List[PackedBlock], h: torch.Tensor, aux, params_of) -> Tuple:
        """Stream the blocks forward, saving each input; (h, saved inputs)."""
        n, nb = len(stream), stream[0].nbytes
        saved: List[Any] = [None] * n
        out = [h]

        def fwd(i, slot):
            saved[i] = self._save_act(i, out[0])
            # the input as a leaf that wants a gradient: attention then takes the
            # training kernel, as the resident (remat) forward does; the graph
            # dies with the block's output
            x = out[0].detach().requires_grad_(True)
            with torch.enable_grad():
                y = run_block(self.template, params_of(i, slot[:nb]), x, aux, "unfused",
                              "unfused")
            out[0] = y.detach()

        _stream(self._ring(nb), list(range(n)), lambda i: [(stream[i].data, 0)], fwd)
        return out[0], saved

    def _head_loss(self, wan: WanDiT, h: torch.Tensor, e: torch.Tensor, grid, target, weights,
                   resident_grads: bool):
        """loss, d_h, d_e (the head's backward; the head params' .grad when
        resident_grads)."""
        hf = h.detach().requires_grad_(True)
        e_leaf = e.detach().requires_grad_(True)
        with torch.enable_grad():
            v = wan._head(hf, e_leaf, grid, "unfused")
            per = (v - target).square().mean(dim=(1, 2, 3, 4))
            loss = (weights * per).mean()
            if resident_grads:
                loss.backward()
                return loss.detach(), hf.grad, e_leaf.grad
            (d_h,) = torch.autograd.grad(loss, [hf])
        return loss.detach(), d_h, None

    def train_step(self, state: StreamedTrainState, batch: Dict[str, torch.Tensor],
                   draws: Optional[Draws] = None):
        tc, wan, dev = self.tc, state.resident, self.device
        n = len(state.host_blocks)
        res_leaves = wan.resident_parameters()
        for _, p in res_leaves:
            p.grad = None
        noisy, t, context, target, weights = self._inputs(wan, batch, draws)
        pro, hf0, aux = self._prologue(wan, noisy, t, context, True)
        q8 = self.stream_quant is not None
        stream = self._q8_blocks(state.host_blocks) if q8 else state.host_blocks
        spk = stream[0].packer

        h, saved = self._forward(stream, hf0.detach(), aux,
                                 lambda i, buf: self._block_params(spk.views(buf)))
        loss, d_h, d_e = self._head_loss(wan, h, pro.e, pro.grid, target, weights, True)
        del h

        # pass A: recompute each block in reverse, its grads to host (or, fused, its update)
        fused = not tc.grad_clip and not q8
        count = state.step
        opk = state.host_opts[0].packer
        npar, nopt = spk.nbytes, opk.nbytes
        gpk = BlockPacker(state.host_blocks[0].block())  # grads: the masters' layout
        grads_host: List[Any] = [None] * n
        d_e0 = torch.zeros_like(aux.e0)
        d_ctx = torch.zeros_like(aux.context)
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        carry = [d_h]

        def back(i, slot):
            nonlocal d_e0, d_ctx, sq
            views = spk.views(slot[:npar])
            dense = self._block_params(views)
            leaves = {k: v.detach().requires_grad_(True) for k, v in dense.items()}
            x = self._next_act(saved, i).requires_grad_(True)
            e0 = aux.e0.detach().requires_grad_(True)
            ctx = aux.context.detach().requires_grad_(True)
            with torch.enable_grad():
                out = run_block(self.template, leaves, x, aux._replace(e0=e0, context=ctx),
                                "unfused", "unfused")
                names = list(leaves)
                gs = torch.autograd.grad(out, [leaves[k] for k in names] + [x, e0, ctx],
                                         carry[0])
            g = dict(zip(names, gs[:len(names)]))
            carry[0], de0, dctx = gs[len(names):]
            saved[i] = None
            d_e0 = d_e0 + de0
            d_ctx = d_ctx + dctx
            sq = sq + torch.stack([v.float().square().sum() for v in g.values()]).sum()
            if fused:
                opt = self._opt_views(slot[npar:npar + nopt], opk)
                with torch.no_grad():
                    self.rule.apply(list(views.items()), g, opt, count)
                self.mover.to_host(slot[:npar], state.host_blocks[i].data)
                self.mover.to_host(slot[npar:npar + nopt], state.host_opts[i].data)
                return
            if q8:
                g = quantize_block(g)
            pk = BlockPacker(g)
            buf = torch.empty(pk.nbytes, dtype=torch.uint8, device=dev)
            fill_block(pk.views(buf), g)
            grads_host[i] = self._host_set("grads", pk, n)[i]
            self.mover.to_host(buf, grads_host[i].data)

        if fused:
            srcs = lambda i: [(stream[i].data, 0), (state.host_opts[i].data, npar)]  # noqa: E731
            ring = self._ring(npar + nopt)
        else:
            srcs = lambda i: [(stream[i].data, 0)]  # noqa: E731
            ring = self._ring(npar)
        _stream(ring, list(range(n - 1, -1, -1)), srcs, back)
        d_hf0 = carry[0]

        # the prologue's backward: the resident leaves' grads (the head's are in)
        torch.autograd.backward([hf0, pro.e, pro.aux.e0, pro.aux.context],
                                [d_hf0, d_e, d_e0, d_ctx])
        g_res = {nm: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for nm, p in res_leaves}
        sq = sq + torch.stack([v.float().square().sum() for v in g_res.values()]).sum()
        gnorm = sq.sqrt()
        clip = bool(tc.grad_clip) and float(gnorm) >= tc.grad_clip

        def clipped(g):
            return {k: (v / gnorm) * tc.grad_clip for k, v in g.items()} if clip else g

        with torch.no_grad():
            self.rule.apply(res_leaves, clipped(g_res), state.resident_opt, count)
        for _, p in res_leaves:
            p.grad = None
        self.mover.sync()
        if q8:  # pass B on the host CPU against the masters
            norm = gnorm.cpu()
            for i in range(n):
                g = dequantize_block(grads_host[i].block())
                if clip:
                    g = {k: (v / norm) * tc.grad_clip for k, v in g.items()}
                opt = self._opt_views(state.host_opts[i].data, opk)
                with torch.no_grad():
                    self.rule.apply(list(state.host_blocks[i].block().items()), g, opt, count)
                grads_host[i] = None
        elif not fused:  # pass B on the device: params, grads, state in; params, state out
            ngr = gpk.nbytes

            def upd(i, slot):
                views = spk.views(slot[:npar])
                g = gpk.views(slot[npar:npar + ngr])
                opt = self._opt_views(slot[npar + ngr:npar + ngr + nopt], opk)
                with torch.no_grad():
                    self.rule.apply(list(views.items()), clipped(g), opt, count)
                self.mover.to_host(slot[:npar], state.host_blocks[i].data)
                self.mover.to_host(slot[npar + ngr:npar + ngr + nopt], state.host_opts[i].data)

            _stream(self._ring(npar + ngr + nopt), list(range(n)),
                    lambda i: [(state.host_blocks[i].data, 0), (grads_host[i].data, npar),
                               (state.host_opts[i].data, npar + ngr)], upd)
        self.mover.sync()
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# streamed LoRA: the frozen base streams, the adapters train on the device
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamedLoRAState:
    """resident: the frozen DiT with its blocks on the host (host_blocks,
    no adapters); lora: {'blocks.i.<linear>.lora_a'/'lora_b': device f32
    leaf}; lora_scales: {'blocks.i.<linear>.lora_scale': 0-d tensor},
    frozen; lora_opt: one rule state over every adapter; step."""

    resident: WanDiT
    host_blocks: List[PackedBlock]
    lora: Dict[str, torch.Tensor]
    lora_scales: Dict[str, torch.Tensor]
    lora_opt: Dict[str, Any]
    step: int = 0

    def to_checkpoint(self) -> dict:
        """Adapters, their state and the step (the frozen base is rebuilt
        from where the run started)."""
        return {"kind": "streamed_lora",
                "lora": {k: v.detach().cpu() for k, v in self.lora.items()},
                "lora_opt": self.lora_opt, "step": self.step}

    def load_checkpoint(self, blob: dict) -> None:
        _check_kind(blob, "streamed_lora")
        with torch.no_grad():
            for k, v in self.lora.items():
                v.copy_(blob["lora"][k])
        dev = next(iter(self.lora.values())).device
        self.lora_opt = _to_device(blob["lora_opt"], dev)
        self.step = int(blob["step"])


class StreamedLoRATrainer(StreamedTrainer):
    """LoRA fine-tuning of a DiT whose frozen base lives in host memory
    (module docstring). The rule state spans every adapter, named as the
    resident LoRA step names them ('blocks.i.self_attn.q.lora_a'), so its
    update is the resident step's; grad_norm is over the adapters (the
    resident step's once `freeze_base` has run)."""

    def __init__(self, cfg: PipelineConfig, tc: TrainConfig, act_offload: bool = True,
                 device="cuda", base_quant: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, dataclasses.replace(tc, trainable_filters=()), act_offload,
                         device, None, generator)
        if base_quant not in (None, "int8"):
            raise ValueError(f"base_quant {base_quant!r} not in (None, 'int8')")
        self.base_quant = base_quant
        self._base_key: Optional[tuple] = None
        self._base: List[PackedBlock] = []

    def init_state(self, wan: WanDiT, adapters: Optional[Dict[str, tuple]] = None
                   ) -> StreamedLoRAState:
        """wan: the base DiT, resident with adapters attached to its blocks
        (training/lora.py `inject_lora`) or streamed with `adapters`
        ({linear name: (A, B, scale)}, `draw_lora`). The adapters move to
        (and stay on) the device; the blocks go to host without them."""
        from ..ops.lora import has_lora
        from ..training.lora import remove_adapter

        dev = self.device
        if adapters is None:
            if wan.streamed:
                raise ValueError("a streamed DiT's adapters must be given (draw_lora)")
            adapters = {}
            for name, m in wan.blocks.named_modules():
                if isinstance(m, torch.nn.Linear) and has_lora(m):
                    adapters[f"blocks.{name}"] = (m.lora_a.detach(), m.lora_b.detach(),
                                                  m.lora_scale.detach())
                    remove_adapter(m)
        if not adapters:
            raise ValueError("no adapters: inject_lora the blocks first")
        wan, blocks = split_host_params(wan)
        for _, p in wan.resident_parameters():
            p.requires_grad_(False)
        lora, scales = {}, {}
        for name, (a, b, s) in adapters.items():
            lora[f"{name}.lora_a"] = a.detach().to(dev, torch.float32).clone().requires_grad_(True)
            lora[f"{name}.lora_b"] = b.detach().to(dev, torch.float32).clone().requires_grad_(True)
            scales[f"{name}.lora_scale"] = s.detach().to(dev, torch.float32).clone()
        self.template = block_template(self.dit_cfg, [k.split(".", 2)[2] for k in lora])
        return StreamedLoRAState(wan, blocks, lora, scales, self.rule.init(list(lora.items())))

    def _base_stream(self, blocks: List[PackedBlock]) -> List[PackedBlock]:
        """The base as it crosses the link (int8 with base_quant: quantised
        on the device, once per base, as the executor does)."""
        if self.base_quant is None:
            return blocks
        key = tuple(id(b) for b in blocks)
        if self._base_key != key:
            self._base = quantized_blocks(blocks, self.device)
            self._base_key = key
        return self._base

    def _adapters(self, state: StreamedLoRAState, i: int) -> Dict[str, torch.Tensor]:
        pre = f"blocks.{i}."
        return {k[len(pre):]: v for d in (state.lora, state.lora_scales) for k, v in d.items()
                if k.startswith(pre)}

    def train_step(self, state: StreamedLoRAState, batch: Dict[str, torch.Tensor],
                   draws: Optional[Draws] = None):
        tc, wan = self.tc, state.resident
        n = len(state.host_blocks)
        noisy, t, context, target, weights = self._inputs(wan, batch, draws)
        pro, hf0, aux = self._prologue(wan, noisy, t, context, False)
        stream = self._base_stream(state.host_blocks)
        spk = stream[0].packer
        deq = dequantize_block if self.base_quant else (lambda b: b)

        def params(i, buf):
            return {**deq(spk.views(buf)), **self._adapters(state, i)}

        h, saved = self._forward(stream, hf0, aux, params)
        loss, d_h, _ = self._head_loss(wan, h, pro.e, pro.grid, target, weights, False)
        del h
        grads: Dict[str, torch.Tensor] = {}
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        carry = [d_h]
        nb = spk.nbytes

        def back(i, slot):
            nonlocal sq
            p = params(i, slot[:nb])
            x = self._next_act(saved, i).requires_grad_(True)
            trained = [k for k in p if k.endswith(("lora_a", "lora_b"))]
            with torch.enable_grad():
                out = run_block(self.template, p, x, aux, "unfused", "unfused")
                gs = torch.autograd.grad(out, [p[k] for k in trained] + [x], carry[0])
            saved[i] = None
            carry[0] = gs[-1]
            for k, g in zip(trained, gs[:-1]):
                grads[f"blocks.{i}.{k}"] = g
            sq = sq + torch.stack([g.float().square().sum() for g in gs[:-1]]).sum()

        _stream(self._ring(nb), list(range(n - 1, -1, -1)),
                lambda i: [(stream[i].data, 0)], back)
        gnorm = sq.sqrt()
        g = {k: grads[k] for k in state.lora}
        if tc.grad_clip and float(gnorm) >= tc.grad_clip:
            g = {k: (v / gnorm) * tc.grad_clip for k, v in g.items()}
        with torch.no_grad():
            self.rule.apply(list(state.lora.items()), g, state.lora_opt, state.step)
        self.mover.sync()
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    def export_params(self, state: StreamedLoRAState) -> Dict[str, torch.Tensor]:
        """The whole DiT as a host state dict with the adapters grafted onto
        their Linears ('blocks.i.<linear>.lora_a' ...: the names
        training/lora.py `merge_lora_state_dict` folds, and JAX's
        `export_params`' content); block weights are views of the host
        blocks."""
        sd = {n: p.detach().cpu() for n, p in state.resident.resident_parameters()}
        for i, b in enumerate(state.host_blocks):
            for k, v in b.block().items():
                sd[f"blocks.{i}.{k}"] = v
        for d in (state.lora, state.lora_scales):
            sd.update({k: v.detach().cpu() for k, v in d.items()})
        return sd

    def export_adapters(self, state: StreamedLoRAState) -> Dict[str, Dict[str, Any]]:
        """The adapters in JAX's form {path: {key: [L, ...] array}}
        (training/lora.py `write_adapters_npz` writes it)."""
        from .lora import _dense_site

        per: Dict[str, Dict[str, dict]] = {}
        for d in (state.lora, state.lora_scales):
            for k, v in d.items():
                lin, key = k.rsplit(".", 1)
                site = _dense_site(lin, None)
                per.setdefault(site.path, {}).setdefault(key, {})[site.layer] = (
                    v.detach().float().cpu().numpy())
        import numpy as np

        return {p: {k: np.stack([by[i] for i in sorted(by)]) for k, by in keys.items()}
                for p, keys in per.items()}
