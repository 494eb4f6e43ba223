"""Ahead-of-time export of the DiT denoise step for serving (port of
tools/export_aot.py).

The JAX tool serializes the jitted CFG-2 denoise forward as StableHLO with
the weights as call-time arguments. Here the same function of
(params, x, t, ctx), the DiT's tensors bound from `params` by
`torch.func.functional_call`, is traced by `torch.export` and written with
`torch.export.save` as a `.pt2` program: the weights are inputs, not in the
artifact. The kernels of the forward are the registered ops of
`omnivideo_tpu_torch.ops` (`omnivideo::qk_prep`, `omnivideo::flash_attention`,
and `omnivideo::fused_adaln` in the f32-residual mode), held in the program
as calls: loading it needs only `import omnivideo_tpu_torch.ops`, and the
loaded program launches the same hand-written kernels as the eager forward.

Shapes: latents [2, z, (F-1)/4+1, H/8, W/8] bf16, t [2] f32, ctx
[2, max_context_len, text_dim] bf16. `--residual_dtype bfloat16` (the
serving default) exports the bf16 residual stream with the unfused
sandwich; `float32` the parity stream with the fused AdaLN sandwich
(`ew_impl="kernel"`), as tools/serve.py builds them.

    python -m omnivideo_tpu_torch.tools.export_aot --tiny --device cpu --out /tmp/dit.pt2
    python -m omnivideo_tpu_torch.tools.export_aot --tiny --device cpu --load /tmp/dit.pt2 --check

The device defaults to cuda; `--device cpu` traces and runs the plain twins.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
from torch import nn

import omnivideo_tpu_torch.ops  # noqa: F401  (registers the omnivideo:: ops)
from omnivideo_tpu_torch.configs import WAN_CONFIGS
from omnivideo_tpu_torch.configs.base import PipelineConfig
from omnivideo_tpu_torch.device import resolve_device
from omnivideo_tpu_torch.models.wan_dit import WanDiT

RESIDUAL_DTYPES = ("bfloat16", "float32")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--task", default="t2v-1.3B")
    p.add_argument("--size", default="832*480")
    p.add_argument("--frame_num", type=int, default=81)
    p.add_argument("--out", default=None, help="write the .pt2 program here")
    p.add_argument("--load", default=None, help="load a .pt2 program (and call it with --check)")
    p.add_argument("--check", action="store_true",
                   help="after --load, call the program once on seeded weights")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--residual_dtype", default="bfloat16", choices=RESIDUAL_DTYPES)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def task_config(task: str, tiny: bool = False) -> PipelineConfig:
    """The task's config; `tiny` takes the JAX tool's tiny widths."""
    cfg = WAN_CONFIGS[task]
    if tiny:
        cfg = cfg.replace(
            dit=cfg.dit.replace(dim=128, ffn_dim=256, num_heads=4, num_layers=2, freq_dim=32,
                                text_dim=64),
            max_context_len=64)
    return cfg


def input_shapes(cfg: PipelineConfig, size: Tuple[int, int], frame_num: int
                 ) -> Tuple[tuple, tuple, tuple]:
    """(x, t, ctx) shapes of the CFG-2 step at `size` = (W, H)."""
    w, h = size
    vs = cfg.vae.vae_stride
    lat = (cfg.vae.z_dim, (frame_num - 1) // vs[0] + 1, h // vs[1], w // vs[2])
    return (2,) + lat, (2,), (2, cfg.max_context_len, cfg.dit.text_dim)


def dit_params(dit: nn.Module) -> Dict[str, torch.Tensor]:
    """Every tensor the forward reads, by name, detached: the program's
    `params` argument."""
    out = {k: v.detach() for k, v in dit.named_parameters()}
    out.update({k: v.detach() for k, v in dit.named_buffers()})
    return out


def ew_impl_for(residual_dtype: torch.dtype) -> str:
    """The f32 parity stream fuses its AdaLN sandwiches (kernel row 7); the
    bf16 stream runs them unfused, as the kernel needs an f32 stream."""
    return "kernel" if residual_dtype == torch.float32 else "unfused"


class DenoiseStep(nn.Module):
    """The CFG-2 denoise forward as a function of (params, x, t, ctx). The
    DiT is held outside the module tree, so the module has no state of its
    own: every tensor the forward reads is bound from `params`."""

    def __init__(self, dit: WanDiT, residual_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        object.__setattr__(self, "dit", dit)  # a template, not a submodule
        self.residual_dtype = residual_dtype

    def forward(self, params: Dict[str, torch.Tensor], x: torch.Tensor, t: torch.Tensor,
                ctx: torch.Tensor) -> torch.Tensor:
        kw = dict(residual_dtype=self.residual_dtype, qk_impl="kernel",
                  ew_impl=ew_impl_for(self.residual_dtype))
        return torch.func.functional_call(self.dit, params, (x, t, ctx), kw)


def export_denoise(dit: WanDiT, x: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor,
                   residual_dtype: torch.dtype = torch.bfloat16):
    """torch.export of `DenoiseStep(dit)` at these inputs' shapes. The RoPE
    tables of the latent grid are made first, so the program holds them as
    constants (they are not weights)."""
    pt, ph, pw = dit.cfg.patch_size
    dit.rope_tables((x.shape[2] // pt, x.shape[3] // ph, x.shape[4] // pw))
    with torch.no_grad():
        return torch.export.export(DenoiseStep(dit, residual_dtype),
                                   (dit_params(dit), x, t, ctx))


def save_program(prog, path) -> int:
    """`torch.export.save` without the example inputs, which would carry the
    weights (the `params` argument) into the file. Returns the bytes."""
    prog.example_inputs = None
    torch.export.save(prog, str(path))
    return Path(path).stat().st_size


def seeded_dit(cfg: PipelineConfig, device, seed: int = 0) -> WanDiT:
    """The bf16 DiT of `cfg` from a seeded init (the zero-init head filled
    with N(0, 1/√dim), so the output depends on every block)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dit = WanDiT(cfg.dit.replace(text_len=cfg.max_context_len), dtype=torch.bfloat16,
                 device=device, generator=gen)
    with torch.no_grad():
        dit.head.head.weight.normal_(0.0, cfg.dit.dim**-0.5, generator=gen)
    return dit


def _size(args) -> Tuple[Tuple[int, int], int]:
    if args.tiny:
        return (64, 32), min(args.frame_num, 9)
    w, h = (int(v) for v in args.size.split("*"))
    return (w, h), args.frame_num


def check_inputs(shapes, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tool's --check inputs: zero latents and context at t = 500."""
    xs, ts, cs = shapes
    return (torch.zeros(xs, dtype=torch.bfloat16, device=device),
            torch.full(ts, 500.0, dtype=torch.float32, device=device),
            torch.zeros(cs, dtype=torch.bfloat16, device=device))


def main(argv=None) -> Optional[torch.Tensor]:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = task_config(args.task, args.tiny)
    size, frame_num = _size(args)
    shapes = input_shapes(cfg, size, frame_num)
    rdt = getattr(torch, args.residual_dtype)

    if args.load:
        t0 = time.perf_counter()
        prog = torch.export.load(args.load)
        nbytes = Path(args.load).stat().st_size
        print(f"loaded {args.load}: {nbytes} bytes in {time.perf_counter() - t0:.2f}s")
        if not args.check:
            return None
        params = dit_params(seeded_dit(cfg, dev))
        x, t, c = check_inputs(shapes, dev)
        t0 = time.perf_counter()
        out = prog.module()(params, x, t, c)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"program call OK: out {tuple(out.shape)} {out.dtype} "
              f"({time.perf_counter() - t0:.2f}s)")
        return out

    dit = seeded_dit(cfg, dev)
    x, t, c = check_inputs(shapes, dev)
    t0 = time.perf_counter()
    prog = export_denoise(dit, x, t, c, rdt)
    out = args.out or f"dit_{args.task}.pt2"
    nbytes = save_program(prog, out)
    print(f"exported {out}: {nbytes} bytes in "
          f"{time.perf_counter() - t0:.2f}s (x={shapes[0]}, ctx={shapes[2]}, "
          f"residual {args.residual_dtype})")
    return None


if __name__ == "__main__":
    main()
