"""Training checkpoint save/resume (port of omnivideo_tpu/training/
checkpoint.py, which uses orbax; here `torch.save`).

`directory/<step>/state.pt` holds the parameters' state dict (LoRA adapters
and their scale buffers included), the optimizer state (AdamW's moments or
adafactor's statistics, the count, MultiSteps' accumulator) and the step;
`meta.json` beside it the caller's metadata. A step is
written to a temporary directory and renamed into place, so a crash never
leaves a half-written step for `latest_step` to find; the newest
`max_to_keep` steps are kept.

Under a process group of more than one process the file holds the full,
unsharded state whatever the mesh: every process joins the gather (`get_model_state_dict` with full-state options;
the optimizer's sharded tensors through `full_tensor`), rank 0 alone writes,
and the others wait at a barrier. Every process restores from the full
file and re-shards it onto its own parameters (`set_model_state_dict`), so
a step written under one mesh resumes under another, or in one process.
Adafactor's row and column statistics, which lack one of their parameter's
dims, are spread along it for the re-sharding and sliced back.

The streamed trainers' states (training/streaming.py) save and restore
themselves (`to_checkpoint` / `load_checkpoint`): the full trainer's
resident leaves and their rule state, every host block and its packed rule
state, and the step; the LoRA trainer's adapters, their rule state and the
step (its frozen base is rebuilt from where the run started). One process.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.checkpoint.state_dict import (
    StateDictOptions,
    get_model_state_dict,
    set_model_state_dict,
)
from torch.distributed.tensor import DTensor

from .trainer import TrainState

_OPT_TENSORS = ("mu", "nu", "acc", "v", "v_row", "v_col")  # AdamW, MultiSteps, adafactor
_REDUCED = {"v_row": 1, "v_col": 0}  # the index in opt_state["factored"][name] of the dim dropped


def _sharded(module) -> bool:
    return any(isinstance(p, DTensor) for p in module.parameters())


def _full_opt_state(opt_state: dict) -> dict:
    """The optimizer state with every DTensor gathered, on the host (a
    collective where the state is sharded: every process calls it)."""
    out = {}
    for k, v in opt_state.items():
        if k in _OPT_TENSORS:
            out[k] = {n: (t.full_tensor() if isinstance(t, DTensor) else t).cpu()
                      for n, t in v.items()}
        else:
            out[k] = v
    return out


@torch.no_grad()
def _load_sharded(model, full_params: dict, opt_like: dict, full_opt: dict) -> dict:
    """Re-shard a full state onto `model` (sharded) and an optimizer state
    shaped like `opt_like`: each optimizer tree is loaded into the
    parameters by set_model_state_dict and copied out of their shards,
    then the parameters themselves are loaded."""
    opts = StateDictOptions(full_state_dict=True, strict=False)
    params = dict(model.named_parameters())
    out = dict(full_opt)
    for k in _OPT_TENSORS:
        if k not in opt_like:
            continue
        full, dropped = dict(full_opt[k]), {}
        if k in _REDUCED:  # adafactor's row/column statistics: spread over the dim they reduce
            for n, t in full.items():
                d = full_opt["factored"][n][_REDUCED[k]]
                dropped[n] = d
                full[n] = t.unsqueeze(d).expand(params[n].shape)
        set_model_state_dict(model, full, options=opts)
        out[k] = {}
        for n, t in opt_like[k].items():
            src = params[n].to_local() if isinstance(params[n], DTensor) else params[n]
            if n in dropped:
                src = src.select(dropped[n], 0)
            dst = torch.empty_like(t)
            (dst.to_local() if isinstance(dst, DTensor) else dst).copy_(src)
            out[k][n] = dst
    set_model_state_dict(model, full_params, options=opts)
    return out


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = Path(directory).absolute()
        self.max_to_keep = max_to_keep

    def steps(self):
        if not self.dir.is_dir():
            return []
        return sorted(int(p.name) for p in self.dir.iterdir()
                      if p.name.isdigit() and (p / "state.pt").exists())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, metadata: Optional[dict] = None) -> Path:
        final = self.dir / str(step)
        if hasattr(state, "to_checkpoint"):  # a streamed trainer's state
            return self._write_blob(final, step, state.to_checkpoint(), metadata)
        if dist.is_initialized() and dist.get_world_size() > 1:
            params = get_model_state_dict(
                state.params, options=StateDictOptions(full_state_dict=True, cpu_offload=True))
            opt_state = _full_opt_state(state.opt_state)
            if dist.get_rank() == 0:
                self._write(final, step, params, opt_state, state.step, metadata)
            dist.barrier()
            return final
        return self._write(final, step, state.params.state_dict(), state.opt_state, state.step,
                           metadata)

    def _write(self, final: Path, step: int, params: dict, opt_state: dict, at: int,
               metadata: Optional[dict]) -> Path:
        return self._write_blob(final, step, {"params": params, "opt_state": opt_state,
                                              "step": at}, metadata)

    def _write_blob(self, final: Path, step: int, blob: dict, metadata: Optional[dict]) -> Path:
        tmp = self.dir / f".{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        torch.save(blob, tmp / "state.pt")
        (tmp / "meta.json").write_text(json.dumps(metadata or {}))
        shutil.rmtree(final, ignore_errors=True)
        tmp.rename(final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self.dir / str(old), ignore_errors=True)
        return final

    def restore(self, state_like: TrainState, step: Optional[int] = None) -> TrainState:
        """Load a step (default: the latest) into state_like's parameters and
        optimizer state, on their device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        if hasattr(state_like, "load_checkpoint"):  # a streamed trainer's state
            state_like.load_checkpoint(torch.load(self.dir / str(step) / "state.pt",
                                                  map_location="cpu", weights_only=True))
            return state_like
        dev = next(state_like.params.parameters()).device
        blob = torch.load(self.dir / str(step) / "state.pt", map_location=dev,
                          weights_only=True)
        if _sharded(state_like.params):
            state_like.opt_state = _load_sharded(state_like.params, blob["params"],
                                                 state_like.opt_state, blob["opt_state"])
        else:
            state_like.params.load_state_dict(blob["params"])
            state_like.opt_state = blob["opt_state"]  # map_location put its tensors on dev
        state_like.step = int(blob["step"])
        return state_like
