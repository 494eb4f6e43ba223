"""Training checkpoint save/resume (port of omnivideo_tpu/training/
checkpoint.py, which uses orbax; here `torch.save`).

`directory/<step>/state.pt` holds the parameters' state dict, the optimizer
state and the step; `meta.json` beside it the caller's metadata. A step is
written to a temporary directory and renamed into place, so a crash never
leaves a half-written step for `latest_step` to find; the newest
`max_to_keep` steps are kept.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional

import torch

from .trainer import TrainState


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
        tmp = self.dir / f".{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        torch.save({"params": state.params.state_dict(), "opt_state": state.opt_state,
                    "step": state.step}, tmp / "state.pt")
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
        dev = next(state_like.params.parameters()).device
        blob = torch.load(self.dir / str(step) / "state.pt", map_location=dev,
                          weights_only=True)
        state_like.params.load_state_dict(blob["params"])
        state_like.opt_state = blob["opt_state"]  # map_location put its tensors on dev
        state_like.step = int(blob["step"])
        return state_like
