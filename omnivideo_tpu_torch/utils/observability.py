"""Training-loop observability (port of the loop half of
omnivideo_tpu/utils/observability.py): a JSONL metrics writer with optional
TensorBoard scalars, and the two stop guards a training loop polls (walltime
and SIGTERM preemption); and `StepTimes`, the denoise loops' per-step
synchronized wall times. Device traces are `torch.profiler`'s, used directly.
"""

from __future__ import annotations

import json
import logging
import signal
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

log = logging.getLogger(__name__)


class StepTimes:
    """Each denoise step's wall time, the device synchronized at every lap
    (the steps of a pipeline then cannot overlap the host's next launches,
    which costs nothing at a step of seconds)."""

    def __init__(self, device):
        self.device = device
        self.steps: List[float] = []
        self._sync()
        self.t0 = self.t = time.perf_counter()

    def _sync(self) -> None:
        if getattr(self.device, "type", None) == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def lap(self) -> None:
        self._sync()
        now = time.perf_counter()
        self.steps.append(now - self.t)
        self.t = now

    def timings(self) -> Dict[str, Union[float, List[float]]]:
        """{"denoise_s", "denoise_step_s" (the mean), "step_s" (each)}."""
        total = self.t - self.t0
        return {"denoise_s": total, "denoise_step_s": total / max(1, len(self.steps)),
                "step_s": list(self.steps)}


class TimeoutGuard:
    """Stop before a walltime limit, `safety_margin_s` early."""

    def __init__(self, walltime_s: Optional[float], safety_margin_s: float = 300.0):
        self.deadline = time.monotonic() + walltime_s - safety_margin_s if walltime_s else None

    def should_stop(self) -> bool:
        return self.deadline is not None and time.monotonic() >= self.deadline


class PreemptionGuard:
    """SIGTERM-aware stop flag: on the signal the loop checkpoints and exits."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = False
        for s in signals:
            try:
                signal.signal(s, self._handler)
            except ValueError:  # not in the main thread
                pass

    def _handler(self, signum, frame):
        log.warning("received signal %s — requesting graceful stop", signum)
        self._stop = True

    def should_stop(self) -> bool:
        return self._stop


class MetricsLogger:
    """`metrics.jsonl` (one {"step", "time", **scalars} line per call), mirrored
    to TensorBoard when `torch.utils.tensorboard` can be loaded."""

    def __init__(self, directory: str):
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        self._f = open(d / "metrics.jsonl", "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(str(d / "tb"))
        except ImportError:  # the tensorboard package is optional
            self._tb = None

    def log(self, step: int, **scalars):
        rec = {"step": step, "time": time.time(), **{k: float(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
