"""Deterministic fault injection for resilience testing (port of
omnivideo_tpu/utils/chaos.py).

A seeded context makes chosen filesystem operations fail with a given
probability, so the port's fault-tolerance paths run under test rather than
for the first time in production: training/dataset.py's retry-on-corrupt
with seeded substitution (`OmniVideoDataset.__getitem__`), utils/video.py's
`save_video` retries, a checkpoint save (`inject_call_faults`).

    with inject_io_faults(rate=0.3, seed=0, match="*.npz"):
        batch = next(loader)   # some loads raise; retry path must absorb

Implementation: patches builtins.open and numpy.load to raise IOError on a
seeded Bernoulli draw when the target path matches. Thread-safe within one
context; nesting composes (outermost wins on conflicting matches).
"""

from __future__ import annotations

import builtins
import contextlib
import fnmatch
import random
from typing import Iterator, Optional

import numpy as np


class FaultInjector:
    """Seeded fault source — one draw per *matching* operation."""

    def __init__(self, rate: float, seed: int, match: str = "*"):
        assert 0.0 <= rate <= 1.0
        self.rate = rate
        self.match = match
        self._rng = random.Random(seed)
        self.injected = 0  # observability: how many faults actually fired

    def should_fail(self, path) -> bool:
        p = str(path)
        if not fnmatch.fnmatch(p, self.match):
            return False
        if self._rng.random() < self.rate:
            self.injected += 1
            return True
        return False


@contextlib.contextmanager
def inject_io_faults(rate: float, seed: int = 0,
                     match: str = "*") -> Iterator[FaultInjector]:
    """Make open()/np.load() on matching paths raise IOError at `rate`."""
    inj = FaultInjector(rate, seed, match)
    real_open = builtins.open
    real_load = np.load

    def chaotic_open(file, *a, **kw):
        if inj.should_fail(file):
            raise IOError(f"[chaos] injected open failure: {file}")
        return real_open(file, *a, **kw)

    def chaotic_load(file, *a, **kw):
        if inj.should_fail(file):
            raise IOError(f"[chaos] injected load failure: {file}")
        return real_load(file, *a, **kw)

    builtins.open = chaotic_open
    np.load = chaotic_load
    try:
        yield inj
    finally:
        builtins.open = real_open
        np.load = real_load


@contextlib.contextmanager
def inject_call_faults(obj, attr: str, rate: float, seed: int = 0,
                       exc: Optional[type] = None) -> Iterator[FaultInjector]:
    """Make obj.attr(...) raise at `rate` — for non-IO seams (e.g. a
    checkpoint manager's save, a remote API client)."""
    inj = FaultInjector(rate, seed)
    real = getattr(obj, attr)
    err = exc or RuntimeError

    def chaotic(*a, **kw):
        if inj.should_fail("call"):
            raise err(f"[chaos] injected failure in {attr}")
        return real(*a, **kw)

    setattr(obj, attr, chaotic)
    try:
        yield inj
    finally:
        setattr(obj, attr, real)
