"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The device an entry point runs on. Defaults to CUDA; raises when CUDA
    is asked for (explicitly or by default) and no CUDA device exists — the
    port never moves to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "omnivideo_tpu_torch: no CUDA device available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
