"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch
import torch.distributed as dist


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The device an entry point runs on. Defaults to CUDA; raises when CUDA
    is asked for (explicitly or by default) and no CUDA device exists — the
    port never moves to the CPU quietly. Under an NCCL process group a bare
    "cuda" names this process's own card (the one
    `parallel.distributed.maybe_initialize_distributed` set)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "omnivideo_tpu_torch: no CUDA device available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if (dev.type == "cuda" and dev.index is None and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
