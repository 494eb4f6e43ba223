"""Process-group bring-up (port of omnivideo_tpu/parallel/distributed.py).

The JAX package calls `jax.distributed.initialize`; the port starts a
`torch.distributed` process group, one process per card. The rendezvous
comes from the flags, else from torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT); without either the run is a single
process and nothing happens.

    torchrun --nproc_per_node 4 -m omnivideo_tpu_torch.tools.generate --sp_size 4 ...

On the card the group is NCCL and each process first takes its own card,
`cuda:LOCAL_RANK` (`resolve_device("cuda")` then names that card); gloo runs
only when the caller asks for the CPU.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

log = logging.getLogger(__name__)


def maybe_initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    local_rank: Optional[int] = None,
) -> bool:
    """Start the default process group when the run has one. Returns True
    if `init_process_group` was called. Resolution: the arguments (the CLI
    flags; `coordinator_address` is host:port of process 0), then torchrun's
    environment, else a single process (no-op). `device` "cuda" (default)
    takes card `local_rank` (default LOCAL_RANK, else the process id) and
    NCCL; "cpu" takes gloo."""
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None:
        return False  # single process
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator {coordinator_address} given without the process count "
                         "and id (--num_processes, --process_id, or WORLD_SIZE and RANK)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if local_rank is None:
            local_rank = int(env["LOCAL_RANK"]) if env.get("LOCAL_RANK") else process_id
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    log.info("torch.distributed initialized (%s): rank %d of %d", backend, process_id,
             num_processes)
    return True


def add_distributed_args(parser) -> None:
    """The rendezvous flags (torchrun's environment is read without them)."""
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0 (MASTER_ADDR/MASTER_PORT also honoured)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="total number of processes, one per card (WORLD_SIZE)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this process's rank, 0-based (RANK)")
