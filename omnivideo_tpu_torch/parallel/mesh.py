"""Device mesh (port of omnivideo_tpu/parallel/mesh.py).

One `torch.distributed.device_mesh.DeviceMesh` over the process group with
the JAX package's axis names ('data', 'fsdp', 'seq', 'tensor'); each axis
has its process group (`mesh.get_group(axis)`) and this process's place on
it (`mesh.get_local_rank(axis)`). Rank order is row-major over the four
axes, as `np.reshape` lays the JAX devices out. The port runs the 'seq'
axis (sequence parallelism) and the 'fsdp' axis as the Ulysses axis of the
hybrid mode; parameter sharding over 'fsdp' and tensor parallelism come
with the FSDP/TP slice.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

AXES = ("data", "fsdp", "seq", "tensor")


def create_mesh(dp: int = 1, fsdp: int = 1, sp: int = 1, tp: int = 1,
                device: Optional[str] = None) -> DeviceMesh:
    """A (dp, fsdp, sp, tp) mesh over the default process group, whose size
    must be the product. `device` defaults to the group's: "cuda" under
    NCCL, "cpu" under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh: no process group; call "
                           "parallel.distributed.maybe_initialize_distributed first")
    n = dp * fsdp * sp * tp
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {dp}x{fsdp}x{sp}x{tp} needs {n} processes, "
                         f"the group has {dist.get_world_size()}")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(resolve_device(device).type, (dp, fsdp, sp, tp), mesh_dim_names=AXES)
