"""Device mesh (port of omnivideo_tpu/parallel/mesh.py).

One `torch.distributed.device_mesh.DeviceMesh` over the process group with
the JAX package's axis names ('data', 'fsdp', 'seq', 'tensor'); each axis
has its process group (`mesh.get_group(axis)`) and this process's place on
it (`mesh.get_local_rank(axis)`). Rank order is row-major over the four
axes, as `np.reshape` lays the JAX devices out. 'data' splits the batch,
'fsdp' shards parameters (FSDP2, parallel/sharding.py) and is the Ulysses
axis of the hybrid mode, 'seq' shards tokens (sequence parallelism) and
'tensor' heads and FFN columns (parallel/tp.py). `axis_size` and
`axis_index` read one axis and take None for "no mesh" (size 1, index 0);
`batch_slice` is the rows of a global batch this process's data index
holds.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """Ranks along `axis` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_index(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This process's place along `axis` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def batch_slice(mesh: Optional[DeviceMesh], global_batch: int) -> Tuple[int, int]:
    """(start, stop) of this process's rows of a global batch split over
    'data' (ranks that share a data index hold the same rows)."""
    dp = axis_size(mesh, "data")
    if global_batch % dp:
        raise ValueError(f"global batch {global_batch} does not divide over data = {dp}")
    n = global_batch // dp
    i = axis_index(mesh, "data")
    return i * n, (i + 1) * n
