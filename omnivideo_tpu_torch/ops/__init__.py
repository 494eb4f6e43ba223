"""Ops of the port: norms, rope, attention, the MoE's grouped products and the
CUDA kernels with their plain PyTorch twins.

Importing this package registers the inference kernels of the DiT's path
as PyTorch ops under the `omnivideo` namespace: `omnivideo::flash_attention`
(ops/flash_attention.py), `omnivideo::qk_prep` (ops/qk_prep.py) and
`omnivideo::fused_adaln` (ops/fused_adaln.py). A `torch.export` program of
the DiT holds them as calls, so loading one needs only this import.

It also exports the MoE's grouped products (ops/gmm.py): `gmm` (row 9),
`tgmm` (row 9b) and `GroupedMatmul`, their autograd function; each kernel
counts its launches in `gmm.launches` and `tgmm.launches`."""

from . import flash_attention, fused_adaln, qk_prep  # noqa: F401  (registers the ops)
from .gmm import GroupedMatmul, gmm, tgmm  # noqa: F401
