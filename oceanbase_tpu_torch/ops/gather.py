"""Multi-column row gather over kernel K4.

Counterpart of `oceanbase_tpu/ops/gather.py`: every payload column of a
batch by one index array, in one launch. The JAX package's int32-plane
packing into (N, 8) matrices was a TPU gather workaround and has no
counterpart here.
"""

from __future__ import annotations

import torch

from ..kernels import gather_columns


def gather_rows(cols: dict, idx: torch.Tensor) -> dict:
    """{name: column[idx]} for every column (common length)."""
    if not cols:
        return {}
    names = list(cols)
    out = gather_columns([cols[n] for n in names], idx)
    return dict(zip(names, out))
