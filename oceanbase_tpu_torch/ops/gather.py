"""Multi-column row gather over kernel K4.

Counterpart of `oceanbase_tpu/ops/gather.py`: every payload column of a
batch by one index array, in one launch (a VECTOR column in one more). The JAX package's int32-plane
packing into (N, 8) matrices was a TPU gather workaround and has no
counterpart here.
"""

from __future__ import annotations

import torch

from ..kernels import gather_columns


def gather_rows(cols: dict, idx: torch.Tensor) -> dict:
    """{name: column[idx]} for every column (common length). Flat columns
    share one launch; a 2-D column (a VECTOR column, (n, d) float32)
    gathers its flattened elements by the row index expanded to
    idx * d + j, in a launch of its own."""
    if not cols:
        return {}
    flat = [n for n, c in cols.items() if c.dim() == 1]
    out = dict(zip(flat, gather_columns([cols[n] for n in flat], idx)))
    for n, c in cols.items():
        if c.dim() == 1:
            continue
        rows, width = int(c.shape[0]), int(c[0].numel()) if len(c) else 0
        j = idx.to(torch.int64).clamp(0, max(rows - 1, 0)) * width
        eidx = (j[:, None] + torch.arange(width, device=idx.device)).reshape(-1)
        (g,) = gather_columns([c.reshape(-1)], eidx.to(torch.int32))
        out[n] = g.reshape((idx.shape[0],) + tuple(c.shape[1:]))
    return {n: out[n] for n in cols}
