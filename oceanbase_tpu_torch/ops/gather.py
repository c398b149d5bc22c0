"""Multi-column row gather over kernel K4.

Counterpart of `oceanbase_tpu/ops/gather.py`: every payload column of a
batch by one index array, in one call (a VECTOR column in one more), under
jnp's gather rule (an index below 0 counts from the end, then clamped).
The JAX package packs int32 planes 8 to a row so that one TPU row gather
fetches every column of a row; K4 does the same on the card where it pays
(`kernels.k4_route`): a random read there moves a whole 32-byte sector, so
one packed row of a large source costs one sector where its columns cost
one each.
"""

from __future__ import annotations

import torch

from ..kernels import gather_columns, k4_norm_index


def gather_rows(cols: dict, idx: torch.Tensor) -> dict:
    """{name: column[idx]} for every column (common length). Flat columns
    share one call; a 2-D column (a VECTOR column, (n, d) float32)
    gathers its flattened elements by the normalized row index expanded
    to idx * d + j, in a call of its own."""
    if not cols:
        return {}
    flat = [n for n, c in cols.items() if c.dim() == 1]
    out = dict(zip(flat, gather_columns([cols[n] for n in flat], idx)))
    for n, c in cols.items():
        if c.dim() == 1:
            continue
        rows, width = int(c.shape[0]), int(c[0].numel()) if len(c) else 0
        j = k4_norm_index(idx, rows) * width
        eidx = (j[:, None] + torch.arange(width, device=idx.device)).reshape(-1)
        (g,) = gather_columns([c.reshape(-1)], eidx.to(torch.int32))
        out[n] = g.reshape((idx.shape[0],) + tuple(c.shape[1:]))
    return {n: out[n] for n in cols}
