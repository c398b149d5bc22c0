"""Sort / top-n over kernel K3.

Counterpart of `oceanbase_tpu/ops/sort.py`. The JAX package sorts with
`lax.sort` over (dead flag, int32 key planes..., row index); the port
computes the same order with the stable radix sort of K3, so ties and
compaction order are the reference's exactly. The int32 plane split of
int64 keys was a TPU sort workaround and has no counterpart.
"""

from __future__ import annotations

import torch

from ..kernels import sort_order


def sort_indices(keys: list[torch.Tensor], descending: list[bool],
                 mask: torch.Tensor) -> torch.Tensor:
    """Row order (int32 [N]) sorting live rows by keys; dead rows last;
    ties keep the original row order."""
    return sort_order(keys, descending, mask)


def topn_indices(keys: list[torch.Tensor], descending: list[bool],
                 mask: torch.Tensor, n_top: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-n rows by sort keys. Returns (order [n_top], valid [n_top])."""
    order = sort_indices(keys, descending, mask)
    top = order[:n_top]
    nlive = torch.sum(mask, dtype=torch.int64)
    valid = torch.arange(n_top, dtype=torch.int64, device=mask.device) < nlive
    return top, valid
