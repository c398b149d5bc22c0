"""Window-function scans over sorted partitions.

Counterpart of `oceanbase_tpu/ops/window.py`: the batch sorts once by
(partition keys, order keys), dead rows last, and every window function
is a scan over the sorted rows: run boundaries (`boundaries`), segment
starts and peer-group ends (`segment_starts`, `peer_ends`), running sums
(`prefix_sum`, `segmented_cumsum`), and running min/max forward and
backward within segments (`segmented_scan_minmax`,
`suffix_scan_minmax`). On the card each is kernel K13
(`csrc/k13_window_scan.cu`); on the CPU the wrappers run their plain
versions beside K8's in `kernels.py`.
"""

from __future__ import annotations

import torch

from ..kernels import (
    boundaries,
    gather_columns,
    peer_ends,
    prefix_sum,
    segment_starts,
    segmented_scan_minmax,
    suffix_scan_minmax,
)

__all__ = [
    "agg_identity",
    "boundaries",
    "peer_ends",
    "prefix_sum",
    "segment_starts",
    "segmented_cumsum",
    "segmented_scan_minmax",
    "suffix_scan_minmax",
]


def segmented_cumsum(values: torch.Tensor,
                     seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum within each segment. `values` must already be
    masked (dead/NULL rows contribute 0)."""
    c = prefix_sum(values)
    idx = seg_start.to(torch.int32)
    c0, v0 = gather_columns([c, values], idx)
    return c - c0 + v0


def agg_identity(dtype: torch.dtype, is_min: bool):
    """The identity of min (is_min) or max in a value type."""
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min
