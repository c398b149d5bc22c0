"""Segmented scans over sorted rows, as plain torch code.

Counterpart of the scans in `oceanbase_tpu/ops/window.py` that the sort
group-by runs on (`boundaries`, `segment_starts`, `peer_ends`,
`segmented_cumsum`, `segmented_scan_minmax`). They live in `kernels.py`
beside K8's plain version (`kernels.segmented_reduce_plain`), which runs
on them, so that the kernel layer imports nothing above it; the CPU tests
hold them to the JAX package, and on the card the group-by goes through K8
itself. The window operator that also uses them is not ported yet.
"""

from __future__ import annotations

from ..kernels import (
    boundaries,
    peer_ends,
    segment_starts,
    segmented_cumsum,
    segmented_scan_minmax,
)

__all__ = [
    "boundaries",
    "peer_ends",
    "segment_starts",
    "segmented_cumsum",
    "segmented_scan_minmax",
]
