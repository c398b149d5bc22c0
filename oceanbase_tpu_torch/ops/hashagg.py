"""Aggregation operators over the port's kernels.

Counterpart of `oceanbase_tpu/ops/hashagg.py` for the ungrouped path
(`scalar_aggregate`, kernel K1), the direct-addressed group-by
(`groupby_direct`, kernel K2), the sort-based group-by (`sort_groupby`:
the order from K3, the sorted keys through K4, the segmented reduction
K8), the first-occurrence mask of DISTINCT aggregates
(`distinct_first_mask`: the order from K3, the run starts written back
through it by K15) and the HyperLogLog count of `approx_ndv` (K16). The
hash group-by is not ported yet.
"""

from __future__ import annotations

import torch

from ..kernels import (
    first_occurrence,
    gather_columns,
    groupby_slots,
    scalar_reduce,
    segmented_reduce,
)
from .hll import hll_count
from .sort import sort_indices


def scalar_aggregate(mask: torch.Tensor, agg_ops: list[str],
                     agg_values: list):
    """Ungrouped aggregation: one masked reduction per aggregate (K1),
    each a 0-d tensor."""
    out = []
    for op, v in zip(agg_ops, agg_values):
        if op == "approx_ndv":
            out.append(hll_count(v, mask))
            continue
        out.append(scalar_reduce(op, mask, v))
    return out


def groupby_direct(packed_keys: torch.Tensor, domain: int,
                   mask: torch.Tensor, agg_ops: list[str], agg_values: list,
                   agg_masks: list | None = None):
    """Direct-addressed group-by for bit-packed bounded keys (K2).

    packed_keys in [0, domain). Returns (slot_used [domain], aggs [domain]
    each); a slot is used when any row under `mask` carries its key. Each
    aggregate reduces over `mask`, or over its own entry of `agg_masks`
    (the executor's direct path, `_direct_slot_agg`: NULL arguments drop
    out of their aggregate only). One K2 launch serves every aggregate."""
    masks = agg_masks if agg_masks is not None else [mask] * len(agg_ops)
    specs = [("count", None, mask)] + [
        (op, None if op == "count" else v, m)
        for op, v, m in zip(agg_ops, agg_values, masks)
    ]
    res = groupby_slots(packed_keys, domain, specs)
    return res[0] > 0, res[1:]


def sort_groupby(key_cols: list[torch.Tensor], mask: torch.Tensor,
                 agg_ops: list[str], agg_values: list,
                 agg_masks: list | None = None):
    """Sort-based group-by for unbounded key domains: one stable sort on
    (dead flag, keys..., row) (K3), the key columns and the live flag in
    sorted order (K4), then every aggregate reduced per run of equal keys
    (K8). The output reuses the input capacity with one live row per group
    at its segment start, in sorted key order.

    Returns (group_keys [N] each, sel [N] bool, aggs [N] each, order [N]
    int32). agg_masks[i] (optional) restricts which rows feed aggregate i;
    rows outside `mask` never contribute."""
    order = sort_indices(list(key_cols), [False] * len(key_cols), mask)
    gathered = gather_columns(list(key_cols) + [mask], order)
    skeys, ssel = gathered[:-1], gathered[-1]
    masks = agg_masks if agg_masks is not None else [None] * len(agg_ops)
    sel, aggs = segmented_reduce(skeys, ssel, order, [
        (op, None if op == "count" else v, m)
        for op, v, m in zip(agg_ops, agg_values, masks)
    ])
    return skeys, sel, aggs, order


def distinct_first_mask(key_vals: list[torch.Tensor], val: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """First-occurrence mask for DISTINCT aggregates: True for exactly one
    live row per (group keys, value) combination, the lowest such row, in
    row order. K3 orders (dead, keys..., value) stably, and K15 marks each
    run's first live row straight into row order (no inverse sort).
    Values compare with `!=`: every NaN row is its own value, -0.0 and 0.0
    are one."""
    n = int(mask.shape[0])
    cols = [(k.expand(n) if k.dim() == 0 else k).contiguous()
            for k in (*key_vals, val)]
    order = sort_indices(cols, [False] * len(cols), mask)
    return first_occurrence(cols, mask, order)
