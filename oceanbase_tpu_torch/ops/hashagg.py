"""Aggregation operators over the port's kernels.

Counterpart of `oceanbase_tpu/ops/hashagg.py`: the ungrouped path
(`scalar_aggregate`, kernel K1), the direct-addressed group-by
(`groupby_direct`, kernel K2), the general hash group-by (`groupby_hash`
over `assign_group_slots` and `_apply_agg`, kernel K29), the sort-based
group-by (`sort_groupby`: the order from K3, the sorted keys through K4,
the segmented reduction K8), the first-occurrence mask of DISTINCT
aggregates (`distinct_first_mask`: K3's sorted images or order, the run
starts written back by K15) and the HyperLogLog count of
`approx_ndv` (K16).
"""

from __future__ import annotations

import torch

from ..kernels import (
    first_occurrence,
    first_occurrence_images,
    gather_columns,
    groupby_slots,
    hash_groupby,
    scalar_reduce,
    segmented_reduce,
    slot_aggregate,
    sort_order_images,
)
from .hashing import next_pow2
from .hll import hll_count
from .sort import sort_indices


def assign_group_slots(key_cols: list[torch.Tensor], mask: torch.Tensor,
                       table_size: int):
    """Each live row's slot in an open-addressing table of `table_size`
    slots (K29). Returns (row_slot [N] int32, slot_used [T] bool,
    slot_row [T] int32: each used slot's lowest row). Dead rows, and live
    rows that find no slot in a full table, get slot -1."""
    row_slot, slot_row, slot_used, _keys, _aggs = hash_groupby(
        [c.contiguous() for c in key_cols], mask, [], table_size)
    return row_slot, slot_used, slot_row


def _apply_agg(op: str, row_slot, mask, values, table_size: int):
    """One aggregate scattered into the slots of `row_slot` (K29's
    aggregate pass): count and integer sums in int64, float sums and
    min/max in the value's type; dead rows drop, slot -1 wraps to T - 1
    as JAX's scatter does."""
    return slot_aggregate(row_slot, mask, [(op, values)], table_size)[0]


def groupby_hash(key_cols: list[torch.Tensor], mask: torch.Tensor,
                 agg_ops: list[str], agg_values: list, table_size: int):
    """General hash group-by, one K29 launch.

    Returns (group_keys: list of [T] arrays, the key columns at each used
    slot's first row and 0 elsewhere; slot_used [T]; aggs: list of [T]
    arrays). table_size must be a power of two >= 2 * expected NDV."""
    assert table_size == next_pow2(table_size)
    _row_slot, _slot_row, slot_used, keys, aggs = hash_groupby(
        [c.contiguous() for c in key_cols], mask,
        [(op, None if op == "count" else v.contiguous())
         for op, v in zip(agg_ops, agg_values)], table_size)
    return keys, slot_used, aggs


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


def groupby_direct(keys: torch.Tensor, domains, mask: torch.Tensor,
                   agg_ops: list[str], agg_values: list,
                   agg_masks: list | None = None):
    """Direct-addressed group-by for bounded keys (K2).

    keys: each row's dense mixed-radix slot over the key domains
    `domains` (`ops.hashing.dense_keys`; an int is one key, keys in
    [0, domains)). Returns (slot_used, aggs) over pack_keys's packed slots
    of those domains (`kernels.k2_layout`), as the JAX package's
    groupby_direct returns them for the packed key; a slot is used when
    any row under `mask` carries its key. Each aggregate reduces over
    `mask`, or over its own entry of `agg_masks` (the executor's direct
    path, `_direct_slot_agg`: NULL arguments drop out of their aggregate
    only). One K2 launch serves every aggregate."""
    masks = agg_masks if agg_masks is not None else [mask] * len(agg_ops)
    specs = [("count", None, mask)] + [
        (op, None if op == "count" else v, m)
        for op, v, m in zip(agg_ops, agg_values, masks)
    ]
    res = groupby_slots(keys, domains, specs)
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
    run's first live row straight into row order (no inverse sort): from
    K3's sorted images where one composite holds every key and the row,
    else by the order (`kernels.k15_route`). Values compare with `!=`:
    every NaN row is its own value, -0.0 and 0.0 are one."""
    n = int(mask.shape[0])
    cols = [(k.expand(n) if k.dim() == 0 else k).contiguous()
            for k in (*key_vals, val)]
    s = sort_order_images(cols, [False] * len(cols), mask)
    if s.images is not None:
        return first_occurrence_images(s)
    return first_occurrence(cols, mask, s.order)
