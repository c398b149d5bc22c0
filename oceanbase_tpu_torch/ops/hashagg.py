"""Aggregation operators over the port's kernels.

Counterpart of `oceanbase_tpu/ops/hashagg.py` for the ungrouped path
(`scalar_aggregate`, kernel K1) and the direct-addressed group-by
(`groupby_direct`, kernel K2). The sort-based and hash group-bys are not
ported yet.
"""

from __future__ import annotations

import torch

from ..kernels import groupby_slots, scalar_reduce


def scalar_aggregate(mask: torch.Tensor, agg_ops: list[str],
                     agg_values: list):
    """Ungrouped aggregation: one masked reduction per aggregate (K1),
    each a 0-d tensor."""
    out = []
    for op, v in zip(agg_ops, agg_values):
        if op == "approx_ndv":
            raise NotImplementedError(
                "approx_ndv (HyperLogLog) is not ported yet")
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
