"""Join operators over the port's kernels.

Counterpart of `oceanbase_tpu/ops/join.py`: the unique-build join
(`merge_join_unique`, kernel K9), the M:N expansion against a key-sorted
build side (`sort_build_side` on K3 + K4, `expand_join`, kernel K10), the
per-probe-row OR over its pair run (`probe_run_any`, kernel K11), and the
canonical 64-bit join key (`join_keys64`, kernel K12 for keys of several
columns), and the open-addressing hash set of multi-column keys
(`build_hash_table`, `hash_join_probe`, kernel K14) that set operations
and multi-column semi/anti joins probe for existence.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..kernels import float_key_image, gather_columns
from .hashing import hash_combine
from .sort import sort_indices

_I64_MAX = torch.iinfo(torch.int64).max


def join_keys64(key_cols: list[torch.Tensor]) -> torch.Tensor:
    """Canonical 64-bit join key: one integer column widens exactly to
    int64, one float column becomes the injective image of its value
    (`float_key_image`; no collision risk either way); several columns
    hash-combine (K12, floats by the same image), and the engine
    exact-verifies the expanded pairs of such keys."""
    if len(key_cols) == 1:
        c = key_cols[0]
        if c.dtype.is_floating_point:
            return float_key_image(c)
        return c.to(torch.int64)
    return hash_combine([c.contiguous() for c in key_cols])


def key_live(key_cols: list, mask: torch.Tensor) -> torch.Tensor:
    """The rows of `mask` that can match: a NaN key equals nothing, as in
    SQL comparison."""
    for c in key_cols:
        if c.dtype.is_floating_point:
            mask = mask & ~torch.isnan(c)
    return mask


def sort_build_side(key_cols: list[torch.Tensor], mask: torch.Tensor):
    """Build rows sorted by their 64-bit key for expand_join: (sorted keys
    int64 [nb], build row per sorted position int32 [nb]). Dead rows sort
    strictly last (K3's dead flag leads the order) and carry int64 max, so
    the keys stay nondecreasing; expand_join clamps its ranges to the live
    count, so a live key of int64 max never meets the dead tail."""
    keys64 = join_keys64(key_cols).contiguous()
    order = sort_indices([keys64], [False], mask)
    skeys, ssel = gather_columns([keys64, mask], order)
    return torch.where(ssel, skeys, _I64_MAX), order


def expand_join(build_sorted_keys64, build_order, build_nrows,
                probe_key_cols, probe_mask, out_capacity: int):
    """M:N join expansion (K10). Returns (probe row int32 [C], build row
    int32 [C], valid bool [C], total 0-d int64, pair starts int64 [N],
    pair offs int64 [N]); when total > C the pairs are truncated and the
    engine re-runs at a larger capacity."""
    keys64 = join_keys64(probe_key_cols).contiguous()
    return kernels.expand_join(build_sorted_keys64, build_order,
                               build_nrows.to(torch.int64), keys64,
                               probe_mask, out_capacity)


def probe_has_match(build_sorted_keys64, build_nrows, probe_key,
                    probe_mask) -> torch.Tensor:
    """Whether each live probe row's key occurs among the live sorted
    build keys: the range search of K10 alone (the sorted-range semi and
    anti joins)."""
    cnt = kernels.join_ranges(build_sorted_keys64,
                              build_nrows.to(torch.int64),
                              probe_key.to(torch.int64).contiguous(),
                              probe_mask)
    return cnt > 0


def probe_run_any(pair_ok, starts, offs) -> torch.Tensor:
    """Per probe row, the OR of pair_ok over its pair run (K11)."""
    return kernels.probe_run_any(pair_ok.contiguous(), starts, offs)


def merge_join_unique(build_key, build_mask, probe_key, probe_mask):
    """Unique-build join on one integer key column (K9): match_row [Np]
    int32 in probe order (-1 = no match); among duplicate live build keys
    the lowest row wins, as the reference's combined sort makes it."""
    return kernels.merge_join(build_key.contiguous(), build_mask,
                              probe_key.contiguous(), probe_mask)


def build_hash_table(key_cols: list[torch.Tensor], mask: torch.Tensor,
                     table_size: int):
    """Insert the live rows' key tuples into an open-addressing table of
    `table_size` (a power of two >= 2 rows) int32 slots (K14). Returns
    (slot_tag, slot_row); empty slots hold row -1, and each key's slot
    holds its lowest live row."""
    return kernels.hash_set_build([c.contiguous() for c in key_cols], mask,
                                  table_size)


def hash_join_probe(slot_tag, slot_row, build_key_cols, probe_key_cols,
                    probe_mask) -> torch.Tensor:
    """Probe the table (K14): match_row [Np] int32, the build row whose key
    tuple equals each live probe row's exactly, or -1. A 32-bit tag
    collision costs a probe step, never a wrong match."""
    return kernels.hash_set_probe(
        slot_tag, slot_row, [c.contiguous() for c in build_key_cols],
        [c.contiguous() for c in probe_key_cols], probe_mask)
