from .gather import gather_rows
from .hashagg import (
    assign_group_slots,
    groupby_direct,
    groupby_hash,
    scalar_aggregate,
    sort_groupby,
)
from .hashing import hash_combine, mix64, next_pow2, pack_keys
from .join import (
    expand_join,
    join_keys64,
    merge_join_unique,
    probe_run_any,
    sort_build_side,
)
from .sort import sort_indices, topn_indices

__all__ = [
    "assign_group_slots",
    "expand_join",
    "gather_rows",
    "groupby_direct",
    "groupby_hash",
    "hash_combine",
    "join_keys64",
    "merge_join_unique",
    "mix64",
    "next_pow2",
    "pack_keys",
    "probe_run_any",
    "scalar_aggregate",
    "sort_build_side",
    "sort_groupby",
    "sort_indices",
    "topn_indices",
]
