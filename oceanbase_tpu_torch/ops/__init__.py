from .gather import gather_rows
from .hashagg import groupby_direct, scalar_aggregate, sort_groupby
from .hashing import next_pow2, pack_keys
from .sort import sort_indices, topn_indices

__all__ = [
    "gather_rows",
    "groupby_direct",
    "scalar_aggregate",
    "sort_groupby",
    "next_pow2",
    "pack_keys",
    "sort_indices",
    "topn_indices",
]
