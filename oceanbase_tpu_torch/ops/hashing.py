"""Key packing for the direct-addressed group-by.

Counterpart of the packing half of `oceanbase_tpu/ops/hashing.py`: when
every group key has a small static domain (dictionary codes, bools), the
keys bit-pack into one int key that is its own perfect-hash slot. The
avalanche hashes of that module serve the join paths and are not ported
yet.
"""

from __future__ import annotations

import torch


def pack_keys(columns: list[torch.Tensor], domains: list[int]
              ) -> tuple[torch.Tensor, int]:
    """Bit-pack bounded-domain key columns into a single dense int key.

    columns[i] must take values in [0, domains[i]). Returns (packed, space)
    with packed in [0, space), int32 when the packing fits 31 bits."""
    bits = [max(1, int(d - 1).bit_length()) for d in domains]
    total = sum(bits)
    dtype = torch.int32 if total <= 31 else torch.int64
    packed = torch.zeros(columns[0].shape, dtype=dtype,
                         device=columns[0].device)
    shift = 0
    for c, b in zip(columns, bits):
        packed = packed | (c.to(dtype) << shift)
        shift += b
    return packed, 1 << total


def next_pow2(n: int) -> int:
    return 1 << max(1, (int(n) - 1).bit_length())
