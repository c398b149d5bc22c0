"""Key packing for the direct-addressed group-by, and the key hashes.

Counterpart of `oceanbase_tpu/ops/hashing.py`: when every group key has a
small static domain (dictionary codes, bools), the keys bit-pack into one
int key that is its own perfect-hash slot (`pack_keys`); the direct
group-by (K2) takes the dense mixed-radix slot instead (`dense_keys`) and
lays its results out in `pack_keys`'s slots. Multi-column join
keys hash-combine through the splitmix64 finalizer (`mix64`,
`hash_combine`, kernel K12). torch has no uint64 shift or add, so the
hash runs on int64 bits: multiplies and adds wrap modulo 2^64 alike, and
each right shift masks off the sign bits. The 32-bit murmur3 mixes
(`mix32`, `fold32`, `hash32_combine`) run the same way on uint32 values
held in int64; the hash set (K14) and the HyperLogLog registers (K16)
compute them inside their kernels on the card, with the same bits.
"""

from __future__ import annotations

import torch

from ..kernels import hash_columns as hash_combine  # noqa: F401 (K12)
from ..kernels import fold32_plain as fold32  # noqa: F401
from ..kernels import hash32_combine_plain as hash32_combine  # noqa: F401
from ..kernels import mix32_plain as mix32  # noqa: F401
from ..kernels import mix64_plain as mix64  # noqa: F401


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


def dense_keys(columns: list[torch.Tensor], domains: list[int]
               ) -> torch.Tensor:
    """The dense mixed-radix slot of bounded-domain key columns: key i
    times the product of the domains before it (key 0 least significant),
    in [0, product of the domains); int32 (the direct group-by admits a
    product of at most 64)."""
    slots = torch.zeros(columns[0].shape, dtype=torch.int32,
                        device=columns[0].device)
    radix = 1
    for c, d in zip(columns, domains):
        if d > 1:
            slots = slots + c.to(torch.int32) * radix
        radix *= int(d)
    return slots


def next_pow2(n: int) -> int:
    return 1 << max(1, (int(n) - 1).bit_length())
