"""HyperLogLog NDV sketch: fixed memory, mergeable.

Counterpart of `oceanbase_tpu/ops/hll.py`: m = 2^14 registers, each the
largest rank (leading zeros + 1) of the second of two independent 32-bit
mixes of the values whose first mix falls in its bucket; alpha = 0.7213 /
(1 + 1.079 / m) and linear counting below 2.5 m with empty registers.
The registers come from kernel K16 (`kernels.hll_registers`, one pass and
an order-free max, bit-equal to the reference's sort); the estimate is a
few torch operations on them, in the reference's order, and IEEE
divisions by tensors on the registers' device so that the card and the
CPU divide alike.
"""

from __future__ import annotations

import torch

from ..kernels import HLL_M as M  # noqa: F401
from ..kernels import hll_hashes_plain as _two_hashes  # noqa: F401
from ..kernels import hll_registers


def hll_estimate(regs: torch.Tensor) -> torch.Tensor:
    """Register array -> 0-d int64 cardinality estimate (linear counting
    below 2.5 m when some register is empty). Every exp2(-r) is a power of
    two >= 2^-33 and 16384 of them sum below 2^15, so the sum is exact in
    float64 in any order."""
    m = int(regs.shape[0])
    dev = regs.device
    f64 = torch.float64
    alpha = 0.7213 / (1.0 + 1.079 / m)
    inv = torch.sum(torch.exp2(-regs.to(f64)))
    raw = torch.full((), alpha * m * m, dtype=f64, device=dev) / inv
    zeros = torch.sum(regs == 0)
    small = m * torch.log(torch.full((), m, dtype=f64, device=dev)
                          / torch.clamp(zeros, min=1).to(f64))
    est = torch.where((raw <= 2.5 * m) & (zeros > 0), small, raw)
    return torch.round(est).to(torch.int64)


def hll_count(col: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One-shot approx NDV of a masked column (the scalar-aggregate
    path)."""
    n = int(mask.shape[0])
    if col.dim() == 0:
        col = col.expand(n)
    return hll_estimate(hll_registers(col.contiguous(), mask))


def hll_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Union of two sketches: the elementwise register max."""
    return torch.maximum(a, b)
