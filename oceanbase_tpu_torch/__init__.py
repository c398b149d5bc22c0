"""oceanbase_tpu_torch — the PyTorch/CUDA port of the SQL engine.

Mirrors the layout of the JAX package module for module: column batches
are SoA torch tensors on one explicit `torch.device`, expressions are
torch elementwise code, and the device functions a statement cannot run
without (masked reduction, direct group-by, stable multi-key sort, row
gather) are hand-written CUDA kernels for Hopper (`csrc/`, bound through
`kernels.py`). The SQL front end, planner and catalog types are host-only
copies kept inside this package.

Device rule: entry points run on the first CUDA device unless the caller
names another device (the CPU tests pass ``device="cpu"``). Nothing drops
to the CPU on its own.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def device(arg=None) -> torch.device:
    """Resolve a caller's device argument: None means ``cuda:0`` and
    raises when no CUDA device is present; anything else is taken as
    given (``"cpu"``, ``"cuda:1"``, a ``torch.device``)."""
    if arg is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass device='cpu' to run the "
                "port on the CPU"
            )
        return torch.device("cuda", 0)
    dev = torch.device(arg)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev
