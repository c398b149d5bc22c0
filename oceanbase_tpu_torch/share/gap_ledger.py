"""The statement host-tax ledger, as far as the port's engines report to it.

Counterpart of the recording half of `oceanbase_tpu/share/gap_ledger.py`:
a GapLedger installed for the running statement's thread collects named
host phases (seconds) and device-busy seconds. The streaming pipeline adds
its non-overlapped host-to-device wall ("h2d") and its chunk compute, and
the memory governor its admission waits ("governor reserve").
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class GapLedger:
    __slots__ = ("phases", "device_s")

    def __init__(self):
        self.phases: Dict[str, float] = {}
        self.device_s = 0.0

    def add(self, phase: str, seconds: float) -> None:
        if seconds > 0.0:
            self.phases[phase] = self.phases.get(phase, 0.0) + seconds

    def device(self, seconds: float) -> None:
        """Record device-busy wall overlapping this statement."""
        if seconds > 0.0:
            self.device_s += seconds


_tls = threading.local()


def set_current(led: Optional[GapLedger]) -> None:
    _tls.ledger = led


def current() -> Optional[GapLedger]:
    return getattr(_tls, "ledger", None)
