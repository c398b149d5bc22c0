"""Device-memory governor: a device-memory ledger with admission-time
reservations.

Counterpart of `oceanbase_tpu/engine/memory_governor.py`. Every statement
states its peak device working set up front and the governor grants a
reservation, queues it, or rejects it against the statement deadline, so
running out of device memory is a planned-for, degradable condition
instead of a crash.

Two accounting axes share one ledger:

- a global device budget (0 = auto: a fraction of the card's memory as
  ``torch.cuda.mem_get_info`` reports it, or a synthetic budget on the
  CPU so the whole subsystem stays testable there), shrunk
  multiplicatively by ``note_oom()`` whenever a device OOM proves the
  estimates optimistic;
- per-tenant shares: a tenant's reservations and its resident catalog
  bytes are charged against the same limit, so a tenant at its limit
  queues instead of evicting a neighbour's residency.

A third, the staged ledger, counts the host-side wire buffers of the
streaming prefetcher (engine/pipeline.py). The ledger must balance:
every grant is released in a ``finally`` (Reservation and StagedLease are
context managers and release is idempotent), and ``ledger_balanced()``
says whether it did.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..share import gap_ledger as _gap

#: synthetic budget used on the CPU; big enough that tests opt *in* to
#: pressure by configuring a small explicit limit.
SYNTHETIC_CPU_BUDGET = 2 << 30

#: fraction of the card's memory handed to the governor when it is
#: auto-sized (the rest covers the allocator's scratch and the resident
#: column cache, which are not reservation-tracked).
AUTO_HBM_FRACTION = 0.75

#: note_oom() multiplies the effective budget by this; floor below.
OOM_SHRINK = 0.75
OOM_SHRINK_FLOOR = 0.25

#: conservative bytes/row guess used when deriving a chunk size from a
#: byte budget without column knowledge.
_EST_ROW_BYTES = 128


def detect_device_budget(device=None) -> int:
    """The governor's auto budget: AUTO_HBM_FRACTION of the CUDA card's
    total memory (``torch.cuda.mem_get_info``), or the synthetic budget
    on the CPU. `device` None means the first CUDA device when there is
    one."""
    import torch

    dev = torch.device(device) if device is not None else (
        torch.device("cuda", 0) if torch.cuda.is_available() else None)
    if dev is not None and dev.type == "cuda":
        _free, total = torch.cuda.mem_get_info(dev)
        return int(total * AUTO_HBM_FRACTION)
    return int(os.environ.get("OB_TPU_SYNTHETIC_HBM", SYNTHETIC_CPU_BUDGET))


def derive_chunk_rows(budget_bytes: int, default_rows: int,
                      row_bytes: int = _EST_ROW_BYTES) -> int:
    """Chunk size for a byte budget, clamped so a tiny budget still makes
    forward progress and a huge one keeps the default.

    `row_bytes` must be the DECODED on-device row width of the streamed
    columns (engine/pipeline.decoded_row_bytes), not the wire width: the
    governor charges staged (compressed) host-pinned bytes separately
    through the staged ledger, so sizing chunks from compressed bytes
    would let a high-ratio RLE column overcommit HBM by its encoding
    ratio. Callers without column knowledge keep the conservative
    wide-row default."""
    rows = int(max(budget_bytes, 1) // max(int(row_bytes), 1))
    return max(4096, min(default_rows, rows))


class Reservation:
    """One granted slice of the ledger. Idempotent release; usable as a
    context manager so error paths cannot leak bytes."""

    __slots__ = ("_gov", "tenant", "nbytes", "_live")

    def __init__(self, gov: "MemoryGovernor", tenant: str, nbytes: int):
        self._gov = gov
        self.tenant = tenant
        self.nbytes = nbytes
        self._live = True

    def release(self) -> None:
        if self._live:
            self._live = False
            self._gov._release(self.tenant, self.nbytes)

    def __enter__(self) -> "Reservation":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class StagedLease:
    """One staged (host-pinned, wire-encoded) chunk's slice of the staged
    ledger — the streaming prefetcher holds one per in-flight chunk.
    Idempotent release; usable as a context manager so a cancelled
    prefetch cannot leak staged bytes."""

    __slots__ = ("_gov", "tenant", "nbytes", "_live")

    def __init__(self, gov: "MemoryGovernor", tenant: str, nbytes: int):
        self._gov = gov
        self.tenant = tenant
        self.nbytes = nbytes
        self._live = True

    def release(self) -> None:
        if self._live:
            self._live = False
            self._gov._release_staged(self.nbytes)

    def __enter__(self) -> "StagedLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


@dataclass
class _Tenant:
    limit: Optional[int]  # None = unlimited share
    resident_fn: Optional[Callable[[], int]]
    reserved: int = 0


class MemoryGovernor:
    """Per-device HBM ledger with per-tenant shares and a wait queue."""

    def __init__(self, budget: int, max_queue: int = 64,
                 clock: Optional[Callable[[], float]] = None):
        self.budget = int(budget)
        self.max_queue = max_queue
        self._shrink = 1.0
        self.reserved = 0
        self.peak_reserved = 0
        self._tenants: dict[str, _Tenant] = {}
        # sharded-residency reporters (mesh executors): each returns the
        # PER-DEVICE bytes its partitioned tables pin — total/n_shards,
        # because row sharding leaves each device one slice of every
        # resident table. The budget is per-device HBM, so this is the
        # unit that competes with reservations for the same pool.
        self._sharded_fns: list[Callable[[], int]] = []
        self._waiters = 0
        self._cond = threading.Condition()
        # staged ledger: host-pinned wire-encoded chunk buffers held by
        # the streaming prefetcher (engine/pipeline.py). Tracked apart
        # from device reservations — staged bytes live in HOST memory
        # awaiting H2D, so they must not eat the HBM pool — but they
        # participate in ledger_balanced(): a statement error/timeout
        # with a prefetch in flight must still drain to zero.
        self.staged = 0
        self.peak_staged = 0
        # monotonic counters (mirrored into sysstat by callers)
        self.grants = 0
        self.rejects = 0
        self.oom_notes = 0
        # bounded ring of recent reservation-wait seconds for the p99
        # surfaced in __all_virtual_memory_governor and the sentinel
        self._wait_ring: list[float] = []
        self._wait_cap = 512
        import time as _t

        self._clock = clock if clock is not None else _t.monotonic

    # ------------------------------------------------------------ config
    def set_budget(self, budget: int) -> None:
        with self._cond:
            self.budget = int(budget)
            self._cond.notify_all()

    def register_tenant(self, name: str, memory_limit: Optional[int],
                        resident_fn: Optional[Callable[[], int]] = None
                        ) -> None:
        """Seed a tenant share from its TenantUnit.memory_limit. The
        resident_fn reports the tenant's resident catalog snapshot bytes
        so reservations and residency charge one accounting surface."""
        with self._cond:
            t = self._tenants.get(name)
            if t is None:
                self._tenants[name] = _Tenant(memory_limit, resident_fn)
            else:  # re-register (restart): keep live reservation count
                t.limit = memory_limit
                if resident_fn is not None:
                    t.resident_fn = resident_fn

    def register_sharded_residency(self, fn: Callable[[], int]) -> None:
        """Register a mesh executor's partitioned-residency reporter
        (ShardedResidency.per_device_bytes). Idempotent per callable."""
        with self._cond:
            if fn not in self._sharded_fns:
                self._sharded_fns.append(fn)

    # ----------------------------------------------------------- budget
    def effective_budget(self) -> int:
        return max(1, int(self.budget * self._shrink))

    def sharded_resident_bytes(self) -> int:
        """Per-device bytes pinned by partitioned (mesh-sharded) tables
        across all registered mesh executors."""
        total = 0
        for fn in list(self._sharded_fns):
            try:
                total += int(fn())
            except Exception:
                pass
        return total

    def upload_budget(self) -> int:
        """What a single statement may plan to hold on device: the
        executor's prepare() consults this before a whole-table upload."""
        return self.effective_budget()

    def remaining(self) -> int:
        with self._cond:
            return max(0, self.effective_budget() - self.reserved
                       - self.sharded_resident_bytes())

    def note_oom(self) -> None:
        """A device OOM proved the estimates optimistic: shrink the
        reservation pool multiplicatively (ladder rung 1)."""
        with self._cond:
            self._shrink = max(OOM_SHRINK_FLOOR, self._shrink * OOM_SHRINK)
            self.oom_notes += 1

    def reset_shrink(self) -> None:
        with self._cond:
            self._shrink = 1.0
            self._cond.notify_all()

    # ------------------------------------------------------------ ledger
    def _tenant_fits(self, t: Optional[_Tenant], nbytes: int) -> bool:
        if t is None or t.limit is None:
            return True
        if t.reserved == 0:
            # a tenant's LONE statement is always admissible: its own
            # resident snapshots are reclaimable (server-side
            # _enforce_memory evicts the tenant's OWN coldest tables),
            # so an over-resident tenant degrades its own working set
            # instead of deadlocking at admission. What the limit gates
            # is concurrency: a second reservation must fit beside the
            # first AND the residency both charge the same quota.
            return True
        resident = 0
        if t.resident_fn is not None:
            try:
                resident = int(t.resident_fn())
            except Exception:
                resident = 0
        return t.reserved + resident + nbytes <= t.limit

    def reserve(self, tenant: str, nbytes: int,
                timeout_s: float = 5.0) -> Optional[Reservation]:
        """Grant `nbytes` against the ledger, waiting up to `timeout_s`.

        Returns None on timeout or queue-depth backpressure (the caller
        maps that onto DeviceMemoryTimeout / the statement deadline).
        A single statement larger than the whole effective budget is
        clamped to it: it must still run (degrading via the ladder),
        just strictly alone."""
        nbytes = int(max(0, nbytes))
        if nbytes == 0:
            return Reservation(self, tenant, 0)
        deadline = self._clock() + max(timeout_s, 0.0)
        with self._cond:
            t = self._tenants.get(tenant)
            waited = False
            t0 = self._clock()
            while True:
                # re-clamp every pass: note_oom() can shrink the pool
                # while we wait, and a request clamped to the OLD budget
                # would otherwise never fit again
                want = min(nbytes, self.effective_budget())
                if t is not None and t.limit is not None:
                    # a share-capped tenant's lone statement is likewise
                    # clamped so it can always eventually be admitted
                    want = min(want, max(1, t.limit))
                # sharded residency shrinks the pool new reservations
                # compete for — but never below `want`: a lone statement
                # must stay admissible even when partitioned tables pin
                # most of the device (they are evictable, exactly like
                # the per-tenant lone-statement rule), else admission
                # deadlocks with no one left to trigger eviction.
                pool = self.effective_budget()
                sharded = self.sharded_resident_bytes()
                if sharded:
                    pool = max(pool - sharded, want)
                fits = (self.reserved + want <= pool
                        and self._tenant_fits(t, want))
                if fits:
                    break
                if not waited and self._waiters >= self.max_queue:
                    self.rejects += 1  # queue-depth backpressure
                    return None
                rem = deadline - self._clock()
                if rem <= 0:
                    self.rejects += 1
                    self._note_wait(self._clock() - t0)
                    return None
                self._waiters += 1
                waited = True
                try:
                    self._cond.wait(timeout=min(rem, 0.05))
                finally:
                    self._waiters -= 1
            if waited:
                self._note_wait(self._clock() - t0)
            self.reserved += want
            self.peak_reserved = max(self.peak_reserved, self.reserved)
            if t is not None:
                t.reserved += want
            self.grants += 1
            return Reservation(self, tenant, want)

    def _release(self, tenant: str, nbytes: int) -> None:
        with self._cond:
            self.reserved = max(0, self.reserved - nbytes)
            t = self._tenants.get(tenant)
            if t is not None:
                t.reserved = max(0, t.reserved - nbytes)
            self._cond.notify_all()

    def stage(self, tenant: str, nbytes: int) -> StagedLease:
        """Charge `nbytes` of host-pinned staged (wire-encoded) chunk
        buffers to the staged ledger. Never blocks: the prefetch queue
        depth is the backpressure (at most `depth` staged chunks exist),
        so this is accounting + leak detection, not admission."""
        nbytes = int(max(0, nbytes))
        with self._cond:
            self.staged += nbytes
            self.peak_staged = max(self.peak_staged, self.staged)
        return StagedLease(self, tenant, nbytes)

    def _release_staged(self, nbytes: int) -> None:
        with self._cond:
            self.staged = max(0, self.staged - nbytes)
            self._cond.notify_all()

    def _note_wait(self, s: float) -> None:
        # caller holds _cond
        self._wait_ring.append(s)
        if len(self._wait_ring) > self._wait_cap:
            del self._wait_ring[: len(self._wait_ring) - self._wait_cap]
        # host-tax: admission waits park the statement's own thread here,
        # so the hint lands on its ledger without any plumbing
        led = _gap.current()
        if led is not None and s > 0.0:
            led.add("governor reserve", s)

    # ------------------------------------------------------- observation
    def wait_p99_s(self) -> float:
        with self._cond:
            ring = sorted(self._wait_ring)
        if not ring:
            return 0.0
        return ring[min(len(ring) - 1, int(len(ring) * 0.99))]

    def under_pressure(self) -> bool:
        """Cheap predicate for admission-side consumers (the statement
        batcher clamps batch size while the ledger is mostly spoken
        for, or waiters are queued)."""
        with self._cond:
            eff = self.effective_budget()
            return (self._waiters > 0
                    or self.reserved * 4 >= eff * 3
                    or self._shrink < 1.0)

    def ledger_balanced(self) -> bool:
        with self._cond:
            return (self.reserved == 0
                    and self.staged == 0
                    and all(t.reserved == 0 for t in self._tenants.values()))

    def stats(self) -> dict:
        with self._cond:
            return {
                "budget": self.budget,
                "effective_budget": self.effective_budget(),
                "reserved": self.reserved,
                "peak_reserved": self.peak_reserved,
                "staged": self.staged,
                "peak_staged": self.peak_staged,
                "waiters": self._waiters,
                "grants": self.grants,
                "rejects": self.rejects,
                "oom_notes": self.oom_notes,
                "sharded_resident": self.sharded_resident_bytes(),
                "shrink": round(self._shrink, 4),
                "wait_p99_s": self.wait_p99_s() if self._wait_ring else 0.0,
                "tenants": {
                    name: {"limit": t.limit, "reserved": t.reserved}
                    for name, t in self._tenants.items()
                },
            }


__all__ = [
    "MemoryGovernor", "Reservation", "StagedLease", "detect_device_budget",
    "derive_chunk_rows", "SYNTHETIC_CPU_BUDGET",
]
