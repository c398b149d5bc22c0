"""Tenant freezer + LSM maintenance orchestration.

Reference surface: ObTenantFreezer (storage/tx_storage/ob_tenant_freezer.h)
watches the tenant's memstore against its limit and freezes the busiest
memtables at the trigger ratio; ObTenantTabletScheduler
(storage/compaction/ob_tenant_tablet_scheduler.h:146) turns frozen
memtables and delta stacks into merge DAGs on the tenant dag scheduler.

The rebuild's MaintenanceService ties the same loop together over a set of
tablets: memstore accounting -> freeze -> MINI dag (dump frozen memtable)
-> MINOR dag when deltas pile up -> MAJOR dag on demand. `tick()` is
deterministic (tests / single-process); `start()` runs it on a timer.
"""

from __future__ import annotations

import threading

from ..share.dag_scheduler import Dag, DagPriority, TenantDagScheduler
from .tablet import Tablet


class TenantFreezer:
    """Memstore accounting + freeze triggering for one tenant."""

    def __init__(self, memstore_limit: int, trigger_ratio: float):
        self.memstore_limit = memstore_limit
        self.trigger_ratio = trigger_ratio
        self.freeze_count = 0

    def memstore_bytes(self, tablets: list[Tablet]) -> int:
        return sum(
            t.active.bytes_estimate + sum(m.bytes_estimate for m in t.frozen)
            for t in tablets
        )

    def should_freeze(self, tablets: list[Tablet]) -> bool:
        return self.memstore_bytes(tablets) >= (
            self.memstore_limit * self.trigger_ratio
        )

    def freeze_busiest(self, tablets: list[Tablet]) -> Tablet | None:
        """Freeze the tablet holding the most active-memtable memory (the
        reference freezes the top consumers until usage drops)."""
        busiest = max(
            tablets, key=lambda t: t.active.bytes_estimate, default=None
        )
        if busiest is None or busiest.active.nkeys == 0:
            return None
        busiest.freeze()
        self.freeze_count += 1
        return busiest


class MaintenanceService:
    """The freeze/compaction control loop over a set of tablets."""

    def __init__(self, dag_scheduler: TenantDagScheduler, config=None,
                 tablets_fn=None, snapshot_fn=None):
        """tablets_fn() -> list[Tablet]; snapshot_fn() -> current GTS (the
        major-compaction snapshot); config supplies memstore_limit /
        freeze_trigger_ratio / minor_compact_trigger (share/config)."""
        self.dags = dag_scheduler
        self.config = config
        self.tablets_fn = tablets_fn or (lambda: [])
        self.snapshot_fn = snapshot_fn or (lambda: 0)
        self._timer: threading.Timer | None = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------ params
    def _cfg(self, name: str, default):
        if self.config is None:
            return default
        return self.config[name]

    # -------------------------------------------------------------- tick
    def tick(self) -> dict:
        """One control-loop pass: freeze if over trigger, schedule dumps
        for frozen memtables, minors for deep delta stacks. Returns what
        was scheduled (for tests/observability)."""
        tablets = list(self.tablets_fn())
        freezer = TenantFreezer(
            self._cfg("memstore_limit", 256 << 20),
            self._cfg("freeze_trigger_ratio", 0.5),
        )
        out = {"frozen": 0, "mini": 0, "minor": 0}
        # freezing moves bytes active -> frozen (total drops only at dump),
        # so bound the loop by the OVERSHOOT: freeze busiest tablets until
        # the frozen-and-dumpable mass covers it
        total = freezer.memstore_bytes(tablets)
        trigger = freezer.memstore_limit * freezer.trigger_ratio
        overshoot = total - trigger
        while overshoot > 0:
            busiest = max(
                tablets, key=lambda t: t.active.bytes_estimate, default=None
            )
            if busiest is None or busiest.active.nkeys == 0:
                break
            overshoot -= busiest.active.bytes_estimate
            freezer.freeze_busiest(tablets)
            out["frozen"] += 1
        minor_trigger = self._cfg("minor_compact_trigger", 2)
        for t in tablets:
            if t.frozen:
                if self.dags.add_dag(self._mini_dag(t)):
                    out["mini"] += 1
            if len(t.deltas) >= minor_trigger:
                if self.dags.add_dag(self._minor_dag(t)):
                    out["minor"] += 1
        return out

    def _mini_dag(self, t: Tablet) -> Dag:
        d = Dag("MINI_MERGE", DagPriority.MINI_MERGE, key=(t.tablet_id, "mini"))

        def dump():
            # a frozen memtable with staged-but-undecided rows must wait
            # for its writers (retried by a later tick)
            while t.frozen and not t.frozen[0].has_uncommitted:
                t.dump_mini()

        d.add_task(dump, "dump_frozen")
        return d

    def _minor_dag(self, t: Tablet) -> Dag:
        d = Dag("MINOR_MERGE", DagPriority.MINOR_MERGE,
                key=(t.tablet_id, "minor"))
        d.add_task(lambda: t.minor_compact(), "minor_compact")
        return d

    def schedule_major(self, t: Tablet) -> bool:
        """Major freeze entry (the RS major-freeze analog)."""
        d = Dag("MAJOR_MERGE", DagPriority.MAJOR_MERGE,
                key=(t.tablet_id, "major"))
        snapshot = self.snapshot_fn()
        d.add_task(lambda: t.major_compact(snapshot), "major_compact")
        return self.dags.add_dag(d)

    # --------------------------------------------------------- live mode
    def start(self, interval_s: float = 1.0) -> None:
        def loop():
            self.tick()
            self.dags.run_until_idle()
            with self._lock:
                if self._timer is not None:
                    self._timer = threading.Timer(interval_s, loop)
                    self._timer.daemon = True
                    self._timer.start()

        with self._lock:
            if self._timer is None:
                self._timer = threading.Timer(interval_s, loop)
                self._timer.daemon = True
                self._timer.start()

    def stop(self) -> None:
        with self._lock:
            t, self._timer = self._timer, None
        if t is not None:
            t.cancel()
