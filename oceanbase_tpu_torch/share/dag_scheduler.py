"""Tenant DAG scheduler: prioritized background task graphs.

Reference surface: ObTenantDagScheduler (share/scheduler/
ob_tenant_dag_scheduler.h:1179) — compaction/DDL/backup work is expressed
as DAGs of tasks; the scheduler runs them on bounded worker pools ordered
by priority, records failures in a warning history
(share/scheduler/ob_dag_warning_history_mgr.h), and exposes progress.

The rebuild keeps the same model: a Dag owns tasks with dependencies; the
scheduler pops READY tasks from the highest-priority non-empty queue.
`run_until_idle()` drains everything on the calling thread (deterministic
for tests and single-process deployments); `start(n)` runs a thread pool
for live servers.
"""

from __future__ import annotations

import enum
import itertools
import threading
import traceback
from collections import deque
from dataclasses import dataclass, field


class DagPriority(enum.IntEnum):
    """Lower value = more urgent (matches the reference's prio ordering:
    urgent system dags, then mini, minor, major, background)."""

    URGENT = 0
    MINI_MERGE = 1
    MINOR_MERGE = 2
    MAJOR_MERGE = 3
    BACKGROUND = 4


@dataclass
class DagTask:
    fn: object  # callable() -> None
    name: str = ""
    deps: list["DagTask"] = field(default_factory=list)
    done: bool = False
    error: str = ""

    @property
    def ready(self) -> bool:
        return not self.done and all(d.done for d in self.deps)


@dataclass
class Dag:
    dag_type: str
    priority: DagPriority
    key: tuple = ()  # dedup identity (e.g. (tablet_id, "mini"))
    tasks: list[DagTask] = field(default_factory=list)
    dag_id: int = 0
    failed: bool = False
    # full-link tracing: (trace_id, parent_span_id) of the statement that
    # queued this dag — captured at add_dag so each task's span lands in
    # the initiating statement's trace tree even though it runs later
    trace_ctx: tuple | None = None
    # progress row in the tenant LongOps registry (set by the scheduler)
    long_op: object = None

    def add_task(self, fn, name: str = "", deps: list[DagTask] | None = None) -> DagTask:
        t = DagTask(fn, name or f"task{len(self.tasks)}", list(deps or []))
        self.tasks.append(t)
        return t

    @property
    def finished(self) -> bool:
        return self.failed or all(t.done for t in self.tasks)


@dataclass
class DagWarning:
    dag_type: str
    key: tuple
    task: str
    error: str


class TenantDagScheduler:
    def __init__(self, warning_capacity: int = 512, tracer=None, long_ops=None):
        # observability hooks (server/diag.Tracer + LongOps): when wired,
        # every task runs under a "dag task" span in the queueing
        # statement's trace, and each dag gets a __all_virtual_long_ops row
        self.tracer = tracer
        self.long_ops = long_ops
        self._queues: dict[DagPriority, deque[Dag]] = {
            p: deque() for p in DagPriority
        }
        self._keys: set[tuple] = set()
        self._ids = itertools.count(1)
        self._lock = threading.RLock()
        self.warnings: deque[DagWarning] = deque(maxlen=warning_capacity)
        self.scheduled = 0
        self.completed = 0
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._work = threading.Condition(self._lock)

    # ------------------------------------------------------------- submit
    def add_dag(self, dag: Dag) -> bool:
        """Queue a dag; duplicate keys are rejected (the reference dedups
        merge dags per tablet so one tablet never compacts twice at once)."""
        with self._lock:
            if dag.key and dag.key in self._keys:
                return False
            dag.dag_id = next(self._ids)
            if dag.key:
                self._keys.add(dag.key)
            if dag.trace_ctx is None and self.tracer is not None:
                dag.trace_ctx = self.tracer.current_ctx()
            if self.long_ops is not None and dag.long_op is None:
                dag.long_op = self.long_ops.start(
                    dag.dag_type, target=str(dag.key) if dag.key else "",
                    total=len(dag.tasks),
                    trace_id=dag.trace_ctx[0] if dag.trace_ctx else 0,
                )
            self._queues[dag.priority].append(dag)
            self.scheduled += 1
            self._work.notify_all()
            return True

    # ------------------------------------------------------------ running
    def _next_task(self):
        """Highest-priority dag with a ready task."""
        for p in DagPriority:
            q = self._queues[p]
            for dag in list(q):
                if dag.failed or dag.finished:
                    continue
                for t in dag.tasks:
                    if t.ready and not getattr(t, "_claimed", False):
                        t._claimed = True
                        return dag, t
        return None

    def _finish_dag(self, dag: Dag):
        self._queues[dag.priority].remove(dag)
        self._keys.discard(dag.key)
        self.completed += 1
        if self.long_ops is not None and dag.long_op is not None:
            self.long_ops.finish(dag.long_op, ok=not dag.failed)

    def _run_one(self) -> bool:
        with self._lock:
            nxt = self._next_task()
            if nxt is None:
                # sweep finished/failed dags
                for p in DagPriority:
                    for dag in [d for d in self._queues[p] if d.finished]:
                        self._finish_dag(dag)
                return False
            dag, task = nxt
        try:
            if self.tracer is not None:
                with self.tracer.span(
                    "dag task", ctx=dag.trace_ctx,
                    dag_type=dag.dag_type, task=task.name, dag_id=dag.dag_id,
                ):
                    task.fn()
            else:
                task.fn()
            task.done = True
            if self.long_ops is not None and dag.long_op is not None:
                self.long_ops.update(
                    dag.long_op,
                    done=sum(1 for t in dag.tasks if t.done),
                    message=task.name,
                )
        except Exception as e:  # noqa: BLE001 - background task boundary
            task.error = f"{type(e).__name__}: {e}"
            with self._lock:
                dag.failed = True
                self.warnings.append(
                    DagWarning(dag.dag_type, dag.key, task.name, task.error)
                )
                traceback.clear_frames(e.__traceback__)
        with self._lock:
            if dag.finished:
                if dag in self._queues[dag.priority]:
                    self._finish_dag(dag)
        return True

    def run_until_idle(self, max_tasks: int = 100000) -> int:
        """Drain all runnable work on the calling thread (test/deterministic
        mode). Returns tasks executed."""
        n = 0
        while n < max_tasks and self._run_one():
            n += 1
        return n

    # ------------------------------------------------------ thread pool
    def start(self, n_workers: int = 2) -> None:
        def worker():
            while not self._stop.is_set():
                if not self._run_one():
                    with self._work:
                        self._work.wait(timeout=0.05)

        with self._lock:
            if self._threads:
                return
            for i in range(n_workers):
                t = threading.Thread(target=worker, daemon=True,
                                     name=f"dag-worker-{i}")
                t.start()
                self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        with self._work:
            self._work.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()
        self._stop.clear()

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())
