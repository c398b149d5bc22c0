"""Completion drain: statement accounting moved off the serving path.

The gap ledger (share/gap_ledger.py) shows a warm fast-path statement
spending a measurable slice of its end-to-end wall inside the completion
finally block — sql_audit record assembly, statement-summary and host-tax folds,
metrics bulk, timeline record — all of it host work the CLIENT has no
reason to wait for. With ob_enable_completion_drain on, the serving
thread snapshots what those folds need (plain values: the ledger is
re-armed in place for the session's next statement) and hands a closure
to this bounded drain; the wire write happens first, the accounting
lands a moment later.

Exactly-once, no drops: a full queue (or a closed drain) runs the
closure INLINE on the submitting thread — backpressure degrades latency,
never accounting. flush() is the read-your-own-accounting barrier for
tools and tests; virtual-table materialization calls it so
`SELECT ... FROM sql_audit` still observes every prior statement."""

from __future__ import annotations

import threading
from collections import deque


class CompletionDrain:
    """One daemon worker over a bounded deque of zero-arg closures."""

    def __init__(self, depth: int = 256, metrics=None):
        self.depth = int(depth)
        self.metrics = metrics
        self._lock = threading.Lock()
        self._work: deque = deque()
        self._wake = threading.Condition(self._lock)
        self._thread = None
        self._closed = False
        # a generation counter + drained-count pair lets flush() wait for
        # "everything submitted before now" without tracking identities
        self.submitted = 0
        self.drained = 0
        self.inline = 0
        self.errors = 0

    # ------------------------------------------------------------ submit
    def submit(self, fn) -> None:
        """Run `fn` exactly once: queued to the worker normally, inline
        on this thread when the drain is full or closed."""
        with self._lock:
            if not self._closed and len(self._work) < self.depth:
                self._work.append(fn)
                self.submitted += 1
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._run, name="completion-drain",
                        daemon=True)
                    self._thread.start()
                self._wake.notify()
                return
            self.inline += 1
        self._call(fn)

    def _call(self, fn) -> None:
        try:
            fn()
        except Exception:
            self.errors += 1
            m = self.metrics
            if m is not None and m.enabled:
                m.add("completion drain errors")

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._work and not self._closed:
                    self._wake.wait()
                if not self._work and self._closed:
                    return
                fn = self._work.popleft()
            self._call(fn)
            with self._lock:
                self.drained += 1
                self._wake.notify_all()

    # ----------------------------------------------------------- barrier
    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every closure submitted before this call has run.
        Returns False on timeout (the worker is wedged — accounting will
        still land, just later)."""
        import time as _time

        with self._lock:
            target = self.submitted
            deadline = _time.monotonic() + timeout
            while self.drained < target:
                left = deadline - _time.monotonic()
                if left <= 0:
                    return False
                self._wake.wait(left)
        return True

    def close(self) -> None:
        """Stop accepting queued work and drain the backlog INLINE (the
        worker may already be gone at interpreter shutdown; accounting
        must still land exactly once)."""
        with self._lock:
            self._closed = True
            backlog = list(self._work)
            self._work.clear()
            self.drained += len(backlog)
            self._wake.notify_all()
        for fn in backlog:
            self._call(fn)

    def stats(self) -> dict:
        with self._lock:
            return {
                "submitted": self.submitted,
                "drained": self.drained,
                "inline": self.inline,
                "errors": self.errors,
                "queued": len(self._work),
            }
