"""Statement interrupt checkpoints.

Counterpart of `checkpoint` in `oceanbase_tpu/share/interrupt.py` without
the cluster bus: a running statement installs an InterruptChecker for its
thread, and the engines call `checkpoint()` between device programs
(between chunks of an out-of-core run, between partitions of a grace-hash
run). An interrupted statement raises QueryInterrupted there and unwinds.
"""

from __future__ import annotations

import threading


class QueryInterrupted(Exception):
    """Raised at a statement checkpoint after an interrupt arrived."""


class InterruptChecker:
    def __init__(self, interrupt_id=None):
        self.interrupt_id = interrupt_id
        self.reason = ""
        self._fired = threading.Event()

    def interrupt(self, reason: str = "killed") -> None:
        self.reason = reason
        self._fired.set()

    @property
    def is_set(self) -> bool:
        return self._fired.is_set()

    def check(self) -> None:
        if self.is_set:
            raise QueryInterrupted(
                f"query {self.interrupt_id} interrupted: {self.reason}")


_tls = threading.local()


def set_current(checker: InterruptChecker | None):
    """Install the running statement's checker for this thread; returns
    the previous one (restore in a finally)."""
    prev = getattr(_tls, "checker", None)
    _tls.checker = checker
    return prev


def current_checker() -> InterruptChecker | None:
    return getattr(_tls, "checker", None)


def checkpoint() -> None:
    """Raise QueryInterrupted if the current statement was interrupted."""
    c = current_checker()
    if c is not None:
        c.check()
