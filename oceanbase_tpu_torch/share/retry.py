"""Statement-level retry control: error taxonomy, policies, deadlines.

Reference surface: ObQueryRetryCtrl (observer/ob_query_retry_ctrl.h) — every
error a statement can surface is classified into a retry policy before the
session gives up; retryable classes re-drive the statement (refreshing the
location cache, re-electing routing, flushing stale plans) with backoff until
the statement deadline (ob_query_timeout / ob_trx_timeout) expires, at which
point the statement fails with a *timeout* error, never the raw transient.

The rebuild keeps the same three pieces:

- ``classify(err)``        -> RetryPolicy       (the taxonomy)
- ``Deadline``             -> ob_query_timeout on the bus virtual clock
- ``RetryController``      -> per-statement attempt/backoff bookkeeping

All waits are in *virtual* seconds: the session retry loop burns them via
``cluster.settle`` so palf elections progress during the backoff, exactly
like the reference's retry sleep overlapping with location cache refresh.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

# ------------------------------------------------------------------ errors


class StatementTimeout(Exception):
    """Base for deadline expiries; never retried."""


class QueryTimeout(StatementTimeout):
    """ob_query_timeout expired (OB_TIMEOUT analog)."""


class TrxTimeout(StatementTimeout):
    """ob_trx_timeout expired (OB_TRANS_TIMEOUT analog)."""


class StaleLocation(Exception):
    """Location cache kept pointing at a non-ready replica; the leader for
    the log stream could not be resolved locally (OB_LS_LOCATION_NOT_EXIST
    analog). Retryable after a cache refresh once the election settles."""


class PxAdmissionTimeout(Exception):
    """PX admission queue wait exceeded its bound (OB_ERR_SCHEDULER_THREAD_
    NOT_ENOUGH analog). Retryable: quota frees up as peers finish."""


class SchemaVersionMismatch(Exception):
    """A cached plan was compiled against a schema version that changed
    under the statement (OB_SCHEMA_EAGAIN analog). Retry immediately after
    flushing the plan cache."""


class CommitUnknown(Exception):
    """palf commit-wait timed out: the commit outcome is *unknown* (the log
    may still replicate later), so the statement must not be blindly
    re-driven. Non-retryable, surfaced as a timeout class."""


class DeviceOOM(Exception):
    """Device memory exhausted mid-statement (torch.OutOfMemoryError, or
    its errsim twin EN_DEVICE_OOM on CPU chaos runs). Retryable through the degradation ladder: evict + shrink,
    re-plan chunked, finally execute on host — never surfaced raw."""


class DeviceMemoryTimeout(Exception):
    """Device-memory reservation wait exceeded its bound (the governor
    queue stayed full). Retryable: reservations free up as peers
    finish, exactly like PX admission quota."""


# ---------------------------------------------------------------- policies

#: policy kinds (mirrors ObQueryRetryCtrl's retry_type)
NONE = "none"            # not retryable: surface the error
IMMEDIATE = "immediate"  # retry at once (schema mismatch, plan flush)
BACKOFF = "backoff"      # linear backoff on the virtual clock until deadline
CAPPED = "capped"        # backoff, but give up after max_retries attempts


@dataclass(frozen=True)
class RetryPolicy:
    kind: str = NONE
    reason: str = "non-retryable"
    #: linear backoff base, virtual seconds; attempt N waits base * N
    base_wait: float = 0.0
    #: cap a single backoff wait
    max_wait: float = 2.0
    #: None = bounded only by the deadline
    max_retries: Optional[int] = None
    #: invalidate + re-resolve the location cache between attempts
    refresh_location: bool = False
    #: drop cached plans before the next attempt
    flush_plan_cache: bool = False

    @property
    def retryable(self) -> bool:
        return self.kind != NONE


NOT_RETRYABLE = RetryPolicy()

#: NotMaster / stale location: the replica we routed to is not (or no longer)
#: the ready leader. Refresh the cache and back off so the election settles.
LOCATION_REFRESH = RetryPolicy(
    kind=BACKOFF, reason="not master, location refresh",
    base_wait=0.05, max_wait=1.0, refresh_location=True,
)

STALE_LOCATION = RetryPolicy(
    kind=BACKOFF, reason="stale location cache",
    base_wait=0.05, max_wait=1.0, refresh_location=True,
)

#: Injected transient faults (errsim): short backoff, bounded attempts so a
#: permanently armed point (prob=1, count=-1) cannot spin until the deadline.
INJECTED_TRANSIENT = RetryPolicy(
    kind=CAPPED, reason="injected transient error",
    base_wait=0.02, max_wait=0.5, max_retries=16,
)

PX_ADMISSION = RetryPolicy(
    kind=CAPPED, reason="px admission timeout",
    base_wait=0.05, max_wait=1.0, max_retries=4,
)

SCHEMA_EAGAIN = RetryPolicy(
    kind=IMMEDIATE, reason="schema version mismatch",
    flush_plan_cache=True, max_retries=8,
)

WRITE_CONFLICT = RetryPolicy(
    kind=BACKOFF, reason="write-write conflict",
    base_wait=0.02, max_wait=0.5,
)

#: Device OOM: exactly three attempts — one per rung of the degradation
#: ladder (evict + shrink pool, re-plan chunked, host fallback). The
#: host rung cannot OOM, so a fourth attempt would mean a logic bug.
DEVICE_OOM = RetryPolicy(
    kind=CAPPED, reason="device oom",
    base_wait=0.02, max_wait=0.5, max_retries=3,
)

DEVICE_MEMORY = RetryPolicy(
    kind=CAPPED, reason="device memory reservation timeout",
    base_wait=0.05, max_wait=1.0, max_retries=4,
)

#: Corrupt transient storage mid-statement (a spill segment failed its
#: checksum): the bad file is already deleted by the reader, so a
#: re-drive recomputes it from the base tables. Bounded — corruption
#: of DURABLE state (checkpoint, sstable) surfaces through recovery or
#: the scrubber instead, never a statement retry loop.
STORAGE_CORRUPT = RetryPolicy(
    kind=CAPPED, reason="storage corruption recompute",
    base_wait=0.0, max_wait=0.1, max_retries=3,
)


def _is_device_oom(err: BaseException) -> bool:
    """Recognize the torch caching allocator's out-of-memory error
    (torch.OutOfMemoryError) without importing torch (share/ stays
    importable on bare interpreters)."""
    return type(err).__name__ == "OutOfMemoryError"


def classify(err: BaseException) -> RetryPolicy:
    """Map an engine failure onto its retry policy.

    Import targets lazily: share/ must stay importable without tx/ or
    server/ loaded (tx imports share.errsim; server imports share.*)."""
    from .errsim import InjectedError
    from .interrupt import QueryInterrupted

    if isinstance(err, (StatementTimeout, QueryInterrupted, CommitUnknown)):
        return NOT_RETRYABLE
    if isinstance(err, StaleLocation):
        return STALE_LOCATION
    if isinstance(err, PxAdmissionTimeout):
        return PX_ADMISSION
    if isinstance(err, SchemaVersionMismatch):
        return SCHEMA_EAGAIN
    if isinstance(err, DeviceOOM) or _is_device_oom(err):
        return DEVICE_OOM
    if isinstance(err, DeviceMemoryTimeout):
        return DEVICE_MEMORY
    if isinstance(err, InjectedError):
        return INJECTED_TRANSIENT
    try:
        from ..storage.integrity import CorruptBlock
    except Exception:  # pragma: no cover - storage layer absent
        pass
    else:
        if isinstance(err, CorruptBlock):
            return STORAGE_CORRUPT
    try:
        from ..tx.txn import NotMaster, WriteConflict
    except Exception:  # pragma: no cover - tx layer absent in unit slices
        return NOT_RETRYABLE
    if isinstance(err, NotMaster):
        return LOCATION_REFRESH
    if isinstance(err, WriteConflict):
        return WRITE_CONFLICT
    return NOT_RETRYABLE


# ---------------------------------------------------------------- deadline


@dataclass(slots=True)
class Deadline:
    """An absolute point on the bus virtual clock.

    One Deadline object travels with the statement (thread-local, see
    ``deadline_scope``) so plan compile, PX admission, worker waits, DAS
    routing and palf commit waits all bound themselves by the same clock."""

    clock: Callable[[], float]
    at: float
    label: str = "ob_query_timeout"

    @classmethod
    def after(cls, clock: Callable[[], float], timeout_s: float,
              label: str = "ob_query_timeout") -> "Deadline":
        return cls(clock=clock, at=clock() + timeout_s, label=label)

    def remaining(self) -> float:
        return self.at - self.clock()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def _error(self) -> StatementTimeout:
        exc = TrxTimeout if self.label == "ob_trx_timeout" else QueryTimeout
        return exc(f"{self.label} expired (deadline {self.at:.3f}s on the "
                   f"virtual clock)")

    def check(self) -> None:
        if self.expired:
            raise self._error()

    def bound(self, timeout_s: Optional[float]) -> float:
        """Clamp a private timeout by the statement deadline. Expired
        deadlines raise rather than returning a non-positive wait."""
        self.check()
        rem = self.remaining()
        if timeout_s is None:
            return rem
        return min(timeout_s, rem)

    def tighter_than(self, timeout_s: Optional[float]) -> bool:
        return timeout_s is None or self.remaining() < timeout_s

    @staticmethod
    def earliest(*deadlines: Optional["Deadline"]) -> Optional["Deadline"]:
        live = [d for d in deadlines if d is not None]
        if not live:
            return None
        return min(live, key=lambda d: d.at)


_tls = threading.local()


def current_deadline() -> Optional[Deadline]:
    return getattr(_tls, "deadline", None)


def set_current_deadline(d: Optional[Deadline]) -> None:
    _tls.deadline = d


@contextmanager
def deadline_scope(d: Optional[Deadline]):
    prev = current_deadline()
    set_current_deadline(d)
    try:
        yield d
    finally:
        set_current_deadline(prev)


def checkpoint_deadline() -> None:
    """Called from share.interrupt.checkpoint(): unwind an expired statement
    at the next cooperative checkpoint, like ObInterruptChecker polling the
    worker's retire timestamp."""
    d = current_deadline()
    if d is not None:
        d.check()


# -------------------------------------------------------------- controller


@dataclass
class Attempt:
    reason: str
    wait_s: float
    error: str


@dataclass(slots=True)
class RetryController:
    """Per-statement retry bookkeeping (ObQueryRetryCtrl's retry_cnt /
    retry_info). The session loop owns location refresh and the actual
    backoff sleep (it must drive the cluster, which share/ cannot see)."""

    deadline: Optional[Deadline] = None
    retry_cnt: int = 0
    attempts: list = field(default_factory=list)
    _per_policy: dict = field(default_factory=dict)

    def decide(self, err: BaseException,
               stmt_retryable: bool = True) -> Optional[RetryPolicy]:
        """Return the policy to apply, or None if the statement must fail.

        ``stmt_retryable`` is False for statements whose side effects are
        not replayable (DML inside an explicit transaction: the tx already
        staged partial writes; OB likewise only retries at statement level
        when the whole statement can be re-driven)."""
        policy = classify(err)
        if not policy.retryable:
            return None
        if not stmt_retryable and policy.kind != IMMEDIATE:
            return None
        if self.retry_cnt >= 256:  # belt: no unbounded redrive, ever
            return None
        n = self._per_policy.get(policy.reason, 0)
        if policy.max_retries is not None and n >= policy.max_retries:
            return None
        return policy

    def record(self, policy: RetryPolicy, err: BaseException) -> float:
        """Account one retry; returns the backoff wait in virtual seconds."""
        n = self._per_policy.get(policy.reason, 0) + 1
        self._per_policy[policy.reason] = n
        self.retry_cnt += 1
        wait = min(policy.base_wait * n, policy.max_wait)
        if self.deadline is not None:
            wait = min(wait, max(self.deadline.remaining(), 0.0))
        self.attempts.append(Attempt(policy.reason, wait,
                                     f"{type(err).__name__}: {err}"))
        return wait

    @property
    def retry_info(self) -> str:
        """Compact audit string: 'reason x count; ...' (retry_info column)."""
        seen: dict[str, int] = {}
        for a in self.attempts:
            seen[a.reason] = seen.get(a.reason, 0) + 1
        return "; ".join(f"{r} x{c}" for r, c in seen.items())

    def timeout_error(self, last: BaseException) -> StatementTimeout:
        """Deadline expired while retrying: surface a timeout chaining the
        last transient, never the raw NotMaster/InjectedError."""
        assert self.deadline is not None
        err = self.deadline._error()
        err.__cause__ = last
        return err


__all__ = [
    "StatementTimeout", "QueryTimeout", "TrxTimeout", "StaleLocation",
    "PxAdmissionTimeout", "SchemaVersionMismatch", "CommitUnknown",
    "DeviceOOM", "DeviceMemoryTimeout",
    "RetryPolicy", "classify", "Deadline", "RetryController",
    "current_deadline", "set_current_deadline", "deadline_scope",
    "checkpoint_deadline",
    "NONE", "IMMEDIATE", "BACKOFF", "CAPPED",
    "NOT_RETRYABLE", "LOCATION_REFRESH", "STALE_LOCATION",
    "INJECTED_TRANSIENT", "PX_ADMISSION", "SCHEMA_EAGAIN", "WRITE_CONFLICT",
    "DEVICE_OOM", "DEVICE_MEMORY", "STORAGE_CORRUPT",
]
