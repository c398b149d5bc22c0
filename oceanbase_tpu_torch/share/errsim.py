"""ERRSIM tracepoints + debug sync: runtime fault injection.

Reference surface: the ERRSIM build's EN_* tracepoints
(deps/oblib/src/lib/utility/ob_tracepoint_def.h, activated at runtime to
return injected errors at named code points) and ObDebugSync
(share/ob_debug_sync.h, named sync points where tests park/interleave
executions).

The rebuild keeps both always-on (they cost one dict lookup when idle):

  errsim_point("EN_MINI_MERGE")      raises the armed error (count-limited
                                     and/or probabilistic) at the point
  debug_sync("BEFORE_COMMIT")        runs a test-armed callback at the
                                     point — the deterministic harness's
                                     way to interleave actions mid-flow
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass


class InjectedError(Exception):
    """Default error raised by an armed tracepoint."""


@dataclass
class _Arm:
    error: Exception | None
    prob: float
    remaining: int  # -1 = unlimited
    fired: int = 0
    # scope the arm to one path class (ckpt/meta/artifact/spill/backup/
    # sstable — see storage/integrity.py); None fires for every class
    path_class: object = None


#: default seed for probabilistic arms; reseed() replays a chaos schedule
DEFAULT_SEED = 0xE5


class ErrsimRegistry:
    def __init__(self, seed: int = DEFAULT_SEED):
        self._arms: dict[str, _Arm] = {}
        self._lock = threading.Lock()
        self.seed = seed
        self._rng = random.Random(seed)

    def reseed(self, seed: int) -> None:
        """Reset the probabilistic-arm RNG so a logged chaos seed replays
        the exact same firing sequence."""
        with self._lock:
            self.seed = seed
            self._rng = random.Random(seed)

    def arm(self, name: str, error: Exception | None = None,
            prob: float = 1.0, count: int = -1,
            path_class: object = None) -> None:
        """Arm a tracepoint: `error` raises at the point (default
        InjectedError(name)); fires `count` times (-1 = until cleared)
        with probability `prob`. `path_class` (str or tuple of str)
        restricts a disk-fault arm to matching should_fire() callers."""
        with self._lock:
            self._arms[name] = _Arm(error, prob, count,
                                    path_class=path_class)

    def clear(self, name: str | None = None) -> None:
        with self._lock:
            if name is None:
                self._arms.clear()
            else:
                self._arms.pop(name, None)

    def fired(self, name: str) -> int:
        with self._lock:
            a = self._arms.get(name)
            return a.fired if a else 0

    def check(self, name: str) -> None:
        """Called at the injection point; raises if armed."""
        with self._lock:
            a = self._arms.get(name)
            if a is None or a.remaining == 0:
                return
            if a.prob < 1.0 and self._rng.random() >= a.prob:
                return
            if a.remaining > 0:
                a.remaining -= 1
            a.fired += 1
            err = a.error
        raise err if err is not None else InjectedError(name)

    def should_fire(self, name: str, path_class: str | None = None) -> bool:
        """Non-raising fire decision for data-corrupting arms (the disk
        fault layer in storage/integrity.py asks, then corrupts the bytes
        itself instead of raising). Honors prob/count exactly like check()
        and additionally filters on the arm's path-class scope."""
        with self._lock:
            a = self._arms.get(name)
            if a is None or a.remaining == 0:
                return False
            if a.path_class is not None:
                classes = (a.path_class if isinstance(a.path_class, (tuple, list, set, frozenset)) else (a.path_class,))
                if path_class not in classes:
                    return False
            if a.prob < 1.0 and self._rng.random() >= a.prob:
                return False
            if a.remaining > 0:
                a.remaining -= 1
            a.fired += 1
            return True


class DebugSyncRegistry:
    def __init__(self):
        self._actions: dict[str, object] = {}
        self._lock = threading.Lock()

    def activate(self, name: str, action) -> None:
        with self._lock:
            self._actions[name] = action

    def deactivate(self, name: str | None = None) -> None:
        with self._lock:
            if name is None:
                self._actions.clear()
            else:
                self._actions.pop(name, None)

    def reach(self, name: str) -> None:
        with self._lock:
            action = self._actions.get(name)
        if action is not None:
            action()


ERRSIM = ErrsimRegistry()
DEBUG_SYNC = DebugSyncRegistry()


def errsim_point(name: str) -> None:
    """The EN_* macro analog: call at a fault-injectable code point."""
    ERRSIM.check(name)


def debug_sync(name: str) -> None:
    """The DEBUG_SYNC macro analog: call at an interleavable code point."""
    DEBUG_SYNC.reach(name)
