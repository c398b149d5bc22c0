"""Multi-version schema service.

Reference surface: ObMultiVersionSchemaService (share/schema/
ob_multi_version_schema_service.h:113) — a versioned in-memory cache of all
table schemas; every DDL produces a new schema version; executing code
takes a schema *guard* pinning one version so concurrent DDL never mutates
a statement's view mid-flight.

The rebuild keeps copy-on-write name->TableInfo maps per version. TableInfo
objects themselves carry runtime state (dictionaries, data versions) shared
across schema versions — the version history answers "which tables existed
and with what shape", not "what rows they held".
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from types import MappingProxyType


class SchemaError(Exception):
    pass


@dataclass(frozen=True)
class SchemaGuard:
    """An immutable view of the schema at one version."""

    version: int
    tables: MappingProxyType

    def get(self, name: str):
        return self.tables.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self.tables

    def names(self) -> list[str]:
        return sorted(self.tables)


class SchemaService:
    """Versioned table registry with guard-based reads."""

    def __init__(self, history_limit: int = 64):
        self._lock = threading.RLock()
        self._version = 0
        self._maps: dict[int, MappingProxyType] = {
            0: MappingProxyType({})
        }
        self._history_limit = history_limit

    @property
    def version(self) -> int:
        return self._version

    def guard(self, version: int | None = None) -> SchemaGuard:
        if version is None:
            # lock-free current-version read: dict.get is GIL-atomic, and
            # a publish race (version bumped before its map lands) simply
            # misses and falls through to the locked path below
            v = self._version
            m = self._maps.get(v)
            if m is not None:
                return SchemaGuard(v, m)
        with self._lock:
            v = self._version if version is None else version
            m = self._maps.get(v)
            if m is None:
                raise SchemaError(f"schema version {v} expired")
            return SchemaGuard(v, m)

    def apply_ddl(self, mutate) -> int:
        """Run a DDL mutation on a copy of the current map; publish it as a
        new version. `mutate(dict)` edits in place and may raise to abort."""
        with self._lock:
            cur = dict(self._maps[self._version])
            mutate(cur)
            self._version += 1
            self._maps[self._version] = MappingProxyType(cur)
            # retire old versions beyond the history window
            floor = self._version - self._history_limit
            for v in [v for v in self._maps if v < floor]:
                del self._maps[v]
            return self._version
