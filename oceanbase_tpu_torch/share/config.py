"""Typed cluster/tenant parameter system with hot reload.

Reference surface: the ~650 DEF_INT/DEF_CAP/DEF_TIME/DEF_BOOL parameter
declarations (share/parameter/ob_parameter_seed.ipp:36+) and the config
manager that validates, persists and hot-reloads them (ObConfigManager,
share/config/ob_config_manager.h; ALTER SYSTEM SET handled via
observer/ob_server_reload_config.cpp).

The rebuild keeps the same model — a declarative registry of typed,
range-checked, scoped parameters; dynamic ones take effect immediately via
change callbacks, static ones require restart — with a compact seed of the
parameters that actually gate rebuild behavior.

Value syntax follows the reference: capacities accept K/M/G/T suffixes,
times accept us/ms/s/m/h suffixes.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field


class ConfigError(Exception):
    pass


_CAP_RE = re.compile(r"^(\d+(?:\.\d+)?)\s*([KMGTP]?)B?$", re.I)
_TIME_RE = re.compile(r"^(\d+(?:\.\d+)?)\s*(us|ms|s|m|h|d)?$", re.I)
_CAP_MULT = {"": 1, "K": 1 << 10, "M": 1 << 20, "G": 1 << 30,
             "T": 1 << 40, "P": 1 << 50}
_TIME_MULT = {"us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0,
              "d": 86400.0, "": 1.0}


def parse_capacity(v) -> int:
    if isinstance(v, (int, float)):
        return int(v)
    m = _CAP_RE.match(str(v).strip())
    if not m:
        raise ConfigError(f"bad capacity {v!r}")
    return int(float(m.group(1)) * _CAP_MULT[m.group(2).upper()])


def parse_time(v) -> float:
    """Time value in seconds."""
    if isinstance(v, (int, float)):
        return float(v)
    m = _TIME_RE.match(str(v).strip())
    if not m:
        raise ConfigError(f"bad time {v!r}")
    return float(m.group(1)) * _TIME_MULT[(m.group(2) or "").lower()]


_PARSERS = {
    "int": lambda v: int(str(v), 0),
    "double": lambda v: float(v),
    "bool": lambda v: (
        v if isinstance(v, bool)
        else {"true": True, "1": True, "on": True,
              "false": False, "0": False, "off": False}[str(v).lower()]
    ),
    "str": lambda v: str(v),
    "capacity": parse_capacity,
    "time": parse_time,
}


@dataclass(frozen=True)
class Param:
    name: str
    type: str  # int | double | bool | str | capacity | time
    default: object
    info: str = ""
    scope: str = "tenant"  # cluster | tenant
    dynamic: bool = True  # hot-reloadable (False -> takes effect at restart)
    min: float | None = None
    max: float | None = None
    choices: tuple[str, ...] | None = None

    def parse(self, value):
        try:
            v = _PARSERS[self.type](value)
        except (KeyError, ValueError, TypeError) as e:
            raise ConfigError(f"{self.name}: bad value {value!r}: {e}") from None
        if self.min is not None and v < self.min:
            raise ConfigError(f"{self.name}: {v} < min {self.min}")
        if self.max is not None and v > self.max:
            raise ConfigError(f"{self.name}: {v} > max {self.max}")
        if self.choices is not None and v not in self.choices:
            raise ConfigError(f"{self.name}: {v!r} not in {self.choices}")
        return v


def default_params() -> list[Param]:
    """Seed registry: the parameters the rebuild's subsystems consult.

    Names mirror the reference's where a direct analog exists
    (ob_parameter_seed.ipp)."""
    return [
        # SQL / plan cache
        Param("plan_cache_capacity", "int", 128,
              "max compiled plans (XLA executables) kept per tenant",
              min=1, max=1 << 16),
        Param("ob_enable_plan_cache", "bool", True,
              "serve compiled plans from the cache"),
        Param("parallel_servers_target", "int", 64,
              "cluster-wide PX worker admission quota", scope="cluster",
              min=0),
        Param("ob_sql_parallel_degree", "int", 8,
              "default DOP for PX plans", min=1, max=4096),
        Param("ob_batch_max_size", "int", 16,
              "cross-session micro-batching: max fast-path statements "
              "folded into one batched device dispatch (1 disables "
              "batching); clamped by the tenant unit's max_workers",
              min=1, max=1024),
        Param("ob_batch_max_wait_us", "int", 200,
              "cross-session micro-batching: group-commit window (us) a "
              "batch leader holds open for followers before dispatching",
              min=0, max=1_000_000),
        Param("ob_batch_follower_timeout", "time", 10.0,
              "continuous batching: how long a follower lane waits on "
              "its cohort's dispatch before pulling out and re-executing "
              "solo (a queued leader waits 2x this for gate admission)",
              min=0.01, max=600.0),
        Param("ob_batch_queue_depth", "int", 32,
              "continuous batching: max forming groups queued per tenant "
              "at the dispatch gate; arrivals beyond it shed to the solo "
              "fast path", min=1, max=4096),
        Param("ob_enable_result_narrow", "bool", True,
              "whole-statement fusion: compile the final result-frame "
              "gather (compaction + projection to the rows the client "
              "gets) INTO the plan's device program — one dispatch, one "
              "D2H of final bytes"),
        Param("ob_result_narrow_rows", "int", 256,
              "fused result frame seed width (rows) when the plan root "
              "gives no exact bound (LIMIT/scalar aggregate do); grows "
              "pow2 on frame overflow", min=1, max=1 << 20),
        Param("ob_result_narrow_max_rows", "int", 4096,
              "fused result frame ceiling: a statement whose live result "
              "exceeds this falls back to the plain lazy cursor (wide "
              "results want the transfer-on-touch contract anyway)",
              min=1, max=1 << 24),
        Param("ob_enable_result_cache", "bool", True,
              "device-resident result cache: repeated dashboard "
              "statements (same text, literals, snapshot watermark) "
              "serve the cached narrowed frame with zero dispatches"),
        Param("ob_result_cache_size", "capacity", 4 << 20,
              "result cache capacity (bytes, LRU): charged against the "
              "tenant memory unit through the governor residency "
              "surface", min=0),
        Param("ob_result_cache_entry_limit", "capacity", 65536,
              "max bytes one cached result may occupy (dashboards are "
              "small; big results stay on the lazy cursor path)", min=0),
        Param("ob_enable_completion_drain", "bool", False,
              "serve-then-account: move audit/summary/metrics/timeline "
              "completion folds and governor release behind the wire "
              "write onto a bounded drain worker (exactly-once; "
              "observability surfaces lag the response by the drain "
              "depth — tools that read sql_audit synchronously should "
              "leave this off)"),
        Param("ob_completion_drain_depth", "int", 256,
              "completion drain: max queued statement-completion folds "
              "before submitters fold inline (backpressure, no drops)",
              min=1, max=1 << 16),
        Param("ob_enable_batch_coalesce", "bool", True,
              "micro-batching: let two heterogeneous-plan cohorts "
              "sharing a pow2 bucket shape coalesce into one fused "
              "device dispatch at the gate"),
        Param("ob_tenant_admission_slots", "int", 8,
              "weighted tenant admission: running permits for gated "
              "fast-path statements, shared cluster-wide and allotted "
              "by TenantUnit.weight share; a flooding tenant over its "
              "share waits while other tenants are active (single-"
              "tenant clusters bypass the permit)", min=1, max=1024),
        Param("mysql_async_workers", "int", 8,
              "async MySQL front end: bounded statement-execution worker "
              "pool size (protocol work stays on the event loop)",
              min=1, max=256),
        # memory / freeze / compaction
        Param("memstore_limit", "capacity", 256 << 20,
              "per-tenant active+frozen memtable budget"),
        Param("freeze_trigger_ratio", "double", 0.5,
              "fraction of memstore_limit that triggers a tenant freeze",
              min=0.01, max=0.99),
        Param("minor_compact_trigger", "int", 2,
              "delta sstable count that triggers a minor compaction",
              min=1, max=64),
        Param("major_compact_interval", "time", 0.0,
              "0 disables time-based major compaction"),
        # log / consensus
        Param("log_disk_utilization_limit", "double", 0.95,
              "palf stops appending beyond this disk fraction",
              scope="cluster", min=0.5, max=1.0),
        Param("lease_duration", "time", 4.0,
              "election lease window (RTO driver)", scope="cluster",
              dynamic=False, min=0.5),
        # observability
        Param("enable_sql_audit", "bool", True,
              "record per-statement audit entries"),
        Param("sql_audit_memory_limit", "capacity", 64 << 20,
              "ring-buffer budget for sql_audit"),
        Param("enable_perf_event", "bool", True,
              "per-operator plan monitor collection"),
        Param("enable_query_profile", "bool", True,
              "per-query TPU resource profiling: compile cache hit/miss, "
              "host<->device transfer bytes, device working set"),
        Param("trace_log_slow_query_watermark", "time", 1.0,
              "statements slower than this get a flight-recorder "
              "diagnostic bundle (span tree, plan, metrics delta)",
              min=0.0),
        Param("syslog_level", "str", "INFO", "server log level",
              choices=("DEBUG", "TRACE", "INFO", "WARN", "ERROR")),
        # workload repository (server/workload.py)
        Param("enable_sql_stat", "bool", True,
              "fold completed statements into the digest-keyed statement "
              "summary and table/column access stats"),
        Param("ob_sql_stat_max_digests", "int", 256,
              "statement-summary digest cap; cold digests evict beyond it",
              min=8, max=1 << 20),
        Param("workload_snapshot_capacity", "int", 16,
              "bounded count of workload snapshots held in memory",
              min=2, max=4096),
        Param("workload_snapshot_interval", "time", 0.0,
              "0 disables periodic workload snapshots; otherwise at most "
              "one snapshot per interval, checked at statement completion",
              min=0.0),
        # serving timeline + health sentinel (share/timeline.py,
        # server/sentinel.py)
        Param("enable_serving_timeline", "bool", True,
              "feed the time-sliced serving telemetry ring (device busy, "
              "queue depth, per-tenant QoS) from the statement path"),
        Param("serving_timeline_bucket", "time", 1.0,
              "width of one serving-timeline bucket", min=0.05),
        Param("serving_timeline_capacity", "int", 120,
              "bounded count of timeline buckets held in the ring",
              min=8, max=1 << 16),
        # host-tax gap ledger + stack sampler (share/gap_ledger.py)
        Param("enable_host_tax", "bool", True,
              "conservation-account every statement's e2e wall into "
              "named host phases + an explicit unattributed residual "
              "(share/gap_ledger.py, __all_virtual_host_tax)"),
        Param("host_tax_max_digests", "int", 256,
              "bounded count of per-digest host-tax aggregates",
              min=8, max=1 << 16),
        Param("host_tax_window", "time", 1.0,
              "width of one host-tax chip-idle window bucket", min=0.05),
        Param("enable_stack_sampler", "bool", False,
              "keep the in-process wall-clock stack sampler armed "
              "continuously (otherwise it only auto-arms after a "
              "statement crosses the slow-query watermark)"),
        Param("stack_sampler_interval", "time", 0.005,
              "stack sampler period", min=0.0001),
        Param("stack_sampler_auto_arm", "time", 2.0,
              "how long the sampler stays armed after a statement "
              "crosses trace_log_slow_query_watermark; 0 disables "
              "auto-arming", min=0.0),
        # operator-level plan telemetry (engine/plan_profile.py)
        Param("enable_plan_profile", "bool", True,
              "sampled per-operator profiled execution: segmented fenced "
              "stages yield device time / cardinality / bytes per plan "
              "node as (estimate, actual) calibration pairs "
              "(__all_virtual_sql_plan_monitor per-operator rows)"),
        Param("ob_plan_profile_sample", "int", 64,
              "profile every statement digest's first re-execution (one-"
              "shot digests never pay a segmented trace), then 1-in-N of "
              "its later executions; 0 = first re-execution only",
              min=0, max=1 << 20),
        Param("ob_plan_profile_max_digests", "int", 128,
              "bounded count of per-digest operator calibration records",
              min=1, max=1 << 16),
        Param("enable_health_sentinel", "bool", True,
              "evaluate health rules (latency regressions, starvation, "
              "compile storms...) on every workload snapshot"),
        Param("health_alert_capacity", "int", 256,
              "bounded count of sentinel alerts held in memory",
              min=8, max=1 << 16),
        Param("ob_layout_advisor_mode", "str", "off",
              "closed-loop layout advisor: off (explicit runs only "
              "propose), dry_run (also proposes on every workload "
              "snapshot, mutates nothing), auto (applies through "
              "background rebuild dags)",
              choices=("off", "dry_run", "auto")),
        Param("layout_advisor_max_bytes", "capacity", 512 << 20,
              "budget for advisor-materialized layouts (sorted "
              "projections); candidates over budget are narrowed to the "
              "role-referenced columns, then rejected"),
        # plan artifact store (engine/plan_artifact.py)
        Param("ob_plan_artifact_mode", "str", "off",
              "persistent compiled-plan artifacts: off (memory-only plan "
              "cache), ro (hydrate executables from disk, never write), "
              "rw (also export on compile and re-export on overflow "
              "recompile)",
              choices=("off", "ro", "rw")),
        Param("plan_artifact_dir", "str", "",
              "artifact store directory; empty resolves to "
              "<data_dir>/plan_artifacts (in-memory clusters need an "
              "explicit path for warm restarts to mean anything)"),
        Param("plan_artifact_max_bytes", "capacity", 256 << 20,
              "byte budget for exported executables on disk and for the "
              "boot-time warm-load of the hottest digests; coldest "
              "artifacts evict beyond it"),
        # elastic serving (follower reads + rootserver rebalancing)
        Param("ob_read_consistency", "str", "strong",
              "default read consistency for new sessions: strong (leader "
              "only), bounded_staleness (follower snapshot within "
              "ob_max_read_stale_us), weak (any replica watermark)",
              choices=("strong", "bounded_staleness", "weak")),
        Param("ob_max_read_stale_us", "int", 5_000_000,
              "bounded-staleness ceiling in microseconds of GTS time; a "
              "follower whose apply watermark lags further rejects the "
              "read back to the leader", min=0),
        Param("enable_leader_rebalance", "bool", True,
              "let the rootserver move LS leaders off unreachable or "
              "QoS-overloaded nodes as background dags"),
        Param("leader_rebalance_min_interval", "time", 5.0,
              "floor between rootserver rebalance passes (hysteresis "
              "against leader ping-pong)"),
        # device memory governor
        Param("ob_device_memory_limit", "capacity", 0,
              "device HBM budget the memory governor reserves against; "
              "0 = auto (a fraction of detected HBM, or a synthetic "
              "budget on CPU backends)", scope="cluster", min=0),
        Param("ob_governor_queue_timeout", "time", 5.0,
              "max wait on the 'device memory reservation' event before "
              "a statement is rejected (deadline-bounded)", min=0.0),
        Param("ob_governor_max_queue", "int", 64,
              "queue-depth backpressure: reservation requests beyond "
              "this many waiters are rejected immediately",
              scope="cluster", min=1, max=1 << 16),
        Param("ob_governor_cold_reserve", "capacity", 16 << 20,
              "conservative peak-working-set reservation for digests "
              "the workload repository has not measured yet", min=0),
        # storage
        Param("block_cache_size", "capacity", 256 << 20,
              "budget for decoded micro-block column cache"),
        Param("default_compress_func", "str", "for",
              "preferred micro-block codec family",
              choices=("raw", "for", "rle", "auto")),
        Param("micro_block_rows", "int", 16384,
              "rows per micro block at dump time", min=256, max=1 << 20),
        # storage integrity (storage/integrity.py + storage/scrub.py)
        Param("ob_scrub_interval", "time", 0.0,
              "floor between background storage-scrub passes verifying "
              "every durable artifact's checksum envelope; 0 disables "
              "the scrubber", min=0.0),
        Param("ob_errsim_disk_bitflip", "double", 0.0,
              "disk-fault injection: probability a durable write/read "
              "flips one payload byte (EN_DISK_BITFLIP arm)",
              min=0.0, max=1.0),
        Param("ob_errsim_disk_torn_write", "double", 0.0,
              "disk-fault injection: probability a durable write "
              "persists only a prefix (EN_DISK_TORN_WRITE arm)",
              min=0.0, max=1.0),
        Param("ob_errsim_disk_truncate", "double", 0.0,
              "disk-fault injection: probability a durable file loses "
              "its tail before a read (EN_DISK_TRUNCATE arm)",
              min=0.0, max=1.0),
        Param("ob_errsim_disk_io_error", "double", 0.0,
              "disk-fault injection: probability a durable read/write "
              "raises an I/O error (EN_IO_ERROR arm)",
              min=0.0, max=1.0),
        # security
        Param("secure_file_priv", "str", "",
              "directory non-root external-table locations must resolve "
              "inside; empty = root-only (MySQL secure_file_priv analog)",
              scope="cluster"),
    ]


class Config:
    """A parameter namespace (one per tenant + one cluster scope).

    set() validates, records, and fires change callbacks for dynamic
    params; static params are recorded but only picked up by subsystems
    that re-read at (re)start — matching the reference's semantics.
    """

    def __init__(self, params: list[Param] | None = None):
        self.registry: dict[str, Param] = {
            p.name: p for p in (params if params is not None else default_params())
        }
        self._values: dict[str, object] = {
            p.name: p.default for p in self.registry.values()
        }
        self._lock = threading.RLock()
        self._listeners: dict[str, list] = {}
        self.version = 0

    # ------------------------------------------------------------- access
    def get(self, name: str):
        try:
            return self._values[name]
        except KeyError:
            raise ConfigError(f"unknown parameter {name}") from None

    def __getitem__(self, name: str):
        return self.get(name)

    def set(self, name: str, value) -> None:
        p = self.registry.get(name)
        if p is None:
            raise ConfigError(f"unknown parameter {name}")
        v = p.parse(value)
        with self._lock:
            old = self._values[name]
            self._values[name] = v
            self.version += 1
            listeners = list(self._listeners.get(name, ())) if p.dynamic else []
        for fn in listeners:
            fn(name, old, v)

    def on_change(self, name: str, fn) -> None:
        """Register a hot-reload callback for a dynamic parameter."""
        if name not in self.registry:
            raise ConfigError(f"unknown parameter {name}")
        self._listeners.setdefault(name, []).append(fn)

    def snapshot(self) -> list[tuple[str, object, Param]]:
        with self._lock:
            return [
                (n, self._values[n], p)
                for n, p in sorted(self.registry.items())
            ]
