"""Plan cache with literal parameterization.

Reference surface: ObPlanCache + the fast-parser parameterization pipeline
(src/sql/plan_cache/ob_plan_cache.h:227, sql/parser/ob_fast_parser.h). The
reference caches physical plans keyed by literal-normalized SQL so repeated
statements skip the compiler; a "plan set" under each key matches incoming
parameter types to a compiled plan.

On TPU the cached artifact is the jitted XLA executable, and a recompile
costs seconds — so parameterization is not an optimization but the thing
that makes a plan cache meaningful at all:

- numeric / decimal / date literals become runtime scalars (Literal.slot)
  fed to the jitted program as an extra argument; one executable serves
  every value.
- string literals, LIKE patterns, IN lists and function arguments stay
  baked: they drive host-side dictionary lookup tables at trace time (the
  reference marks the analogous cases "must be checked" fixed consts). Their
  values join the cache key, so a different pattern compiles a new plan
  rather than reusing a wrong one.

Eviction is LRU by entry count (the reference evicts by memory watermark,
ob_plan_cache.h evict_expired_plan; entry count is the honest proxy here
because the dominant cost is one XLA executable per entry).
"""

from __future__ import annotations

import re
import threading
from collections import OrderedDict
from dataclasses import dataclass, field, replace as dc_replace

import numpy as np

from ..core.dtypes import TypeKind
from ..expr import ir as E
from .logical import (
    Aggregate,
    Distinct,
    Filter,
    JoinOp,
    Limit,
    LogicalOp,
    Project,
    Scan,
    SetOp,
    Sort,
    TopN,
    Window,
)

# literal kinds whose values may become runtime parameters
_PARAM_KINDS = {
    TypeKind.INT8,
    TypeKind.INT16,
    TypeKind.INT32,
    TypeKind.INT64,
    TypeKind.FLOAT32,
    TypeKind.FLOAT64,
    TypeKind.DECIMAL,
    TypeKind.DATE,
    TypeKind.VECTOR,
}


@dataclass
class ParamizeResult:
    plan: LogicalOp
    values: list  # python values per slot, in slot order
    dtypes: list  # DataType per slot
    sig: tuple  # parameter type signature (part of the cache key)
    baked: tuple  # non-parameterizable literal values (part of the cache key)


class _Paramizer:
    def __init__(self):
        self.values = []
        self.dtypes = []
        self.baked = []

    # ---- expressions -----------------------------------------------------
    def expr(self, e: E.Expr | None, in_func: bool = False) -> E.Expr | None:
        if e is None:
            return None
        if isinstance(e, E.Literal):
            if (
                not in_func
                and e.value is not None
                and e.dtype.kind in _PARAM_KINDS
            ):
                slot = len(self.values)
                self.values.append(e.value)
                self.dtypes.append(e.dtype)
                return E.Literal(e.value, e.dtype, slot=slot)
            self.baked.append(e.value)
            return e
        if isinstance(e, E.ColRef):
            return e
        if isinstance(e, E.BinaryOp):
            return E.BinaryOp(e.op, self.expr(e.left, in_func), self.expr(e.right, in_func))
        if isinstance(e, E.Compare):
            return E.Compare(e.op, self.expr(e.left, in_func), self.expr(e.right, in_func))
        if isinstance(e, E.BoolOp):
            return E.BoolOp(e.op, tuple(self.expr(a, in_func) for a in e.args))
        if isinstance(e, E.Not):
            return E.Not(self.expr(e.arg, in_func))
        if isinstance(e, E.IsNull):
            return E.IsNull(self.expr(e.arg, in_func), e.negated)
        if isinstance(e, E.Cast):
            return E.Cast(self.expr(e.arg, in_func), e.dtype)
        if isinstance(e, E.Case):
            whens = tuple(
                (self.expr(c, in_func), self.expr(v, in_func)) for c, v in e.whens
            )
            return E.Case(whens, self.expr(e.default, in_func))
        if isinstance(e, E.InList):
            # membership sets become boolean LUTs / unrolled comparisons at
            # trace time; keep them baked and key-relevant
            self.baked.extend(e.values)
            return E.InList(self.expr(e.arg, in_func), e.values, e.negated)
        if isinstance(e, E.Between):
            return E.Between(
                self.expr(e.arg, in_func),
                self.expr(e.low, in_func),
                self.expr(e.high, in_func),
                e.negated,
            )
        if isinstance(e, E.Func):
            if e.name in ("vec_l2", "vec_ip", "vec_cosine"):
                # the QUERY VECTOR parameterizes (one executable per
                # column serves every query point — the ANN qps story);
                # the column ref stays structural
                return E.Func(e.name, (
                    self.expr(e.args[0], True),
                    self.expr(e.args[1], False),
                ))
            # function args (LIKE patterns, substr bounds) drive host-side
            # dictionary transforms during tracing: never parameterize
            return E.Func(e.name, tuple(self.expr(a, True) for a in e.args))
        raise NotImplementedError(type(e))

    # ---- plan nodes ------------------------------------------------------
    def plan(self, op: LogicalOp) -> LogicalOp:
        if isinstance(op, Scan):
            return dc_replace(op, pushed_filter=self.expr(op.pushed_filter))
        if isinstance(op, Filter):
            return dc_replace(op, child=self.plan(op.child), pred=self.expr(op.pred))
        if isinstance(op, Project):
            return dc_replace(
                op,
                child=self.plan(op.child),
                exprs=tuple((n, self.expr(e)) for n, e in op.exprs),
            )
        if isinstance(op, JoinOp):
            return dc_replace(
                op,
                left=self.plan(op.left),
                right=self.plan(op.right),
                left_keys=tuple(self.expr(e) for e in op.left_keys),
                right_keys=tuple(self.expr(e) for e in op.right_keys),
                residual=self.expr(op.residual),
            )
        if isinstance(op, Aggregate):
            if op.grouping_sets is not None:
                # set structure shapes the physical program: structural
                self.baked.append(("gsets", op.grouping_sets))
            return dc_replace(
                op,
                child=self.plan(op.child),
                group_keys=tuple((n, self.expr(e)) for n, e in op.group_keys),
                aggs=tuple(
                    (n, fn, self.expr(a), d) for n, fn, a, d in op.aggs
                ),
            )
        if isinstance(op, Sort):
            return dc_replace(
                op,
                child=self.plan(op.child),
                keys=tuple((self.expr(e), d) for e, d in op.keys),
            )
        if isinstance(op, Limit):
            # limit/offset shape the static output capacity: structural
            self.baked.append(("limit", op.n, op.offset))
            return dc_replace(op, child=self.plan(op.child))
        if isinstance(op, Distinct):
            return dc_replace(op, child=self.plan(op.child))
        if isinstance(op, TopN):
            # n/offset shape the static output capacity: structural
            self.baked.append(("topn", op.n, op.offset))
            return dc_replace(
                op,
                child=self.plan(op.child),
                keys=tuple((self.expr(e), d) for e, d in op.keys),
            )
        if isinstance(op, SetOp):
            # kind/all are structural (they shape the physical program)
            self.baked.append(("setop", op.kind, op.all))
            return dc_replace(
                op, left=self.plan(op.left), right=self.plan(op.right)
            )
        if isinstance(op, Window):
            def fix_extra(fn, x):
                # frame bounds / ntile buckets are ints shaping the kernel:
                # structural. lag/lead defaults are exprs: parameterize.
                if fn in ("lag", "lead") and x is not None:
                    off, dflt = x
                    self.baked.append(("winoff", off))
                    return (off, self.expr(dflt) if dflt is not None else None)
                if x is not None:
                    self.baked.append(("winextra", fn, x))
                return x

            return dc_replace(
                op,
                child=self.plan(op.child),
                funcs=tuple(
                    (
                        n, fn, self.expr(a),
                        tuple(self.expr(p) for p in pk),
                        tuple((self.expr(o), d) for o, d in ok),
                        fix_extra(fn, x),
                    )
                    for n, fn, a, pk, ok, x in op.funcs
                ),
            )
        raise NotImplementedError(type(op))


def parameterize(plan: LogicalOp) -> ParamizeResult:
    p = _Paramizer()
    plan2 = p.plan(plan)
    sig = tuple(str(t) for t in p.dtypes)
    return ParamizeResult(plan2, p.values, p.dtypes, sig, tuple(map(repr, p.baked)))


_GENSYM_RE = None


def plan_fingerprint(plan: LogicalOp) -> str:
    """Structural digest of a (parameterized) plan.

    Part of the cache key: literals the PLANNER consumes (ORDER BY ordinals,
    hoisted conjuncts, unnesting choices) leave no Literal node behind, so
    normalized SQL + params alone can collide across genuinely different
    plans. The dataclass repr covers node types, column refs, sort keys,
    limits and slot numbers deterministically; md5 keeps the key small.

    Gensym names ($agg3, $sub1, ...) come from global counters so two
    plannings of the SAME query get different numbers — canonicalize them
    by first occurrence before hashing."""
    import hashlib
    import re

    global _GENSYM_RE
    if _GENSYM_RE is None:
        _GENSYM_RE = re.compile(r"\$([a-z]+)\d+")
    mapping: dict[str, str] = {}

    def canon(m):
        tok = m.group(0)
        if tok not in mapping:
            mapping[tok] = f"${m.group(1)}#{len(mapping)}"
        return mapping[tok]

    r = _GENSYM_RE.sub(canon, repr(plan))
    return hashlib.md5(r.encode()).hexdigest()


def bind(values, dtypes, device) -> tuple:
    """Host-convert literal values to physical scalars: 0-d tensors of
    their storage dtype on the session's device."""
    import torch

    from ..expr.compile import bind_value

    return tuple(
        torch.as_tensor(np.asarray(bind_value(v, t)), device=device)
        for v, t in zip(values, dtypes)
    )


# ---- text-keyed fast tier (the ObPlanCache fast-parser front end) ----------
#
# The logical cache above still pays parse + resolve + rewrite + plan +
# parameterize on every statement just to COMPUTE its key. The fast tier
# keys on the kind-marked normalized text alone (parser.fast_normalize, one
# regex pass) and stores everything needed to rebuild the logical key
# without planning: the parameter signature, baked literals, plan
# fingerprint and referenced tables. A fast hit therefore still goes
# through PlanCache.get() with a freshly computed key_extra — schema-version
# bumps, flush() and LRU eviction of the logical entry all invalidate the
# fast path with no extra bookkeeping.
#
# Correctness of literal re-binding rests on token accounting built at
# registration time: every literal token of the statement is either
#   - mapped to exactly one parameter slot whose registered value provably
#     round-trips from the token text through one recorded converter
#     (int / float / date), with the slot matched by no other token, or
#   - marked BAKED: the raw token text must match the registration text
#     exactly on every fast hit (strings, IN-list members, LIMIT counts,
#     planner-folded literals like date + interval — anything whose value
#     the planner consumed rather than slotted).
# Any ambiguity (duplicate values, a token matching two slots, a folded
# slot colliding with a token) degrades to BAKED, never to a guess: a
# mismatch falls back to the full parse path, which is always correct.

_DATE_TOK_RE = re.compile(r"\d{4}-\d{2}-\d{2}$")


def _tok_candidate(tok: str, kind: str):
    """The (converter_tag, value) the slow path would produce for this
    literal token, or None. Mirrors sql/logical.py exactly: a num token
    types int unless it contains '.', a quoted YYYY-MM-DD behind DATE
    becomes epoch days."""
    try:
        if kind == "num":
            if "." in tok:
                return ("float", float(tok))
            return ("int", int(tok))
        if _DATE_TOK_RE.match(tok):
            return ("date", int(np.datetime64(tok, "D").astype(np.int64)))
        if kind == "str" and tok.startswith("[") and tok.endswith("]"):
            # vector literal: the slot value IS the raw bracket text
            # (sql/logical.py binds it at execution), so the slot match
            # below is plain string equality — a fresh embedding per
            # statement re-binds instead of baking a fast-tier miss
            return ("vec", tok)
    except ValueError:
        pass
    return None


def _convert_token(tok: str, tag: str):
    """Re-apply a recorded converter to a NEW token text. Returns the
    bound value or None when the token no longer fits the registered
    typing (dtype widening '5' -> '5.5', malformed dates) — the caller
    falls back to the full parse path and a separate plan entry."""
    try:
        if tag == "int":
            return int(tok)  # raises on '5.5': widening is a fast miss
        if tag == "float":
            if "." not in tok:
                return None  # would have typed int: different signature
            return float(tok)
        if tag == "date":
            if not _DATE_TOK_RE.match(tok):
                return None
            return int(np.datetime64(tok, "D").astype(np.int64))
        if tag == "vec":
            if not (tok.startswith("[") and tok.endswith("]")):
                return None
            # validate components parse; dimension is checked by
            # bind_value at execution (a mismatch raises there exactly
            # like the slow path would)
            [float(x) for x in tok[1:-1].split(",")]
            return tok
    except ValueError:
        return None
    return None


def build_slot_map(params: tuple, kinds: tuple, values: list) -> tuple:
    """Token accounting for one registered statement: per literal token,
    ("slot", slot_idx, converter_tag) when the token<->slot correspondence
    is unambiguous, else ("baked", raw_token_text)."""
    cands = [_tok_candidate(t, k) for t, k in zip(params, kinds)]
    tok_edges: list[list[int]] = [[] for _ in params]
    slot_edges: list[list[tuple[int, str]]] = [[] for _ in values]
    for i, c in enumerate(cands):
        if c is None:
            continue
        tag, cv = c
        for j, v in enumerate(values):
            # exact-type equality: an int token must not cross-bind a
            # float slot (or epoch-day ints a same-valued INT slot — the
            # bipartite uniqueness check below catches that collision)
            if type(cv) is type(v) and cv == v:
                tok_edges[i].append(j)
                slot_edges[j].append((i, tag))
    out = []
    for i, tok in enumerate(params):
        es = tok_edges[i]
        if len(es) == 1 and len(slot_edges[es[0]]) == 1:
            out.append(("slot", es[0], slot_edges[es[0]][0][1]))
        else:
            out.append(("baked", tok))
    return tuple(out)


@dataclass
class FastEntry:
    """One text-tier entry: the material to rebuild the LOGICAL cache key
    (norm_key/sig/baked/fingerprint + referenced tables for key_extra)
    plus the token->slot accounting that re-binds literals without
    parsing. Holds no compiled artifact — the executable stays owned by
    the logical tier, so eviction/flush there invalidates here for free."""

    norm_key: str
    sig: tuple
    baked: tuple
    fingerprint: str
    tables: tuple[str, ...]
    slot_map: tuple
    base_values: tuple  # registration-time slot values (fixed slots replay)
    stmt_type: str = "Select"
    hits: int = 0

    def bind_tokens(self, params: tuple) -> list | None:
        """Slot values for a repeat statement's raw literal tokens, or
        None when any baked token differs / any converter rejects —
        the caller takes the full parse path."""
        if len(params) != len(self.slot_map):
            return None
        vals = list(self.base_values)
        for tok, m in zip(params, self.slot_map):
            if m[0] == "baked":
                if tok != m[1]:
                    return None
            else:
                v = _convert_token(tok, m[2])
                if v is None:
                    return None
                vals[m[1]] = v
        return vals


@dataclass
class CacheEntry:
    prepared: object  # engine.executor.PreparedPlan
    output_names: tuple[str, ...]
    dtypes: list
    hits: int = 0
    monitor: object = None  # server/diag.PlanMonitorEntry (if enabled)


@dataclass
class PlanCacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    # text-keyed fast tier (fast-parser front end)
    fast_hits: int = 0
    fast_misses: int = 0
    fast_evictions: int = 0
    fast_invalidations: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def fast_hit_rate(self) -> float:
        total = self.fast_hits + self.fast_misses
        return self.fast_hits / total if total else 0.0


class PlanCache:
    """LRU cache: (normalized SQL, param signature, baked literals) ->
    compiled plan. One entry = one XLA executable."""

    def __init__(self, capacity: int = 128, metrics=None):
        self.capacity = capacity
        # one lock over both tiers: every public method mutates shared
        # OrderedDicts (move_to_end reorders even on reads) and the
        # server's ThreadingTCPServer drives them from one thread per
        # connection. RLock because metrics callbacks stay inside the
        # critical section and a re-entrant flush must not self-deadlock.
        self._lock = threading.RLock()
        self._entries: OrderedDict[tuple, CacheEntry] = OrderedDict()
        # text tier: kind-marked normalized text -> FastEntry. Same
        # capacity: a FastEntry is tiny next to the XLA executable its
        # logical entry holds, and a text entry whose logical entry was
        # evicted self-invalidates on its next hit anyway.
        self._fast: OrderedDict[str, FastEntry] = OrderedDict()
        # A/B switch (latency_bench --no-fastpath, tests): disabled means
        # lookups miss and registrations drop; the logical tier is
        # untouched so only the text tier's contribution is isolated
        self.fast_enabled = True
        self.stats = PlanCacheStats()
        # tenant metrics registry (share/metrics): mirrors hit/miss/evict
        # into __all_virtual_sysstat next to every other engine stat
        self.metrics = metrics
        # on-disk tier (engine/plan_artifact.PlanArtifactStore) wired by
        # the server when ob_plan_artifact_mode != off: misses hydrate
        # exported executables from it, flush() covers it
        self.artifact_store = None
        # hook: engine/result_cache.ResultCache — flushes with the plan
        # tiers (the server wires it; see flush())
        self.result_cache = None

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def get(self, key: tuple, count_miss: bool = True) -> CacheEntry | None:
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                ent.hits += 1
                self.stats.hits += 1
                if self.metrics is not None:
                    self.metrics.add("plan cache hit")
            elif count_miss:
                self.stats.misses += 1
                if self.metrics is not None:
                    self.metrics.add("plan cache miss")
            return ent

    def put(self, key: tuple, entry: CacheEntry):
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1
                if self.metrics is not None:
                    self.metrics.add("plan cache eviction")

    # ---- text tier -------------------------------------------------------
    def fast_peek(self, text_key: str) -> FastEntry | None:
        """Text-tier lookup WITHOUT hit/miss accounting: a peeked entry
        still has to survive literal re-binding and the logical-tier get
        before it counts as a hit (Session.fast_lookup does the counting,
        so a bind mismatch is honestly a miss)."""
        if not self.fast_enabled:
            return None
        with self._lock:
            ent = self._fast.get(text_key)
            if ent is not None:
                self._fast.move_to_end(text_key)
            return ent

    def fast_hit_get(self, key: tuple,
                     defer_adds: list | None = None) -> CacheEntry | None:
        """Logical-tier get + hit accounting for a VALIDATED fast hit,
        under one lock acquisition — the serving hot path runs this once
        per statement, where get() + note_fast_hit() would take the cache
        lock twice and the metrics lock twice (nested, at that). Metric
        bumps move after the cache lock releases; a caller that flushes a
        per-statement counter batch at statement end (the server session)
        passes `defer_adds` and the bumps ride its one bulk() instead of
        taking the metrics lock here. A None return means the logical
        entry is gone; the caller notes the miss and drops the text entry
        exactly as with get(count_miss=False)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                ent.hits += 1
                self.stats.hits += 1
                self.stats.fast_hits += 1
        if ent is not None and self.metrics is not None:
            if defer_adds is not None:
                defer_adds.append(("plan cache hit", 1))
                defer_adds.append(("plan cache fast hit", 1))
            else:
                self.metrics.bulk(adds=(("plan cache hit", 1),
                                        ("plan cache fast hit", 1)))
        return ent

    def note_fast_hit(self) -> None:
        with self._lock:
            self.stats.fast_hits += 1
            if self.metrics is not None:
                self.metrics.add("plan cache fast hit")

    def note_fast_miss(self) -> None:
        with self._lock:
            self.stats.fast_misses += 1
            if self.metrics is not None:
                self.metrics.add("plan cache fast miss")

    def fast_put(self, text_key: str, entry: FastEntry) -> None:
        if not self.fast_enabled:
            return
        with self._lock:
            self._fast[text_key] = entry
            self._fast.move_to_end(text_key)
            while len(self._fast) > self.capacity:
                self._fast.popitem(last=False)
                self.stats.fast_evictions += 1
                if self.metrics is not None:
                    self.metrics.add("plan cache fast eviction")

    def fast_invalidate(self, text_key: str) -> None:
        """Drop one stale text entry (its logical entry vanished, or a
        fast execution failed) — the next occurrence re-registers."""
        with self._lock:
            if self._fast.pop(text_key, None) is not None:
                self.stats.fast_invalidations += 1
                if self.metrics is not None:
                    self.metrics.add("plan cache fast invalidation")

    def census(self) -> tuple[list[dict], list[dict]]:
        """(logical entries, fast-text entries) for the device census —
        per-entry hit counts, the pow2 batch-bucket shapes compiled so
        far, and the memoized device-input bytes. One lock hold; values
        are plain dicts so the census owns nothing live."""
        with self._lock:
            logical = []
            for k, e in self._entries.items():
                memo = getattr(e.prepared, "_dev_bytes_memo", None)
                batched = getattr(e.prepared, "_batched", None)
                aref = getattr(e.prepared, "artifact_ref", None)
                logical.append({
                    "norm_key": k[1],
                    "hits": e.hits,
                    "buckets": tuple(sorted(batched)) if batched else (),
                    "dev_bytes": int(memo[2]) if memo is not None else 0,
                    # artifact tier: which on-disk executable backs this
                    # entry, and whether it was hydrated (vs compiled)
                    "artifact_id": aref[1] if aref is not None else "",
                    "warm": int(not getattr(e.prepared, "_traceable", True)),
                })
            fast = [
                {"text_key": k, "hits": fe.hits,
                 "stmt_type": fe.stmt_type, "tables": list(fe.tables)}
                for k, fe in self._fast.items()
            ]
        return logical, fast

    def flush(self, memory_only: bool = False):
        """Flush BOTH tiers. Retry policies with flush_plan_cache
        (OB_SCHEMA_EAGAIN), DDL-driven invalidation and ALTER SYSTEM all
        land here — a text entry surviving a flush would replay a plan
        compiled against a dead schema.

        memory_only=True flushes ONLY the in-memory tiers: a process
        restart loses RAM, not the disk store, and warm boot rehydrates
        from it. Schema-driven invalidation MUST NOT set it — the schema
        a disk artifact was compiled against is just as dead."""
        with self._lock:
            self._entries.clear()
            if self._fast:
                self.stats.fast_invalidations += len(self._fast)
                if self.metrics is not None:
                    self.metrics.add(
                        "plan cache fast invalidation", len(self._fast))
                self._fast.clear()
            # the artifact tier flushes with the in-memory tiers: an
            # exported executable surviving a schema-driven flush would
            # hydrate a plan compiled against a dead schema
            if not memory_only and self.artifact_store is not None:
                self.artifact_store.flush()
        # the result cache sits ABOVE the plan tiers (cached frames came
        # from entries that just died) and must flush with them — its
        # hook rides the plan cache so every flush caller is covered
        rc = getattr(self, "result_cache", None)
        if rc is not None:
            rc.flush()
