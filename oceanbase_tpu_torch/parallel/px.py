"""PX: distributed plan execution as one SPMD run over a device mesh.

Counterpart of `oceanbase_tpu/parallel/px.py`. Reference surface: the
parallel-execution component (sql/engine/px) -- the coordinator splits
the plan into DFOs at TRANSMIT/RECEIVE pairs (ObDfoMgr::do_split,
ob_dfo_mgr.cpp:462), dispatches SQCs to nodes, workers pull granules and
rows cross DTL channels routed by ObSliceIdxCalc; admission bounds
cluster DOP (ObPxAdmission, ob_px_target_mgr.h); join-filter pushdown
ships build-side bloom filters to probe-side scans.

The JAX package collapses the DFO graph into one shard_map program. The
port runs the same emission eagerly, once per shard, each shard in a
thread of its own on its device (parallel/group.py):

  * DFO boundary      -> an exchange between the shards' threads
                         (exchange.py on kernels K25-K28)
  * granule iterator  -> a static row slice of each table per shard
                         (shard_put: the granule map)
  * SQC/worker threads-> one thread per shard
  * DTL channel       -> lanes of static capacity + overflow retry
  * datahub rollup    -> psum/pmin/pmax partial-aggregate merges (K27)
  * join bloom filter -> build-side key bitset OR-merged over the shards
                         (K28 + K27), applied to the probe mask before
                         the exchange

Every intermediate carries a distribution state per shard: SHARDED (rows
split over the mesh) or REPLICATED (every shard holds all rows).
Placement rules:

  scan -> SHARDED.  filter/project preserve.
  join: build(right) REPLICATED -> local; small build -> broadcast build;
        else hash-repartition both sides on the join keys.
  group-by: small-domain direct aggregation -> local partials + merge
        (REPLICATED out); generic group-by -> hash-repartition on the
        group keys (SHARDED out); scalar aggregate -> partials + merge.
  sort/limit/distinct: gather (REPLICATED), then identical local compute;
        large sorts exchange by RANGE, large DISTINCTs by hash.
  root: gathered if still SHARDED.

Out-of-core PX: a statement over the device budget streams its biggest
table through the SPMD program chunk by chunk (`make_chunk_source`,
`_PxChunkSourceExecutor`): each chunk's narrowed host planes split over
the mesh and widen on every shard's device (K18), one counted host hop a
chunk.
"""

from __future__ import annotations

import threading
import time
from dataclasses import replace

import numpy as np
import torch

from ..core.column import ColumnBatch, make_batch
from ..core.dtypes import Schema
from ..engine.chunked import ChunkWindowMixin, decode_chunk, split_validity
from ..engine.executor import (
    DIRECT_GROUPBY_MAX_DOMAIN,
    PACK_GUARD_BASE,
    ROOT_COMPACT,
    Executor,
    _collect_qparam_spec,
    _dict_domain,
    _number_nodes,
    _unpack_qparams,
    compact_batch,
)
from ..expr import ir as E
from ..expr.compile import evaluate
from ..ops.hashing import next_pow2
from ..sql.logical import (
    Aggregate,
    Distinct,
    JoinOp,
    Limit,
    Scan,
    SetOp,
    Sort,
    TopN,
    Window,
)
from .. import kernels as K
from .exchange import (
    broadcast_rows,
    dest_by_hash,
    dest_by_range,
    merge,
    repartition,
    ring_broadcast_rows,
    sample_range_bounds,
)
from .group import current, run_spmd
from .mesh import Mesh, mesh_signature
from .spmd import ShardedResidency, SpmdLowering, shard_put, shard_put_planes

SHARDED = "sharded"
REPLICATED = "replicated"

# synthesized PhysicalParams ids for exchange lanes (disjoint from plan
# node ids, which are small pre-order indexes)
_EXCH_BASE = 1_000_000


def _exch_id(nid: int, slot: int) -> int:
    return _EXCH_BASE + nid * 4 + slot


_AGG_CHILD, _JOIN_LEFT, _JOIN_RIGHT, _SORT_CHILD = 0, 1, 2, 3


class PxAdmission:
    """Cluster-wide DOP quota (ObPxAdmission / ObPxTargetMgr analog).

    acquire() grants up to `dop` workers, degrading to whatever quota
    remains (minimum 1, like the reference's min-DOP admission). When
    nothing is free the caller QUEUES (FIFO, condition-variable wait) up
    to `queue_timeout_s`; only a timeout raises."""

    def __init__(self, target: int, queue_timeout_s: float = 10.0):
        self.target = target
        self.queue_timeout_s = queue_timeout_s
        self._used = 0
        self._lock = threading.Lock()
        self._free_cv = threading.Condition(self._lock)
        self._waiters = 0
        self.queued_total = 0  # observability: how often a burst queued

    @property
    def used(self) -> int:
        with self._lock:
            return self._used

    def acquire(self, dop: int, timeout: float | None = None) -> int:
        deadline = time.monotonic() + (
            self.queue_timeout_s if timeout is None else timeout
        )
        with self._free_cv:
            first = True
            while self.target - self._used <= 0:
                if first:
                    self.queued_total += 1
                    self._waiters += 1
                    first = False
                remain = deadline - time.monotonic()
                timed_out = remain <= 0 or not self._free_cv.wait(remain)
                # a release can land between the wait timing out and the
                # lock reacquisition: re-check before failing a query that
                # would now be admissible
                if timed_out and self.target - self._used <= 0:
                    if not first:
                        self._waiters -= 1
                    raise RuntimeError(
                        f"PX admission: queue timeout "
                        f"({self._used}/{self.target} in use, "
                        f"{self._waiters} queued)"
                    )
            if not first:
                self._waiters -= 1
            granted = min(dop, self.target - self._used)
            self._used += granted
            return granted

    def release(self, granted: int) -> None:
        with self._free_cv:
            self._used = max(0, self._used - granted)
            self._free_cv.notify_all()


class PxExecutor(Executor):
    """Runs logical plans as SPMD runs over a mesh: the base executor's
    emission once per shard, with exchanges between the shards."""

    chunking_enabled = True
    # shard inputs are row slices: full-table fk ranges would misindex,
    # and the top-k prefilter reads whole-table inputs
    clustered_agg_enabled = False
    # likewise: the sorted-projection slice indexes whole-table columns
    scan_slice_enabled = False

    def make_chunk_source(self, stream_table: str, chunk_rows: int):
        # per-shard granularity: the chunk capacity must shard evenly
        unit = 1024 * self.nsh
        rows = -(-chunk_rows // unit) * unit
        src = _PxChunkSourceExecutor(
            self.catalog, stream_table, rows, mesh=self.mesh,
            unique_keys=self.unique_keys, stats=self.stats,
            default_rows_estimate=self.default_rows_estimate,
            broadcast_threshold=self.broadcast_threshold,
            join_bloom=self.join_bloom,
            bloom_max_bits=self.bloom_max_bits,
            hybrid_hash=self.hybrid_hash,
            broadcast_impl=self.broadcast_impl,
            tracer=self.tracer, metrics=self.metrics,
            access=self.access,
        )
        # the streamed path re-crosses the host every chunk: it shares the
        # observability channels so those hops are COUNTED, and the
        # residency ledger so resident side tables charge the governor once
        src.timeline = self.timeline
        src.governor = self.governor
        src.residency = self.residency
        return src

    def _affine_build_info(self, op):
        # every batch is a per-shard SLICE (and hash exchanges reorder
        # rows), so the storage-layout affinity of the direct-address join
        # does not hold: always the merge or expansion join
        return None

    def __init__(self, catalog, mesh: Mesh, unique_keys=None,
                 default_rows_estimate=1 << 16,
                 broadcast_threshold: int = 1 << 16,
                 join_bloom: bool = True,
                 bloom_max_bits: int = 1 << 20,
                 hybrid_hash: "bool | str" = "auto",
                 broadcast_impl: str = "all_gather", stats=None,
                 device_budget=None, chunk_rows=None,
                 tracer=None, metrics=None, access=None):
        if stats is None:
            # histogram-backed cardinalities drive the exchange choice
            from ..share.stats import StatsManager

            stats = StatsManager(catalog)
        # this process's first shard: on a mesh over processes shard 0 may
        # lie in another process
        self.lead = mesh.local_shards()[0]
        super().__init__(catalog, unique_keys=unique_keys,
                         default_rows_estimate=default_rows_estimate,
                         stats=stats, device=mesh.devices[self.lead],
                         device_budget=device_budget, chunk_rows=chunk_rows)
        self.mesh = mesh
        self.nsh = mesh.size
        self.mesh_sig = mesh_signature(mesh)
        if broadcast_impl not in ("all_gather", "ring"):
            raise ValueError(f"unknown broadcast_impl {broadcast_impl!r}")
        self.broadcast_impl = broadcast_impl
        # partitioned residency: what the fullest device holds of every
        # resident table, the ledger the memory governor charges (this
        # process's shards: a mesh over processes keeps one a process)
        self.residency = ShardedResidency(
            len(mesh.local_shards()), mesh.shards_per_device())
        # the device budget is per device: a plan's inputs spread over the
        # mesh's distinct devices before prepare degrades to streaming
        self.budget_scale = len(mesh.distinct_devices())
        # the last compile's recorder (prepare attaches its plan)
        self._lowering: SpmdLowering | None = None
        self.broadcast_threshold = broadcast_threshold
        self.join_bloom = join_bloom
        self.bloom_max_bits = bloom_max_bits
        # skew-adaptive hybrid-hash joins: "auto" consults the workload
        # evidence and the optimizer histograms; True forces it
        self.hybrid_hash = hybrid_hash
        self.access = access
        # per-thread emission state: each shard's distribution map and
        # whether it records the lowering (the first local shard of a first
        # run)
        self._tls = threading.local()
        self._last_dist: dict = {}
        self.tracer = tracer
        self.metrics = metrics
        # exchange triples of the LAST recorded compile (execute's spans)
        self._exch_log: list[tuple[str, int, int]] = []

    @property
    def _dist(self) -> dict:
        """This shard's distribution map (in a shard's thread), else the
        last run's map of this process's first shard."""
        d = getattr(self._tls, "dist", None)
        return d if d is not None else self._last_dist

    def _recorder(self) -> SpmdLowering | None:
        return getattr(self._tls, "lowering", None)

    def _note_exchange(self, kind: str, ncols: int, cap: int,
                       collective: str | None = None) -> None:
        """DTL accounting, once per compile (the first local shard of the
        first run):
        per-lane capacity x lane count x 8-byte columns is the shuffle
        volume each dispatch moves."""
        low = self._recorder()
        if low is None:
            return
        lanes = self.nsh if kind == "broadcast" else self.nsh * self.nsh
        low.note(kind, ncols, cap, lanes, collective=collective)
        m = self.metrics
        if m is not None:
            m.add("px exchanges compiled")
            m.add("px exchange rows capacity", cap * lanes)
            m.add("px exchange bytes capacity", ncols * cap * lanes * 8)

    def _note_merge(self, kind: str, ncols: int, cap: int,
                    elem_bytes: int = 8) -> None:
        """Record a reduction collective (psum/pmin/pmax families) in the
        mesh plan; they stay out of the row-exchange triples."""
        low = self._recorder()
        if low is not None:
            low.note(kind, ncols, cap, self.nsh, collective="psum",
                     elem_bytes=elem_bytes, legacy=False)

    def execute(self, plan, max_retries: int = 3):
        """Coordinator-side execution: with a tracer, the distributed
        query runs under one coordinator span with one worker span per
        compiled exchange inside it; with metrics, per-collective
        counters fold in."""
        tr, m = self.tracer, self.metrics
        if tr is None and m is None:
            return super().execute(plan, max_retries)
        from contextlib import nullcontext

        cm = (tr.span("px_coordinator", dop=self.nsh)
              if tr is not None else nullcontext())
        with cm as root:
            t0 = time.perf_counter()
            prepared = self.prepare(plan)
            compile_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = prepared.run(max_retries)
            exec_s = time.perf_counter() - t0
            if tr is not None:
                exch = getattr(prepared, "px_exchanges", self._exch_log)
                for i, (kind, ncols, cap) in enumerate(exch):
                    with tr.span("px_worker", dfo=i, exchange=kind,
                                 lane_cap=cap, cols=ncols):
                        pass
                root.tags["compile_us"] = int(compile_s * 1e6)
                root.tags["exec_us"] = int(exec_s * 1e6)
            if m is not None:
                m.add("px executions")
                m.observe("px compile", compile_s)
                m.observe("px execute", exec_s)
                m.wait("px dispatch", exec_s)
            mp = getattr(prepared, "mesh_plan", None)
            if mp is not None and mp.total_ops:
                if m is not None:
                    for coll, cnt in mp.ops_by_collective().items():
                        m.add(f"px collective {coll}", cnt)
                    m.add("px collective bytes", mp.total_bytes)
                tl = self.timeline
                if tl is not None:
                    tl.record_collective(mp.total_ops, mp.total_bytes)
        return out

    def prepare(self, plan):
        """Compile + attach the mesh plan to the prepared plan BY
        REFERENCE: it fills in on the first dispatch, and every later
        consumer (session folds, spans) reads the populated layout."""
        self._lowering = None
        prepared = super().prepare(plan)
        self.sync_prepared(prepared)
        return prepared

    def sync_prepared(self, prepared) -> None:
        """(Re)attach the current compile's mesh plan to a prepared plan:
        from prepare() and again after an overflow recompile."""
        low = self._lowering
        if low is None:
            low = SpmdLowering(self.mesh_sig, self.nsh, self.mesh.n_procs)
        prepared.mesh_plan = low.plan
        prepared.px_exchanges = low.legacy_log
        prepared.px_nsh = self.nsh
        prepared.mesh_sig = self.mesh_sig

    # ------------------------------------------------------------ inputs
    def table_batch(self, name: str, cols: tuple[str, ...]):
        """Raw sharded input: one {"cols", "valid", "sel"} dict per shard,
        the table padded to a multiple of nsh * 1024 rows."""
        is_private = getattr(self.catalog, "is_private", None)
        if is_private is not None and is_private(name):
            # a transaction's private view: sharded fresh, never through
            # the shared cache, no residency charge
            return self._shard_upload(name, cols, resident=False)
        key = (name, cols)
        if key not in self._batch_cache:
            self._batch_cache[key] = self._shard_upload(name, cols)
        return self._batch_cache[key]

    def invalidate_table(self, name: str) -> None:
        super().invalidate_table(name)
        self.residency.discharge(name)

    def _shard_upload(self, name: str, cols: tuple[str, ...],
                      resident: bool = True):
        t = self.catalog[name]
        sub_schema = Schema(
            tuple(f for f in t.schema.fields if f.name in cols)
        )
        unit = 1024 * self.nsh
        cap = max(unit, -(-(t.nrows or 1) // unit) * unit)
        b = make_batch(
            {c: t.data[c] for c in sub_schema.names()},
            sub_schema,
            {c: d for c, d in t.dicts.items() if c in cols},
            capacity=cap,
            valid={c: v for c, v in t.valid.items() if c in cols},
            device="cpu",
        )
        raw, nbytes = shard_put(self.mesh, b)
        self.h2d_bytes += nbytes
        if resident:
            self.residency.charge(name, nbytes)
        tl = self.timeline
        if tl is not None:
            tl.record_transfer(nbytes)
        m = self.metrics
        if m is not None:
            m.add("px sharded upload bytes", nbytes)
        return raw

    # ------------------------------------------------------- capacities
    def seed_params(self, plan):
        params = super().seed_params(plan)
        nodes = _number_nodes(plan)
        est = self._est_rows

        def lane_cap(rows: float) -> int:
            # per (src,dst) lane: expected rows/nsh^2 with 2x skew headroom
            c = int(rows * 2 / (self.nsh * self.nsh)) + 512
            return -(-c // 128) * 128

        for nid, op in nodes.items():
            if isinstance(op, JoinOp) and op.left_keys:
                params.exchange_cap[_exch_id(nid, _JOIN_LEFT)] = lane_cap(
                    est(op.left))
                params.exchange_cap[_exch_id(nid, _JOIN_RIGHT)] = lane_cap(
                    est(op.right))
            if isinstance(op, Aggregate) and (
                op.group_keys
                or any(a[3] or a[1] == "approx_ndv" for a in op.aggs)
            ):
                params.exchange_cap[_exch_id(nid, _AGG_CHILD)] = lane_cap(
                    est(op.child))
            if isinstance(op, Sort) and self._sortable_by_range(op):
                params.exchange_cap[_exch_id(nid, _SORT_CHILD)] = lane_cap(
                    est(op.child))
            if isinstance(op, Distinct):
                params.exchange_cap[_exch_id(nid, _AGG_CHILD)] = lane_cap(
                    est(op.child))
            if isinstance(op, SetOp) and not (op.kind == "union" and op.all):
                params.exchange_cap[_exch_id(nid, _JOIN_LEFT)] = lane_cap(
                    est(op.left))
                params.exchange_cap[_exch_id(nid, _JOIN_RIGHT)] = lane_cap(
                    est(op.right))
            if isinstance(op, Window) and self._window_common_pk(op):
                params.exchange_cap[_exch_id(nid, _AGG_CHILD)] = lane_cap(
                    est(op.child))
        return params

    @staticmethod
    def _sortable_by_range(op: Sort) -> bool:
        """RANGE exchange needs an integer-typed leading sort key."""
        from ..expr.compile import infer_type
        from ..sql.logical import output_schema

        try:
            dt = infer_type(op.keys[0][0], output_schema(op.child))
        except Exception:
            return False
        return np.issubdtype(dt.storage_np, np.integer)

    @staticmethod
    def _window_common_pk(op: Window):
        """The shared partition-key tuple of all window specs, or None."""
        pks = {pk for _n, _f, _a, pk, _ok, _x in op.funcs}
        if len(pks) == 1:
            pk = next(iter(pks))
            if pk:
                return pk
        return None

    # -------------------------------------------------------- exchanges
    def _gather_batch(self, b: ColumnBatch) -> ColumnBatch:
        """GATHER/BROADCAST: replicate all rows on every shard (the
        all_gather layout, or the ring per broadcast_impl)."""
        ring = self.broadcast_impl == "ring"
        self._note_exchange("broadcast", _payload_units(b), b.capacity,
                            collective="ppermute" if ring else "all_gather")
        payload = {("c", n): a for n, a in b.cols.items()}
        payload.update({("v", n): a for n, a in b.valid.items()})
        if ring:
            out, mask = ring_broadcast_rows(payload, b.sel, self.nsh)
        else:
            out, mask = broadcast_rows(payload, b.sel)
        return ColumnBatch(
            cols={n: out[("c", n)] for n in b.cols},
            valid={n: out[("v", n)] for n in b.valid},
            sel=mask,
            nrows=torch.sum(mask, dtype=torch.int64),
            schema=b.schema,
            dicts=b.dicts,
        )

    def _exchange_dest(self, b: ColumnBatch, dest, cap: int):
        """Redistribute rows of a batch to per-row dest shards."""
        self._note_exchange("repartition", _payload_units(b), cap)
        payload = {("c", n): a for n, a in b.cols.items()}
        payload.update({("v", n): a for n, a in b.valid.items()})
        out, mask, ovf = repartition(payload, b.sel, dest, self.nsh, cap)
        nb = ColumnBatch(
            cols={n: out[("c", n)] for n in b.cols},
            valid={n: out[("v", n)] for n in b.valid},
            sel=mask,
            nrows=torch.sum(mask, dtype=torch.int64),
            schema=b.schema,
            dicts=b.dicts,
        )
        return nb, ovf

    @staticmethod
    def _key_values(exprs, b: ColumnBatch) -> list:
        out = []
        for e in exprs:
            v = evaluate(e, b)[0]
            out.append(v.expand(b.capacity) if v.dim() == 0 else v)
        return out

    def _exchange_hash(self, b: ColumnBatch, key_exprs, cap: int):
        """HASH distribution: co-partition rows by key hash."""
        return self._exchange_keys(b, self._key_values(key_exprs, b), cap)

    def _exchange_keys(self, b: ColumnBatch, keys, cap: int):
        """HASH distribution on evaluated key columns (a join's, made
        comparable across its sides first)."""
        return self._exchange_dest(b, dest_by_hash(keys, self.nsh), cap)

    def _concat_batches(self, a: ColumnBatch, b: ColumnBatch) -> ColumnBatch:
        """Row-concatenate two same-schema batches (capacities add)."""
        cols = {n: torch.cat([a.cols[n], b.cols[n]]) for n in a.cols}
        valid = {n: torch.cat([a.valid[n], b.valid[n]]) for n in a.valid}
        sel = torch.cat([a.sel, b.sel])
        return ColumnBatch(
            cols=cols, valid=valid, sel=sel,
            nrows=torch.sum(sel, dtype=torch.int64),
            schema=a.schema, dicts=a.dicts,
        )

    def _hybrid_exchange(self, probe: ColumnBatch, pk,
                         build: ColumnBatch, bk,
                         cap_probe: int, cap_build: int):
        """HYBRID_HASH_BROADCAST/RANDOM: skew-adaptive repartition. Hash
        bucket histograms of both sides' key columns (K28), summed over
        the shards (K27), pick the popular buckets identically on every
        shard (K28); popular probe rows stay local, popular build rows
        broadcast, the other rows of both sides hash-exchange."""
        hb = 4096
        self._note_merge("skew_histogram", 2, hb)
        cnt_p, cnt_b = merge([
            (K.hash_histogram(pk, probe.sel, hb), "sum"),
            (K.hash_histogram(bk, build.sel, hb), "sum"),
        ])
        # skew on EITHER side forces the hybrid route for that key
        popular = K.hot_buckets(cnt_p, cnt_b, self.nsh)
        p_pop = K.bucket_probe(pk, probe.sel, popular)

        probe_norm, ox_p = self._exchange_dest(
            probe.with_sel(probe.sel & ~p_pop), dest_by_hash(pk, self.nsh),
            cap_probe)
        probe_loc = probe.with_sel(p_pop)
        new_probe = self._concat_batches(probe_norm, probe_loc)

        b_pop = K.bucket_probe(bk, build.sel, popular)
        build_norm, ox_b = self._exchange_dest(
            build.with_sel(build.sel & ~b_pop), dest_by_hash(bk, self.nsh),
            cap_build)
        build_bc = self._gather_batch(build.with_sel(b_pop))
        new_build = self._concat_batches(build_norm, build_bc)
        return new_probe, new_build, ox_p, ox_b

    def _bloom_prefilter(self, probe: ColumnBatch, pk,
                         build: ColumnBatch, bk,
                         est_build: float) -> ColumnBatch:
        """Join-filter pushdown: a bitset of the build side's key columns
        (K28) OR-merged over the shards (K27) drops probe rows that cannot
        match BEFORE the exchange (K28's probe)."""
        m = min(self.bloom_max_bits, next_pow2(max(int(4 * est_build), 1024)))
        self._note_merge("bloom", 1, m, elem_bytes=4)
        (bits,) = merge([(K.bloom_bits(bk, build.sel, m), "or")])
        return probe.with_sel(K.bucket_probe(pk, probe.sel, bits))

    # ------------------------------------------------------- emission
    def _emit_node(self, op, inputs, emit, params, id_of):
        nid = id_of[id(op)]
        dist = self._dist

        if isinstance(op, Scan):
            out, ovf = super()._emit_node(op, inputs, emit, params, id_of)
            dist[id(op)] = SHARDED
            return out, ovf

        if isinstance(op, JoinOp):
            return self._emit_join_px(op, nid, inputs, emit, params, id_of)

        if isinstance(op, Aggregate):
            return self._emit_agg_px(op, nid, inputs, emit, params, id_of)

        if isinstance(op, Sort):
            return self._emit_sort_px(op, nid, inputs, emit, params, id_of)

        if isinstance(op, TopN):
            # two-phase top-n: per-shard top (n+offset) local rows, gather
            # the survivors, final top-n (the merge-sort-receive analog)
            child, covf = emit(op.child, inputs)
            if dist[id(op.child)] == SHARDED:
                local = self._topn_batch(child, op.keys, op.n + op.offset, 0)
                gathered = self._gather_batch(local)
                out = self._topn_batch(gathered, op.keys, op.n, op.offset)
            else:
                out = self._topn_batch(child, op.keys, op.n, op.offset)
            dist[id(op)] = REPLICATED
            return out, covf

        if isinstance(op, Window):
            return self._emit_window_px(op, nid, inputs, emit, params, id_of)

        if isinstance(op, Limit):
            # per-shard prelimit + compacted gather: moves O(n + offset)
            # rows per shard, never the relation
            child, covf = emit(op.child, inputs)
            if dist[id(op.child)] == SHARDED:
                k = op.n + op.offset
                pos = torch.cumsum(child.sel.to(torch.int64), 0) - 1
                local = child.with_sel(child.sel & (pos < k))
                cap2 = min(child.capacity, max(8, -(-k // 8) * 8))
                local, _oc = compact_batch(local, cap2)  # k <= cap2: no ovf
                child = self._gather_batch(local)
                covf = dict(covf)
            out, ovf = super()._emit_node(
                op, inputs, _override(emit, op.child, (child, covf)),
                params, id_of)
            dist[id(op)] = REPLICATED
            return out, ovf

        if isinstance(op, Distinct):
            # hash-repartition on the whole row: each shard owns its value
            # space, so local dedup is globally exact
            child, covf = emit(op.child, inputs)
            cd = dist[id(op.child)]
            exch = _exch_id(nid, _AGG_CHILD)
            if (
                cd == SHARDED
                and exch in params.exchange_cap
                and self._est_rows(op.child) > self.broadcast_threshold
            ):
                keys = self._row_hash_keys(child)
                child2, xovf = self._exchange_dest(
                    child, dest_by_hash(keys, self.nsh),
                    params.exchange_cap[exch])
                out, ovf = super()._emit_node(
                    op, inputs, _override(emit, op.child, (child2, covf)),
                    params, id_of)
                ovf = dict(ovf)
                ovf[exch] = xovf
                dist[id(op)] = SHARDED
                return out, ovf
            if cd == SHARDED:
                child = self._gather_batch(child)
            out, ovf = super()._emit_node(
                op, inputs, _override(emit, op.child, (child, covf)),
                params, id_of)
            dist[id(op)] = REPLICATED
            return out, ovf

        if isinstance(op, SetOp):
            return self._emit_setop_px(op, nid, inputs, emit, params, id_of)

        # Filter / Project: local, distribution-preserving
        out, ovf = super()._emit_node(op, inputs, emit, params, id_of)
        child = getattr(op, "child", None)
        dist[id(op)] = dist[id(child)] if child is not None else SHARDED
        return out, ovf

    # ---- set operations --------------------------------------------------
    def _row_hash_keys(self, b: ColumnBatch):
        """Whole-row hash key columns with set-op NULL normalization (the
        validity planes join the key; the hash folds bools as 0/1)."""
        return self._setop_key_cols(b.cols, b.valid, b.schema)

    def _copartition_side(self, b: ColumnBatch, dist: str, cap: int):
        """Bring one promoted set-op side onto the whole-row hash
        partitioning. SHARDED: exchange. REPLICATED: every shard keeps the
        rows hashing to itself (a mask, no collective)."""
        dest = dest_by_hash(self._row_hash_keys(b), self.nsh)
        if dist == REPLICATED:
            return b.with_sel(b.sel & (dest == current().shard)), None
        return self._exchange_dest(b, dest, cap)

    def _emit_setop_px(self, op: SetOp, nid, inputs, emit, params, id_of):
        dist = self._dist
        left, lovf = emit(op.left, inputs)
        right, rovf = emit(op.right, inputs)
        ld, rd = dist[id(op.left)], dist[id(op.right)]
        ovf = {**lovf, **rovf}
        lb, rb, out_schema, dicts = self._setop_promote(op, left, right)

        if op.kind == "union" and op.all:
            # pure concatenation: SHARDED++SHARDED stays sharded; a
            # REPLICATED side spreads by row index so each row exists once
            if ld == rd == REPLICATED:
                out, ovf = self._setop_combine(
                    op, lb, rb, out_schema, dicts, ovf)
                dist[id(op)] = REPLICATED
                return out, ovf
            me = current().shard
            if ld == REPLICATED:
                ridx = torch.arange(lb.capacity, device=lb.device) % self.nsh
                lb = lb.with_sel(lb.sel & (ridx == me))
            if rd == REPLICATED:
                ridx = torch.arange(rb.capacity, device=rb.device) % self.nsh
                rb = rb.with_sel(rb.sel & (ridx == me))
            out, ovf = self._setop_combine(op, lb, rb, out_schema, dicts, ovf)
            dist[id(op)] = SHARDED
            return out, ovf

        cap_l = params.exchange_cap.get(_exch_id(nid, _JOIN_LEFT))
        cap_r = params.exchange_cap.get(_exch_id(nid, _JOIN_RIGHT))
        big = (
            self._est_rows(op.left) + self._est_rows(op.right)
            > self.broadcast_threshold
        )
        if big and cap_l is not None and cap_r is not None \
                and (ld == SHARDED or rd == SHARDED):
            # co-partition both sides by whole-row hash: equal rows meet
            # on one shard, so the local set kernels are globally exact
            lb2, xl = self._copartition_side(lb, ld, cap_l)
            rb2, xr = self._copartition_side(rb, rd, cap_r)
            out, ovf = self._setop_combine(op, lb2, rb2, out_schema, dicts,
                                           ovf)
            ovf = dict(ovf)
            if xl is not None:
                ovf[_exch_id(nid, _JOIN_LEFT)] = xl
            if xr is not None:
                ovf[_exch_id(nid, _JOIN_RIGHT)] = xr
            dist[id(op)] = SHARDED
            return out, ovf

        if ld == SHARDED:
            lb = self._gather_batch(lb)
        if rd == SHARDED:
            rb = self._gather_batch(rb)
        out, ovf = self._setop_combine(op, lb, rb, out_schema, dicts, ovf)
        dist[id(op)] = REPLICATED
        return out, ovf

    # ---- sort / window --------------------------------------------------
    def _emit_sort_px(self, op: Sort, nid, inputs, emit, params, id_of):
        """Large SHARDED sorts exchange by RANGE on the leading key: each
        shard gets one contiguous key range and sorts it, and the
        shard-order concatenation at gather time IS the global order.
        Small or replicated inputs gather, then sort."""
        dist = self._dist
        child, covf = emit(op.child, inputs)
        cd = dist[id(op.child)]
        exch = _exch_id(nid, _SORT_CHILD)
        use_range = (
            cd == SHARDED
            and exch in params.exchange_cap
            and self._est_rows(op.child) > self.broadcast_threshold
        )
        if not use_range:
            if cd == SHARDED:
                child = self._gather_batch(child)
            out, ovf = super()._emit_node(
                op, inputs, _override(emit, op.child, (child, covf)),
                params, id_of)
            dist[id(op)] = REPLICATED
            return out, ovf

        key_expr, desc0 = op.keys[0]
        kv = self._key_values([key_expr], child)[0]
        self._note_merge("range_sample", 1, 4096)
        bounds = sample_range_bounds(kv, child.sel, self.nsh)
        # desc: shard 0 holds the HIGHEST range so the gathered
        # concatenation reads in descending order
        dest = dest_by_range(kv, bounds, desc=desc0)
        child2, xovf = self._exchange_dest(
            child, dest, params.exchange_cap[exch])
        out, ovf = super()._emit_node(
            op, inputs, _override(emit, op.child, (child2, covf)),
            params, id_of)
        ovf = dict(ovf)
        ovf[exch] = xovf
        # each shard holds one globally contiguous, locally sorted range
        dist[id(op)] = SHARDED
        return out, ovf

    def _emit_window_px(self, op: Window, nid, inputs, emit, params, id_of):
        """Windows with a common PARTITION BY hash-repartition on it: each
        partition lands whole on one shard. Others gather."""
        dist = self._dist
        child, covf = emit(op.child, inputs)
        cd = dist[id(op.child)]
        exch = _exch_id(nid, _AGG_CHILD)
        pk = self._window_common_pk(op)
        if (
            cd == SHARDED
            and pk is not None
            and exch in params.exchange_cap
            and self._est_rows(op.child) > self.broadcast_threshold
        ):
            child2, xovf = self._exchange_hash(
                child, list(pk), params.exchange_cap[exch])
            out, ovf = super()._emit_node(
                op, inputs, _override(emit, op.child, (child2, covf)),
                params, id_of)
            ovf = dict(ovf)
            ovf[exch] = xovf
            dist[id(op)] = SHARDED
            return out, ovf
        if cd == SHARDED:
            child = self._gather_batch(child)
        out, ovf = super()._emit_node(
            op, inputs, _override(emit, op.child, (child, covf)),
            params, id_of)
        dist[id(op)] = REPLICATED
        return out, ovf

    # ---- joins ----------------------------------------------------------
    def _skewed_key(self, side_op, keys) -> bool:
        """Skew signal for auto hybrid-hash: the workload's measured
        heavy-hitter share of the key column, else a value repeated across
        r consecutive equi-height bucket edges (>= (r-1)/N of the rows);
        skewed when one value would overload a shard's fair lane 2x."""
        from ..share.stats import N_BUCKETS
        from ..sql.logical import Filter, Project

        if len(keys) != 1 or self.stats is None:
            return False
        e = keys[0]
        name = e.name if isinstance(e, E.ColRef) else None
        if name is None:
            return False
        node = side_op
        while isinstance(node, (Filter, Project)):
            if isinstance(node, Project):
                nxt = dict(node.exprs).get(name)
                if not isinstance(nxt, E.ColRef):
                    return False
                name = nxt.name
            node = node.child
        if not isinstance(node, Scan) or "." not in name:
            return False
        alias, col = name.split(".", 1)
        if alias != node.alias:
            return False
        if self.access is not None:
            ev = self.access.key_evidence(
                node.table, col, self.catalog.get(node.table))
            if ev is not None and ev[1] >= 2.0 / self.nsh:
                return True
        ts = self.stats.table_stats(node.table)
        cs = ts.cols.get(col) if ts is not None else None
        if cs is None or cs.edges is None:
            return False
        edges = np.asarray(cs.edges)
        eq = edges[1:] == edges[:-1]
        best = run = 0
        for x in eq:
            run = run + 1 if x else 0
            best = max(best, run)
        return best / N_BUCKETS >= 2.0 / self.nsh

    def _emit_join_px(self, op, nid, inputs, emit, params, id_of):
        dist = self._dist
        left, lovf = emit(op.left, inputs)
        right, rovf = emit(op.right, inputs)
        ld, rd = dist[id(op.left)], dist[id(op.right)]
        ovf = {**lovf, **rovf}

        # the optimizer's exchange allocation
        if op.kind == "full" and (ld == SHARDED or rd == SHARDED):
            # a broadcast build would duplicate unmatched-right rows on
            # every shard: FULL joins co-partition both sides
            method = "hash" if op.left_keys else "gather_both"
        elif rd == REPLICATED:
            method = "local"
        elif not op.left_keys:
            method = "broadcast"
        elif ld == REPLICATED:
            method = "broadcast"
        elif self._est_rows(op.right) <= self.broadcast_threshold or (
            # broadcast ships est_r to every shard; hash moves each row of
            # both sides once
            self._est_rows(op.right) * (self.nsh - 1)
            <= self._est_rows(op.left)
        ):
            method = "broadcast"
        else:
            method = "hash"

        if method == "hash":
            # both sides hash the same comparable key columns (a float
            # meeting another type as float64), so equal keys meet
            lk, rk = self._join_keys(op, left, right)
            # bloom pushdown only where dropping non-matching probe rows
            # is a no-op: inner and semi joins
            if self.join_bloom and op.kind in ("inner", "cross", "semi"):
                left = self._bloom_prefilter(
                    left, lk, right, rk, self._est_rows(op.right))
            cap_l = params.exchange_cap[_exch_id(nid, _JOIN_LEFT)]
            cap_r = params.exchange_cap[_exch_id(nid, _JOIN_RIGHT)]
            use_hybrid = op.kind == "inner" and (
                self.hybrid_hash is True
                or (
                    self.hybrid_hash == "auto"
                    and (
                        self._skewed_key(op.left, op.left_keys)
                        or self._skewed_key(op.right, op.right_keys)
                    )
                )
            )
            if use_hybrid:
                left, right, xl, xr = self._hybrid_exchange(
                    left, lk, right, rk, cap_l, cap_r)
            else:
                left, xl = self._exchange_keys(left, lk, cap_l)
                right, xr = self._exchange_keys(right, rk, cap_r)
            ovf = dict(ovf)
            ovf[_exch_id(nid, _JOIN_LEFT)] = xl
            ovf[_exch_id(nid, _JOIN_RIGHT)] = xr
            out_dist = SHARDED
        elif method == "broadcast":
            right = self._gather_batch(right)
            out_dist = ld
        elif method == "gather_both":
            if ld == SHARDED:
                left = self._gather_batch(left)
            if rd == SHARDED:
                right = self._gather_batch(right)
            out_dist = REPLICATED
        else:
            out_dist = ld

        emit2 = _override(
            _override(emit, op.left, (left, {})), op.right, (right, {}))
        out, jovf = super()._emit_join(op, nid, inputs, emit2, params)
        ovf.update({k: v for k, v in jovf.items() if k not in ovf})
        dist[id(op)] = out_dist
        return out, ovf

    # ---- aggregation -----------------------------------------------------
    def _emit_agg_px(self, op, nid, inputs, emit, params, id_of):
        dist = self._dist
        child, covf = emit(op.child, inputs)
        cd = dist[id(op.child)]

        if cd == REPLICATED:
            out, ovf = super()._emit_aggregate(
                op, nid, inputs, _override(emit, op.child, (child, covf)),
                params)
            dist[id(op)] = REPLICATED
            return out, ovf

        domains = [_dict_domain(child, e) for _, e in op.group_keys]
        direct = (
            bool(op.group_keys)
            and all(d is not None for d in domains)
            and int(np.prod([d for d in domains])) <= DIRECT_GROUPBY_MAX_DOMAIN
        )

        # DISTINCT aggregates: a shard's partial over its local first
        # occurrences would double-count values present on other shards,
        # so the rows colocate by the dedup domain BEFORE aggregating.
        # approx_ndv joins the set: colocated by its argument, each shard
        # sketches a disjoint value set and the estimates psum-merge
        distinct_args = {a[2] for a in op.aggs if a[3] or a[1] == "approx_ndv"}
        if distinct_args and not op.group_keys:
            if len(distinct_args) == 1:
                cap = params.exchange_cap[_exch_id(nid, _AGG_CHILD)]
                child, xovf = self._exchange_hash(
                    child, [next(iter(distinct_args))], cap)
                covf = dict(covf)
                covf[_exch_id(nid, _AGG_CHILD)] = xovf
            else:
                # two distinct domains cannot colocate by one exchange
                child = self._gather_batch(child)
                out, ovf = super()._emit_aggregate(
                    op, nid, inputs,
                    _override(emit, op.child, (child, covf)), params)
                dist[id(op)] = REPLICATED
                return out, ovf
        elif distinct_args:
            direct = False  # partials would double-count: repartition

        if direct or not op.group_keys:
            # local partials + the datahub-rollup merge (K27): moves
            # O(groups), not O(rows)
            out, ovf = super()._emit_aggregate(
                op, nid, inputs, _override(emit, op.child, (child, covf)),
                params)
            self._note_merge(
                "merge", len(out.cols) + len(out.valid) + 1, out.capacity)
            pairs = []
            for name, fn, _arg, _d in op.aggs:
                if fn in ("sum", "count", "approx_ndv"):
                    pairs.append((out.cols[name], "sum"))
                elif fn in ("min", "max"):
                    pairs.append((out.cols[name], fn))
                else:
                    raise NotImplementedError(f"PX merge for {fn}")
            vnames = list(out.valid)
            pairs.append((out.sel, "or"))
            pairs += [(out.valid[n], "or") for n in vnames]
            got = merge(pairs)
            merged = dict(out.cols)
            for (name, _f, _a, _d), v in zip(op.aggs, got):
                merged[name] = v
            sel = got[len(op.aggs)]
            valid = dict(zip(vnames, got[len(op.aggs) + 1:]))
            out = replace(
                out, cols=merged, valid=valid, sel=sel,
                nrows=torch.sum(sel, dtype=torch.int64),
            )
            dist[id(op)] = REPLICATED
            return out, ovf

        # generic group-by: co-partition rows on the group keys, then each
        # shard owns its key space
        cap = params.exchange_cap[_exch_id(nid, _AGG_CHILD)]
        child2, xovf = self._exchange_hash(
            child, [e for _, e in op.group_keys], cap)
        out, ovf = super()._emit_aggregate(
            op, nid, inputs, _override(emit, op.child, (child2, covf)), params)
        ovf = dict(ovf)
        ovf[_exch_id(nid, _AGG_CHILD)] = xovf
        dist[id(op)] = SHARDED
        return out, ovf

    # ------------------------------------------------------ compilation
    def compile(self, plan, params):
        """The plan as run(inputs, qparams) -> (out batch, overflow
        vector): every shard runs the emission over its slice; the result
        (replicated on every shard) and the summed overflow vector are
        this process's first shard's (every process of a mesh over
        processes returns them)."""
        self.compiles += 1
        nodes = _number_nodes(plan)
        id_of = {id(o): i for i, o in nodes.items()}
        needed = self._needed_columns(plan)
        scans = self._collect_scans(plan)
        input_spec = []
        side: dict[str, tuple[Schema, dict]] = {}
        for s in scans:
            cols = needed.get(s.alias, set())
            if not cols:
                cols = {self.catalog[s.table].schema.fields[0].name}
            cols = tuple(sorted(cols))
            input_spec.append((s.alias, s.table, cols))
            t = self.catalog[s.table]
            sub_schema = Schema(
                tuple(f for f in t.schema.fields if f.name in cols))
            side[s.alias] = (
                sub_schema,
                {c: d for c, d in t.dicts.items() if c in cols},
            )
        params.clustered_aggs.clear()
        params.vector_topns.clear()

        overflow_nodes = sorted(
            set(params.join_cap) | set(params.exchange_cap)
            | set(params.scan_cap) | set(params.topn_cand)
            | {
                PACK_GUARD_BASE + nid
                for nid in params.pack_guard
                if nid not in params.groupby_nopack
            }
        )

        def emit(op, inputs):
            return self._emit_node(op, inputs, emit, params, id_of)

        qparam_spec = _collect_qparam_spec(plan)
        lowering = SpmdLowering(self.mesh_sig, self.nsh, self.mesh.n_procs)
        self._lowering = lowering
        mesh = self.mesh
        lead = self.lead

        def run_local(shard, raw_inputs, qparams, record):
            from ..expr import compile as expr_compile

            tls = self._tls
            tls.dist = {}
            tls.lowering = lowering if record else None
            dev = mesh.devices[shard]
            q = qparams
            if isinstance(q, torch.Tensor):
                q = q if q.device == dev else q.to(dev)
            elif q:
                q = tuple(v if v.device == dev else v.to(dev) for v in q)
            # each shard thread installs the statement's parameter frame
            q = _unpack_qparams(q, qparam_spec)
            inputs = {}
            for alias, raw in raw_inputs.items():
                schema, dicts = side[alias]
                part = raw[shard]
                sel = part["sel"]
                inputs[alias] = ColumnBatch(
                    cols=dict(part["cols"]), valid=dict(part["valid"]),
                    sel=sel, nrows=torch.sum(sel, dtype=torch.int64),
                    schema=schema, dicts=dicts)
            prev = expr_compile.set_params(q if len(q) else None)
            try:
                out, ovf = emit(plan, inputs)
                # compact BEFORE the root gather: the collective then
                # moves O(result) rows per shard
                out, oc = compact_batch(out, params.join_cap[ROOT_COMPACT])
                ovf = dict(ovf)
                ovf[ROOT_COMPACT] = oc
                if tls.dist[id(plan)] == SHARDED:
                    out = self._gather_batch(out)
            finally:
                expr_compile.set_params(prev)
                tls.lowering = None
            if overflow_nodes:
                zero = torch.zeros((), dtype=torch.int64, device=dev)
                local = torch.stack([ovf.get(n, zero).to(torch.int64)
                                     for n in overflow_nodes])
                # a replicated counter sums nsh times: harmless, the
                # retry tests > 0 only
                (ovf_vec,) = merge([(local, "sum")])
            else:
                ovf_vec = torch.zeros(0, dtype=torch.int64, device=dev)
            if shard == lead:
                self._last_dist = tls.dist
            tls.dist = None
            return out, ovf_vec

        recording = threading.Lock()

        def run(raw_inputs, qparams=()):
            # the first run records the layout; a run concurrent with it
            # (another session on the cached plan) does not
            held = recording.acquire(blocking=False)
            record = held and not lowering.traced
            if held and not record:
                recording.release()
            if record:
                lowering.reset()
                self._exch_log = lowering.legacy_log
            try:
                res = run_spmd(mesh, lambda i: run_local(
                    i, raw_inputs, qparams, record and i == lead))
                if record:
                    lowering.traced = True
            finally:
                if record:
                    recording.release()
            return res[lead]

        return run, input_spec, overflow_nodes


class _PxChunkSourceExecutor(ChunkWindowMixin, PxExecutor):
    """PxExecutor whose streamed table reads one fixed-capacity chunk:
    every chunk of the out-of-core loop is one SPMD run over the mesh
    (engine/chunked.py drives it through `_run_legacy`; the window and
    estimate logic lives in ChunkWindowMixin)."""

    chunking_enabled = False
    # the host-slice chunk loop: the uploads split over the mesh, so the
    # single device's prefetch/staging pipeline does not apply
    supports_staged = False

    def __init__(self, catalog, stream_table: str, chunk_rows: int,
                 mesh=None, **kw):
        super().__init__(catalog, mesh, **kw)
        self.stream_table = stream_table
        self.chunk_rows = chunk_rows
        self._chunk: tuple[int, int] | None = None

    def table_batch(self, name: str, cols: tuple[str, ...]):
        if name != self.stream_table or self._chunk is None:
            return super().table_batch(name, cols)
        narrow, bases, count, _schema, _dicts = self._chunk_narrow(
            name, cols)
        # THE host-mediated DTL hop: each chunk of the streamed table
        # crosses host->device per dispatch. Counted so a resident run can
        # be shown to make none: collectives move all steady-state data.
        m = self.metrics
        if m is not None:
            m.add("px dtl host hops")
        low = self._lowering
        if low is not None:
            low.note_host_hop()
        raw, nbytes = shard_put_chunk(self.mesh, narrow, bases, count)
        self.h2d_bytes += nbytes
        return raw


def shard_put_chunk(mesh, narrow: dict, bases: dict, count: int):
    """Partition a streamed chunk's narrowed host planes (numpy, capacity
    a multiple of the shard count; engine/chunked.py `_chunk_narrow`)
    across the mesh and widen each shard's slice on its device with one
    `decode_chunk` (K18). Shard i's live count is clamp(count - i * per,
    0, per), so its sel is the slice of a whole-chunk decode. The wire
    stays narrow up to each device. Returns (raw, nbytes) as `shard_put`,
    nbytes the narrow bytes placed (this process's shards alone)."""
    parts, per, nbytes = shard_put_planes(
        mesh, {k: torch.from_numpy(np.ascontiguousarray(a))
               for k, a in narrow.items()})
    raw = [None] * mesh.size
    for i in mesh.local_shards():
        live = min(max(int(count) - i * per, 0), per)
        decoded, sel = decode_chunk(parts[i], bases, live, mesh.devices[i])
        cols, valid = split_validity(decoded)
        raw[i] = {"cols": cols, "valid": valid, "sel": sel}
    return raw, nbytes


def _payload_units(b: ColumnBatch) -> int:
    """The 8-byte lanes a batch's payload fills in an exchange's
    accounting: one a column or validity plane, and a VECTOR column's d x
    4-byte rows in as many as they need."""
    units = len(b.valid)
    for a in b.cols.values():
        units += max(1, -(-K.plane_row_bytes(a) // 8)) if a.dim() == 2 else 1
    return units


def _override(emit, node, result):
    """An emit view that returns a precomputed (exchanged) batch for one
    child node and delegates everything else."""

    def emit2(op, inputs):
        if op is node:
            return result
        return emit(op, inputs)

    return emit2
