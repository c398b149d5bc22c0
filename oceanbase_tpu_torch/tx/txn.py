"""Transaction service: snapshot-isolation transactions over log streams.

Reference surface: storage/tx ObTransService (ob_trans_service.h:180) and
the participant ctx ObPartTransCtx (ob_trans_part_ctx.h:154): transactions
execute against leader memtables, redo reaches the replicated log at commit,
a single-LS tx commits in one log write (1PC, ob_trans_part_ctx.h:222), a
multi-LS tx runs two-phase commit among LS leaders
(ob_two_phase_committer.h) with the commit version from GTS.

Rebuild semantics (documented divergences):
  * snapshot isolation: read snapshot fixed at begin() from GTS; writes
    stage in leader memtables under tx_id; first-committer-wins on
    write-write conflicts (memtable raises WriteConflict);
  * 1PC: one REDO_COMMIT record carrying mutations + commit version;
  * 2PC: PREPARE records carry each participant's redo; after all prepares
    apply, the commit version is taken from the single per-tenant GTS and
    COMMIT records fan out (the reference derives it as max(prepare log
    scn); with one GTS authority a single fetch is equivalent);
  * commit acknowledgement = the decisive record APPLYING on the local
    replica (which implies it committed in the log).

The service is event-driven off the LS apply callbacks; `drive`-style
helpers (tx/cluster.py) pump the virtual clock in tests and single-process
deployments.
"""

from __future__ import annotations

import enum
import itertools
import threading
from dataclasses import dataclass, field

from ..storage import WriteConflict  # re-export convenience  # noqa: F401
from .gts import GtsService
from .ls import LSReplica
from .records import Mutation, RecordType, TxRecord


class TxState(enum.Enum):
    ACTIVE = "active"
    PREPARING = "preparing"
    # XA: prepared and PARKED — redo is durable in the log on every
    # participant, the decision belongs to an external coordinator
    XA_PREPARED = "xa_prepared"
    COMMITTING = "committing"
    COMMITTED = "committed"
    ABORTED = "aborted"


class NotMaster(Exception):
    """The local LS replica is not the leader; retry at the leader.

    Carries the offending ls_id so the statement retry layer can
    invalidate exactly that location-cache entry instead of dropping the
    whole cache (share/retry.py LOCATION_REFRESH handling)."""

    def __init__(self, msg: str = "", ls_id: int | None = None):
        super().__init__(msg)
        self.ls_id = ls_id


@dataclass
class TxContext:
    tx_id: int
    read_snapshot: int
    state: TxState = TxState.ACTIVE
    mutations: dict[int, list[Mutation]] = field(default_factory=dict)  # ls_id ->
    # dictionary appends to log with the commit (see TxRecord.dict_appends)
    dict_appends: list = field(default_factory=list)
    commit_version: int = 0
    # XA participant set: fixed at xa_prepare (includes the home LS when the
    # branch has no writes, so even an empty branch leaves a durable record)
    xa_parts: tuple = ()
    # the external decision once taken ("commit"/"rollback"): a retry after
    # a transient submit failure must re-drive the SAME decision, never
    # reverse one whose records may already be in a participant log
    xa_decision: str | None = None
    _prepared: set[int] = field(default_factory=set)
    _committed_ls: set[int] = field(default_factory=set)
    # COMMIT decisions whose submit was rejected (transient non-leader
    # window); resubmitted by retry_decisions
    _undelivered: dict[int, "TxRecord"] = field(default_factory=dict)

    @property
    def is_done(self) -> bool:
        return self.state in (TxState.COMMITTED, TxState.ABORTED)


@dataclass
class TransService:
    """Per-node transaction manager over that node's LS replicas."""

    node_id: int
    gts: GtsService
    replicas: dict[int, LSReplica]  # ls_id -> local replica
    _txs: dict[int, TxContext] = field(default_factory=dict)
    _lock: threading.RLock = field(default_factory=threading.RLock)
    _tx_ids: "itertools.count[int]" = None  # type: ignore[assignment]

    def __post_init__(self):
        if self._tx_ids is None:
            # tx ids globally unique across nodes: high bits = node
            self._tx_ids = itertools.count(self.node_id * 1_000_000_000 + 1)
        for r in self.replicas.values():
            prev = r.on_tx_applied
            r.on_tx_applied = self._make_applied_cb(r.ls_id, prev)

    def _make_applied_cb(self, ls_id: int, prev):
        def cb(tx_id: int, rtype: RecordType, version: int):
            if prev is not None:
                prev(tx_id, rtype, version)
            self._on_applied(ls_id, tx_id, rtype, version)

        return cb

    # ------------------------------------------------------------- API
    def begin(self) -> TxContext:
        ctx = TxContext(next(self._tx_ids), self.gts.current())
        with self._lock:
            self._txs[ctx.tx_id] = ctx
        return ctx

    def write(self, ctx: TxContext, ls_id: int, tablet_id: int, key: tuple,
              op: int, values: tuple | None) -> None:
        if ctx.state is not TxState.ACTIVE:
            raise RuntimeError(f"tx {ctx.tx_id} is {ctx.state.value}")
        r = self.replicas[ls_id]
        if not r.is_ready:
            # is_ready (not just is_leader): a fresh leader that has not yet
            # replayed inherited commits would miss write-write conflicts
            # against versions newer than the tx snapshot (lost update)
            raise NotMaster(f"ls {ls_id} not a ready leader on node "
                            f"{self.node_id}", ls_id=ls_id)
        m = Mutation(tablet_id, key, op, values)
        try:
            r.stage_locally(ctx.tx_id, ctx.read_snapshot, m)
        except WriteConflict:
            self.abort(ctx)
            raise
        ctx.mutations.setdefault(ls_id, []).append(m)

    def read(self, ctx: TxContext, ls_id: int, tablet_id: int,
             columns: list[str] | None = None, ranges=None):
        """Snapshot read (sees own staged writes via tx_id)."""
        r = self.replicas[ls_id]
        if not r.is_ready:
            # a fresh leader must finish replaying inherited committed
            # entries before serving, else reads miss rows
            raise NotMaster(f"ls {ls_id} replica on node {self.node_id} "
                            f"not a ready leader", ls_id=ls_id)
        return r.tablets[tablet_id].scan(
            ctx.read_snapshot, columns=columns, ranges=ranges, tx_id=ctx.tx_id
        )

    def commit(self, ctx: TxContext) -> None:
        """Start commit; terminal state arrives via apply callbacks
        (poll ctx.is_done under a drive loop, or block in live runtimes)."""
        from ..share.errsim import debug_sync, errsim_point

        errsim_point("EN_TX_COMMIT")
        debug_sync("BEFORE_COMMIT")
        if ctx.state is not TxState.ACTIVE:
            raise RuntimeError(f"tx {ctx.tx_id} is {ctx.state.value}")
        parts = [ls for ls, ms in ctx.mutations.items() if ms]
        if not parts:
            ctx.state = TxState.COMMITTED
            self._finish(ctx)
            return
        for ls in parts:
            if not self.replicas[ls].is_leader:
                self.abort(ctx)
                raise NotMaster(f"ls {ls} lost leadership before commit",
                                ls_id=ls)
        if len(parts) == 1:
            ls = parts[0]
            # version fetch + submit under gts.submit_lock: commit versions
            # land in the log nondecreasing, keeping entry scns a sound
            # follower-read watermark (see GtsService.submit_lock)
            with self.gts.submit_lock:
                rec = TxRecord(RecordType.REDO_COMMIT, ctx.tx_id,
                               tuple(ctx.mutations[ls]), self.gts.next_ts(),
                               dict_appends=tuple(ctx.dict_appends))
                # state moves BEFORE submit: apply can fire synchronously
                # inside submit_record (single-replica groups commit
                # immediately) and must find the ctx in COMMITTING
                ctx.commit_version = rec.commit_version
                ctx.state = TxState.COMMITTING
                try:
                    accepted = self.replicas[ls].submit_record(rec)
                except Exception:
                    # submit-path failure (EN_LOG_SUBMIT injection, IO error)
                    # before anything reached the log: roll back locally so
                    # the staged rows don't stay locked by a tx that can
                    # never decide — the orphan would block later writers
                    self._rollback(ctx, logged_ls=())
                    raise
            if accepted is None:
                # nothing reached the log: local rollback suffices
                self._rollback(ctx, logged_ls=())
                raise NotMaster(f"ls {ls} rejected submit", ls_id=ls)
            return
        # ---- 2PC
        ctx.state = TxState.PREPARING
        coord = parts[0]
        logged: list[int] = []
        for ls in parts:
            rec = TxRecord(RecordType.PREPARE, ctx.tx_id,
                           tuple(ctx.mutations[ls]), 0, coord, tuple(parts),
                           dict_appends=tuple(ctx.dict_appends))
            try:
                accepted = self.replicas[ls].submit_record(rec)
            except Exception:
                # submit-path failure mid-prepare: log ABORT where a
                # PREPARE already landed, release everything staged
                self._rollback(ctx, logged_ls=tuple(logged))
                raise
            if accepted is None:
                # some participants have a PREPARE in their log: log ABORT
                # there so replicas clean pending redo + tx tables
                self._rollback(ctx, logged_ls=tuple(logged))
                raise NotMaster(f"ls {ls} rejected prepare", ls_id=ls)
            logged.append(ls)

    # ------------------------------------------------------------- XA
    def xa_prepare(self, ctx: TxContext, xid: str, owner: str,
                   tenant: str = "") -> None:
        """Durable XA phase 1 (ob_trans_part_ctx.h:154 logs prepare through
        the part ctx): each participant's redo reaches its replicated log
        in an XA_PREPARE record tagged with the xid, then the tx PARKS in
        XA_PREPARED — no auto-commit; the external coordinator decides.
        Terminal XA_PREPARED arrives via apply callbacks (drive to it)."""
        if ctx.state is not TxState.ACTIVE:
            raise RuntimeError(f"tx {ctx.tx_id} is {ctx.state.value}")
        parts = [ls for ls, ms in ctx.mutations.items() if ms]
        if not parts:
            parts = [min(self.replicas)]  # empty branch: one marker record
        for ls in parts:
            if not self.replicas[ls].is_leader:
                self.abort(ctx)
                raise NotMaster(f"ls {ls} lost leadership before XA prepare",
                                ls_id=ls)
        ctx.xa_parts = tuple(parts)
        ctx.state = TxState.PREPARING
        logged: list[int] = []
        for ls in parts:
            rec = TxRecord(RecordType.XA_PREPARE, ctx.tx_id,
                           tuple(ctx.mutations.get(ls, ())), 0, parts[0],
                           tuple(parts), dict_appends=tuple(ctx.dict_appends),
                           xid=xid, owner=owner, tenant=tenant)
            if self.replicas[ls].submit_record(rec) is None:
                self._rollback(ctx, logged_ls=tuple(logged))
                raise NotMaster(f"ls {ls} rejected XA prepare", ls_id=ls)
            logged.append(ls)

    def xa_decide(self, ctx: TxContext, commit: bool) -> None:
        """External-coordinator decision for a parked (XA_PREPARED) branch.
        Commit logs COMMIT records with a fresh GTS version; replicas that
        staged the rows commit them, replicas (or a restarted node) holding
        only pending redo replay it. Either decision record rides the
        _undelivered/retry_decisions channel through transient non-leader
        windows — a dropped ABORT would leave the branch undecided in the
        log and resurrectable after a restart. Idempotent under retry of
        the SAME decision; reversing an in-flight decision is refused."""
        if ctx.state is TxState.COMMITTING and ctx.xa_decision is not None:
            if (ctx.xa_decision == "commit") != commit:
                raise RuntimeError(
                    f"tx {ctx.tx_id} already deciding "
                    f"{ctx.xa_decision}; cannot reverse")
            return  # retry: caller re-drives retry_decisions
        if ctx.state is not TxState.XA_PREPARED:
            raise RuntimeError(f"tx {ctx.tx_id} is {ctx.state.value}")
        ctx.xa_decision = "commit" if commit else "rollback"
        with self.gts.submit_lock:
            ctx.commit_version = self.gts.next_ts() if commit else 0
            ctx.state = TxState.COMMITTING  # decision (either way) in flight
            if not commit:
                for ls in ctx.mutations:
                    self.replicas[ls].abort_locally(ctx.tx_id)
            rtype = RecordType.COMMIT if commit else RecordType.ABORT
            for ls in ctx.xa_parts:
                rec = TxRecord(rtype, ctx.tx_id, (), ctx.commit_version)
                if self.replicas[ls].submit_record(rec) is None:
                    ctx._undelivered[ls] = rec

    def ensure_tx_id_above(self, floor: int) -> None:
        """Restart recovery: a recovered (still-undecided) XA branch keeps
        its pre-crash tx_id; the fresh counter must never re-issue it —
        a collision would let an unrelated new transaction adopt the
        branch's locks and re-staged rows."""
        nxt = next(self._tx_ids)
        self._tx_ids = itertools.count(max(nxt, floor + 1))

    def abort(self, ctx: TxContext) -> None:
        """Client-driven abort. Refused once the decision is in flight: a tx
        in COMMITTING has decisive records submitted to the log and MUST
        converge to COMMITTED (aborting it locally would diverge from
        followers that apply those records)."""
        if ctx.is_done:
            return
        if ctx.state is TxState.COMMITTING:
            raise RuntimeError(
                f"tx {ctx.tx_id} commit already in flight; cannot abort"
            )
        logged = (
            tuple(set(ctx.mutations) | set(ctx.xa_parts))
            if ctx.state in (TxState.PREPARING, TxState.XA_PREPARED)
            else ()
        )
        self._rollback(ctx, logged_ls=logged)

    def retry_decisions(self, ctx: TxContext) -> None:
        """Resubmit COMMIT decisions rejected by a transient non-leader
        window (driven from commit wait loops). If leadership moved to
        another NODE, resubmitting here cannot succeed — resolving that
        needs participant-driven recovery through the location service
        (prepared participants ask the coordinator log for the outcome);
        until then commit_sync surfaces it as a timeout, never as an abort.
        """
        if ctx.state is not TxState.COMMITTING:
            return
        for ls in list(ctx._undelivered):
            if self.replicas[ls].submit_record(ctx._undelivered[ls]) is not None:
                del ctx._undelivered[ls]

    def _rollback(self, ctx: TxContext, logged_ls: tuple[int, ...]) -> None:
        for ls in ctx.mutations:
            self.replicas[ls].abort_locally(ctx.tx_id)
        for ls in logged_ls:
            self.replicas[ls].submit_record(TxRecord(RecordType.ABORT, ctx.tx_id))
        ctx.state = TxState.ABORTED
        self._finish(ctx)

    # ------------------------------------------------- apply-event engine
    def _on_applied(self, ls_id: int, tx_id: int, rtype: RecordType, version: int) -> None:
        with self._lock:
            ctx = self._txs.get(tx_id)
        if ctx is None or ctx.is_done:
            return
        if rtype is RecordType.REDO_COMMIT:
            ctx.commit_version = version
            ctx.state = TxState.COMMITTED
            self._finish(ctx)
        elif rtype is RecordType.XA_PREPARE and ctx.state is TxState.PREPARING:
            # XA: record prepared parts, park when all are in — NEVER
            # auto-commit (that is the external coordinator's call)
            ctx._prepared.add(ls_id)
            if ctx._prepared >= set(ctx.xa_parts):
                ctx.state = TxState.XA_PREPARED
        elif rtype is RecordType.PREPARE and ctx.state is TxState.PREPARING:
            ctx._prepared.add(ls_id)
            if ctx._prepared >= set(ctx.mutations.keys()):
                # version fetch + COMMIT fan-out atomically vs other
                # committers (watermark invariant, GtsService.submit_lock)
                with self.gts.submit_lock:
                    ctx.commit_version = self.gts.next_ts()
                    ctx.state = TxState.COMMITTING
                    for ls in ctx.mutations:
                        rec = TxRecord(RecordType.COMMIT, ctx.tx_id, (),
                                       ctx.commit_version)
                        if self.replicas[ls].submit_record(rec) is None:
                            ctx._undelivered[ls] = rec
        elif rtype is RecordType.COMMIT and ctx.state is TxState.COMMITTING:
            ctx._committed_ls.add(ls_id)
            if ctx._committed_ls >= set(ctx.mutations.keys()):
                ctx.state = TxState.COMMITTED
                self._finish(ctx)
        elif rtype is RecordType.ABORT:
            if ctx.xa_parts and ctx.state is TxState.COMMITTING:
                # XA rollback decision: like commit, it is final only when
                # the ABORT record has applied on EVERY participant (the
                # caller's drive loop retries undelivered submissions)
                ctx._committed_ls.add(ls_id)
                if ctx._committed_ls >= set(ctx.xa_parts):
                    ctx.state = TxState.ABORTED
                    self._finish(ctx)
            else:
                ctx.state = TxState.ABORTED
                self._finish(ctx)

    def _finish(self, ctx: TxContext) -> None:
        with self._lock:
            self._txs.pop(ctx.tx_id, None)
