"""PALF-lite: leader-based replicated append-only log.

Reference surface: logservice/palf — PalfHandleImpl::submit_log
(palf_handle_impl.cpp:411) appends into a LogSlidingWindow
(log_sliding_window.h:203) that groups entries, replicates via
LogNetService push/ack, advances committed_end_lsn on majority ack, and
hands committed logs to apply/replay services; roles come from LogStateMgr
with lease-based election (palf/election). PALF is leader-based consensus
with proposal-id-stamped logs — functionally raft-shaped — and the rebuild
implements exactly that shape:

  * dense LSNs; entries stamped with the leader's term (proposal id);
  * a bounded sliding window of in-flight entries (group replication);
  * majority ack -> commit_lsn advance -> apply callback (ordered);
  * lease election: followers refuse votes while the leader lease is live
    (prevents disruption); candidates need up-to-date logs to win;
  * log reconciliation on divergence (conflicting suffix truncated).

The state machine is pure event/tick driven — no threads, no wall clock —
so consensus invariants are tested deterministically (tests/test_palf.py);
a runtime wrapper drives it from real time in deployments.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable

from .transport import LocalBus


class Role(enum.Enum):
    LEADER = "leader"
    FOLLOWER = "follower"
    CANDIDATE = "candidate"


@dataclass(frozen=True)
class LogEntry:
    lsn: int
    term: int
    scn: int  # commit timestamp hint (monotonic per log)
    payload: bytes


class LogView:
    """Dense-LSN log whose prefix may have been recycled to a checkpoint.

    Presents list-like access indexed by ABSOLUTE lsn (the code's dense-LSN
    invariant: log[lsn].lsn == lsn) while physically holding only entries
    >= base. `base_prev_term` is the term of entry base-1 (needed for
    log-matching AppendReqs that start exactly at base)."""

    __slots__ = ("base", "entries", "base_prev_term")

    def __init__(self, base: int = 0, entries: list[LogEntry] | None = None,
                 base_prev_term: int = 0):
        self.base = base
        self.entries: list[LogEntry] = entries if entries is not None else []
        self.base_prev_term = base_prev_term

    def __len__(self) -> int:
        return self.base + len(self.entries)

    def __bool__(self) -> bool:
        return len(self) > 0

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                raise ValueError("LogView slices are contiguous")
            lo = max(start - self.base, 0)
            hi = max(stop - self.base, 0)
            return self.entries[lo:hi]
        if i < 0:
            i += len(self)
        if i < self.base:
            raise IndexError(f"lsn {i} recycled (base {self.base})")
        return self.entries[i - self.base]

    def __delitem__(self, i) -> None:
        # only suffix deletion is meaningful for a log
        if not isinstance(i, slice) or i.stop is not None or i.step is not None:
            raise ValueError("only `del log[lsn:]` is supported")
        start = i.start if i.start >= 0 else len(self) + i.start
        if start < self.base:
            raise IndexError(f"cannot truncate below base {self.base}")
        del self.entries[start - self.base :]

    def append(self, e: LogEntry) -> None:
        self.entries.append(e)

    def term_at(self, lsn: int) -> int | None:
        """Term of entry at lsn; None if below base (recycled — committed
        by construction) or beyond the end."""
        if lsn < self.base:
            return None
        if lsn >= len(self):
            return None
        return self.entries[lsn - self.base].term


# ---- messages -----------------------------------------------------------
@dataclass(frozen=True)
class AppendReq:
    term: int
    leader_id: int
    prev_lsn: int
    prev_term: int
    entries: tuple[LogEntry, ...]
    commit_lsn: int


@dataclass(frozen=True)
class AppendAck:
    term: int
    ack_lsn: int  # highest lsn the follower has matched, -1 on mismatch
    success: bool


@dataclass(frozen=True)
class VoteReq:
    term: int
    candidate_id: int
    last_lsn: int
    last_term: int
    # leadership transfer: bypass the lease check (sent only by a candidate
    # that the old leader explicitly handed off to via TimeoutNow)
    force: bool = False


@dataclass(frozen=True)
class TimeoutNow:
    """Leader -> chosen successor: start an election immediately (the
    leadership-transfer handshake; successor's log is already caught up)."""

    term: int


@dataclass(frozen=True)
class VoteResp:
    term: int
    granted: bool


HEARTBEAT_IVL = 0.05
LEASE_TIMEOUT = 0.25
ELECTION_JITTER = 0.05
MAX_INFLIGHT = 1024  # sliding-window cap (entries per follower burst)

# membership-change log entries (LogConfigMgr analog): the payload is a
# reserved marker + the new member list; replicas adopt the config when
# the entry is APPENDED (Raft's rule), and the apply path never surfaces
# these to the state machine
CONFIG_PREFIX = b"\x00\x00CFG1:"


def _encode_config(peers: list[int]) -> bytes:
    return CONFIG_PREFIX + ",".join(str(p) for p in sorted(peers)).encode()


def _decode_config(payload: bytes) -> list[int] | None:
    if not payload.startswith(CONFIG_PREFIX):
        return None
    body = payload[len(CONFIG_PREFIX):]
    return [int(x) for x in body.split(b",") if x]


@dataclass
class PalfReplica:
    """One replica of one log stream."""

    node_id: int
    peers: list[int]  # all member ids including self
    bus: LocalBus
    on_commit: Callable[[LogEntry], None] | None = None
    # durable log engine (log/store.LogStore); None = volatile (pure unit
    # tests). With a store, every append/truncate is mirrored to disk and
    # synced BEFORE the replica acks or counts itself in a quorum, and
    # (term, voted_for) are persisted BEFORE any message acting on them.
    store: Any | None = None
    role: Role = Role.FOLLOWER
    term: int = 0
    voted_for: int | None = None
    log: LogView = field(default_factory=LogView)
    commit_lsn: int = -1
    applied_lsn: int = -1
    # scn of the newest applied entry: the replica's apply watermark in
    # the GTS timestamp domain (tx/ls.py LSReplica.apply_watermark)
    applied_scn: int = 0
    leader_id: int | None = None
    lease_until: float = 0.0
    next_election_at: float = 0.0
    next_heartbeat_at: float = 0.0
    _match_lsn: dict[int, int] = field(default_factory=dict)
    _next_lsn: dict[int, int] = field(default_factory=dict)
    _votes: set[int] = field(default_factory=set)
    _scn: int = 0
    _term_start_lsn: int = 0
    _last_ack: dict[int, float] = field(default_factory=dict)
    # wait-event bookkeeping (virtual-clock timestamps): submit->commit
    # per lsn, append-send->ack per peer (both leader-side)
    _submit_at: dict[int, float] = field(default_factory=dict)
    _sent_at: dict[int, float] = field(default_factory=dict)
    # trace context captured at submit_log, so the commit advance can emit
    # a retrospective "palf replication" span into the submitting
    # statement's trace tree (full-link tracing across the bus)
    _submit_ctx: dict[int, Any] = field(default_factory=dict)

    def __post_init__(self):
        # constructor-provided membership = the config floor a truncation
        # can fall back to when every in-log config entry is cut away
        self._base_config = list(self.peers)
        if self.store is not None:
            entries, base, term, voted_for = self.store.load()
            if entries or term:
                self.log = LogView(
                    base, entries, self.store.base_prev_term
                )
                self.term = term
                self.voted_for = voted_for
                if entries:
                    self._scn = entries[-1].scn
                # re-adopt the newest membership recorded in the log
                for e in reversed(entries):
                    cfg = _decode_config(e.payload)
                    if cfg is not None:
                        self.peers = list(cfg)
                        break
        self.bus.register(self.node_id, self._on_message)
        self.next_election_at = (
            self.bus.now + LEASE_TIMEOUT + self._jitter()
        )

    # ------------------------------------------------------- durability
    def _persist_meta(self) -> None:
        if self.store is not None:
            self.store.save_meta(self.term, self.voted_for)

    def _persist_append(self, entries) -> None:
        if self.store is not None:
            self.store.append(entries)

    def _persist_sync(self) -> None:
        """Group-commit: durable point before ack/self-count."""
        if self.store is not None:
            self.store.sync()

    def recycle(self, upto_lsn: int) -> None:
        """Advance the disk recycle point (everything below upto_lsn is
        covered by a durable checkpoint). In-memory entries are trimmed
        too — a follower that has fallen below this point needs a
        snapshot-based rebuild, not log catch-up."""
        upto = min(upto_lsn, self.commit_lsn + 1)
        if upto <= self.log.base:
            return
        if self.store is not None:
            # disk recycling is segment-aligned and records its own base
            # info (the durable base differs from the in-memory one)
            self.store.recycle(upto)
        keep_term = self.log[upto - 1].term
        self.log = LogView(
            upto, self.log.entries[upto - self.log.base :], keep_term
        )

    # ------------------------------------------------------------ utils
    def _jitter(self) -> float:
        # deterministic per (node, term) spread so elections don't collide
        return ELECTION_JITTER * (1 + ((self.node_id * 2654435761 + self.term) % 97) / 97)

    def _majority(self) -> int:
        return len(self.peers) // 2 + 1

    def _last(self) -> tuple[int, int]:
        if len(self.log) == 0:
            return -1, 0
        if not self.log.entries:
            # fully-recycled log: the last entry's identity survives as the
            # recorded base info (elections must keep working post-recycle)
            return self.log.base - 1, self.log.base_prev_term
        e = self.log[-1]
        return e.lsn, e.term

    def quorum_alive_hint(self) -> bool:
        return self.role is Role.LEADER

    # -------------------------------------------------------- public API
    def submit_log(self, payload: bytes, scn: int | None = None) -> int | None:
        """Leader appends; returns lsn or None if not leader (caller retries
        at the real leader — the analog of OB_NOT_MASTER). Errsim:
        EN_LOG_SUBMIT injects append failures."""
        from ..share.errsim import errsim_point

        errsim_point("EN_LOG_SUBMIT")
        if self.role is not Role.LEADER:
            return None
        lsn = len(self.log)
        self._scn = max(self._scn + 1, scn or 0)
        e = LogEntry(lsn, self.term, self._scn, payload)
        m = getattr(self.bus, "metrics", None)
        tr = getattr(self.bus, "tracer", None)
        if tr is not None:
            ctx = tr.current_ctx()
            if ctx is not None:
                self._submit_at.setdefault(lsn, self.bus.now)
                self._submit_ctx[lsn] = ctx
        self.log.append(e)
        if m is not None:
            # "palf append": the leader's local durability window; "palf
            # commit" (recorded on commit advance) measures the
            # replication round on the bus's virtual clock
            self._submit_at[lsn] = self.bus.now
            m.add("palf log entries submitted")
            with m.waiting("palf append"):
                self._persist_append((e,))
                self._persist_sync()
        else:
            self._persist_append((e,))
            self._persist_sync()  # durable before counting self in the quorum
        self._advance_commit()  # single-replica groups commit immediately
        return lsn

    def tick(self) -> None:
        """Advance timers against the bus's virtual clock."""
        now = self.bus.now
        if self.role is Role.LEADER:
            # leader lease self-check: without acks from a majority within
            # the lease window, step down (the failure-detector demotion —
            # a partitioned/dead-network leader must not keep serving)
            alive = 1 + sum(
                1 for p, t in self._last_ack.items() if now - t < LEASE_TIMEOUT
            )
            if alive < self._majority():
                self._step_down(self.term, None)
                return
            if now >= self.next_heartbeat_at:
                self._broadcast_appends()
                self.next_heartbeat_at = now + HEARTBEAT_IVL
        else:
            lease_live = now < self.lease_until
            if not lease_live and now >= self.next_election_at:
                self._start_election()

    # ---------------------------------------------------------- election
    def _start_election(self, force: bool = False) -> None:
        self.role = Role.CANDIDATE
        self.term += 1
        self.voted_for = self.node_id
        self._persist_meta()  # durable before soliciting votes
        self._votes = {self.node_id}
        self.leader_id = None
        last_lsn, last_term = self._last()
        for p in self.peers:
            if p != self.node_id:
                self.bus.send(
                    self.node_id, p,
                    VoteReq(self.term, self.node_id, last_lsn, last_term, force),
                )
        self.next_election_at = self.bus.now + LEASE_TIMEOUT + self._jitter()
        if len(self.peers) == 1:
            self._become_leader()

    def submit_config(self, new_peers: list[int]) -> int | None:
        """Single-member-change membership update (LogConfigMgr analog):
        the leader logs the new member list and adopts it immediately
        (Raft: a config is effective once appended); followers adopt on
        append. Safe for one add OR one remove at a time — the migration
        path drives each change to commit before the next."""
        if self.role is not Role.LEADER:
            return None
        cur, new = set(self.peers), set(new_peers)
        if len(cur.symmetric_difference(new)) > 1:
            raise ValueError("one membership change at a time")
        lsn = self.submit_log(_encode_config(list(new_peers)))
        if lsn is not None:
            self._adopt_config(list(new_peers))
        return lsn

    def _readopt_config_from_log(self) -> None:
        """Adopt the newest config still in the log, else the base config
        the replica was constructed with (post-truncation recovery)."""
        for e in reversed(self.log.entries):
            cfg = _decode_config(e.payload)
            if cfg is not None:
                self._adopt_config(cfg)
                return
        self._adopt_config(list(self._base_config))

    def _adopt_config(self, new_peers: list[int]) -> None:
        self.peers = list(new_peers)
        if self.role is Role.LEADER:
            nxt = len(self.log)
            for p in self.peers:
                if p != self.node_id:
                    self._next_lsn.setdefault(p, nxt)
                    self._match_lsn.setdefault(p, -1)
                    self._last_ack.setdefault(p, self.bus.now)
            for m in (self._next_lsn, self._match_lsn, self._last_ack):
                for p in list(m):
                    if p not in self.peers:
                        del m[p]

    def transfer_leader(self, target: int) -> bool:
        """Hand leadership to `target` (must be caught up). Returns False if
        not leader or target is behind — caller keeps driving and retries."""
        if self.role is not Role.LEADER or target == self.node_id:
            return False
        if self._match_lsn.get(target, -1) != len(self.log) - 1:
            self._send_append_to(target)  # catch it up first
            return False
        self.bus.send(self.node_id, target, TimeoutNow(self.term))
        return True

    def _become_leader(self) -> None:
        self.role = Role.LEADER
        self.leader_id = self.node_id
        nxt = len(self.log)
        self._next_lsn = {p: nxt for p in self.peers if p != self.node_id}
        self._match_lsn = {p: -1 for p in self.peers if p != self.node_id}
        self._last_ack = {p: self.bus.now for p in self.peers if p != self.node_id}
        # A leader may only count replicas for entries of its own term
        # (prior-term entries commit transitively), so append a no-op to
        # unblock commitment of everything inherited from old leaders.
        self._scn += 1
        self._term_start_lsn = len(self.log)
        e = LogEntry(len(self.log), self.term, self._scn, b"")
        self.log.append(e)
        self._persist_append((e,))
        self._persist_sync()
        self._advance_commit()  # single-replica groups commit immediately
        self.next_heartbeat_at = self.bus.now  # heartbeat immediately
        self.tick()

    @property
    def is_ready_leader(self) -> bool:
        """Leader that committed its own-term no-op AND applied everything —
        only then are reads served (a fresh leader must finish replaying
        inherited entries first; the reference's role-change protocol waits
        the same way before the new leader goes active)."""
        return (
            self.role is Role.LEADER
            and self.commit_lsn >= self._term_start_lsn
            and self.applied_lsn == self.commit_lsn
        )

    def reset_election_timer(self) -> None:
        """Rejoin grace: a replica coming back from a restart/partition
        waits one full lease window for an incumbent leader's heartbeat
        before campaigning. Without this its stale next_election_at fires
        immediately, the term bump NACKs the healthy leader's appends and
        deposes it (restart disruption — the problem pre-vote solves)."""
        self.next_election_at = self.bus.now + LEASE_TIMEOUT + self._jitter()

    def _step_down(self, term: int, leader: int | None) -> None:
        self.role = Role.FOLLOWER
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._persist_meta()  # durable before acting in the new term
        if leader is not None:
            self.leader_id = leader
        self.next_election_at = self.bus.now + LEASE_TIMEOUT + self._jitter()

    # ------------------------------------------------------- replication
    def _broadcast_appends(self) -> None:
        for p in self.peers:
            if p != self.node_id:
                self._send_append_to(p)

    def _advance_commit(self) -> None:
        # highest lsn replicated on a majority AND from the current term
        floor = max(self.commit_lsn, self.log.base - 1)
        prev_commit = self.commit_lsn
        for lsn in range(len(self.log) - 1, floor, -1):
            if self.log[lsn].term != self.term:
                break
            acked = 1 + sum(1 for m in self._match_lsn.values() if m >= lsn)
            if acked >= self._majority():
                self.commit_lsn = lsn
                break
        if self.commit_lsn > prev_commit and (self._submit_at or self._submit_ctx):
            m = getattr(self.bus, "metrics", None)
            tr = getattr(self.bus, "tracer", None)
            for lsn in range(prev_commit + 1, self.commit_lsn + 1):
                t = self._submit_at.pop(lsn, None)
                if t is not None and m is not None:
                    m.wait("palf commit", self.bus.now - t)
                ctx = self._submit_ctx.pop(lsn, None)
                if ctx is not None and tr is not None and t is not None:
                    # retrospective span: the whole replication round for
                    # this lsn (submit -> majority ack) on the virtual clock
                    tr.record_span(
                        "palf replication", ctx, t, self.bus.now,
                        node=self.node_id, lsn=lsn,
                    )
        self._apply()

    def _apply(self) -> None:
        while self.applied_lsn < self.commit_lsn:
            self.applied_lsn += 1
            e = self.log[self.applied_lsn]
            self.applied_scn = max(self.applied_scn, e.scn)
            # membership entries are consensus-internal: never surfaced
            # to the state machine
            if e.payload.startswith(CONFIG_PREFIX):
                continue
            if self.on_commit is not None:
                self.on_commit(e)

    # ------------------------------------------------------ msg handling
    def _on_message(self, src: int, msg: Any) -> None:
        if isinstance(msg, AppendReq):
            self._on_append(src, msg)
        elif isinstance(msg, AppendAck):
            self._on_append_ack(src, msg)
        elif isinstance(msg, VoteReq):
            self._on_vote_req(src, msg)
        elif isinstance(msg, VoteResp):
            self._on_vote_resp(src, msg)
        elif isinstance(msg, TimeoutNow):
            if msg.term == self.term and self.role is not Role.LEADER:
                self._start_election(force=True)

    def _on_append(self, src: int, m: AppendReq) -> None:
        if m.term < self.term:
            self.bus.send(self.node_id, src, AppendAck(self.term, -1, False))
            return
        # valid leader for this term: refresh lease
        self._step_down(m.term, m.leader_id)
        self.lease_until = self.bus.now + LEASE_TIMEOUT
        # log matching; prev below base = recycled = committed = matched
        if m.prev_lsn >= self.log.base:
            if m.prev_lsn >= len(self.log) or self.log[m.prev_lsn].term != m.prev_term:
                self.bus.send(self.node_id, src, AppendAck(self.term, -1, False))
                return
        # append, truncating any conflicting suffix
        appended = []
        for e in m.entries:
            if e.lsn < self.log.base:
                continue  # below our checkpointed prefix: already committed
            if e.lsn < len(self.log):
                if self.log[e.lsn].term != e.term:
                    if e.lsn <= self.commit_lsn:
                        raise AssertionError(
                            f"node {self.node_id}: conflicting entry at committed lsn {e.lsn}"
                        )
                    had_config = any(
                        en.payload.startswith(CONFIG_PREFIX)
                        for en in self.log.entries[e.lsn - self.log.base:]
                    )
                    del self.log[e.lsn :]
                    if self.store is not None:
                        self.store.truncate_from(e.lsn)
                    if had_config:
                        # an adopted-but-uncommitted membership was cut:
                        # fall back to the newest surviving config
                        self._readopt_config_from_log()
                    appended = [a for a in appended if a.lsn < e.lsn]
                    self.log.append(e)
                    appended.append(e)
                # else: duplicate, keep
            else:
                self.log.append(e)
                appended.append(e)
        mx = getattr(self.bus, "metrics", None)
        if mx is not None and appended:
            mx.add("palf log entries replicated", len(appended))
        if appended:
            tr = getattr(self.bus, "tracer", None)
            ctx = self.bus.delivery_ctx() if hasattr(self.bus, "delivery_ctx") else None
            if tr is not None and ctx is not None:
                # follower-side durability work, tagged with THIS node so
                # SHOW TRACE shows which replica appended for the statement
                tr.record_span(
                    "palf append", ctx, self.bus.now, self.bus.now,
                    node=self.node_id, entries=len(appended),
                )
            self._persist_append(appended)
            # adopt any membership change in the appended suffix (config
            # is effective at append; the newest one wins)
            for e in appended:
                cfg = _decode_config(e.payload)
                if cfg is not None:
                    self._adopt_config(cfg)
        self._persist_sync()  # durable BEFORE the ack joins a commit quorum
        new_commit = min(m.commit_lsn, len(self.log) - 1)
        if new_commit > self.commit_lsn:
            self.commit_lsn = new_commit
        self._apply()
        ack_lsn = m.prev_lsn + len(m.entries)
        self.bus.send(self.node_id, src, AppendAck(self.term, ack_lsn, True))

    def _on_append_ack(self, src: int, m: AppendAck) -> None:
        if self.role is not Role.LEADER:
            return
        if m.term > self.term:
            self._step_down(m.term, None)
            return
        self._last_ack[src] = self.bus.now
        mx = getattr(self.bus, "metrics", None)
        sent = self._sent_at.pop(src, None)
        if mx is not None:
            mx.add("palf acks received")
            if sent is not None:
                mx.wait("palf ack", self.bus.now - sent)
        tr = getattr(self.bus, "tracer", None)
        ctx = self.bus.delivery_ctx() if hasattr(self.bus, "delivery_ctx") else None
        if tr is not None and ctx is not None and m.success:
            tr.record_span(
                "palf ack", ctx,
                sent if sent is not None else self.bus.now, self.bus.now,
                node=src, ack_lsn=m.ack_lsn,
            )
        if m.success:
            self._match_lsn[src] = max(self._match_lsn.get(src, -1), m.ack_lsn)
            self._next_lsn[src] = self._match_lsn[src] + 1
            self._advance_commit()
            if self._next_lsn[src] < len(self.log):
                # more to stream: push immediately instead of next heartbeat
                self._send_append_to(src)
        else:
            # back off one step and retry (log reconciliation)
            self._next_lsn[src] = max(0, self._next_lsn.get(src, len(self.log)) - 1)
            self._send_append_to(src)

    def _send_append_to(self, p: int) -> None:
        # a follower below our recycled base needs a snapshot rebuild, not
        # log catch-up — clamp to base (ha/rebuild drives the snapshot)
        nxt = max(self._next_lsn.get(p, len(self.log)), self.log.base)
        prev_lsn = nxt - 1
        if prev_lsn < 0:
            prev_term = 0
        elif prev_lsn < self.log.base:
            prev_term = self.log.base_prev_term
        else:
            prev_term = self.log[prev_lsn].term
        entries = tuple(self.log[nxt : nxt + MAX_INFLIGHT])
        # oldest outstanding send wins: the ack wait must cover the full
        # round, not reset on every heartbeat re-send
        self._sent_at.setdefault(p, self.bus.now)
        self.bus.send(
            self.node_id, p,
            AppendReq(self.term, self.node_id, prev_lsn, prev_term, entries, self.commit_lsn),
        )

    def _on_vote_req(self, src: int, m: VoteReq) -> None:
        if self.bus.now < self.lease_until and not m.force:
            # lease election: current leader still holds a live lease
            self.bus.send(self.node_id, src, VoteResp(self.term, False))
            return
        if m.term > self.term:
            # adopt the term, but do NOT let a denied candidate push our
            # election timer (only a GRANT defers us, below): a stale
            # rejoining candidate with deterministically-small jitter
            # would otherwise re-campaign ahead of every up-to-date
            # replica forever — a term-inflation livelock with no leader
            keep = self.next_election_at
            self._step_down(m.term, None)
            self.next_election_at = keep
        granted = False
        if m.term == self.term and self.voted_for in (None, m.candidate_id):
            last_lsn, last_term = self._last()
            up_to_date = (m.last_term, m.last_lsn) >= (last_term, last_lsn)
            if up_to_date:
                granted = True
                self.voted_for = m.candidate_id
                self._persist_meta()  # the vote must survive restart
                self.next_election_at = self.bus.now + LEASE_TIMEOUT + self._jitter()
        self.bus.send(self.node_id, src, VoteResp(self.term, granted))

    def _on_vote_resp(self, src: int, m: VoteResp) -> None:
        if self.role is not Role.CANDIDATE:
            return
        if m.term > self.term:
            self._step_down(m.term, None)
            return
        if m.granted and m.term == self.term:
            self._votes.add(src)
            if len(self._votes) >= self._majority():
                self._become_leader()


def run_until(bus: LocalBus, replicas: list[PalfReplica], cond, max_time: float = 30.0,
              dt: float = 0.01) -> bool:
    """Drive ticks + delivery until cond() or timeout. Test harness helper."""
    deadline = bus.now + max_time
    while bus.now < deadline:
        for r in replicas:
            r.tick()
        bus.advance(dt)
        if cond():
            return True
    return False


def leader_of(replicas: list[PalfReplica]) -> PalfReplica | None:
    leaders = [r for r in replicas if r.role is Role.LEADER]
    if not leaders:
        return None
    return max(leaders, key=lambda r: r.term)
