"""Mesh-SPMD execution subsystem: the plan-level record of distributed
execution over a device mesh.

Counterpart of `oceanbase_tpu/parallel/spmd.py`. Reference surface: the
PX plan tree -- ObPxTransmit/ObPxReceive pairs mark DFO boundaries, each
with a distribution method (ob_sql_define.h ObPQDistributeMethod). The
port runs every exchange inside one SPMD run over the mesh
(parallel/px.py, parallel/group.py); the record of which collectives a
plan dispatches, over which mesh, moving how many bytes, lives here:

  * ``MeshExchange`` / ``MeshPlan`` -- one record per exchange boundary,
    its PX kind (broadcast / repartition / merge / ...) and the
    collective it stands for (all_gather / all_to_all / psum /
    ppermute), with static lane capacities -> per-dispatch byte volume.
  * ``SpmdLowering`` -- the per-compile recorder the emission sites write
    through. The JAX package fills it while jit traces the program, once;
    the port runs its emission on every dispatch, so the first run of a
    compiled program records (from its first local shard only) and later
    runs do not.
  * ``ShardedResidency`` -- the partitioned residency ledger: what the
    memory governor must charge per device. Shards that share a device
    add up on it.
  * ``shard_put`` -- partition a host-built ColumnBatch across the mesh,
    one row slice per shard on the shard's device; ``shard_put_planes``
    the same for loose host planes (a streamed chunk's narrowed columns,
    which the PX chunk source then widens on each shard's device). On a
    mesh over processes every process passes the whole host batch and
    uploads its own shards' slices alone.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from .mesh import mesh_signature

#: PX exchange kind -> the collective it stands for by default.
#: "broadcast" stands for "ppermute" instead when the executor's
#: broadcast_impl selects the ring schedule (exchange.py
#: ring_broadcast_rows); the lowering records the collective actually run.
KIND_COLLECTIVE = {
    "broadcast": "all_gather",
    "repartition": "all_to_all",
    "merge": "psum",
    "bloom": "psum",
    "skew_histogram": "psum",
    "range_sample": "psum",
}


@dataclass(frozen=True)
class MeshExchange:
    """One exchange boundary of a compiled SPMD program, fully static:
    capacities and column counts are Python ints."""

    kind: str  # PX distribution kind (broadcast/repartition/merge/...)
    collective: str  # the collective it stands for
    ncols: int  # payload columns (cols + validity lanes)
    lane_cap: int  # rows per lane
    lanes: int  # lane count across the mesh
    nbytes: int  # per-dispatch byte capacity the collective moves
    # of those, the bytes that cross between the processes of a mesh
    # over processes (0 on one process)
    cross_bytes: int = 0

    def describe(self) -> str:
        return (f"{self.kind}->{self.collective}"
                f"[{self.ncols}x{self.lane_cap}x{self.lanes}]")


@dataclass
class MeshPlan:
    """Mesh-aware physical plan summary: which collectives one compiled
    SPMD program dispatches, over which mesh. Attached to the
    PreparedPlan so cached plans keep their exchange layout."""

    mesh_sig: tuple  # ((shape...), (axis names...))
    n_shards: int
    exchanges: list = field(default_factory=list)
    # host-mediated data hops the hot loop performs per dispatch: zero
    # for resident SPMD plans (chunk-streamed plans would count one a
    # chunk upload)
    host_hops: int = 0

    @property
    def total_ops(self) -> int:
        return len(self.exchanges)

    @property
    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self.exchanges)

    @property
    def cross_process_bytes(self) -> int:
        """Per-dispatch byte capacity that crosses between processes."""
        return sum(e.cross_bytes for e in self.exchanges)

    def ops_by_collective(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.exchanges:
            out[e.collective] = out.get(e.collective, 0) + 1
        return out

    def describe(self) -> str:
        """Compact per-collective summary for the plan monitor row."""
        return ",".join(
            f"{c}:{n}" for c, n in sorted(self.ops_by_collective().items())
        )


class SpmdLowering:
    """Per-compile exchange recorder.

    px.py creates one per compile(); the compiled program's first run
    resets it and records every emission-site note from its first local
    shard, and sets `traced` so later runs record nothing (the counts are
    the program's, not the number of times it ran)."""

    def __init__(self, mesh_sig: tuple, n_shards: int, n_procs: int = 1):
        self.plan = MeshPlan(mesh_sig=mesh_sig, n_shards=n_shards)
        # processes the mesh spans, its shards split evenly over them
        self.n_procs = max(1, int(n_procs))
        # (kind, ncols, cap) triples of the row exchanges: the worker-span
        # and peak-bytes consumers read this shape
        self.legacy_log: list[tuple[str, int, int]] = []
        self.traced = False

    def reset(self) -> None:
        """Start a recording from zero (a re-recording replays every
        note)."""
        self.plan.exchanges.clear()
        self.plan.host_hops = 0
        del self.legacy_log[:]

    def note(self, kind: str, ncols: int, cap: int, lanes: int,
             collective: str | None = None, elem_bytes: int = 8,
             legacy: bool = True) -> None:
        if collective is None:
            collective = KIND_COLLECTIVE.get(kind, kind)
        nbytes = ncols * cap * lanes * elem_bytes
        p = self.n_procs
        if collective == "all_to_all":
            # the (src, dst) lanes whose ends lie in different processes
            cross = nbytes * (p - 1) // p
        else:
            # every shard's block goes once to each other process
            cross = nbytes * (p - 1)
        self.plan.exchanges.append(MeshExchange(
            kind=kind, collective=collective, ncols=ncols, lane_cap=cap,
            lanes=lanes, nbytes=nbytes, cross_bytes=cross,
        ))
        # reductions (legacy=False) stay out of the triple log: its
        # consumers size row-exchange worker spans and peak shuffle bytes
        if legacy:
            self.legacy_log.append((kind, ncols, cap))

    def note_host_hop(self) -> None:
        self.plan.host_hops += 1


class ShardedResidency:
    """Partitioned residency ledger: which base tables are resident as
    sharded device tensors, and how many bytes one device holds.

    Row sharding splits every column evenly over the shards, so a device
    holding k of the n shards holds k/n of every table: on a mesh of one
    shard per device that is total/n, and on a mesh whose shards share
    one device, all of it. The memory governor charges
    ``per_device_bytes()`` against its per-device budget. On a mesh over
    processes the ledger is per process: it counts this process's
    shards and the bytes it placed. Thread-safe."""

    def __init__(self, n_shards: int, shards_per_device: int = 1):
        self.n_shards = max(1, int(n_shards))
        self.shards_per_device = max(1, int(shards_per_device))
        self._tables: dict[str, int] = {}
        self._lock = threading.Lock()

    def charge(self, table: str, nbytes: int) -> None:
        with self._lock:
            self._tables[table] = self._tables.get(table, 0) + int(nbytes)

    def discharge(self, table: str) -> None:
        with self._lock:
            self._tables.pop(table, None)

    def clear(self) -> None:
        with self._lock:
            self._tables.clear()

    def total_bytes(self) -> int:
        with self._lock:
            return sum(self._tables.values())

    def per_device_bytes(self) -> int:
        """What the fullest device of the mesh holds -- the governor's
        unit of account (its budget is per device)."""
        return self.total_bytes() * self.shards_per_device // self.n_shards

    def tables(self) -> dict[str, int]:
        with self._lock:
            return dict(self._tables)


def _put(t, lo: int, hi: int, dev):
    """Rows [lo, hi) of a host tensor on a shard's device: pinned staging
    on a card, so the copy runs without a host sync."""
    part = t[lo:hi].contiguous()
    if dev.type != "cuda":
        return part.to(dev)
    return part.pin_memory().to(dev, non_blocking=True)


def _per_shard(mesh, cap: int) -> int:
    n = mesh.size
    if cap % n:
        raise ValueError(f"capacity {cap} does not split over {n} shards")
    return cap // n


def shard_put(mesh, batch):
    """Partition a host-built ColumnBatch (CPU tensors, capacity a
    multiple of the shard count) across the mesh: shard i gets rows
    [i * per, (i + 1) * per) on its device. Returns (raw, nbytes): one
    {"cols", "valid", "sel"} dict per shard (None for another process's
    shard), and the bytes this process placed."""
    per = _per_shard(mesh, batch.capacity)
    raw = [None] * mesh.size
    nbytes = 0
    for i in mesh.local_shards():
        dev = mesh.devices[i]
        lo, hi = i * per, (i + 1) * per
        part = {
            "cols": {c: _put(a, lo, hi, dev) for c, a in batch.cols.items()},
            "valid": {c: _put(a, lo, hi, dev)
                      for c, a in batch.valid.items()},
            "sel": _put(batch.sel, lo, hi, dev),
        }
        nbytes += sum(int(a.nbytes) for d in (part["cols"], part["valid"])
                      for a in d.values()) + int(part["sel"].nbytes)
        raw[i] = part
    return raw, nbytes


def shard_put_planes(mesh, planes: dict):
    """Partition host planes (CPU tensors of one length, a multiple of the
    shard count) across the mesh as `shard_put` does a batch. Returns
    (parts, per, nbytes): one {key: tensor} dict per shard (None for
    another process's shard), the rows per shard, and the bytes this
    process placed."""
    per = _per_shard(mesh, len(next(iter(planes.values()))))
    parts = [None] * mesh.size
    nbytes = 0
    for i in mesh.local_shards():
        lo, hi = i * per, (i + 1) * per
        part = {k: _put(a, lo, hi, mesh.devices[i])
                for k, a in planes.items()}
        nbytes += sum(int(a.nbytes) for a in part.values())
        parts[i] = part
    return parts, per, nbytes


__all__ = [
    "KIND_COLLECTIVE",
    "MeshExchange",
    "MeshPlan",
    "ShardedResidency",
    "SpmdLowering",
    "mesh_signature",
    "shard_put",
    "shard_put_planes",
]
