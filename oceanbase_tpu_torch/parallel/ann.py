"""Mesh-sharded IVF kNN: the vector index's PX story, on kernel K31.

Counterpart of `oceanbase_tpu/parallel/ann.py`. The permuted data matrix
splits into contiguous row blocks, one per shard (the cluster-contiguous
layout means a probed list's window touches at most a few blocks); the
centroid table, the list offsets and the lengths replicate, one copy per
device. Every shard runs the same probe (its top-nprobe lists: K21, the
single-device probe's list selection, with lax.top_k's tie order), and
re-ranks only the window rows its block holds, the others masked to +inf
(K31's re-rank): a local top-k of (distance, global position). One
all_gather of those k-strips (exchange.py's, on K26) and a final top-k
over nsh * k rows (K31's merge) give every shard the exact answer. The
merge moves O(nsh * k) scalars, not candidate vectors.

Every candidate row is re-ranked by exactly one shard with the same
arithmetic and the final top-k sees the union of all windows, so the ids
equal the single-device probe's at the same nprobe (up to float32
rounding of near-equal distances). The mesh may span processes
(`mesh.process_mesh`): each process holds its shards' blocks and every
process returns the same answer.

The collective is recorded through the SpmdLowering -> MeshPlan path
(spmd.py), once per (k, nprobe) program, so `mesh_plan.ops_by_collective()`
counts the merge's all_gather like any exchange.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels as K
from .exchange import _all_gather
from .group import run_spmd
from .mesh import Mesh, mesh_signature
from .spmd import MeshPlan, SpmdLowering


@dataclass
class ShardedIvf:
    """One vector index resident across the mesh: the permuted data
    matrix row-sharded into contiguous blocks (this process's shards'
    blocks on their devices, None for another process's), probe metadata
    replicated on every device."""

    mesh: Mesh
    nsh: int
    xs: list                # per shard: (rows_per_shard, d) float32 block
    cent: list              # per shard: (L, d) float32, replicated
    offs: list              # per shard: (L,) int32, replicated
    lens: list              # per shard: (L,) int32, replicated
    perm: np.ndarray        # (n,) host: maps global positions to rowids
    max_list: int
    rows_per_shard: int
    nrows: int              # live rows (before padding)
    lowering: SpmdLowering = None
    _recorded: set = field(default_factory=set)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @property
    def mesh_plan(self) -> MeshPlan:
        return self.lowering.plan

    def device_bytes(self) -> int:
        """Whole-mesh resident footprint, as the reference counts it (the
        row blocks of every shard, the replicated arrays once; the
        governor's unit is per device: divide by nsh for one chip's
        share)."""
        c = self.cent[self.mesh.local_shards()[0]]
        nl, d = int(c.shape[0]), int(c.shape[1])
        return 4 * (self.nsh * self.rows_per_shard * d + nl * d + 2 * nl)

    def search(self, q, k: int, nprobe: int):
        """Exact-merge sharded kNN probe. Returns (rowids, dists) as host
        arrays, rowids already mapped through the perm."""
        nl = int(self.offs[self.mesh.local_shards()[0]].shape[0])
        nprobe = max(1, min(int(nprobe), nl))
        kk = max(1, min(int(k), nprobe * self.max_list))
        key = (int(k), nprobe)
        with self._lock:
            record = key not in self._recorded
            self._recorded.add(key)
        if record:
            self.lowering.reset()
        qh = torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32))
        rps, lead = self.rows_per_shard, self.mesh.local_shards()[0]

        def local(shard):
            dev = self.mesh.devices[shard]
            qd = qh.to(dev)
            probes = K.ivf_lists(self.cent[shard], qd, nprobe)
            dist, pos = K.ann_rerank(self.xs[shard], shard * rps,
                                     self.offs[shard], self.lens[shard],
                                     probes, qd, self.max_list, kk)
            if record and shard == lead:
                # merge: one strip of kk (distance, position) pairs a shard
                self.lowering.note("ann merge", ncols=2, cap=kk,
                                   lanes=self.nsh, collective="all_gather",
                                   legacy=False)
            gd, gp = _all_gather([dist, pos])
            return K.ann_merge(gd, gp, kk)

        dist, pos = run_spmd(self.mesh, local)[lead]
        dist = dist.cpu().numpy()
        pos = pos.cpu().numpy()
        live = np.isfinite(dist)
        return (self.perm[np.clip(pos, 0, len(self.perm) - 1)][live],
                dist[live])


def shard_ivf(mesh: Mesh, x: np.ndarray, idx) -> ShardedIvf:
    """Lay one built IvfIndex (`storage/vector_index.py`'s; an index of
    the JAX package's comes across through `ivf_from_arrays`) out across
    `mesh`: permuted rows split into equal contiguous blocks, metadata
    replicated. Every process of a mesh over processes passes the whole
    matrix and uploads its own shards' blocks."""
    nsh = mesh.size
    x = np.asarray(x, dtype=np.float32)
    xs = x[np.asarray(idx.perm)]
    n = xs.shape[0]
    rps = -(-n // nsh)  # ceil
    pad = nsh * rps - n
    if pad:
        # zero pad rows: list windows never reference positions >= n, so
        # pads are always masked out; zeros (not inf) keep the masked
        # lanes' dot products NaN-free (0 * inf = nan)
        xs = np.concatenate([xs, np.zeros((pad, xs.shape[1]), np.float32)])
    host = {
        "cent": torch.from_numpy(np.ascontiguousarray(idx.centroids,
                                                      dtype=np.float32)),
        "offs": torch.from_numpy(np.ascontiguousarray(idx.offsets,
                                                      dtype=np.int32)),
        "lens": torch.from_numpy(np.ascontiguousarray(idx.lengths,
                                                      dtype=np.int32)),
    }
    rep: dict = {}
    blocks, cent, offs, lens = ([None] * nsh for _ in range(4))
    for i in mesh.local_shards():
        dev = mesh.devices[i]
        blocks[i] = torch.from_numpy(xs[i * rps:(i + 1) * rps]).to(dev)
        if dev not in rep:
            rep[dev] = {k: v.to(dev) for k, v in host.items()}
        cent[i], offs[i], lens[i] = (rep[dev]["cent"], rep[dev]["offs"],
                                     rep[dev]["lens"])
    return ShardedIvf(
        mesh=mesh,
        nsh=nsh,
        xs=blocks,
        cent=cent,
        offs=offs,
        lens=lens,
        perm=np.asarray(idx.perm),
        max_list=int(idx.max_list),
        rows_per_shard=rps,
        nrows=n,
        lowering=SpmdLowering(mesh_signature(mesh), nsh, mesh.n_procs),
    )
