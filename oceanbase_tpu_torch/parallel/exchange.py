"""Exchange (repartition) primitives of PX, on kernels K25-K28.

Counterpart of `oceanbase_tpu/parallel/exchange.py` (:45-237). Reference
surface: the PX exchange operators and DTL channels --
ObPxTransmitOp/do_hash_dist routes each row to a target channel via
ObSliceIdxCalc (sql/engine/px/exchange/ob_px_dist_transmit_op.cpp:283),
receivers drain the channels. The port runs one thread per shard
(parallel/group.py) and every exchange is a rendezvous of the shards:

- HASH            -> dest_by_hash (K25), repartition: K25 packs the live
                     rows stably into [nsh, cap] lanes, K26 takes lane d
                     of every sender at receiver d (the all_to_all)
- BROADCAST       -> broadcast_rows: K26 places every shard's rows at
                     offset i * n (the all_gather); ring_broadcast_rows
                     moves one block a step of the ring into the same
                     layout
- PARTITION(PKEY) -> dest_by_partition (K25's owner lookup)
- RANDOM          -> dest_round_robin (K25's rank of the live rows)
- RANGE           -> sample_range_bounds (K1's span, K28's histogram and
                     bounds, K27's merges), dest_by_range (K25)
- aggregates      -> merge_partials / merge (K27, shard order)

Each (src shard -> dst shard) lane carries a static `cap` rows; overflow
is counted and returned so the engine re-executes with a larger
capacity. Every function except the dest_* ones runs inside an SPMD run
(group.current()); accounting happens at the px.py emission sites.
"""

from __future__ import annotations

import torch

from .. import kernels as K
from .group import current


def _planes(tensors, n: int | None = None) -> list:
    """Contiguous planes (a 0-d value broadcast to n rows). A VECTOR
    column, (rows, d) float32, crosses as one plane of fixed-width rows:
    K25 packs and K26 places d x 4 bytes a row, as they move an element
    of a 1-D column."""
    out = []
    for t in tensors:
        if t.dim() == 0:
            t = t.expand(n)
        if t.dim() not in (1, 2):
            raise ValueError(f"PX exchanges move columns and (rows, d) row "
                             f"planes, not a {t.dim()}-D tensor")
        out.append(t.contiguous())
    return out


def _empty_like_rows(p: torch.Tensor, rows: int,
                     dev: torch.device) -> torch.Tensor:
    """An uninitialised plane of `rows` rows shaped as p's rows."""
    return torch.empty((rows, *p.shape[1:]), dtype=p.dtype, device=dev)


def _local(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A sender's buffer as the receiver's kernel can read it: in place on
    a shared device, else a peer copy onto the receiver's."""
    return t if t.device == dev else t.to(dev)


def dest_by_hash(key_cols, n_shards: int) -> torch.Tensor:
    """HASH distribution: shard id per row from the 32-bit mixed key hash
    (hash32_combine % n_shards), K25."""
    n = max((int(k.shape[0]) for k in key_cols if k.dim()), default=1)
    return K.exchange_dest("hash", n_shards, _planes(key_cols, n))


def dest_by_range(key: torch.Tensor, bounds: torch.Tensor,
                  desc: bool = False) -> torch.Tensor:
    """RANGE distribution: bounds are n_shards-1 ascending split points;
    `desc` numbers the ranges from the top (the descending sort's
    shard order), K25."""
    return K.exchange_dest("range", int(bounds.shape[0]) + 1,
                           _planes([key]), bounds=bounds, desc=desc)


def dest_round_robin(mask: torch.Tensor, n_shards: int,
                     shard_id: int) -> torch.Tensor:
    """RANDOM(_LOCAL) distribution: even resplit of live rows, K25."""
    return K.round_robin_dest(mask.contiguous(), n_shards, int(shard_id))


def dest_by_partition(part_ids: torch.Tensor,
                      owner_of_partition: torch.Tensor) -> torch.Tensor:
    """PARTITION (PKEY) distribution: route each row to the shard owning
    its partition (the location cache's tablet -> shard map), K25."""
    return K.exchange_dest("partition", 1, _planes([part_ids]),
                           owner=owner_of_partition.contiguous())


def _all_to_all(planes, rows: int) -> list:
    """Receiver d takes lane d (rows [d * rows, (d + 1) * rows)) of every
    sender's planes, sender i's at offset i * rows (K26). A sender in this
    process is read in place; across processes only lane d travels to
    receiver d (`ShardGroup.all_to_all`), and K26 places each process's
    run of senders in one launch."""
    ctx = current()
    dev = ctx.device
    n = ctx.n_shards
    blocks = ctx.group.all_to_all(ctx.shard, planes, rows)
    outs = [_empty_like_rows(p, n * rows, dev) for p in planes]
    s0 = 0
    while s0 < n:
        # a run of senders whose blocks hold the lane at the same index
        lane = blocks[0][s0][1]
        s1 = s0 + 1
        while s1 < n and blocks[0][s1][1] == lane:
            s1 += 1
        K.exchange_recv([[_local(blocks[c][s][0], dev) for s in range(s0, s1)]
                         for c in range(len(planes))], rows, lane, outs,
                        out_base=s0 * rows)
        s0 = s1
    return outs


def _all_gather(planes, mask_plane: int = -1, per_host: int = 0) -> list:
    """Every shard's planes at offset i * n (K26), optionally keeping the
    mask plane on the receiver's host stripe."""
    ctx = current()
    dev = ctx.device
    every = ctx.gather(planes)
    n = ctx.n_shards
    rows = int(planes[0].shape[0])
    for s in range(n):
        if any(int(p.shape[0]) != rows for p in every[s]):
            raise ValueError("all_gather needs one capacity on every shard")
    senders = [[_local(every[s][c], dev) for s in range(n)]
               for c in range(len(planes))]
    outs = [_empty_like_rows(p, n * rows, dev) for p in planes]
    return K.exchange_recv(senders, rows, 0, outs, mask_plane=mask_plane,
                           per_host=per_host,
                           host_lane=ctx.shard % per_host if per_host else 0)


def merge(values_ops) -> list:
    """Reduce (tensor, op) pairs over the shards, every pair in one K27
    launch: op "sum" (psum), "min" (pmin), "max" (pmax), "or" (psum > 0,
    a bool result)."""
    ctx = current()
    dev = ctx.device
    xs = [v.contiguous() for v, _op in values_ops]
    every = ctx.gather(xs)
    n = ctx.n_shards
    planes = [[_local(every[s][c], dev) for s in range(n)]
              for c in range(len(xs))]
    return K.shard_merge(planes, [op for _v, op in values_ops])


def repartition(cols: dict, mask: torch.Tensor, dest: torch.Tensor,
                n_shards: int, cap: int):
    """Redistribute rows to their dest shard: K25 packs the send lanes,
    K26 receives lane d of every sender, K27 sums the overflow.

    Returns (new_cols, new_mask [n_shards * cap], overflow: 0-d count of
    rows dropped because a (src, dst) lane exceeded cap, summed over the
    shards). cap is per source->dest lane."""
    names = list(cols)
    n = int(mask.shape[0])
    lanes, sent, ovf = K.exchange_pack(
        _planes([cols[c] for c in names], n), mask.contiguous(),
        dest.to(torch.int32).contiguous(), n_shards, cap)
    recv = _all_to_all(lanes + [sent], cap)
    (overflow,) = merge([(ovf, "sum")])
    return dict(zip(names, recv[:-1])), recv[-1], overflow


def broadcast_rows(cols: dict, mask: torch.Tensor):
    """BROADCAST distribution: every shard receives all rows (the
    all_gather layout, K26)."""
    names = list(cols)
    n = int(mask.shape[0])
    out = _all_gather(_planes([cols[c] for c in names], n)
                      + [mask.contiguous()])
    return dict(zip(names, out[:-1])), out[-1]


def ring_broadcast_rows(cols: dict, mask: torch.Tensor, n_shards: int):
    """BROADCAST on a ring schedule: n_shards-1 steps, each shard taking
    the block its left neighbour received in the step before (K26 places
    it at its origin's offset). The layout equals broadcast_rows'."""
    ctx = current()
    dev = ctx.device
    me = ctx.shard
    names = list(cols)
    n = int(mask.shape[0])
    blk = _planes([cols[c] for c in names], n) + [mask.contiguous()]
    outs = [_empty_like_rows(p, n_shards * n, dev) for p in blk]
    K.exchange_recv([[p] for p in blk], n, 0, outs, out_base=me * n)
    for s in range(1, n_shards):
        every = ctx.gather(blk)
        blk = [_local(x, dev) for x in every[(me - 1) % n_shards]]
        # after s forwards the block in hand started at shard me - s
        K.exchange_recv([[p] for p in blk], n, 0, outs,
                        out_base=((me - s) % n_shards) * n)
    return dict(zip(names, outs[:-1])), outs[-1]


def merge_partials(partials):
    """Merge per-shard partial aggregates (the datahub rollup analog):
    psum over every tensor of a dict / list / tuple tree, one K27
    launch."""
    leaves: list = []

    def flat(x):
        if isinstance(x, dict):
            return {k: flat(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(flat(v) for v in x)
        leaves.append(x)
        return len(leaves) - 1

    shape = flat(partials)
    merged = merge([(x, "sum") for x in leaves]) if leaves else []

    def build(s):
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(build(v) for v in s)
        return merged[s]

    return build(shape)


def sample_range_bounds(key: torch.Tensor, mask: torch.Tensor,
                        n_shards: int, resolution: int = 4096) -> torch.Tensor:
    """RANGE distribution support: n_shards-1 ascending split points that
    give each range ~equal global row counts. The span is the shards'
    merged masked min/max (K1, K27); the equal-width histogram (K28) is
    summed over the shards (K27) and the bounds drawn from its cdf (K28),
    every shard deriving identical bounds with no host round trip.
    Integer keys only (dict codes, dates, ints)."""
    k64 = key.to(torch.int64).contiguous()
    m = mask.contiguous()
    kmin = K.scalar_reduce("min", m, k64)
    kmax = K.scalar_reduce("max", m, k64)
    lo, hi = merge([(kmin.reshape(1), "min"), (kmax.reshape(1), "max")])
    minmax = torch.cat([lo, hi])
    hist = K.range_histogram(k64, m, minmax, resolution)
    (hist,) = merge([(hist, "sum")])
    return K.range_bounds(hist, minmax, n_shards)


def bc2host(cols: dict, mask: torch.Tensor, per_host: int):
    """BC2HOST (SM_BROADCAST): one copy of every row per HOST, split
    across that host's workers: the all_gather with the mask kept on the
    stripe row % per_host == shard % per_host (K26). Consecutive runs of
    `per_host` shards form one host."""
    names = list(cols)
    n = int(mask.shape[0])
    planes = _planes([cols[c] for c in names], n) + [mask.contiguous()]
    out = _all_gather(planes, mask_plane=len(planes) - 1, per_host=per_host)
    return dict(zip(names, out[:-1])), out[-1]
