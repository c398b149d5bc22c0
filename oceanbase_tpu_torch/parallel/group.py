"""The SPMD runner: one thread per shard, every collective a rendezvous.

The JAX package traces a PX plan once under shard_map and XLA runs it on
every device of the mesh, each collective a synchronization point of the
devices. The port runs eagerly: `run_spmd` starts one thread per shard,
each thread runs the same emission over its own slice of the inputs on
its own device, and every collective of parallel/exchange.py is a
rendezvous of the shards' threads (`ShardGroup.gather`): each shard posts
its value, waits for the others, reads them all in shard order, and
waits once more so the slots can be reused. The data stays where it
lies; the receiving shard's kernel reads it (K26, K27).

A one-shard mesh runs in the caller's thread with no rendezvous at all.
A shard that raises aborts the group's barrier, so no other shard waits
forever at its next collective, and the caller gets the first real error
(not a shard's broken-barrier error).

A mesh over processes (`mesh.process_mesh`) runs only this process's
shards here, one thread each. A collective first meets the local shards;
then one of their threads (the leader) exchanges the local shards' values
with the other processes through `torch.distributed` (`_Wire`), and every
local shard reads the full list in global shard order. Tensors cross as
tensors: their bytes packed into one buffer, staged through pinned host
memory when they lie on a card (gloo moves CPU tensors; the copy also
orders the sender's stream before the bytes leave); values whose shapes
SPMD does not fix, and Python values, go through `all_gather_object`.
An all_to_all sends receiver d only its lane d (`ShardGroup.all_to_all`),
so the bytes between processes grow with the rows, not with the shards.
Each crossing is one round of a small protocol: a header all_gather of
(status, bytes, signature) first. A process whose shard raised sends a
failure header in its next round instead; every process then exchanges
the error messages and ends the run with that error, and no process is
left waiting in a collective. A run ends with one more round, so a
failure after the last collective reaches every process too.
"""

from __future__ import annotations

import threading
import zlib
from contextlib import contextmanager

import torch

_CTX = threading.local()

# bytes this process has sent to other processes through collectives
_WIRE_LOCK = threading.Lock()
WIRE_BYTES = {"sent": 0}

_FAIL, _DATA, _DONE = 0, 1, 2


class RemoteShardError(RuntimeError):
    """A shard of another process of the mesh raised; the message names
    it and its error."""


class _Wire:
    """The collectives of one SPMD run between the processes of a mesh,
    issued by one thread at a time (the local shards' leader during the
    run, the caller's thread at its end)."""

    def __init__(self, mesh):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("a process mesh runs inside an initialised "
                               "torch.distributed process group")
        self.dist = dist
        self.mesh = mesh
        self.world = mesh.n_procs
        self.rank = mesh.rank
        self.open = True

    # ---- the protocol -------------------------------------------------
    def _round(self, status: int, nbytes: int = 0, sig: int = 0) -> list:
        """One header all_gather; raises (and closes the run) when any
        process failed or the processes diverged."""
        hdr = torch.tensor([status, nbytes, sig], dtype=torch.int64)
        out = [torch.empty(3, dtype=torch.int64) for _ in range(self.world)]
        try:
            self.dist.all_gather(out, hdr)
        except BaseException:
            self.open = False
            raise
        heads = [t.tolist() for t in out]
        stats = {h[0] for h in heads}
        if _FAIL in stats:
            self.open = False
            if status != _FAIL:
                msgs = self._messages(None)
                raise RemoteShardError("; ".join(m for m in msgs if m))
        elif len(stats) > 1:
            self.open = False
            raise RuntimeError(
                f"the SPMD runs of the mesh's processes diverged: process "
                f"{self.rank} sent {status}, the others {sorted(stats)}")
        return heads

    def _messages(self, mine) -> list:
        msgs: list = [None] * self.world
        self.dist.all_gather_object(msgs, mine)
        return msgs

    def fail(self, shard: int, err: BaseException) -> None:
        """This process's shard raised: a failure round and the messages,
        so every other process ends its run with this error."""
        if not self.open:
            return
        self._round(_FAIL)
        self._messages(f"shard {shard} (process {self.rank}) raised "
                       f"{type(err).__name__}: {err}")

    def finish(self) -> None:
        """The run's last round: every process ended well, or this one
        learns of a failure after the last collective."""
        if self.open:
            self._round(_DONE)
            self.open = False

    # ---- data ---------------------------------------------------------
    def _stage(self, leaves) -> tuple:
        """The leaves' bytes in one CPU buffer (pinned when any lies on a
        card), each at an 8-byte aligned offset. Returns (buffer, [(offset,
        nbytes)])."""
        offs, total = [], 0
        for t in leaves:
            nb = t.numel() * t.element_size()
            offs.append((total, nb))
            total += -(-nb // 8) * 8
        pin = any(t.device.type == "cuda" for t in leaves)
        buf = torch.zeros(total, dtype=torch.uint8, pin_memory=pin)
        for t, (o, nb) in zip(leaves, offs):
            if nb:
                # a copy off a card waits for its stream: the stream
                # synchronisation before the bytes leave
                buf[o:o + nb].copy_(t.reshape(-1).view(torch.uint8))
        return buf, offs

    @staticmethod
    def _recv_buffer(nbytes: int, dev) -> torch.Tensor:
        """Where received bytes end up: on the receivers' card (one copy
        in from pinned memory), else on the host."""
        if dev is not None and dev.type == "cuda":
            return torch.empty(nbytes, dtype=torch.uint8, device=dev)
        return torch.empty(nbytes, dtype=torch.uint8)

    @staticmethod
    def _unstage(buf, o: int, like: torch.Tensor) -> torch.Tensor:
        nb = like.numel() * like.element_size()
        return buf[o:o + nb].view(like.dtype).reshape(like.shape)

    @staticmethod
    def _sig(leaves) -> int:
        text = repr([(str(t.dtype), tuple(t.shape)) for t in leaves])
        return zlib.crc32(text.encode())

    def _count(self, nbytes: int) -> None:
        with _WIRE_LOCK:
            WIRE_BYTES["sent"] += int(nbytes)

    def all_gather(self, values: list, dev) -> list:
        """Every process's list of local values, concatenated in rank
        order (global shard order); remote tensors land on `dev`."""
        flat = [_flatten(v) for v in values]
        if all(f is not None for f in flat):
            leaves = [t for f in flat for t in f[0]]
            buf, offs = self._stage(leaves)
            heads = self._round(_DATA, int(buf.numel()), self._sig(leaves))
            if all(h[1:] == heads[self.rank][1:] for h in heads):
                nb = int(buf.numel())
                out = self._recv_buffer(self.world * nb, dev)
                if nb:
                    host = out if out.device.type == "cpu" else torch.empty(
                        self.world * nb, dtype=torch.uint8, pin_memory=True)
                    self.dist.all_gather(list(host.chunk(self.world)), buf)
                    self._count(nb * (self.world - 1))
                    if host is not out:
                        out.copy_(host, non_blocking=True)
                full = []
                for r in range(self.world):
                    if r == self.rank:
                        full.extend(values)
                        continue
                    it = iter(offs)
                    for f in flat:
                        parts = [self._unstage(out, r * nb + next(it)[0], t)
                                 for t in f[0]]
                        full.append(f[1](parts))
                return full
        else:
            self._round(_DATA, 0, 0)
        # shapes or types that SPMD does not fix, or Python values
        host = [_to_host(v) for v in values]
        gathered: list = [None] * self.world
        self.dist.all_gather_object(gathered, host)
        full = []
        for r in range(self.world):
            full.extend(values if r == self.rank
                        else [_to_dev(v, dev) for v in gathered[r]])
        return full

    def all_to_all(self, senders: dict, rows: int, dev) -> dict:
        """The lanes between processes: `senders` maps each local shard to
        its planes ([nsh * rows] each, lane d for receiver d); process p
        gets lane d of every local sender for each of its shards d.
        Returns {(sender, plane, receiver): [rows] tensor on dev} for the
        remote senders of the local receivers."""
        mesh = self.mesh
        local = mesh.local_shards()
        planes0 = senders[local[0]]
        send_parts = []
        for p in range(self.world):
            if p == self.rank:
                continue
            for s in local:
                for c, pl in enumerate(senders[s]):
                    for d in mesh.shards_of(p):
                        send_parts.append(pl[d * rows:(d + 1) * rows])
        buf, _offs = self._stage(send_parts)
        per_peer = buf.numel() // max(self.world - 1, 1)
        heads = self._round(_DATA, int(buf.numel()),
                            self._sig(planes0) ^ rows)
        if any(h[1:] != heads[self.rank][1:] for h in heads):
            self.open = False
            raise RuntimeError("an all_to_all's lanes differ between the "
                               "mesh's processes")
        splits = [0 if p == self.rank else per_peer
                  for p in range(self.world)]
        host = torch.empty(per_peer * (self.world - 1), dtype=torch.uint8,
                           pin_memory=buf.is_pinned())
        if host.numel():
            self.dist.all_to_all_single(host, buf, output_split_sizes=splits,
                                        input_split_sizes=splits)
            self._count(buf.numel())
        out = host
        if dev is not None and dev.type == "cuda" and host.numel():
            out = self._recv_buffer(host.numel(), dev)
            out.copy_(host, non_blocking=True)
        # the receive side mirrors the send layout: from each remote p, its
        # senders in order, their planes, then this process's receivers
        got = {}
        o = 0
        seg = [pl[:rows] for pl in planes0]
        for p in range(self.world):
            if p == self.rank:
                continue
            for s in mesh.shards_of(p):
                for c, like in enumerate(seg):
                    for d in local:
                        got[(s, c, d)] = self._unstage(out, o, like)
                        nb = like.numel() * like.element_size()
                        o += -(-nb // 8) * 8
        return got


def _flatten(value):
    """(tensor leaves, rebuild) of a tensor or a list/tuple of tensors;
    None for anything else."""
    if isinstance(value, torch.Tensor):
        return [value], lambda parts: parts[0]
    if isinstance(value, (list, tuple)) and all(
            isinstance(v, torch.Tensor) for v in value):
        kind = type(value)
        return list(value), lambda parts: kind(parts)
    return None


def _to_host(v):
    if isinstance(v, torch.Tensor):
        return v.cpu()
    if isinstance(v, (list, tuple)):
        return type(v)(_to_host(x) for x in v)
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    return v


def _to_dev(v, dev):
    if isinstance(v, torch.Tensor):
        return v if dev is None else v.to(dev)
    if isinstance(v, (list, tuple)):
        return type(v)(_to_dev(x, dev) for x in v)
    if isinstance(v, dict):
        return {k: _to_dev(x, dev) for k, x in v.items()}
    return v


class ShardGroup:
    """The rendezvous of one SPMD run's shards (this process's, on a
    process mesh)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n = mesh.size
        self.local = mesh.local_shards()
        nl = len(self.local)
        self.wire = _Wire(mesh) if mesh.n_procs > 1 else None
        self._barrier = threading.Barrier(nl) if nl > 1 else None
        self._slots: dict = {}
        self._full = None
        # shards on several CUDA devices: a sender's stream must finish
        # before another card reads its buffers
        cards = {mesh.devices[i] for i in self.local
                 if mesh.devices[i].type == "cuda"}
        self._cross_card = len(cards) > 1

    def _wait(self) -> bool:
        """The local rendezvous; True in the thread that leads it."""
        if self._barrier is None:
            return True
        return self._barrier.wait() == 0

    def _lead(self, fn) -> None:
        """fn() in the leader between two rendezvous, its result (or its
        error, which aborts the group) published in self._full."""
        if self._wait():
            try:
                self._full = fn()
            except BaseException:
                self.abort()
                raise
        self._wait()

    def gather(self, shard: int, value) -> list:
        """Every shard's `value`, in shard order (the all-gather of Python
        objects that every collective is built on)."""
        if self.n == 1:
            return [value]
        if self._cross_card:
            torch.cuda.current_stream(self.mesh.devices[shard]).synchronize()
        self._slots[shard] = value
        if self.wire is None:
            self._wait()
            out = [self._slots[i] for i in range(self.n)]
            self._wait()
            return out
        dev = self.mesh.devices[self.local[0]]
        self._lead(lambda: self.wire.all_gather(
            [self._slots[i] for i in self.local], dev))
        out = list(self._full)
        self._wait()
        return out

    def all_to_all(self, shard: int, planes: list, rows: int) -> list:
        """The senders of receiver `shard`'s lanes, per plane: a list over
        every shard s of (block, lane) with the rows at lane * rows of
        block: a local sender's whole planes (read in place, lane =
        shard), a remote sender's lane alone (lane 0)."""
        if self._cross_card:
            torch.cuda.current_stream(self.mesh.devices[shard]).synchronize()
        self._slots[shard] = planes
        if self.wire is None:
            self._wait()
            every = [self._slots[i] for i in range(self.n)]
            self._wait()
            return [[(every[s][c], shard) for s in range(self.n)]
                    for c in range(len(planes))]
        dev = self.mesh.devices[self.local[0]]
        self._lead(lambda: self.wire.all_to_all(
            {i: self._slots[i] for i in self.local}, rows, dev))
        got = self._full
        local = set(self.local)
        out = [[(self._slots[s][c], shard) if s in local
                else (got[(s, c, shard)], 0) for s in range(self.n)]
               for c in range(len(planes))]
        self._wait()
        return out

    def abort(self) -> None:
        if self._barrier is not None:
            self._barrier.abort()


class ShardContext:
    """What a shard's thread knows of its run: the group, its index, its
    device."""

    __slots__ = ("group", "shard", "device")

    def __init__(self, group: ShardGroup, shard: int):
        self.group = group
        self.shard = shard
        self.device = group.mesh.devices[shard]

    @property
    def n_shards(self) -> int:
        return self.group.n

    def gather(self, value) -> list:
        return self.group.gather(self.shard, value)


def current() -> ShardContext:
    """The calling thread's shard context; raises outside an SPMD run
    (the collectives exist only inside one, as jax's do inside
    shard_map)."""
    ctx = getattr(_CTX, "ctx", None)
    if ctx is None:
        raise RuntimeError("a PX collective ran outside an SPMD run")
    return ctx


@contextmanager
def _bound(ctx: ShardContext):
    prev = getattr(_CTX, "ctx", None)
    _CTX.ctx = ctx
    try:
        if ctx.device.type == "cuda":
            with torch.cuda.device(ctx.device):
                yield
        else:
            yield
    finally:
        _CTX.ctx = prev


def run_spmd(mesh, fn) -> list:
    """fn(shard) on every shard this process holds, each in its shard
    context; returns the results in shard order (None for another
    process's shards). One local shard runs in the caller's thread; more
    run in one thread each. On a process mesh every process runs this
    together, and a shard that raises in any process ends the run in
    every process with its error."""
    group = ShardGroup(mesh)
    results = [None] * group.n
    if group.n == 1:
        with _bound(ShardContext(group, 0)):
            results[0] = fn(0)
        return results
    errors: dict = {}

    def work(i):
        try:
            with _bound(ShardContext(group, i)):
                results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors[i] = e
            group.abort()

    if len(group.local) == 1:
        work(group.local[0])
    else:
        threads = [threading.Thread(target=work, args=(i,),
                                    name=f"px-shard-{i}", daemon=True)
                   for i in group.local]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    own = [(i, e) for i, e in sorted(errors.items())
           if not isinstance(e, (threading.BrokenBarrierError,
                                 RemoteShardError))]
    wire = group.wire
    if wire is not None:
        if own:
            wire.fail(*own[0])
        elif errors:
            # a remote failure reached this process inside a collective
            # (the wire is closed); nothing more to send
            pass
        else:
            wire.finish()
    if own:
        raise own[0][1]
    remote = [e for e in errors.values() if isinstance(e, RemoteShardError)]
    if remote:
        raise remote[0]
    if errors:
        raise next(iter(errors.values()))
    return results
