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
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

_CTX = threading.local()


class ShardGroup:
    """The rendezvous of one SPMD run's shards."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n = mesh.size
        self._barrier = threading.Barrier(self.n) if self.n > 1 else None
        self._slots = [None] * self.n
        # shards on several CUDA devices: a sender's stream must finish
        # before another card reads its buffers
        cards = {d for d in mesh.devices if d.type == "cuda"}
        self._cross_card = len(cards) > 1

    def gather(self, shard: int, value) -> list:
        """Every shard's `value`, in shard order (the all-gather of Python
        objects that every collective is built on)."""
        if self.n == 1:
            return [value]
        if self._cross_card:
            torch.cuda.current_stream(self.mesh.devices[shard]).synchronize()
        self._slots[shard] = value
        self._barrier.wait()
        out = list(self._slots)
        self._barrier.wait()
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
    """fn(shard) on every shard of the mesh, each in its shard context;
    returns the results in shard order. One shard runs in the caller's
    thread; more run in one thread each."""
    group = ShardGroup(mesh)
    if group.n == 1:
        with _bound(ShardContext(group, 0)):
            return [fn(0)]
    results = [None] * group.n
    errors: list = [None] * group.n

    def work(i):
        try:
            with _bound(ShardContext(group, i)):
                results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors[i] = e
            group.abort()

    threads = [threading.Thread(target=work, args=(i,), name=f"px-shard-{i}",
                                daemon=True)
               for i in range(group.n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    real = [e for e in errors if e is not None
            and not isinstance(e, threading.BrokenBarrierError)]
    if real:
        raise real[0]
    broken = [e for e in errors if e is not None]
    if broken:
        raise broken[0]
    return results
