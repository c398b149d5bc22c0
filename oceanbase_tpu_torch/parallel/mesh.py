"""Device mesh of the port's PX execution.

Counterpart of `oceanbase_tpu/parallel/mesh.py`. Reference surface: the
PX worker/SQC topology -- a query runs at DOP d across nodes, each node
hosting worker threads (sql/engine/px/ob_px_sub_coord.cpp). The mesh has
one axis, "shard", that enumerates the execution shards; each shard is
one `torch.device` and runs its slice of the plan in a thread of its own
(parallel/group.py), so a shard is a worker and its device the node.

A mesh may name one device more than once: every shard then keeps its
own slice and its own exchange lanes on that device. The tests use 8
`cpu` shards for the 8 virtual CPU devices the JAX package runs its PX
tests on, and a `Database(device="cpu")` builds its mesh from
`CPU_SHARDS`. `make_mesh()` itself takes the visible CUDA devices, one
shard each, and raises when there is none.

A mesh may also span processes (`process_mesh`, after
`torch.distributed.init_process_group`), as the JAX package's global mesh
spans the processes of `jax.distributed` (`oceanbase_tpu/parallel/
mesh.py:78-89`): rank r holds shards [r * per, (r + 1) * per), runs them
in threads of its own, and the collectives cross between the processes
through `torch.distributed` (parallel/group.py). Every rank passes the
whole host data, as every JAX process passes the whole array to
`device_put`; each uploads only its own shards' slices.

The JAX package's `shard_map_compat` (a version shim over jax's
shard_map) has no counterpart: the port runs each shard eagerly in its
thread and needs no SPMD tracer.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

SHARD_AXIS = "shard"

#: shards of the mesh a CPU Database builds for PX statements (one
#: device named this many times); the CPU tests set 8
CPU_SHARDS = 1


@dataclass(frozen=True)
class Mesh:
    """An ordered list of devices, one per shard, along one named axis.
    A process mesh also names the rank that owns each shard (`owners`),
    this process's rank and the process group's backend; a remote shard's
    device is the one its owner named."""

    devices: tuple
    axis_names: tuple = (SHARD_AXIS,)
    owners: tuple | None = None
    rank: int = 0
    backend: str | None = None

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def n_procs(self) -> int:
        """The processes the mesh spans (1 unless a process mesh)."""
        return 1 if self.owners is None else max(self.owners) + 1

    def shards_of(self, rank: int) -> tuple:
        """The shards rank `rank` holds, in shard order."""
        if self.owners is None:
            return tuple(range(self.size)) if rank == 0 else ()
        return tuple(i for i, o in enumerate(self.owners) if o == rank)

    def local_shards(self) -> tuple:
        """The shards this process holds, in shard order."""
        return self.shards_of(self.rank)

    def distinct_devices(self) -> list:
        """The devices of this process's shards (every shard in a mesh of
        one process) in first-shard order, each once."""
        out = []
        for i in self.local_shards():
            if self.devices[i] not in out:
                out.append(self.devices[i])
        return out

    def shards_per_device(self) -> int:
        """The most shards any one device of this process holds."""
        shards = self.local_shards()
        return max(sum(1 for i in shards if self.devices[i] == d)
                   for d in self.distinct_devices())


def _resolve(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def mesh_signature(mesh: Mesh) -> tuple:
    """Restart-stable identity of a mesh: axis sizes + axis names.

    Device ids are left out, as in the reference: what a compiled plan
    depends on is the axis geometry its shards and lanes were sized
    for."""
    return (
        tuple(int(mesh.shape[a]) for a in mesh.axis_names),
        tuple(str(a) for a in mesh.axis_names),
    )


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A one-axis mesh over `devices` (default: every visible CUDA device,
    one shard each), cut to the first `n_devices`. Refuses to shrink: a
    mesh of fewer devices than asked for would break the exchange lanes'
    capacity math."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is present; pass devices= "
                "(e.g. [torch.device('cpu')] * n) to build a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_resolve(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"mesh needs {n_devices} devices but only {len(devices)} "
                "are available; silently shrinking would break exchange "
                "capacity math"
            )
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices))


def cpu_mesh(n: int | None = None) -> Mesh:
    """The CPU mesh: one `cpu` device named `n` times (default
    CPU_SHARDS)."""
    return make_mesh(devices=[torch.device("cpu")] * (n or CPU_SHARDS))


#: the backends a process mesh runs on: gloo moves CPU tensors, and CUDA
#: shards stage through pinned host buffers (several processes on one
#: card, where NCCL refuses two ranks on one GPU)
PROCESS_BACKENDS = ("gloo",)


def process_mesh(local_devices, backend: str) -> Mesh:
    """A mesh over the processes of the default process group: this
    process's shards on `local_devices` (one shard each), ordered by
    global index (rank r holds shards [r * per, (r + 1) * per)); every
    rank names the same number of devices. Call it in every rank, after
    `torch.distributed.init_process_group(backend, init_method=...,
    world_size=..., rank=..., timeout=...)`: it raises by name when no
    process group is initialised, and never shrinks to one process."""
    import torch.distributed as dist

    if backend not in PROCESS_BACKENDS:
        raise NotImplementedError(
            f"process_mesh: backend {backend!r} is not supported; a process "
            f"mesh runs on {PROCESS_BACKENDS} (one card per process over "
            "NCCL is not ported)")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "process_mesh: no torch.distributed process group is "
            "initialised; call torch.distributed.init_process_group("
            f"{backend!r}, init_method=..., world_size=..., rank=...) in "
            "every process first")
    if dist.get_backend() != backend:
        raise ValueError(f"process_mesh: the process group runs "
                         f"{dist.get_backend()!r}, not {backend!r}")
    local = [_resolve(d) for d in local_devices]
    if not local:
        raise ValueError("process_mesh: a rank holds at least one shard")
    rank, world = dist.get_rank(), dist.get_world_size()
    named: list = [None] * world
    dist.all_gather_object(named, [str(d) for d in local])
    per = len(local)
    if any(len(x) != per for x in named):
        raise ValueError(f"process_mesh: every rank must hold the same "
                         f"number of shards, got {[len(x) for x in named]}")
    devices = tuple(torch.device(d) for x in named for d in x)
    owners = tuple(r for r in range(world) for _ in range(per))
    return Mesh(devices, owners=owners, rank=rank, backend=backend)
