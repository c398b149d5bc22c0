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
    """An ordered list of devices, one per shard, along one named axis."""

    devices: tuple
    axis_names: tuple = (SHARD_AXIS,)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> list:
        """The devices of the mesh in first-shard order, each once."""
        out = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def shards_per_device(self) -> int:
        """The most shards any one device of the mesh holds."""
        return max(sum(1 for x in self.devices if x == d)
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
