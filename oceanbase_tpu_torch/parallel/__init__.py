"""PX execution of the port over a device mesh (counterpart of
`oceanbase_tpu/parallel`): the mesh, the SPMD runner, the exchanges on
kernels K25-K28 and the PX executor."""

from .exchange import (
    bc2host,
    broadcast_rows,
    dest_by_hash,
    dest_by_partition,
    dest_by_range,
    dest_round_robin,
    merge_partials,
    repartition,
    ring_broadcast_rows,
    sample_range_bounds,
)
from .group import run_spmd
from .mesh import SHARD_AXIS, Mesh, cpu_mesh, make_mesh, mesh_signature
from .spmd import (
    MeshExchange,
    MeshPlan,
    ShardedResidency,
    SpmdLowering,
    shard_put,
)

__all__ = [
    "SHARD_AXIS",
    "Mesh",
    "cpu_mesh",
    "make_mesh",
    "mesh_signature",
    "run_spmd",
    "bc2host",
    "broadcast_rows",
    "dest_by_hash",
    "dest_by_partition",
    "dest_by_range",
    "dest_round_robin",
    "merge_partials",
    "repartition",
    "ring_broadcast_rows",
    "sample_range_bounds",
    "MeshExchange",
    "MeshPlan",
    "ShardedResidency",
    "SpmdLowering",
    "shard_put",
]
