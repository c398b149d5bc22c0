"""PX execution of the port over a device mesh (counterpart of
`oceanbase_tpu/parallel`): the mesh (in one process or over several), the
SPMD runner, the exchanges on kernels K25-K28, the PX executor and the
mesh-sharded IVF probe on K31."""

from .ann import ShardedIvf, shard_ivf
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
from .group import RemoteShardError, run_spmd
from .mesh import (
    SHARD_AXIS,
    Mesh,
    cpu_mesh,
    make_mesh,
    mesh_signature,
    process_mesh,
)
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
    "process_mesh",
    "run_spmd",
    "RemoteShardError",
    "ShardedIvf",
    "shard_ivf",
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
