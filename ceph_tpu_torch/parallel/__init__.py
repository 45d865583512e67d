"""PG-axis data parallelism (the port of `ceph_tpu/parallel`)."""
from ceph_tpu_torch.parallel.sharded import (
    Mesh,
    ShardedClusterMapper,
    default_mesh,
    last_mesh_provenance,
    make_mesh,
)

__all__ = ["Mesh", "ShardedClusterMapper", "default_mesh",
           "last_mesh_provenance", "make_mesh"]
