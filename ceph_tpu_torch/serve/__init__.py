"""Placement serving daemon: the heavy-traffic scenario.

The port of `ceph_tpu/serve/`: the persistent service that answers
`pg_to_up_acting_osds` and object->PG->OSD queries at high QPS through
the rule kernel on the card, and stays correct and available through
epoch swaps, overload, device loss and crash-restart.

    from ceph_tpu_torch.serve import PlacementService, ServeConfig

    svc = PlacementService(osdmap)         # the card; device="cpu": host
    r = svc.lookup(pool_id, seed)          # r.acting, r.acting_primary
    b = svc.query_block(pool_id, seeds)    # the bulk edge, per-lane status
    svc.apply(incremental)                 # epoch swap, readers undisturbed
    svc.close()

- `service.py`: the micro-batcher, the bulk edge, admission control and
  deadlines, double-buffered epoch swaps over `ClusterState` (value-only
  epochs fork it in O(delta); structural ones stage a fresh one on a
  CUDA stream of their own), a device loss answered EFAULT and
  recorded, crash-restart through `runtime.Checkpoint`;
- `front.py`: N replicas behind a rendezvous-hash router with staggered
  epoch fan-out and slowest-replica shedding;
- `slo.py`: the SLO burn-rate engine over `obs.health`;
- `chaos.py`: the lifetime engine's epoch churn against a live service
  under seeded client load (`python -m ceph_tpu_torch.cli.serve chaos`);
- `meshcheck.py`: the witness map and its placement digest.
"""

from __future__ import annotations

from ceph_tpu_torch.serve.front import ServeFront
from ceph_tpu_torch.serve.service import (
    REPLY_STATUSES,
    STATUS_CODES,
    BulkReply,
    PlacementService,
    Reply,
    ServeConfig,
    status_dump,
)

__all__ = [
    "BulkReply",
    "PlacementService",
    "Reply",
    "REPLY_STATUSES",
    "STATUS_CODES",
    "ServeConfig",
    "ServeFront",
    "status_dump",
]
