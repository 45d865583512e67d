"""The canonical witness map of the serving buffer and its placement
digest.

The port of `build_default` and `placement_digest` of
`ceph_tpu/serve/meshcheck.py`.  The JAX module is also a worker that
serves the map on 1, 2 or 8 forced devices and compares digests (the
sharding bit-identity check); that leg waits for the port's multi-device
layer.  Here the digest is the single-device witness: the same map
served by the JAX service and by the port gives the same digest.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ceph_tpu_torch.osd.osdmap import OSDMap, build_hierarchical
from ceph_tpu_torch.osd.types import PgPool, PoolType

# the canonical witness cluster: small enough to stage in seconds, two
# pools so the digest walks a pool boundary
DEFAULT_PGS = 256
DEFAULT_OSDS = 16


def build_default(pgs: int = DEFAULT_PGS,
                  osds: int = DEFAULT_OSDS) -> OSDMap:
    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                  pg_num=pgs, pgp_num=pgs)
    m = build_hierarchical(osds // 4, 4, n_rack=1, pool=pool)
    p2 = PgPool(type=PoolType.REPLICATED, size=2, crush_rule=0,
                pg_num=pgs // 2, pgp_num=pgs // 2)
    m.add_pool("meshcheck2", p2)
    return m


def placement_digest(svc, m: OSDMap) -> tuple[str, bool]:
    """(sha256 digest, oracle_match) over every PG of every pool,
    answered through the bulk edge.  The digest covers all four row
    tensors; the oracle check replays each pool through the host
    mapper at the same padded width."""
    h = hashlib.sha256()
    oracle_ok = True
    for pid in sorted(m.pools):
        seeds = np.arange(m.pools[pid].pg_num, dtype=np.uint32)
        r = svc.query_block(pid, seeds, deadline_s=0)
        if not r.ok:
            h.update(f"{pid}:notok".encode())
            oracle_ok = False
            continue
        for a in (r.up, r.up_primary, r.acting, r.acting_primary):
            h.update(np.ascontiguousarray(a).tobytes())
        up, upp, act, actp = svc._active.host_rows(pid, seeds)
        oracle_ok = oracle_ok and bool(
            (r.up == up).all() and (r.up_primary == upp).all()
            and (r.acting == act).all()
            and (r.acting_primary == actp).all())
    return h.hexdigest(), oracle_ok
