"""Mesh bit-identity witness for the serving buffer.

The port of `ceph_tpu/serve/meshcheck.py`.  The serving buffer's
ClusterState splits its launches over the `CEPH_TPU_MESH_DEVICES` mesh
(`parallel.sharded`).  The contract is that splitting is a throughput
decision with no semantic surface: answers are the same on 1, 2 or 8
devices, and the same as the host-mapper oracle's.

`python -m ceph_tpu_torch.serve.meshcheck` is the worker: it builds the
canonical deterministic map, serves every PG of every pool through
`query_block`, checks each answer against the host oracle in-process
and prints one JSON line:

    {"digest": ..., "oracle_match": true, "devices": N, "mesh": {...}}

`--device cpu` runs on the host (the card is the default); `--split N`
serves through a mesh of the one device repeated N times, the port's
stand-in for XLA's forced host devices.  The JAX worker's digest of the
default map is stored in tests/data/meshcheck.json: equal digests across
packages and splits are the bit-identity proof.
"""

from __future__ import annotations

import hashlib
import json

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


def run(pgs: int = DEFAULT_PGS, osds: int = DEFAULT_OSDS, device=None,
        split: int = 0) -> dict:
    """Serve the witness map through `query_block` and return the
    digest, the oracle verdict, the backend's device count and the
    service's mesh status.  split > 1 serves through a mesh of the one
    device repeated `split` times."""
    import torch

    from ceph_tpu_torch.device import resolve_device
    from ceph_tpu_torch.parallel.sharded import Mesh
    from ceph_tpu_torch.serve.service import PlacementService, ServeConfig

    dev = resolve_device(device)
    mesh = Mesh([dev] * split) if split > 1 else None
    m = build_default(pgs, osds)
    cfg = ServeConfig(block=128, bulk_max=pgs, max_queue=256,
                      deadline_s=0)
    svc = PlacementService(m, config=cfg, name="meshcheck", device=dev,
                           mesh=mesh)
    try:
        digest, oracle_match = placement_digest(svc, m)
        st = svc.status()
        return {
            "digest": digest,
            "oracle_match": oracle_match,
            "devices": (torch.cuda.device_count() if dev.type == "cuda"
                        else 1),
            "mesh": st["mesh"],
        }
    finally:
        svc.close()


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="serve mesh bit-identity worker")
    ap.add_argument("--pgs", type=int, default=DEFAULT_PGS)
    ap.add_argument("--osds", type=int, default=DEFAULT_OSDS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--split", type=int, default=0,
                    help="serve through a mesh of the device repeated N "
                         "times")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.pgs, args.osds, args.device, args.split)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
