"""The system under test, built from a configuration's file.

The port (`ceph_tpu_torch`) is the only code of the repository the
benchmark runs: the placement map with its one pool, the device-resident
`ClusterState`, and the erasure code of a profile.  Each is built on the
device the benchmark asks for: `cuda` on the card (no backend probe),
`cpu` in the CPU tests.
"""

from __future__ import annotations


def placement_map(cfg: dict):
    """The OSDMap of a configuration: its hierarchy (straw2, optimal
    tunables, every OSD up and in at weight 1.0) and its one pool, id 0:
    replicated under the map's `chooseleaf firstn 0 type host` rule, or
    erasure-coded under `chooseleaf indep 0 type host`."""
    from ceph_tpu_torch.osd.osdmap import build_hierarchical
    from ceph_tpu_torch.osd.types import PgPool, PoolType

    p = cfg["pool"]
    if p["type"] == "replicated":
        pool = PgPool(type=PoolType.REPLICATED, size=p["size"],
                      crush_rule=0, pg_num=p["pg_num"], pgp_num=p["pg_num"])
        return build_hierarchical(cfg["hosts"], cfg["osds_per_host"],
                                  n_rack=cfg["racks"], pool=pool)
    if p["type"] != "erasure":
        raise ValueError(f"pool type {p['type']!r}")
    m = build_hierarchical(cfg["hosts"], cfg["osds_per_host"],
                           n_rack=cfg["racks"])
    root = next(b for b, bk in m.crush.buckets.items() if bk.type == 11)
    rule = m.crush.make_erasure_rule(root, 1)
    prof = cfg["ec_profile"]
    m.erasure_code_profiles["bench"] = dict(prof)
    m.add_pool("bench", PgPool(
        type=PoolType.ERASURE, size=p["size"], min_size=int(prof["k"]) + 1,
        crush_rule=rule, pg_num=p["pg_num"], pgp_num=p["pg_num"],
        erasure_code_profile="bench"))
    return m


def cluster_state(cfg: dict, device):
    from ceph_tpu_torch.osd.state import ClusterState

    return ClusterState(placement_map(cfg), device=str(device))


def incremental(epoch: int, delta: dict):
    """The OSDMap::Incremental of a plain delta ({"down": [osd], "up":
    [osd], "weight": {osd: 16.16}}): an up/down flip is the XOR of the
    UP bit."""
    from ceph_tpu_torch.osd.incremental import Incremental
    from ceph_tpu_torch.osd.osdmap import OSD_UP

    inc = Incremental(epoch=epoch)
    for o in list(delta.get("down", ())) + list(delta.get("up", ())):
        inc.new_state[int(o)] = OSD_UP
    inc.new_weight.update({int(o): int(w)
                           for o, w in delta.get("weight", {}).items()})
    return inc


def erasure_code(cfg: dict, device):
    from ceph_tpu_torch.ec.registry import create_erasure_code

    return create_erasure_code(dict(cfg["ec_profile"]), device=str(device))
