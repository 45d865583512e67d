"""Build the port's maps from plain data: how a map's state crosses over.

A map made by the JAX package (or read from its corpus) arrives as a plain
dict of ints, lists and numpy arrays, which JSON also holds:

    crush:   "tunables" {name: int}, "max_devices" int,
             "buckets" [{"id", "alg", "type", "items", "weights", "name"?}],
             "rules" [{"steps" [[op, arg1, arg2]], "ruleset", "type",
                       "min_size", "max_size"} or None],
             "choose_args" [{"key" int|str,
                             "weight_sets" [[bucket_id, [[w, ...], ...]]],
                             "ids" [[bucket_id, [id, ...]]]}]
    OSDMap:  the crush keys, plus "max_osd", "osd_state", "osd_weight",
             "osd_primary_affinity" (or None), "pools" [{"id", "name",
             "type", "size", "min_size", "pg_num", "pgp_num",
             "crush_rule", "flags"}], and the overlays "pg_upmap"
             [[pool, seed, [osd, ...]]], "pg_upmap_items"
             [[pool, seed, [[from, to], ...]]], "pg_temp"
             [[pool, seed, [osd, ...]]], "primary_temp" [[pool, seed, osd]]

Shapes and types are checked; a mismatch raises ValueError.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.crush.types import (
    Bucket,
    BucketAlg,
    ChooseArgs,
    CrushMap,
    Rule,
    Tunables,
)
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import PgId, PgPool, PoolType

_TUNABLES = ("choose_local_tries", "choose_local_fallback_tries",
             "choose_total_tries", "chooseleaf_descend_once",
             "chooseleaf_vary_r", "chooseleaf_stable", "straw_calc_version")


def _int(v, what: str) -> int:
    if isinstance(v, (bool, np.bool_)) or not isinstance(v, (int, np.integer)):
        raise ValueError(f"{what}: int expected, got {type(v).__name__}")
    return int(v)


def _ints(v, what: str, n: int | None = None) -> list[int]:
    a = np.asarray(v)
    if a.ndim != 1 or (a.size and a.dtype.kind not in "iu"):
        raise ValueError(f"{what}: a flat list of ints expected")
    if n is not None and a.size != n:
        raise ValueError(f"{what}: {a.size} entries, expected {n}")
    return [int(i) for i in a]


def crush_from_reference(d: dict) -> CrushMap:
    """The port's CrushMap from the crush keys of `d`."""
    t = d["tunables"]
    m = CrushMap(Tunables(**{k: _int(t[k], f"tunables.{k}")
                             for k in _TUNABLES}))
    for b in d["buckets"]:
        bid = _int(b["id"], "bucket id")
        if bid >= 0 or bid in m.buckets:
            raise ValueError(f"bucket id {bid}: negative and unique expected")
        items = _ints(b["items"], f"bucket {bid} items")
        weights = _ints(b["weights"], f"bucket {bid} weights", len(items))
        bucket = Bucket(bid, BucketAlg(_int(b["alg"], "alg")),
                        _int(b["type"], "type"), items, weights)
        bucket.finalize_derived(m.tunables.straw_calc_version)
        m.buckets[bid] = bucket
        if b.get("name") is not None:
            m.item_names[bid] = str(b["name"])
    m.max_devices = _int(d["max_devices"], "max_devices")
    for r in d["rules"]:
        if r is None:
            m.rules.append(None)
            continue
        steps = [tuple(_ints(s, "rule step", 3)) for s in r["steps"]]
        m.rules.append(Rule(steps, _int(r["ruleset"], "ruleset"),
                            _int(r["type"], "rule type"),
                            _int(r["min_size"], "min_size"),
                            _int(r["max_size"], "max_size")))
    for ca in d.get("choose_args", []):
        args = ChooseArgs()
        for bid, sets in ca["weight_sets"]:
            size = m.buckets[_int(bid, "choose_args bucket")].size
            args.weight_sets[int(bid)] = [
                _ints(ws, f"weight-set of {bid}", size) for ws in sets]
        for bid, ids in ca["ids"]:
            size = m.buckets[_int(bid, "choose_args bucket")].size
            args.ids[int(bid)] = _ints(ids, f"ids of {bid}", size)
        m.choose_args[ca["key"]] = args
    return m


def osdmap_from_reference(d: dict) -> OSDMap:
    """The port's OSDMap from `d` (see the module docstring)."""
    m = OSDMap(crush_from_reference(d))
    n = _int(d["max_osd"], "max_osd")
    m.max_osd = n
    m.osd_state = _ints(d["osd_state"], "osd_state", n)
    m.osd_weight = _ints(d["osd_weight"], "osd_weight", n)
    if d.get("osd_primary_affinity") is not None:
        m.osd_primary_affinity = _ints(d["osd_primary_affinity"],
                                       "osd_primary_affinity", n)
    for p in d["pools"]:
        pool = PgPool(
            type=PoolType(_int(p["type"], "pool type")),
            size=_int(p["size"], "pool size"),
            min_size=_int(p["min_size"], "pool min_size"),
            pg_num=_int(p["pg_num"], "pg_num"),
            pgp_num=_int(p["pgp_num"], "pgp_num"),
            crush_rule=_int(p["crush_rule"], "crush_rule"),
            flags=_int(p["flags"], "pool flags"),
        )
        m.add_pool(str(p["name"]), pool, _int(p["id"], "pool id"))
    for pool, seed, osds in d.get("pg_upmap", []):
        m.pg_upmap[PgId(int(pool), int(seed))] = _ints(osds, "pg_upmap")
    for pool, seed, pairs in d.get("pg_upmap_items", []):
        m.pg_upmap_items[PgId(int(pool), int(seed))] = [
            tuple(_ints(p, "pg_upmap_items pair", 2)) for p in pairs]
    for pool, seed, osds in d.get("pg_temp", []):
        m.pg_temp[PgId(int(pool), int(seed))] = _ints(osds, "pg_temp")
    for pool, seed, osd in d.get("primary_temp", []):
        m.primary_temp[PgId(int(pool), int(seed))] = _int(osd,
                                                          "primary_temp")
    return m
