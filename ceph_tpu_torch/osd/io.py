"""OSDMap / CrushMap native serialization (JSON).

A copy of `ceph_tpu/osd/io.py`, its imports pointed at the port.

The checkpoint/resume surface of the framework: everything durable in the
reference is a versioned binary encoding (OSDMap::encode/decode, reference
src/osd/OSDMap.cc:2914,3249; CrushWrapper::encode :2941) persisted by the
mon and read by the CLIs.  This module is our own format — explicit JSON of
the same state — used by the CLIs; the wire-compatible binary codec (for
reading real cluster artifacts) lives in ceph_tpu_torch.osd.codec.
"""

from __future__ import annotations

import json

from ceph_tpu_torch.crush.compiler import compile_text, decompile
from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import PgId, PgPool, PoolType

FORMAT_VERSION = 1


def osdmap_to_dict(m: OSDMap) -> dict:
    return {
        "format_version": FORMAT_VERSION,
        "epoch": m.epoch,
        "max_osd": m.max_osd,
        "osd_state": list(m.osd_state),
        "osd_weight": list(m.osd_weight),
        "osd_primary_affinity": (
            list(m.osd_primary_affinity)
            if m.osd_primary_affinity is not None
            else None
        ),
        "pools": {
            str(pid): {
                "name": m.pool_name.get(pid, f"pool{pid}"),
                "type": int(p.type),
                "size": p.size,
                "min_size": p.min_size,
                "pg_num": p.pg_num,
                "pgp_num": p.pgp_num,
                "crush_rule": p.crush_rule,
                "flags": p.flags,
                "erasure_code_profile": p.erasure_code_profile,
            }
            for pid, p in m.pools.items()
        },
        "erasure_code_profiles": m.erasure_code_profiles,
        "pg_temp": {str(pg): v for pg, v in m.pg_temp.items()},
        "primary_temp": {str(pg): v for pg, v in m.primary_temp.items()},
        "pg_upmap": {str(pg): v for pg, v in m.pg_upmap.items()},
        "pg_upmap_items": {
            str(pg): [list(pair) for pair in v]
            for pg, v in m.pg_upmap_items.items()
        },
        "crush": decompile(m.crush),
    }


def osdmap_from_dict(d: dict) -> OSDMap:
    crush = compile_text(d["crush"])
    m = OSDMap(crush)
    m.epoch = d.get("epoch", 1)
    m.set_max_osd(d["max_osd"])
    m.osd_state = list(d["osd_state"])
    m.osd_weight = list(d["osd_weight"])
    pa = d.get("osd_primary_affinity")
    m.osd_primary_affinity = list(pa) if pa is not None else None
    for pid_s, pd in d.get("pools", {}).items():
        pool = PgPool(
            type=PoolType(pd["type"]),
            size=pd["size"],
            min_size=pd.get("min_size", 2),
            pg_num=pd["pg_num"],
            pgp_num=pd.get("pgp_num", pd["pg_num"]),
            crush_rule=pd.get("crush_rule", 0),
            flags=pd.get("flags", 1),
            erasure_code_profile=pd.get("erasure_code_profile", ""),
        )
        m.add_pool(pd.get("name", f"pool{pid_s}"), pool, int(pid_s))
    m.erasure_code_profiles = {
        k: dict(v) for k, v in d.get("erasure_code_profiles", {}).items()
    }
    m.pg_temp = {
        PgId.parse(k): list(v) for k, v in d.get("pg_temp", {}).items()
    }
    m.primary_temp = {
        PgId.parse(k): v for k, v in d.get("primary_temp", {}).items()
    }
    m.pg_upmap = {
        PgId.parse(k): list(v) for k, v in d.get("pg_upmap", {}).items()
    }
    m.pg_upmap_items = {
        PgId.parse(k): [tuple(p) for p in v]
        for k, v in d.get("pg_upmap_items", {}).items()
    }
    return m


def save_osdmap(m: OSDMap, path: str, fmt: str = "bin") -> None:
    """fmt="bin" writes the reference wire format (what the real
    osdmaptool produces/consumes); fmt="json" writes the native JSON."""
    if fmt == "bin":
        from ceph_tpu_torch.osd.codec import encode_osdmap

        with open(path, "wb") as f:
            f.write(encode_osdmap(m))
        return
    with open(path, "w") as f:
        json.dump(osdmap_to_dict(m), f, indent=1)


def load_osdmap(path: str) -> OSDMap:
    """Auto-detects the reference binary wire format vs native JSON."""
    from ceph_tpu_torch.osd.codec import decode_osdmap, looks_like_osdmap

    with open(path, "rb") as f:
        data = f.read()
    if looks_like_osdmap(data):
        return decode_osdmap(data)
    return osdmap_from_dict(json.loads(data.decode()))


def save_crush_text(m: CrushMap, path: str) -> None:
    with open(path, "w") as f:
        f.write(decompile(m))


def load_crush_text(path: str) -> CrushMap:
    """Text or binary (wire format), auto-detected."""
    from ceph_tpu_torch.crush.codec import decode_crushmap, looks_like_crushmap

    with open(path, "rb") as f:
        data = f.read()
    if looks_like_crushmap(data):
        return decode_crushmap(data)
    return compile_text(data.decode())
