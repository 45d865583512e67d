"""ceph.conf parsing + OSDMap::build_simple_from_conf.

A copy of `ceph_tpu/osd/conf.py`, its imports pointed at the port.

Mirrors the reference flow used by ``osdmaptool --create-from-conf``
(reference src/osd/OSDMap.cc:4172 build_simple_optioned with nosd=-1 and
:4339 build_simple_crush_map_from_conf): every ``[osd.N]`` section becomes
a device inserted at its host/rack/row/room/datacenter location via
``insert_item``, sections processed in lexicographic order (the C++ conf
stores sections in a std::map), so bucket ids and item orders reproduce
the reference byte-for-byte — pinned by the create-racks.t cram golden.
"""

from __future__ import annotations

import re

from ceph_tpu_torch.crush.types import BucketAlg, CrushMap, Tunables
from ceph_tpu_torch.osd.osdmap import DEFAULT_TYPES, OSDMap
from ceph_tpu_torch.osd.types import PgPool, PoolType


def parse_ceph_conf(path: str) -> dict[str, dict[str, str]]:
    """Minimal ini parser for ceph.conf: ``[section]`` headers,
    ``key = value`` lines, ``;``/``#`` comments.  Keys are normalized
    with spaces collapsed to underscores (ceph accepts ' ', '_', '-'
    interchangeably)."""
    sections: dict[str, dict[str, str]] = {}
    cur: dict[str, str] | None = None
    with open(path) as f:
        for line in f:
            line = line.split(";", 1)[0].split("#", 1)[0].strip()
            if not line:
                continue
            mh = re.match(r"\[(.+)\]$", line)
            if mh:
                cur = sections.setdefault(mh.group(1).strip(), {})
                continue
            if "=" in line and cur is not None:
                k, v = line.split("=", 1)
                k = re.sub(r"[\s_-]+", "_", k.strip())
                cur[k] = v.strip()
    return sections


def conf_get(sections: dict, keys: list[str], name: str,
             default: str | None = None) -> str | None:
    """Layered lookup: first match wins across the given section names."""
    name = re.sub(r"[\s_-]+", "_", name)
    for sec in keys:
        if sec in sections and name in sections[sec]:
            return sections[sec][name]
    return default


def build_from_conf(
    conf_path: str,
    pg_bits: int = 6,
    pgp_bits: int = 6,
    default_pool: bool = True,
    tunables: Tunables | None = None,
) -> OSDMap:
    """reference src/osd/OSDMap.cc:4172 (nosd=-1 path) + :4339."""
    sections = parse_ceph_conf(conf_path)

    crush = CrushMap(tunables)
    crush.type_names = dict(DEFAULT_TYPES)
    root = crush.add_bucket(BucketAlg.STRAW2, 11, [], [], name="default")

    osd_sections = sorted(
        s for s in sections
        if re.fullmatch(r"osd\.\d+", s)
    )
    max_id = -1
    for sec in osd_sections:
        o = int(sec[4:])
        max_id = max(max_id, o)
        host = conf_get(sections, [sec], "host") or "unknownhost"
        rack = conf_get(sections, [sec], "rack") or "unknownrack"
        loc = {"host": host, "rack": rack, "root": "default"}
        for extra in ("row", "room", "datacenter"):
            v = conf_get(sections, [sec], extra)
            if v:
                loc[extra] = v
        crush.insert_item(o, 1.0, sec, loc)

    crush.make_replicated_rule(root, failure_domain_type=1)
    crush.rule_names[0] = "replicated_rule"

    m = OSDMap(crush)
    m.epoch = 0  # caller (osdmaptool) bumps via `modified`
    m.set_max_osd(max_id + 1)

    if default_pool:
        size = int(conf_get(
            sections, ["global", "mon", "osd"], "osd_pool_default_size", "3"
        ))
        poolbase = m.max_osd if m.max_osd else 1
        pgp = min(pgp_bits, pg_bits)
        pool = PgPool(
            type=PoolType.REPLICATED, size=size,
            min_size=size - size // 2,
            crush_rule=0,
            pg_num=poolbase << pg_bits, pgp_num=poolbase << pgp,
        )
        m.pool_max = 0
        m.add_pool("rbd", pool, 1)
    m.erasure_code_profiles["default"] = {
        "k": "2", "m": "2", "plugin": "jerasure",
        "technique": "reed_sol_van",
    }
    return m
