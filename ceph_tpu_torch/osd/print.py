"""Reference-parity text output for OSDMap: print / tree dumpers.

A copy of `ceph_tpu/osd/print.py`, its imports pointed at the port.

Mirrors the reference's exact formats so the osdmaptool cram transcripts
(reference src/test/cli/osdmaptool/*.t) replay verbatim:

- :func:`print_osdmap` — OSDMap::print (reference src/osd/OSDMap.cc:3855)
  incl. pg_pool_t's operator<< line format (src/osd/osd_types.cc:2339)
  and utime/uuid rendering.
- :func:`print_tree_plain` — OSDTreePlainDumper over a TextTable
  (src/osd/OSDMap.cc:3937-4002, src/common/TextTable.cc): ID/CLASS/
  WEIGHT/TYPE NAME/STATUS/REWEIGHT/PRI-AFF columns, children visited in
  (class, name) sort order (src/crush/CrushTreeDumper.h:130-152).
- :func:`tree_json` — OSDTreeFormattingDumper's node list (same
  traversal; children arrays in reverse-sorted order, `pool_weights`
  on non-root items, stray osd section).
"""

from __future__ import annotations

import time as _time

from ceph_tpu_torch.osd.osdmap import (
    DEFAULT_PRIMARY_AFFINITY,
    OSDMap,
)

# ---------------------------------------------------------------- helpers


def fmt_float(v: float) -> str:
    """C++ ostream default float formatting (operator<< double): up to 6
    significant digits, no trailing zeros."""
    s = f"{v:.6g}"
    return s


def weightf5(v: float) -> str:
    """weightf_t: fixed 5 decimals (reference src/include/types.h
    operator<<(weightf_t): %.5f with < 0.01/0.0001 special cases)."""
    if v < 0.0001:
        return "0"
    if v < 0.01:
        return f"{v:.6f}"
    return f"{v:.5f}"


def fmt_uuid(b: bytes) -> str:
    h = b.hex()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def fmt_utime(t: tuple[int, int]) -> str:
    """utime_t operator<< (reference src/include/utime.h): localtime ISO
    with numeric offset; we render in UTC."""
    sec, nsec = t
    base = _time.strftime("%Y-%m-%dT%H:%M:%S", _time.gmtime(sec))
    return f"{base}.{nsec // 1000:06d}+0000"


_RELEASE_NAMES = [
    "unknown", "argonaut", "bobtail", "cuttlefish", "dumpling", "emperor",
    "firefly", "giant", "hammer", "infernalis", "jewel", "kraken",
    "luminous", "mimic", "nautilus", "octopus", "pacific", "quincy",
]

# OSDMap flag bits -> names (reference src/include/ceph_osdmap.h +
# OSDMap::get_flag_string)
_FLAG_NAMES = [
    (1 << 0, "nearfull"), (1 << 1, "full"), (1 << 2, "pauserd"),
    (1 << 3, "pausewr"), (1 << 4, "pauserec"), (1 << 11, "noup"),
    (1 << 12, "nodown"), (1 << 13, "noout"), (1 << 14, "noin"),
    (1 << 15, "nobackfill"), (1 << 16, "norebalance"),
    (1 << 17, "norecover"), (1 << 18, "noscrub"), (1 << 19, "nodeep-scrub"),
    (1 << 20, "notieragent"), (1 << 21, "sortbitwise"),
    (1 << 22, "require_jewel_osds"), (1 << 23, "require_kraken_osds"),
    (1 << 24, "recovery_deletes"), (1 << 25, "purged_snapdirs"),
    (1 << 26, "pglog_hardlimit"),
]


def flag_string(flags: int) -> str:
    return ",".join(n for bit, n in _FLAG_NAMES if flags & bit)


def min_compat_client(m: OSDMap) -> str:
    """OSDMap::get_min_compat_client (reference src/osd/OSDMap.cc:3712):
    keyed off the features the map actually uses."""
    from ceph_tpu_torch.crush.types import BucketAlg

    if m.pg_upmap or m.pg_upmap_items or m.crush.choose_args:
        return "luminous"
    t = m.crush.tunables
    if t.chooseleaf_stable:
        return "jewel"
    if any(b.alg == BucketAlg.STRAW2 for b in m.crush.buckets.values()):
        return "hammer"
    if t.chooseleaf_vary_r or (m.osd_primary_affinity is not None):
        return "firefly"
    if t.choose_local_tries == 0:
        return "dumpling"
    return "argonaut"


def _pool_flag_string(flags: int) -> str:
    names = [
        (1 << 0, "hashpspool"), (1 << 1, "full"),
        (1 << 2, "ec_overwrites"), (1 << 3, "incomplete_clones"),
        (1 << 4, "nodelete"), (1 << 5, "nopgchange"),
        (1 << 6, "nosizechange"), (1 << 7, "write_fadvise_dontneed"),
        (1 << 8, "noscrub"), (1 << 9, "nodeep-scrub"),
        (1 << 10, "full_quota"), (1 << 11, "nearfull"),
        (1 << 12, "backfillfull"), (1 << 13, "selfmanaged_snaps"),
        (1 << 14, "pool_snaps"), (1 << 15, "creating"),
    ]
    return ",".join(n for bit, n in names if flags & bit)


def pool_line(m: OSDMap, pid: int) -> str:
    """pg_pool_t operator<< (reference src/osd/osd_types.cc:2339)."""
    from ceph_tpu_torch.osd.types import PoolType

    p = m.pools[pid]
    name = m.pool_name.get(pid, "<unknown>")
    tname = "replicated" if p.type == PoolType.REPLICATED else "erasure"
    out = [f"pool {pid} '{name}' {tname}"]
    if tname == "erasure":
        out.append(f" profile {p.erasure_code_profile}")
    out.append(
        f" size {p.size} min_size {p.min_size} crush_rule {p.crush_rule}"
        f" object_hash rjenkins pg_num {p.pg_num} pgp_num {p.pgp_num}"
    )
    mode = getattr(p, "pg_autoscale_mode", "on") or "on"
    out.append(f" autoscale_mode {mode}")
    out.append(f" last_change {getattr(p, 'last_change', 0)}")
    if p.flags:
        out.append(f" flags {_pool_flag_string(p.flags)}")
    out.append(f" stripe_width {getattr(p, 'stripe_width', 0)}")
    app = getattr(p, "application", None)
    if app is None and tname == "replicated" and name == "rbd":
        app = "rbd"
    if app:
        out.append(f" application {app}")
    return "".join(out)


def print_osdmap(m: OSDMap, out) -> None:
    """OSDMap::print (reference src/osd/OSDMap.cc:3855-3911)."""
    wire = getattr(m, "wire", None) or {}
    w = out.write
    w(f"epoch {m.epoch}\n")
    w(f"fsid {fmt_uuid(wire.get('fsid', bytes(16)))}\n")
    w(f"created {fmt_utime(wire.get('created', (0, 0)))}\n")
    w(f"modified {fmt_utime(wire.get('modified', (0, 0)))}\n")
    w(f"flags {flag_string(wire.get('flags', 0))}\n")
    w(f"crush_version {wire.get('crush_version', 1)}\n")
    w("full_ratio 0\n")
    w("backfillfull_ratio 0\n")
    w("nearfull_ratio 0\n")
    w(f"min_compat_client {min_compat_client(m)}\n")
    w("stretch_mode_enabled false\n")
    w("\n")
    for pid in sorted(m.pools):
        w(pool_line(m, pid) + "\n")
    w("\n")
    w(f"max_osd {m.max_osd}\n")
    for i in range(m.max_osd):
        if not m.exists(i):
            continue
        up = " up  " if m.is_up(i) else " down"
        inout = " in " if m.is_in(i) else " out"
        line = f"osd.{i}{up}{inout} weight {fmt_float(m.get_weightf(i))}"
        if (m.osd_primary_affinity is not None
                and m.osd_primary_affinity[i] != DEFAULT_PRIMARY_AFFINITY):
            aff = m.osd_primary_affinity[i] / DEFAULT_PRIMARY_AFFINITY
            line += f" primary_affinity {fmt_float(aff)}"
        w(line + "\n")
    w("\n")
    for pg in sorted(m.pg_upmap, key=lambda p: (p.pool, p.seed)):
        v = ",".join(str(o) for o in m.pg_upmap[pg])
        w(f"pg_upmap {pg} [{v}]\n")
    for pg in sorted(m.pg_upmap_items, key=lambda p: (p.pool, p.seed)):
        v = ",".join(str(x) for pr in m.pg_upmap_items[pg] for x in pr)
        w(f"pg_upmap_items {pg} [{v}]\n")
    for pg in sorted(m.pg_temp, key=lambda p: (p.pool, p.seed)):
        v = ",".join(str(o) for o in m.pg_temp[pg])
        w(f"pg_temp {pg} [{v}]\n")
    for pg in sorted(m.primary_temp, key=lambda p: (p.pool, p.seed)):
        w(f"primary_temp {pg} {m.primary_temp[pg]}\n")


# ------------------------------------------------------------------ tree


def _sort_key(m: OSDMap, item: int) -> str:
    """CrushTreeDumper child sort key (reference CrushTreeDumper.h:138-148):
    (device class, name) with osds zero-padded."""
    if item >= 0:
        c = m.crush.item_classes.get(item, "")
        return f"{c}_osd.{item:08d}"
    return "_" + m.crush.item_names.get(item, str(item))


def _tree_items(m: OSDMap):
    """Yield (id, parent, depth, weightf) in OSDTreePlainDumper order;
    each bucket's children visited in ascending sort-key order."""
    shadows = {
        sid for per in m.crush.class_bucket.values() for sid in per.values()
    }
    referenced = {
        it for bid, b in m.crush.buckets.items() if bid not in shadows
        for it in b.items
    }
    roots = sorted(
        (bid for bid in m.crush.buckets
         if bid not in shadows and bid not in referenced),
    )
    touched = set()

    def walk(item: int, parent: int, depth: int, weightf: float):
        touched.add(item)
        yield item, parent, depth, weightf
        b = m.crush.buckets.get(item)
        if item < 0 and b is not None:
            order = sorted(
                range(len(b.items)), key=lambda k: _sort_key(m, b.items[k])
            )
            for k in order:
                yield from walk(
                    b.items[k], item, depth + 1, b.weights[k] / 0x10000
                )

    for r in roots:
        b = m.crush.buckets[r]
        yield from walk(r, 0, 0, sum(b.weights) / 0x10000)
    # stray osds (exist in the osdmap but not the crush tree)
    for i in range(m.max_osd):
        if m.exists(i) and i not in touched:
            yield i, 0, 0, 0.0


def print_tree_plain(m: OSDMap, out) -> None:
    """osdmaptool --tree=plain (reference src/osd/OSDMap.cc:3937-4002 +
    TextTable rendering src/common/TextTable.cc)."""
    cols = ["ID", "CLASS", "WEIGHT", "TYPE NAME", "STATUS", "REWEIGHT",
            "PRI-AFF"]
    right = [True, True, True, False, True, True, True]
    rows: list[list[str]] = []
    for item, parent, depth, weightf in _tree_items(m):
        cls = m.crush.item_classes.get(item, "") if item >= 0 else ""
        indent = "    " * depth
        if item < 0:
            tname = m.crush.type_names.get(
                m.crush.buckets[item].type, "type?"
            )
            name = f"{indent}{tname} {m.crush.item_names.get(item, '?')}"
            rows.append([str(item), cls, weightf5(weightf), name])
        else:
            name = f"{indent}osd.{item}"
            if not m.exists(item):
                rows.append([str(item), cls, weightf5(weightf), name,
                             "DNE", "0"])
            else:
                st = "up" if m.is_up(item) else "down"
                aff = (
                    m.osd_primary_affinity[item] / DEFAULT_PRIMARY_AFFINITY
                    if m.osd_primary_affinity is not None else 1.0
                )
                rows.append([
                    str(item), cls, weightf5(weightf), name, st,
                    weightf5(m.get_weightf(item)), weightf5(aff),
                ])
    widths = [
        max(len(cols[j]), max((len(r[j]) for r in rows if j < len(r)),
                              default=0))
        for j in range(len(cols))
    ]

    def render(cells: list[str], align_header=False):
        parts = []
        for j in range(len(cols)):
            s = cells[j] if j < len(cells) else ""
            if align_header:
                parts.append(s.ljust(widths[j]))
            else:
                parts.append(
                    s.rjust(widths[j]) if right[j] else s.ljust(widths[j])
                )
        return "  ".join(parts)

    out.write(render(cols, align_header=True).rstrip() + "\n")
    for r in rows:
        out.write(render(r) + "\n")


def tree_json(m: OSDMap) -> dict:
    """osdmaptool --tree=json-pretty node list (reference
    OSDTreeFormattingDumper, src/osd/OSDMap.cc:4009-4076)."""
    nodes = []
    stray = []
    for item, parent, depth, weightf in _tree_items(m):
        n: dict = {"id": item}
        cls = m.crush.item_classes.get(item) if item >= 0 else None
        if cls:
            n["device_class"] = cls
        if item < 0:
            btype = m.crush.buckets[item].type
            n["name"] = m.crush.item_names.get(item, "?")
            n["type"] = m.crush.type_names.get(btype, "type?")
            n["type_id"] = btype
        else:
            n["name"] = f"osd.{item}"
            n["type"] = "osd"
            n["type_id"] = 0
            n["crush_weight"] = _js_float(weightf)
            n["depth"] = depth
        if parent < 0:
            n["pool_weights"] = {}
        if item < 0:
            b = m.crush.buckets[item]
            order = sorted(
                range(len(b.items)), key=lambda k: _sort_key(m, b.items[k])
            )
            n["children"] = [b.items[k] for k in reversed(order)]
        else:
            st = "up" if m.is_up(item) else "down"
            aff = (
                m.osd_primary_affinity[item] / DEFAULT_PRIMARY_AFFINITY
                if m.osd_primary_affinity is not None else 1.0
            )
            n["exists"] = 1 if m.exists(item) else 0
            n["status"] = st
            n["reweight"] = _js_float(m.get_weightf(item))
            n["primary_affinity"] = _js_float(aff)
        # osds outside the crush tree go to the stray section
        (stray if item >= 0 and parent == 0 else nodes).append(n)
    return {"nodes": nodes, "stray": stray}


def _js_float(v: float):
    """ceph JSONFormatter::dump_float: integral floats print as ints."""
    return int(v) if float(v) == int(v) else round(v, 6)
