"""OSDMap::Incremental: epoch deltas, wire-compatible with the reference.

The port's copy of `ceph_tpu/osd/incremental.py` (reference model:
src/osd/OSDMap.h:376-496, the field list; src/osd/OSDMap.cc:2061
``apply_incremental``; codec src/osd/OSDMap.cc:557-733
``Incremental::encode``/``decode``), over the port's codecs:

- :class:`Incremental`: the delta model, restricted to the fields the
  placement stack models (pools, weights, state, overlays, crush, EC
  profiles).  Fields outside that scope (addresses, xinfo, blocklist,
  snaps) are kept as raw wire spans on decode and replayed on encode, the
  same fidelity model as ``osd.codec``.
- ``encode_incremental`` / ``decode_incremental``: the binary format,
  ENCODE_START(8,7) meta wrapper, client-usable section (v4..v8),
  osd-only section, trailing CRC-32C over the buffer with the crc hole
  excluded (reference src/osd/OSDMap.cc:714-731).
- :func:`apply_incremental`: the state transition, in the reference's
  order: flags, max_osd, pools, weights/affinity, EC profiles, state XOR
  (with the destroy special case), pg_temp/primary_temp, upmaps, and the
  new crush blob last (src/osd/OSDMap.cc:2061-2341).

tests/test_torch_incremental.py holds it byte for byte to the JAX
package's module.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ceph_tpu_torch.crush.codec import decode_crushmap
from ceph_tpu_torch.osd.codec import (
    CodecError,
    R,
    W,
    _decode_pool,
    _encode_pool,
    _skip_addrvec,
    decode_osdmap,
)
from ceph_tpu_torch.osd.osdmap import (
    DEFAULT_PRIMARY_AFFINITY,
    OSD_AUTOOUT,
    OSD_EXISTS,
    OSD_NEW,
    OSD_UP,
    OSDMap,
)
from ceph_tpu_torch.osd.types import PgId, PgPool
from ceph_tpu_torch.utils.crc32c import crc32c


@dataclass
class Incremental:
    """Delta from ``epoch - 1`` to ``epoch`` (reference
    src/osd/OSDMap.h:354-496).  Sentinel conventions match the C++:
    ``new_flags``/``new_max_osd`` < 0 and ``new_pool_max`` == -1 mean
    "unchanged"; an empty ``new_pg_temp`` vector removes the entry; a
    ``new_primary_temp`` value of -1 removes the entry."""

    epoch: int = 0
    fsid: bytes = b"\0" * 16
    modified: tuple[int, int] = (0, 0)
    new_pool_max: int = -1
    new_flags: int = -1
    fullmap: bytes = b""          # in lieu of everything below (rare)
    crush: bytes = b""            # new crushmap blob, applied last
    new_max_osd: int = -1
    new_pools: dict[int, PgPool] = field(default_factory=dict)
    new_pool_wire: dict[int, dict] = field(default_factory=dict)
    new_pool_names: dict[int, str] = field(default_factory=dict)
    old_pools: set[int] = field(default_factory=set)
    new_up_client: dict[int, bytes] = field(default_factory=dict)  # raw addrvec
    new_state: dict[int, int] = field(default_factory=dict)   # XOR onto prev
    new_weight: dict[int, int] = field(default_factory=dict)
    new_pg_temp: dict[PgId, list[int]] = field(default_factory=dict)
    new_primary_temp: dict[PgId, int] = field(default_factory=dict)
    new_primary_affinity: dict[int, int] = field(default_factory=dict)
    new_erasure_code_profiles: dict[str, dict[str, str]] = field(
        default_factory=dict
    )
    old_erasure_code_profiles: list[str] = field(default_factory=list)
    new_pg_upmap: dict[PgId, list[int]] = field(default_factory=dict)
    old_pg_upmap: set[PgId] = field(default_factory=set)
    new_pg_upmap_items: dict[PgId, list[tuple[int, int]]] = field(
        default_factory=dict
    )
    old_pg_upmap_items: set[PgId] = field(default_factory=set)
    full_crc: int = 0
    wire: dict = field(default_factory=dict)  # raw spans for replay

    def get_new_pool(self, pool_id: int, orig: PgPool) -> PgPool:
        """Copy-on-write pool mutation handle (reference
        src/osd/OSDMap.h:451-455)."""
        if pool_id not in self.new_pools:
            self.new_pools[pool_id] = PgPool(**vars(orig))
        return self.new_pools[pool_id]


# ---------------------------------------------------------------- codec


def _pg_sorted(d):
    return sorted(d, key=lambda p: (p.pool, p.seed))


def decode_incremental(data: bytes) -> Incremental:
    """reference src/osd/OSDMap.cc:837 (Incremental::decode)."""
    r = R(data)
    meta_v, meta_compat, meta_end = r.start()
    if meta_v < 7:
        raise CodecError(f"incremental meta v{meta_v} (classic) unsupported")
    inc = Incremental()
    inc.wire = {"meta_v": meta_v, "meta_compat": meta_compat}

    v, compat, end = r.start()  # client-usable section
    inc.wire["client_v"], inc.wire["client_compat"] = v, compat
    if v < 4:
        raise CodecError(f"incremental client data v{v} unsupported")
    inc.fsid = r.take(16)
    inc.epoch = r.u32()
    inc.modified = r.utime()
    inc.new_pool_max = r.i64()
    inc.new_flags = r.i32()
    inc.fullmap = r.take(r.u32())
    inc.crush = r.take(r.u32())
    inc.new_max_osd = r.i32()
    for _ in range(r.u32()):
        pid = r.i64()
        pool, pw = _decode_pool(r)
        inc.new_pools[pid] = pool
        inc.new_pool_wire[pid] = pw
    for _ in range(r.u32()):
        pid = r.i64()
        inc.new_pool_names[pid] = r.string()
    for _ in range(r.u32()):
        inc.old_pools.add(r.i64())
    if v >= 7:
        for _ in range(r.u32()):
            osd = r.i32()
            p0 = r.off
            _skip_addrvec(r)
            inc.new_up_client[osd] = r.d[p0:r.off]
    else:
        raise CodecError("incremental client data v<7 addr maps unsupported")
    for _ in range(r.u32()):
        osd = r.i32()
        inc.new_state[osd] = r.u32() if v >= 5 else r.u8()
    for _ in range(r.u32()):
        osd = r.i32()
        inc.new_weight[osd] = r.u32()
    for _ in range(r.u32()):
        pg = r.pg()
        inc.new_pg_temp[pg] = [r.i32() for _ in range(r.u32())]
    for _ in range(r.u32()):
        pg = r.pg()
        inc.new_primary_temp[pg] = r.i32()
    for _ in range(r.u32()):
        osd = r.i32()
        inc.new_primary_affinity[osd] = r.u32()
    for _ in range(r.u32()):
        name = r.string()
        prof = inc.new_erasure_code_profiles[name] = {}
        for _ in range(r.u32()):
            k = r.string()
            prof[k] = r.string()
    for _ in range(r.u32()):
        inc.old_erasure_code_profiles.append(r.string())
    if v >= 4:
        for _ in range(r.u32()):
            pg = r.pg()
            inc.new_pg_upmap[pg] = [r.i32() for _ in range(r.u32())]
        for _ in range(r.u32()):
            inc.old_pg_upmap.add(r.pg())
        for _ in range(r.u32()):
            pg = r.pg()
            inc.new_pg_upmap_items[pg] = [
                (r.i32(), r.i32()) for _ in range(r.u32())
            ]
        for _ in range(r.u32()):
            inc.old_pg_upmap_items.add(r.pg())
    if v >= 6:
        p0 = r.off
        for _ in range(2):  # new_removed_snaps, new_purged_snaps
            for _ in range(r.u32()):
                r.i64()
                r.take(16 * r.u32())
        inc.wire["snaps_raw"] = r.d[p0:r.off]
    if v >= 8:
        inc.wire["last_up_change"] = r.utime()
        inc.wire["last_in_change"] = r.utime()
    inc.wire["client_tail"] = r.d[r.off:end]
    r.off = end

    # osd-only section: preserved raw, whole frame
    p0 = r.off
    _, _, oend = r.start()
    inc.wire["osd_raw"] = r.d[p0:oend]
    r.off = oend

    if r.off + 8 <= meta_end:
        stored = r.u32()  # inc_crc (in the hole position)
        inc.full_crc = r.u32()
        # crc covers [0, hole) + [hole_end, end) (reference OSDMap.cc:714-731)
        hole = r.off - 8
        calc = crc32c(data[:hole], 0xFFFFFFFF)
        calc = crc32c(data[hole + 4:], calc)
        if stored != calc:
            raise CodecError(
                f"incremental crc mismatch: stored {stored:#x} calc {calc:#x}"
            )
    return inc


def _default_inc_osd_only(inc: Incremental) -> bytes:
    """Minimal decodable osd-only section for self-built incrementals: all
    change-maps empty (reference field list src/osd/OSDMap.cc:650-709,
    target_v 9) — except new_hb_back_up/new_hb_front_up, which must carry
    an entry for every new_up_client osd: the reference's
    apply_incremental dereferences new_hb_back_up.find(osd) without a
    presence check (src/osd/OSDMap.cc:2203-2208)."""

    def hb_map(w: W):
        w.u32(len(inc.new_up_client))
        for osd in sorted(inc.new_up_client):
            w.i32(osd)
            w.u8(2)  # empty entity_addrvec_t
            w.u32(0)

    w = W()
    h = w.start(9, 1)
    hb_map(w)  # new_hb_back_up
    w.u32(0)  # new_up_thru
    w.u32(0)  # new_last_clean_interval
    w.u32(0)  # new_lost
    w.u32(0)  # new_blocklist
    w.u32(0)  # old_blocklist
    w.u32(0)  # new_up_cluster
    w.string("")  # cluster_snapshot
    w.u32(0)  # new_uuid
    w.u32(0)  # new_xinfo
    hb_map(w)  # new_hb_front_up
    w.u64(0)  # features
    w.raw(b"\x00\x00\x80\xbf" * 3)  # near/full/backfillfull ratios = -1.0f
    w.u8(0xFF)  # new_require_min_compat_client (unset)
    w.u8(0xFF)  # new_require_osd_release (unset)
    w.u32(0)  # new_crush_node_flags
    w.u32(0)  # new_device_class_flags
    w.finish(h)
    return bytes(w.b)


def encode_incremental(inc: Incremental) -> bytes:
    """reference src/osd/OSDMap.cc:557 (Incremental::encode)."""
    wire = inc.wire or {}
    w = W()
    mh = w.start(wire.get("meta_v", 8), wire.get("meta_compat", 7))

    v = wire.get("client_v", 8)
    ch = w.start(v, wire.get("client_compat", 1))
    w.raw(inc.fsid)
    w.u32(inc.epoch)
    w.utime(inc.modified)
    w.i64(inc.new_pool_max)
    w.i32(inc.new_flags)
    w.u32(len(inc.fullmap))
    w.raw(inc.fullmap)
    w.u32(len(inc.crush))
    w.raw(inc.crush)
    w.i32(inc.new_max_osd)
    w.u32(len(inc.new_pools))
    for pid in sorted(inc.new_pools):
        w.i64(pid)
        _encode_pool(w, inc.new_pools[pid], inc.new_pool_wire.get(pid))
    w.u32(len(inc.new_pool_names))
    for pid in sorted(inc.new_pool_names):
        w.i64(pid)
        w.string(inc.new_pool_names[pid])
    w.u32(len(inc.old_pools))
    for pid in sorted(inc.old_pools):
        w.i64(pid)
    w.u32(len(inc.new_up_client))
    for osd in sorted(inc.new_up_client):
        w.i32(osd)
        w.raw(inc.new_up_client[osd] or b"\x02\x00\x00\x00\x00")
    w.u32(len(inc.new_state))
    for osd in sorted(inc.new_state):
        w.i32(osd)
        w.u32(inc.new_state[osd])
    w.u32(len(inc.new_weight))
    for osd in sorted(inc.new_weight):
        w.i32(osd)
        w.u32(inc.new_weight[osd])
    w.u32(len(inc.new_pg_temp))
    for pg in _pg_sorted(inc.new_pg_temp):
        w.pg(pg)
        osds = inc.new_pg_temp[pg]
        w.u32(len(osds))
        for o in osds:
            w.i32(o)
    w.u32(len(inc.new_primary_temp))
    for pg in _pg_sorted(inc.new_primary_temp):
        w.pg(pg)
        w.i32(inc.new_primary_temp[pg])
    w.u32(len(inc.new_primary_affinity))
    for osd in sorted(inc.new_primary_affinity):
        w.i32(osd)
        w.u32(inc.new_primary_affinity[osd])
    w.u32(len(inc.new_erasure_code_profiles))
    for name in sorted(inc.new_erasure_code_profiles):
        w.string(name)
        prof = inc.new_erasure_code_profiles[name]
        w.u32(len(prof))
        for k in sorted(prof):
            w.string(k)
            w.string(prof[k])
    w.u32(len(inc.old_erasure_code_profiles))
    for name in inc.old_erasure_code_profiles:
        w.string(name)
    if v >= 4:
        w.u32(len(inc.new_pg_upmap))
        for pg in _pg_sorted(inc.new_pg_upmap):
            w.pg(pg)
            osds = inc.new_pg_upmap[pg]
            w.u32(len(osds))
            for o in osds:
                w.i32(o)
        w.u32(len(inc.old_pg_upmap))
        for pg in _pg_sorted(inc.old_pg_upmap):
            w.pg(pg)
        w.u32(len(inc.new_pg_upmap_items))
        for pg in _pg_sorted(inc.new_pg_upmap_items):
            w.pg(pg)
            pairs = inc.new_pg_upmap_items[pg]
            w.u32(len(pairs))
            for frm, to in pairs:
                w.i32(frm)
                w.i32(to)
        w.u32(len(inc.old_pg_upmap_items))
        for pg in _pg_sorted(inc.old_pg_upmap_items):
            w.pg(pg)
    if v >= 6:
        w.raw(wire.get("snaps_raw", b"\0" * 8))
    if v >= 8:
        w.utime(wire.get("last_up_change", (0, 0)))
        w.utime(wire.get("last_in_change", (0, 0)))
    w.raw(wire.get("client_tail", b""))
    w.finish(ch)

    w.raw(wire.get("osd_raw") or _default_inc_osd_only(inc))

    # inc_crc hole + full_crc, inside the meta wrapper (OSDMap.cc:714-731)
    hole = len(w.b)
    w.u32(0)
    w.u32(inc.full_crc)
    w.finish(mh)
    crc = crc32c(bytes(w.b[:hole]), 0xFFFFFFFF)
    crc = crc32c(bytes(w.b[hole + 4:]), crc)
    w.b[hole:hole + 4] = crc.to_bytes(4, "little")
    return bytes(w.b)


def looks_like_incremental(data: bytes) -> bool:
    """Full maps and incrementals share the outer framing; distinguish by
    the client section's layout: an incremental's bytes 22-29 are
    new_pool_max (i64), a full map's are created.utime — full maps have
    fsid right after the inner header, incrementals too, but the
    incremental's epoch is followed by modified + i64 new_pool_max whose
    high word is 0xffffffff for the common "-1 = unchanged" case.  Robust
    discrimination: try decoding as incremental and check crc."""
    try:
        decode_incremental(data)
        return True
    except Exception:
        return False


# ---------------------------------------------------------------- apply


def apply_incremental(m: OSDMap, inc: Incremental) -> OSDMap:
    """Advance ``m`` from epoch e to e+1 (reference src/osd/OSDMap.cc:2061).
    Returns the resulting map — ``m`` mutated in place, or a fresh decode
    when the incremental carries a full map."""
    if inc.epoch != m.epoch + 1:
        raise ValueError(f"incremental epoch {inc.epoch} != {m.epoch}+1")
    # fsid guard (reference OSDMap.cc:2064-2067): adopt at epoch 1, reject
    # mismatches otherwise.  An all-zero inc.fsid means "unset" for
    # programmatically-built deltas (the reference always carries one).
    zero_fsid = b"\0" * 16
    m_fsid = getattr(m, "wire", {}).get("fsid", zero_fsid) if \
        getattr(m, "wire", None) else zero_fsid
    if inc.epoch == 1:
        pass  # fsid adopted below via wire
    elif inc.fsid != zero_fsid and m_fsid != zero_fsid \
            and inc.fsid != m_fsid:
        raise ValueError("incremental fsid does not match map fsid")

    if inc.fullmap:
        full = decode_osdmap(inc.fullmap)
        if full.epoch != inc.epoch:
            raise ValueError("fullmap epoch mismatch")
        return full

    m.epoch += 1
    wire = getattr(m, "wire", None)
    if wire is None:
        wire = m.wire = {"pools": {}}
    wire["modified"] = inc.modified  # OSDMap.cc:2072
    if inc.epoch == 1 and inc.fsid != zero_fsid:
        wire["fsid"] = inc.fsid

    if inc.new_flags >= 0:
        wire["flags"] = inc.new_flags
    if inc.new_max_osd >= 0:
        m.set_max_osd(inc.new_max_osd)
    if inc.new_pool_max != -1:
        m.pool_max = inc.new_pool_max

    for pid, pool in inc.new_pools.items():
        m.pools[pid] = PgPool(**vars(pool))
        if pid in inc.new_pool_wire:
            pw = dict(inc.new_pool_wire[pid])
            pw["last_change"] = m.epoch  # OSDMap.cc:2106
            wire.setdefault("pools", {})[pid] = pw
    for pid, name in inc.new_pool_names.items():
        m.pool_name[pid] = name
    for pid in inc.old_pools:
        m.pools.pop(pid, None)
        m.pool_name.pop(pid, None)
        wire.get("pools", {}).pop(pid, None)

    for osd, weight in inc.new_weight.items():
        m.osd_weight[osd] = weight
        if weight:  # marking in clears AUTOOUT/NEW (OSDMap.cc:2153-2157)
            m.osd_state[osd] &= ~(OSD_AUTOOUT | OSD_NEW)

    for osd, aff in inc.new_primary_affinity.items():
        m.set_primary_affinity(osd, aff)

    profs = m.erasure_code_profiles
    for name in inc.old_erasure_code_profiles:
        profs.pop(name, None)
    for name, prof in inc.new_erasure_code_profiles.items():
        profs[name] = dict(prof)

    for osd, s in inc.new_state.items():
        s = s or OSD_UP
        if (m.osd_state[osd] & OSD_EXISTS) and (s & OSD_EXISTS):
            # destroy: clear everything interesting (OSDMap.cc:2183-2196)
            m.osd_state[osd] = 0
            m.set_primary_affinity(osd, DEFAULT_PRIMARY_AFFINITY)
        else:
            m.osd_state[osd] ^= s

    for osd in inc.new_up_client:
        m.osd_state[osd] |= OSD_EXISTS | OSD_UP

    for pg, osds in inc.new_pg_temp.items():
        if osds:
            m.pg_temp[pg] = list(osds)
        else:
            m.pg_temp.pop(pg, None)
    for pg, primary in inc.new_primary_temp.items():
        if primary == -1:
            m.primary_temp.pop(pg, None)
        else:
            m.primary_temp[pg] = primary

    for pg, osds in inc.new_pg_upmap.items():
        m.pg_upmap[pg] = list(osds)
    for pg in inc.old_pg_upmap:
        m.pg_upmap.pop(pg, None)
    for pg, pairs in inc.new_pg_upmap_items.items():
        m.pg_upmap_items[pg] = list(pairs)
    for pg in inc.old_pg_upmap_items:
        m.pg_upmap_items.pop(pg, None)

    # new crush map last, after up/down stuff (OSDMap.cc:2330-2341)
    if inc.crush:
        m.crush = decode_crushmap(inc.crush)
        wire["crush_raw"] = inc.crush
        wire["crush_obj"] = m.crush
        wire["crush_version"] = wire.get("crush_version", 1) + 1
    return m
