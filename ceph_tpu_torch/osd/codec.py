"""Binary OSDMap codec — wire-compatible with the reference.

A copy of `ceph_tpu/osd/codec.py`, its imports pointed at the port.

Implements OSDMap::encode / ::decode (reference src/osd/OSDMap.cc:2914,
3249): the ENCODE_START(8,7) meta wrapper holding a client-usable section
(v3..v9), an osd-only section, and a trailing CRC-32C.  Nested structures
follow their reference encoders: pg_pool_t (src/osd/osd_types.cc:1833,
v≥14 length-framed), pg_t (osd_types.h:483: u8 1 + u64 pool + u32 seed +
i32 -1), utime_t (u32 sec + u32 nsec), entity_addr(vec)_t markers
(src/msg/msg_types.h:435, msg_types.cc:317).

Fidelity model: every field the placement stack uses is parsed into the
OSDMap model; everything else (addr vectors, the whole osd-only section,
pool cache/tier fields, unknown version tails) is captured as raw spans in
`m.wire` / per-pool raw dicts and replayed verbatim on encode — so
decode→encode of a real cluster artifact is byte-exact (CRC recomputed and
verified), without modeling subsystems the framework doesn't have.  Maps
built programmatically (no wire info) encode with modern defaults
(client v9 / pool v29 / osd-only v9) that the reference can decode.
"""

from __future__ import annotations

import struct

from ceph_tpu_torch.crush.codec import decode_crushmap, encode_crushmap
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import PgId, PgPool, PoolType
from ceph_tpu_torch.utils.crc32c import crc32c


class CodecError(ValueError):
    pass


# ---------------------------------------------------------------- primitives


class R:
    def __init__(self, data: bytes, off: int = 0):
        self.d = data
        self.off = off

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.d):
            raise CodecError(
                f"truncated osdmap (need {n} at {self.off}/{len(self.d)})"
            )
        b = self.d[self.off:self.off + n]
        self.off += n
        return b

    def u8(self):
        return self.take(1)[0]

    def u16(self):
        return struct.unpack("<H", self.take(2))[0]

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.take(8))[0]

    def i64(self):
        return struct.unpack("<q", self.take(8))[0]

    def string(self) -> str:
        return self.take(self.u32()).decode()

    def utime(self):
        return (self.u32(), self.u32())

    def start(self):
        """ENCODE_START framing: (struct_v, compat, end_offset)."""
        v = self.u8()
        compat = self.u8()
        ln = self.u32()
        return v, compat, self.off + ln

    def pg(self) -> PgId:
        v = self.u8()
        if v != 1:
            raise CodecError(f"pg_t v{v}")
        pool = self.u64()
        seed = self.u32()
        self.i32()  # preferred (-1)
        return PgId(pool, seed)


class W:
    def __init__(self):
        self.b = bytearray()

    def raw(self, data: bytes):
        self.b += data

    def u8(self, v):
        self.b += struct.pack("<B", v & 0xFF)

    def u16(self, v):
        self.b += struct.pack("<H", v & 0xFFFF)

    def u32(self, v):
        self.b += struct.pack("<I", v & 0xFFFFFFFF)

    def i32(self, v):
        self.b += struct.pack("<i", v)

    def u64(self, v):
        self.b += struct.pack("<Q", v & (2**64 - 1))

    def i64(self, v):
        self.b += struct.pack("<q", v)

    def string(self, s: str):
        e = s.encode()
        self.u32(len(e))
        self.b += e

    def utime(self, t):
        self.u32(t[0])
        self.u32(t[1])

    def pg(self, pg: PgId):
        self.u8(1)
        self.u64(pg.pool)
        self.u32(pg.seed)
        self.i32(-1)

    def start(self, v: int, compat: int):
        """ENCODE_START; returns a patch handle for finish()."""
        self.u8(v)
        self.u8(compat)
        self.u32(0)
        return len(self.b)

    def finish(self, handle: int):
        ln = len(self.b) - handle
        self.b[handle - 4:handle] = struct.pack("<I", ln)


# ------------------------------------------------------- addr skip helpers


def _skip_addr(r: R):
    """entity_addr_t (reference src/msg/msg_types.h:435): u8 marker —
    0 => legacy u32 marker + u32 nonce + 128B sockaddr_storage,
    1 => ENCODE wrapper."""
    marker = r.u8()
    if marker == 0:
        r.take(3 + 4 + 128)
    elif marker == 1:
        _, _, end = r.start()
        r.off = end
    else:
        raise CodecError(f"entity_addr_t marker {marker}")


def _skip_addrvec(r: R):
    """entity_addrvec_t (reference src/msg/msg_types.cc:317)."""
    marker = r.u8()
    if marker == 0:
        r.take(3 + 4 + 128)
    elif marker == 1:
        _, _, end = r.start()
        r.off = end
    elif marker == 2:
        n = r.u32()
        for _ in range(n):
            _skip_addr(r)
    else:
        raise CodecError(f"entity_addrvec_t marker {marker}")


def _skip_addr_vector(r: R, vecform: bool):
    """client_addrs: v>=8 vector<addrvec>, v<8 vector<addr>
    (reference src/osd/OSDMap.cc:2984-2988)."""
    n = r.u32()
    for _ in range(n):
        if vecform:
            _skip_addrvec(r)
        else:
            _skip_addr(r)


# ------------------------------------------------------------- pg_pool_t


def _decode_pool(r: R) -> tuple[PgPool, dict]:
    """pg_pool_t::decode (reference src/osd/osd_types.cc:2052; encode
    :1833).  Parses the placement-relevant head; preserves the rest raw."""
    v, compat, end = r.start()
    if v < 14:
        raise CodecError(f"pg_pool_t v{v} < 14 (pre-firefly) unsupported")
    w: dict = {"v": v, "compat": compat}
    ptype = r.u8()
    size = r.u8()
    crush_rule = r.u8()
    object_hash = r.u8()
    pg_num = r.u32()
    pgp_num = r.u32()
    r.u32()  # lpg_num
    r.u32()  # lpgp_num
    w["last_change"] = r.u32()
    w["snap_seq"] = r.u64()
    w["snap_epoch"] = r.u32()
    # snaps: map<snapid_t, pool_snap_info_t> — wrapper-framed entries
    p0 = r.off
    n = r.u32()
    for _ in range(n):
        r.u64()
        _, _, e2 = r.start()
        r.off = e2
    # removed_snaps: interval_set<snapid_t>
    m = r.u32()
    for _ in range(m):
        r.u64()
        r.u64()
    w["snaps_raw"] = r.d[p0:r.off]
    w["auid"] = r.u64()
    flags = r.u64()
    r.u32()  # crash_replay_interval
    min_size = r.u8()
    w["quota_max_bytes"] = r.u64()
    w["quota_max_objects"] = r.u64()
    p0 = r.off
    tn = r.u32()
    r.take(8 * tn)  # tiers
    r.take(8)  # tier_of
    r.take(1)  # cache_mode
    r.take(16)  # read_tier, write_tier
    pn = r.u32()  # properties
    for _ in range(pn):
        r.string()
        r.string()
    _, _, e2 = r.start()  # hit_set_params wrapper
    r.off = e2
    r.take(4 * 3)  # hit_set_period, hit_set_count, stripe_width
    r.take(8 * 2)  # target_max_bytes/objects
    r.take(4 * 4)  # cache ratios/ages
    w["mid_raw"] = r.d[p0:r.off]
    ec_profile = r.string()
    w["tail_raw"] = r.d[r.off:end]
    r.off = end

    pool = PgPool(
        type=PoolType(ptype),
        size=size,
        min_size=min_size,
        pg_num=pg_num,
        pgp_num=pgp_num or pg_num,
        crush_rule=crush_rule,
        flags=flags,
        object_hash=object_hash,
        erasure_code_profile=ec_profile,
    )
    return pool, w


def _encode_pool(w: W, pool: PgPool, wire: dict | None):
    if wire:  # replay a decoded pool byte-exactly
        h = w.start(wire["v"], wire["compat"])
        w.u8(int(pool.type))
        w.u8(pool.size)
        w.u8(pool.crush_rule)
        w.u8(pool.object_hash)
        w.u32(pool.pg_num)
        w.u32(pool.pgp_num)
        w.u32(0)
        w.u32(0)
        w.u32(wire["last_change"])
        w.u64(wire["snap_seq"])
        w.u32(wire["snap_epoch"])
        w.raw(wire["snaps_raw"])
        w.u64(wire["auid"])
        w.u64(pool.flags)
        w.u32(0)
        w.u8(pool.min_size)
        w.u64(wire["quota_max_bytes"])
        w.u64(wire["quota_max_objects"])
        w.raw(wire["mid_raw"])
        w.string(pool.erasure_code_profile)
        w.raw(wire["tail_raw"])
        w.finish(h)
        return
    # fresh pool: modern v29 defaults (reference encode v29 field list,
    # src/osd/osd_types.cc:1954-2046)
    h = w.start(29, 5)
    w.u8(int(pool.type))
    w.u8(pool.size)
    w.u8(pool.crush_rule)
    w.u8(pool.object_hash)
    w.u32(pool.pg_num)
    w.u32(pool.pgp_num)
    w.u32(0)  # lpg_num
    w.u32(0)  # lpgp_num
    w.u32(0)  # last_change
    w.u64(0)  # snap_seq
    w.u32(0)  # snap_epoch
    w.u32(0)  # snaps (empty map)
    w.u32(0)  # removed_snaps (empty interval_set)
    w.u64(0)  # auid
    w.u64(pool.flags)
    w.u32(0)  # crash_replay_interval
    w.u8(pool.min_size)
    w.u64(0)  # quota_max_bytes
    w.u64(0)  # quota_max_objects
    w.u32(0)  # tiers
    w.i64(-1)  # tier_of
    w.u8(0)  # cache_mode
    w.i64(-1)  # read_tier
    w.i64(-1)  # write_tier
    w.u32(0)  # properties
    hh = w.start(1, 1)  # hit_set_params: TYPE_NONE
    w.u8(0)
    w.finish(hh)
    w.u32(0)  # hit_set_period
    w.u32(0)  # hit_set_count
    w.u32(0)  # stripe_width
    w.u64(0)  # target_max_bytes
    w.u64(0)  # target_max_objects
    w.u32(0)  # cache_target_dirty_ratio_micro
    w.u32(0)  # cache_target_full_ratio_micro
    w.u32(0)  # cache_min_flush_age
    w.u32(0)  # cache_min_evict_age
    w.string(pool.erasure_code_profile)
    w.u32(0)  # last_force_op_resend_preluminous
    w.u32(0)  # min_read_recency_for_promote
    w.u64(pool.expected_num_objects)
    w.u32(0)  # cache_target_dirty_high_ratio_micro (v19)
    w.u32(0)  # min_write_recency_for_promote (v20)
    w.u8(1)  # use_gmt_hitset (v21)
    w.u8(0)  # fast_read (v22)
    w.u32(0)  # hit_set_grade_decay_rate (v23)
    w.u32(0)  # hit_set_search_last_n (v23)
    hh = w.start(2, 1)  # opts: pool_opts_t empty (v24)
    w.u32(0)
    w.finish(hh)
    w.u32(0)  # last_force_op_resend_prenautilus (v25)
    w.u32(0)  # application_metadata (v26)
    w.utime((0, 0))  # create_time (v27)
    w.u32(pool.pg_num)  # pg_num_target (v28)
    w.u32(pool.pgp_num)  # pgp_num_target
    w.u32(pool.pg_num_pending or pool.pg_num)  # pg_num_pending
    w.u32(0)  # pg_num_dec_last_epoch_started (14.1.x relic)
    w.u32(0)  # pg_num_dec_last_epoch_clean
    w.u32(0)  # last_force_op_resend
    w.u8(0)  # pg_autoscale_mode
    hh = w.start(1, 1)  # last_pg_merge_meta (v29)
    w.pg(PgId(0, 0))
    w.u32(0)  # ready_epoch
    w.u32(0)  # last_epoch_started
    w.u32(0)  # last_epoch_clean
    w.u64(0)  # source_version.version
    w.u32(0)  # source_version.epoch
    w.u64(0)  # target_version.version
    w.u32(0)  # target_version.epoch
    w.finish(hh)
    w.finish(h)


# --------------------------------------------------------------- top level


def looks_like_osdmap(data: bytes) -> bool:
    if len(data) < 10 or data[1] != 7 or data[0] < 7 or data[0] > 10:
        return False
    ln = struct.unpack("<I", data[2:6])[0]
    return ln == len(data) - 6


def decode_osdmap(data: bytes) -> OSDMap:
    r = R(data)
    meta_v, meta_compat, meta_end = r.start()
    if meta_v < 7:
        raise CodecError(f"osdmap meta v{meta_v} (classic encoding) "
                         "unsupported")

    m = OSDMap()
    wire: dict = {"meta_v": meta_v, "meta_compat": meta_compat,
                  "pools": {}}
    m.wire = wire

    # ---- client-usable section (reference OSDMap.cc:2948-3023)
    v, compat, end = r.start()
    wire["client_v"], wire["client_compat"] = v, compat
    if v < 4:
        raise CodecError(f"client data v{v} unsupported")
    wire["fsid"] = r.take(16)
    m.epoch = r.u32()
    wire["created"] = r.utime()
    wire["modified"] = r.utime()
    n = r.u32()
    for _ in range(n):
        pid = r.i64()
        pool, pw = _decode_pool(r)
        m.pools[pid] = pool
        wire["pools"][pid] = pw
    n = r.u32()
    for _ in range(n):
        pid = r.i64()
        m.pool_name[pid] = r.string()
    m.pool_max = r.i32()  # int32_t (reference src/osd/OSDMap.h:523)
    wire["flags"] = r.u32()
    max_osd = r.i32()
    if v >= 5:
        n = r.u32()
        m.osd_state = [r.u32() for _ in range(n)]
    else:
        n = r.u32()
        m.osd_state = [r.u8() for _ in range(n)]
    n = r.u32()
    m.osd_weight = [r.u32() for _ in range(n)]
    p0 = r.off
    _skip_addr_vector(r, vecform=v >= 8)
    wire["client_addrs_raw"] = r.d[p0:r.off]
    n = r.u32()
    for _ in range(n):
        pg = r.pg()
        cnt = r.u32()
        m.pg_temp[pg] = [r.i32() for _ in range(cnt)]
    n = r.u32()
    for _ in range(n):
        pg = r.pg()
        m.primary_temp[pg] = r.i32()
    n = r.u32()
    if n:
        m.osd_primary_affinity = [r.u32() for _ in range(n)]
    cblob = r.take(r.u32())
    wire["crush_raw"] = cblob
    m.crush = decode_crushmap(cblob)
    wire["crush_obj"] = m.crush  # staleness guard for encode
    n = r.u32()
    profs: dict[str, dict[str, str]] = {}
    for _ in range(n):
        name = r.string()
        kn = r.u32()
        profs[name] = {}
        for _ in range(kn):
            k = r.string()
            profs[name][k] = r.string()
    wire["erasure_code_profiles"] = profs
    m.erasure_code_profiles = profs
    if v >= 4:
        n = r.u32()
        for _ in range(n):
            pg = r.pg()
            cnt = r.u32()
            m.pg_upmap[pg] = [r.i32() for _ in range(cnt)]
        n = r.u32()
        for _ in range(n):
            pg = r.pg()
            cnt = r.u32()
            m.pg_upmap_items[pg] = [
                (r.i32(), r.i32()) for _ in range(cnt)
            ]
    if v >= 6:
        wire["crush_version"] = r.u32()
    if v >= 7:
        p0 = r.off
        for _ in range(2):  # new_removed_snaps, new_purged_snaps
            n = r.u32()
            for _ in range(n):
                r.i64()
                iv = r.u32()
                r.take(16 * iv)
        wire["snaps_raw"] = r.d[p0:r.off]
    if v >= 9:
        wire["last_up_change"] = r.utime()
        wire["last_in_change"] = r.utime()
    wire["client_tail"] = r.d[r.off:end]
    r.off = end

    # ---- osd-only section: preserved raw (framing incl. header)
    p0 = r.off
    _, _, oend = r.start()
    wire["osd_raw"] = r.d[p0:oend]
    r.off = oend

    # ---- trailing crc (reference OSDMap.cc:3102-3112)
    if r.off + 4 <= meta_end:
        stored = r.u32()
        calc = crc32c(data[: r.off - 4], 0xFFFFFFFF)
        if stored != calc:
            raise CodecError(
                f"osdmap crc mismatch: stored {stored:#x} calc {calc:#x}"
            )
        wire["had_crc"] = True
    m.max_osd = max_osd  # decoded vectors are authoritative
    return m


def _default_osd_only(m: OSDMap) -> bytes:
    """A decodable osd-only section for self-built maps: default osd_info/
    xinfo/uuid entries, empty addrs/blocklist (reference field list
    OSDMap.cc:3025-3098, target_v 9)."""
    w = W()
    h = w.start(9, 1)
    w.u32(m.max_osd)  # hb_back_addrs: one empty addrvec per osd
    for _ in range(m.max_osd):
        w.u8(2)
        w.u32(0)
    w.u32(m.max_osd)  # osd_info: classic struct, six u32s after v byte
    for _ in range(m.max_osd):
        w.u8(1)
        for _ in range(6):
            w.u32(0)
    w.u32(0)  # blocklist
    w.u32(m.max_osd)  # cluster_addrs
    for _ in range(m.max_osd):
        w.u8(2)
        w.u32(0)
    w.u32(0)  # cluster_snapshot_epoch
    w.string("")  # cluster_snapshot
    w.u32(m.max_osd)  # osd_uuid
    for _ in range(m.max_osd):
        w.raw(b"\0" * 16)
    w.u32(m.max_osd)  # osd_xinfo_t (wrapper-framed each)
    for _ in range(m.max_osd):
        hh = w.start(4, 1)
        w.utime((0, 0))  # down_stamp
        w.u32(0)  # laggy_probability (scaled)
        w.u32(0)  # laggy_interval
        w.u64(0)  # features
        w.u32(0x10000)  # old_weight
        w.utime((0, 0))  # last_purged_snaps_scrub (v3)
        w.u32(0)  # dead_epoch (v4)
        w.finish(hh)
    w.u32(m.max_osd)  # hb_front_addrs
    for _ in range(m.max_osd):
        w.u8(2)
        w.u32(0)
    w.u32(0)  # nearfull_ratio (float as u32? encoded as float)
    w.u32(0)  # full_ratio
    w.u32(0)  # backfillfull_ratio
    w.u8(0)  # require_min_compat_client (ceph_release_t: u8)
    w.u8(0)  # require_osd_release
    w.u32(0)  # removed_snaps_queue (v6)
    w.u32(0)  # crush_node_flags (v8)
    w.u32(0)  # device_class_flags (v9)
    w.finish(h)
    return bytes(w.b)


def encode_osdmap(m: OSDMap) -> bytes:
    wire = getattr(m, "wire", None) or {}
    pools_w = wire.get("pools", {})

    w = W()
    mh = w.start(wire.get("meta_v", 8), wire.get("meta_compat", 7))

    v = wire.get("client_v", 9)
    ch = w.start(v, wire.get("client_compat", 1))
    w.raw(wire.get("fsid", b"\0" * 16))
    w.u32(m.epoch)
    w.utime(wire.get("created", (0, 0)))
    w.utime(wire.get("modified", (0, 0)))
    w.u32(len(m.pools))
    for pid in sorted(m.pools):
        w.i64(pid)
        _encode_pool(w, m.pools[pid], pools_w.get(pid))
    w.u32(len(m.pool_name))
    for pid in sorted(m.pool_name):
        w.i64(pid)
        w.string(m.pool_name[pid])
    w.i32(m.pool_max)  # int32_t (reference src/osd/OSDMap.h:523)
    w.u32(wire.get("flags", 0))
    w.i32(m.max_osd)
    w.u32(len(m.osd_state))
    for s in m.osd_state:
        w.u32(s)
    w.u32(len(m.osd_weight))
    for s in m.osd_weight:
        w.u32(s)
    if "client_addrs_raw" in wire:
        w.raw(wire["client_addrs_raw"])
    else:
        w.u32(m.max_osd)
        for _ in range(m.max_osd):
            w.u8(2)  # empty addrvec per osd
            w.u32(0)
    w.u32(len(m.pg_temp))
    for pg in sorted(m.pg_temp, key=lambda p: (p.pool, p.seed)):
        w.pg(pg)
        v2 = m.pg_temp[pg]
        w.u32(len(v2))
        for o in v2:
            w.i32(o)
    w.u32(len(m.primary_temp))
    for pg in sorted(m.primary_temp, key=lambda p: (p.pool, p.seed)):
        w.pg(pg)
        w.i32(m.primary_temp[pg])
    if m.osd_primary_affinity is not None:
        w.u32(len(m.osd_primary_affinity))
        for a in m.osd_primary_affinity:
            w.u32(a)
    else:
        w.u32(0)
    cblob = wire.get("crush_raw")
    if cblob is None or wire.get("crush_obj") is not m.crush:
        # crush was replaced/rebuilt since decode: re-encode it
        cblob = encode_crushmap(m.crush)
    w.u32(len(cblob))
    w.raw(cblob)
    profs = m.erasure_code_profiles
    w.u32(len(profs))
    for name in sorted(profs):
        w.string(name)
        w.u32(len(profs[name]))
        for k in sorted(profs[name]):
            w.string(k)
            w.string(profs[name][k])
    if v >= 4:
        w.u32(len(m.pg_upmap))
        for pg in sorted(m.pg_upmap, key=lambda p: (p.pool, p.seed)):
            w.pg(pg)
            v2 = m.pg_upmap[pg]
            w.u32(len(v2))
            for o in v2:
                w.i32(o)
        w.u32(len(m.pg_upmap_items))
        for pg in sorted(m.pg_upmap_items, key=lambda p: (p.pool, p.seed)):
            w.pg(pg)
            v2 = m.pg_upmap_items[pg]
            w.u32(len(v2))
            for frm, to in v2:
                w.i32(frm)
                w.i32(to)
    if v >= 6:
        w.u32(wire.get("crush_version", 1))
    if v >= 7:
        w.raw(wire.get("snaps_raw", b"\0" * 8))
    if v >= 9:
        w.utime(wire.get("last_up_change", (0, 0)))
        w.utime(wire.get("last_in_change", (0, 0)))
    w.raw(wire.get("client_tail", b""))
    w.finish(ch)

    w.raw(wire.get("osd_raw") or _default_osd_only(m))

    # crc goes inside the meta wrapper and covers everything before it
    # with the wrapper length already patched (reference OSDMap.cc:3099-3112)
    crc_at = len(w.b)
    w.u32(0)
    w.finish(mh)
    crc = crc32c(bytes(w.b[:crc_at]), 0xFFFFFFFF)
    w.b[crc_at:crc_at + 4] = struct.pack("<I", crc)
    return bytes(w.b)


def save_osdmap_bin(m: OSDMap, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode_osdmap(m))


def load_osdmap_bin(path: str) -> OSDMap:
    with open(path, "rb") as f:
        return decode_osdmap(f.read())
