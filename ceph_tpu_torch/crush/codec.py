"""Binary crushmap codec — wire-compatible with the reference.

A copy of `ceph_tpu/crush/codec.py`, its imports pointed at the port.

Implements the on-disk/on-wire crushmap encoding of CrushWrapper::encode /
::decode (reference src/crush/CrushWrapper.cc:2941,3117): little-endian
magic + bucket array (alg-tagged slots with per-alg payloads) + rules +
name maps + staged tunables + the luminous device-class and choose_args
sections.  Field widths follow the C structs (reference src/crush/crush.h:
crush_bucket :229, crush_rule_mask :84, tunables :377-456, CRUSH_MAGIC :24).

This lets the CLIs read/write real `crushtool -o` artifacts: a map encoded
by the reference decodes here bit-for-bit and vice versa (modulo optional
trailing sections governed by feature bits — we always emit the full modern
form, like a luminous+ cluster would).
"""

from __future__ import annotations

import struct

from ceph_tpu_torch.crush.types import (
    Bucket,
    BucketAlg,
    ChooseArgs,
    CrushMap,
    Rule,
    Tunables,
)

CRUSH_MAGIC = 0x00010000


class CodecError(ValueError):
    pass


class Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def u8(self, v):
        self.parts.append(struct.pack("<B", v & 0xFF))

    def u16(self, v):
        self.parts.append(struct.pack("<H", v & 0xFFFF))

    def u32(self, v):
        self.parts.append(struct.pack("<I", v & 0xFFFFFFFF))

    def i32(self, v):
        self.parts.append(struct.pack("<i", v))

    def i64(self, v):
        self.parts.append(struct.pack("<q", v))

    def string(self, s: str):
        b = s.encode()
        self.u32(len(b))
        self.parts.append(b)

    def str_map(self, m: dict[int, str]):
        self.u32(len(m))
        for k in sorted(m):
            self.i32(k)
            self.string(m[k])

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise CodecError("truncated crushmap")
        b = self.data[self.off : self.off + n]
        self.off += n
        return b

    def end(self) -> bool:
        return self.off >= len(self.data)

    def u8(self):
        return self._take(1)[0]

    def u16(self):
        return struct.unpack("<H", self._take(2))[0]

    def u32(self):
        return struct.unpack("<I", self._take(4))[0]

    def i32(self):
        return struct.unpack("<i", self._take(4))[0]

    def i64(self):
        return struct.unpack("<q", self._take(8))[0]

    def string(self) -> str:
        return self._take(self.u32()).decode()

    def str_map(self) -> dict[int, str]:
        """With the 32-or-64-bit key quirk (reference
        decode_32_or_64_string_map, CrushWrapper.cc:3100)."""
        out = {}
        n = self.u32()
        for _ in range(n):
            key = self.i32()
            slen = self.u32()
            if slen == 0:
                slen = self.u32()  # key was actually 64 bits
            out[key] = self._take(slen).decode()
        return out


def encode_crushmap(m: CrushMap) -> bytes:
    w = Writer()
    w.u32(CRUSH_MAGIC)
    max_buckets = getattr(m, "wire_max_buckets", None)
    if max_buckets is None or max_buckets < m.max_buckets:
        # emulate the C builder's slot-array growth (8, 16, 32, ...;
        # builder.c crush_add_bucket) so built maps encode byte-identical
        # to maps built through the reference builder
        max_buckets = 0 if not m.buckets else 8
        while max_buckets < m.max_buckets:
            max_buckets *= 2
    n_rules = len(m.rules)
    w.i32(max_buckets)
    w.u32(n_rules)
    w.i32(m.max_devices)

    # buckets
    for i in range(max_buckets):
        b = m.buckets.get(-1 - i)
        if b is None:
            w.u32(0)
            continue
        w.u32(int(b.alg))
        w.i32(b.id)
        w.u16(b.type)
        w.u8(int(b.alg))
        w.u8(b.hash)
        w.u32(b.weight)
        w.u32(b.size)
        for it in b.items:
            w.i32(it)
        if b.alg == BucketAlg.UNIFORM:
            w.u32(b.weights[0] if b.weights else 0)
        elif b.alg == BucketAlg.LIST:
            assert b.sum_weights is not None
            for iw, sw in zip(b.weights, b.sum_weights):
                w.u32(iw)
                w.u32(sw)
        elif b.alg == BucketAlg.TREE:
            assert b.node_weights is not None
            w.u8(len(b.node_weights))
            for nw in b.node_weights:
                w.u32(nw)
        elif b.alg == BucketAlg.STRAW:
            assert b.straws is not None
            for iw, st in zip(b.weights, b.straws):
                w.u32(iw)
                w.u32(st)
        elif b.alg == BucketAlg.STRAW2:
            for iw in b.weights:
                w.u32(iw)
        else:
            raise CodecError(f"unencodable bucket alg {b.alg}")

    # rules
    for rule in m.rules:
        if rule is None:
            w.u32(0)
            continue
        w.u32(1)
        w.u32(len(rule.steps))
        w.u8(rule.ruleset)
        w.u8(rule.type)
        w.u8(rule.min_size)
        w.u8(rule.max_size)
        for op, a1, a2 in rule.steps:
            w.u32(int(op))
            w.i32(a1)
            w.i32(a2)

    # name maps
    w.str_map(m.type_names)
    w.str_map(m.item_names)
    w.str_map(m.rule_names)

    # tunables (staged like the reference's decode expects)
    t = m.tunables
    w.u32(t.choose_local_tries)
    w.u32(t.choose_local_fallback_tries)
    w.u32(t.choose_total_tries)
    w.u32(t.chooseleaf_descend_once)
    w.u8(t.chooseleaf_vary_r)
    w.u8(t.straw_calc_version)
    w.u32(t.allowed_bucket_algs)
    w.u8(t.chooseleaf_stable)

    # device classes (luminous section)
    class_by_name = {n: c for c, n in m.class_names.items()}
    class_map = {
        dev: class_by_name[cname]
        for dev, cname in sorted(m.item_classes.items())
        if cname in class_by_name
    }
    w.u32(len(class_map))
    for dev in sorted(class_map):
        w.i32(dev)
        w.i32(class_map[dev])
    w.str_map(m.class_names)
    # class_bucket: map<i32, map<i32,i32>>
    w.u32(len(m.class_bucket))
    for orig in sorted(m.class_bucket):
        w.i32(orig)
        per = m.class_bucket[orig]
        w.u32(len(per))
        for cid in sorted(per):
            w.i32(cid)
            w.i32(per[cid])

    # choose_args
    int_keys = [k for k in m.choose_args if isinstance(k, int)]
    w.u32(len(int_keys))
    for key in sorted(int_keys):
        ca = m.choose_args[key]
        w.i64(key)
        entries = sorted(set(ca.weight_sets) | set(ca.ids))
        # bucket ids -> slot indexes
        w.u32(len(entries))
        for bid in entries:
            idx = -1 - bid
            w.u32(idx)
            ws = ca.weight_sets.get(bid, [])
            w.u32(len(ws))
            for row in ws:
                w.u32(len(row))
                for v in row:
                    w.u32(v)
            ids = ca.ids.get(bid, [])
            w.u32(len(ids))
            for v in ids:
                w.i32(v)
    return w.getvalue()


def decode_crushmap(data: bytes) -> CrushMap:
    r = Reader(data)
    magic = r.u32()
    if magic != CRUSH_MAGIC:
        raise CodecError(f"bad crush magic 0x{magic:x}")
    max_buckets = r.i32()
    max_rules = r.u32()
    max_devices = r.i32()

    # "legacy tunables, unless we decode something newer" — the reference
    # decode resets to the legacy profile before the staged tunable reads
    # (CrushWrapper.cc decode: set_tunables_legacy())
    m = CrushMap(Tunables.profile("legacy"))
    m.type_names = {}
    m.max_devices = max_devices
    # preserve the stored slot-array size: the C builder's capacity grows
    # 8,16,32,... and empty slots encode as a 4-byte 0 (builder.c
    # crush_add_bucket), so re-encode must replay the same capacity
    m.wire_max_buckets = max_buckets

    for i in range(max_buckets):
        alg = r.u32()
        if alg == 0:
            continue
        bid = r.i32()
        btype = r.u16()
        alg2 = r.u8()
        hash_ = r.u8()
        weight = r.u32()
        size = r.u32()
        items = [r.i32() for _ in range(size)]
        weights: list[int] = []
        sum_weights = None
        node_weights = None
        straws = None
        if alg2 == BucketAlg.UNIFORM:
            iw = r.u32()
            weights = [iw] * size
        elif alg2 == BucketAlg.LIST:
            sum_weights = []
            for _ in range(size):
                weights.append(r.u32())
                sum_weights.append(r.u32())
        elif alg2 == BucketAlg.TREE:
            n_nodes = r.u8()
            node_weights = [r.u32() for _ in range(n_nodes)]
            # leaf j lives at node (j+1)*2-1
            weights = [
                node_weights[((j + 1) << 1) - 1]
                if ((j + 1) << 1) - 1 < n_nodes
                else 0
                for j in range(size)
            ]
        elif alg2 == BucketAlg.STRAW:
            straws = []
            for _ in range(size):
                weights.append(r.u32())
                straws.append(r.u32())
        elif alg2 == BucketAlg.STRAW2:
            weights = [r.u32() for _ in range(size)]
        else:
            raise CodecError(f"unknown bucket alg {alg2}")
        b = Bucket(
            bid, BucketAlg(alg2), btype, items, weights, hash_,
            sum_weights=sum_weights, node_weights=node_weights,
            straws=straws,
        )
        m.buckets[bid] = b

    for ruleno in range(max_rules):
        yes = r.u32()
        if not yes:
            m.rules.append(None)
            continue
        length = r.u32()
        ruleset = r.u8()
        rtype = r.u8()
        min_size = r.u8()
        max_size = r.u8()
        steps = [(r.u32(), r.i32(), r.i32()) for _ in range(length)]
        m.rules.append(
            Rule(steps, ruleset=ruleset, type=rtype,
                 min_size=min_size, max_size=max_size)
        )

    m.type_names = r.str_map()
    m.item_names = r.str_map()
    m.rule_names = r.str_map()

    t = m.tunables
    if not r.end():
        t.choose_local_tries = r.u32()
        t.choose_local_fallback_tries = r.u32()
        t.choose_total_tries = r.u32()
    if not r.end():
        t.chooseleaf_descend_once = r.u32()
    if not r.end():
        t.chooseleaf_vary_r = r.u8()
    if not r.end():
        t.straw_calc_version = r.u8()
    if not r.end():
        t.allowed_bucket_algs = r.u32()
    if not r.end():
        t.chooseleaf_stable = r.u8()
    if not r.end():
        n = r.u32()
        class_map = {}
        for _ in range(n):
            dev = r.i32()
            class_map[dev] = r.i32()
        m.class_names = {
            k: v for k, v in r.str_map().items()
        }
        for dev, cid in class_map.items():
            if cid in m.class_names:
                m.item_classes[dev] = m.class_names[cid]
        n = r.u32()
        for _ in range(n):
            orig = r.i32()
            per_n = r.u32()
            per = {}
            for _ in range(per_n):
                cid = r.i32()
                per[cid] = r.i32()
            m.class_bucket[orig] = per
    if not r.end():
        n_ca = r.u32()
        for _ in range(n_ca):
            key = r.i64()
            ca = ChooseArgs()
            n_args = r.u32()
            for _ in range(n_args):
                idx = r.u32()
                bid = -1 - idx
                positions = r.u32()
                if positions:
                    ws = []
                    for _ in range(positions):
                        sz = r.u32()
                        ws.append([r.u32() for _ in range(sz)])
                    ca.weight_sets[bid] = ws
                ids_size = r.u32()
                if ids_size:
                    ca.ids[bid] = [r.i32() for _ in range(ids_size)]
            m.choose_args[key] = ca

    m.refresh_derived()
    return m


def looks_like_crushmap(data: bytes) -> bool:
    return len(data) >= 4 and struct.unpack("<I", data[:4])[0] == CRUSH_MAGIC
