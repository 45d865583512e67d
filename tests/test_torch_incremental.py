"""The port's OSDMap::Incremental (`ceph_tpu_torch.osd.incremental`) held
byte for byte to the JAX package's: the cases of tests/test_incremental.py
run through both packages.  `encode_incremental` gives equal bytes,
`decode_incremental` round-trips (and reads the other package's bytes),
and `apply_incremental` gives maps whose `encode_osdmap` bytes are equal;
the guards raise alike.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _api(pkg: str) -> SimpleNamespace:
    if pkg == "jax":
        from ceph_tpu.crush import codec as crush_codec
        from ceph_tpu.osd import codec, incremental, osdmap, types
    else:
        from ceph_tpu_torch.crush import codec as crush_codec
        from ceph_tpu_torch.osd import codec, incremental, osdmap, types
    return SimpleNamespace(
        Incremental=incremental.Incremental,
        encode=incremental.encode_incremental,
        decode=incremental.decode_incremental,
        apply=incremental.apply_incremental,
        looks_like=incremental.looks_like_incremental,
        encode_osdmap=codec.encode_osdmap, decode_osdmap=codec.decode_osdmap,
        encode_crushmap=crush_codec.encode_crushmap,
        build_hierarchical=osdmap.build_hierarchical,
        build_simple=osdmap.build_simple,
        OSD_EXISTS=osdmap.OSD_EXISTS, OSD_UP=osdmap.OSD_UP,
        PgId=types.PgId, PgPool=types.PgPool, PoolType=types.PoolType)


API = {pkg: _api(pkg) for pkg in ("jax", "port")}


def small_map(P):
    return P.build_hierarchical(4, 4, n_rack=2, pool=P.PgPool(
        type=P.PoolType.REPLICATED, size=3, crush_rule=0,
        pg_num=64, pgp_num=64))


def both(scenario):
    """scenario(P) for each package; the two results must be equal."""
    want, got = scenario(API["jax"]), scenario(API["port"])
    assert got == want
    return got


def outcome(fn):
    """("ok", value) or (exception type name, message) of fn()."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return (type(e).__name__, str(e))


# -- codec ---------------------------------------------------------------------

def _fields_inc(P):
    inc = P.Incremental(epoch=9)
    inc.new_max_osd = 20
    inc.new_flags = 0x18000
    inc.new_pool_max = 3
    inc.new_weight = {3: 0, 7: 0x8000}
    inc.new_state = {3: P.OSD_UP, 5: P.OSD_EXISTS | P.OSD_UP}
    inc.new_primary_affinity = {2: 0x4000}
    inc.new_pg_temp = {P.PgId(1, 4): [2, 0, 1], P.PgId(1, 9): []}
    inc.new_primary_temp = {P.PgId(1, 4): 2, P.PgId(1, 5): -1}
    inc.new_pg_upmap = {P.PgId(1, 7): [3, 2, 1]}
    inc.old_pg_upmap = {P.PgId(1, 8)}
    inc.new_pg_upmap_items = {P.PgId(1, 2): [(0, 5), (1, 6)]}
    inc.old_pg_upmap_items = {P.PgId(1, 3)}
    inc.new_erasure_code_profiles = {"p1": {"k": "4", "m": "2"}}
    inc.old_erasure_code_profiles = ["dead"]
    inc.new_pool_names = {2: "renamed"}
    inc.old_pools = {9}
    return inc


def _pool_crush_inc(P):
    inc = P.Incremental(epoch=2)
    inc.new_pools[5] = P.PgPool(type=P.PoolType.REPLICATED, size=2,
                                crush_rule=0, pg_num=32, pgp_num=32)
    inc.new_pool_names[5] = "newpool"
    inc.crush = P.encode_crushmap(small_map(P).crush)
    return inc


INCS = {
    "empty": lambda P: P.Incremental(epoch=5),
    "fields": _fields_inc,
    "pool_and_crush": _pool_crush_inc,
}


@pytest.mark.parametrize("name", sorted(INCS))
def test_encode_equal_and_round_trips(name):
    def scenario(P):
        blob = P.encode(INCS[name](P))
        again = P.encode(P.decode(blob))
        assert again == blob  # decode -> encode is byte-exact
        return blob

    blob = both(scenario)
    # each package reads the other's bytes
    port, jax = API["port"], API["jax"]
    assert port.encode(port.decode(jax.encode(INCS[name](jax)))) == blob
    assert port.looks_like(blob) and not port.looks_like(b"\0" * 64)


def test_decoded_fields_equal():
    def scenario(P):
        out = P.decode(P.encode(_fields_inc(P)))
        return {f: repr(getattr(out, f)) for f in (
            "new_max_osd", "new_flags", "new_pool_max", "new_weight",
            "new_state", "new_primary_affinity", "new_pg_temp",
            "new_primary_temp", "new_pg_upmap", "old_pg_upmap",
            "new_pg_upmap_items", "old_pg_upmap_items",
            "new_erasure_code_profiles", "old_erasure_code_profiles",
            "new_pool_names", "old_pools")}

    both(scenario)


def test_crc_guard():
    def scenario(P):
        blob = bytearray(P.encode(P.Incremental(epoch=3)))
        blob[20] ^= 0xFF
        return outcome(lambda: P.decode(bytes(blob)))

    kind, msg = both(scenario)
    assert kind == "CodecError" and "crc" in msg


# -- apply ---------------------------------------------------------------------

def test_apply_guards():
    def scenario(P):
        m = small_map(P)
        epoch = outcome(lambda: P.apply(m, P.Incremental(epoch=m.epoch + 2)))
        m.wire = {"fsid": b"A" * 16, "pools": {}}
        fsid = outcome(lambda: P.apply(
            m, P.Incremental(epoch=m.epoch + 1, fsid=b"B" * 16)))
        return epoch, fsid

    (k1, m1), (k2, m2) = both(scenario)
    assert k1 == k2 == "ValueError" and "epoch" in m1 and "fsid" in m2


def test_apply_chain_equals_direct_mutation():
    """A 4-epoch chain: each link round-trips, and the chained map's
    bytes equal the directly mutated map's in both packages."""
    def scenario(P):
        m, d = small_map(P), small_map(P)
        base = m.epoch
        chain = []
        inc = P.Incremental(epoch=base + 1)
        inc.new_weight = {2: 0}
        inc.new_state = {3: P.OSD_UP}  # mark osd.3 down (XOR of UP)
        chain.append(P.encode(inc))
        d.osd_weight[2] = 0
        d.osd_state[3] &= ~P.OSD_UP
        inc = P.Incremental(epoch=base + 2)
        inc.new_pg_upmap_items = {P.PgId(0, 5): [(1, 9)]}
        inc.new_pg_temp = {P.PgId(0, 7): [8, 9, 10]}
        inc.new_primary_temp = {P.PgId(0, 7): 9}
        chain.append(P.encode(inc))
        d.pg_upmap_items[P.PgId(0, 5)] = [(1, 9)]
        d.pg_temp[P.PgId(0, 7)] = [8, 9, 10]
        d.primary_temp[P.PgId(0, 7)] = 9
        inc = P.Incremental(epoch=base + 3)
        inc.new_weight = {2: 0x10000}
        inc.new_pg_temp = {P.PgId(0, 7): []}
        inc.new_primary_temp = {P.PgId(0, 7): -1}
        inc.old_pg_upmap_items = {P.PgId(0, 5)}
        chain.append(P.encode(inc))
        d.osd_weight[2] = 0x10000
        del d.pg_temp[P.PgId(0, 7)]
        del d.primary_temp[P.PgId(0, 7)]
        del d.pg_upmap_items[P.PgId(0, 5)]
        inc = P.Incremental(epoch=base + 4)
        inc.new_erasure_code_profiles = {
            "ec42": {"k": "4", "m": "2", "plugin": "jax"}}
        inc.new_pool_names = {0: "rbd-renamed"}
        chain.append(P.encode(inc))
        d.erasure_code_profiles["ec42"] = {"k": "4", "m": "2",
                                           "plugin": "jax"}
        d.pool_name[0] = "rbd-renamed"
        d.epoch = base + 4
        for blob in chain:
            m = P.apply(m, P.decode(blob))
        for f in ("epoch", "osd_weight", "osd_state", "pg_temp",
                  "primary_temp", "pg_upmap_items", "erasure_code_profiles",
                  "pool_name"):
            assert getattr(m, f) == getattr(d, f), f
        out = P.encode_osdmap(m)
        assert P.encode_osdmap(P.decode_osdmap(out)) == out
        return chain, out

    both(scenario)


def test_apply_destroy_and_new_up():
    def scenario(P):
        m = small_map(P)
        inc = P.Incremental(epoch=m.epoch + 1)
        inc.new_state = {1: P.OSD_EXISTS}  # destroy osd.1
        inc.new_max_osd = m.max_osd + 1
        inc.new_up_client = {m.max_osd: b""}
        inc.new_weight = {m.max_osd: 0x10000}
        m = P.apply(m, P.decode(P.encode(inc)))
        assert not m.exists(1) and m.is_up(m.max_osd - 1)
        return P.encode_osdmap(m)

    both(scenario)


def test_apply_fullmap():
    def scenario(P):
        m = small_map(P)
        target = P.build_simple(8, 5, 5)
        target.epoch = m.epoch + 1
        inc = P.Incremental(epoch=m.epoch + 1)
        inc.fullmap = P.encode_osdmap(target)
        out = P.apply(m, inc)
        assert out.max_osd == 8
        return P.encode_osdmap(out)

    both(scenario)


def test_apply_new_pool_weight_and_crush():
    """A new pool, a weight, a down OSD and a new crush blob in one
    delta; the mapping of the new map follows."""
    def scenario(P):
        m = small_map(P)
        inc = _pool_crush_inc(P)
        inc.epoch = m.epoch + 1
        inc.new_pool_max = 5
        inc.new_weight = {4: 0}
        inc.new_state = {4: P.OSD_UP}
        m = P.apply(m, P.decode(P.encode(inc)))
        rows = [m.pg_to_up_acting_osds(P.PgId(pid, ps))
                for pid in sorted(m.pools) for ps in range(8)]
        assert all(4 not in up for up, _, _, _ in rows)
        return P.encode_osdmap(m), rows

    both(scenario)
