"""The port's PG→OSD pipeline (`ceph_tpu_torch.osd.pipeline.PoolMapper`,
on the CPU) held element-exact against the JAX package: the 16 cases of
tests/test_pipeline_jax.py, each against `ceph_tpu`'s `PoolMapper.map_all`
and `OSDMap.pg_to_up_acting_osds` for every PG.  Maps are built with
`ceph_tpu`'s builders and carried across as plain data
(`osd.carry.osdmap_from_reference`).

`osdmap_dict` also serves tests/test_torch_placement_corpus.py.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu.crush.types import ChooseArgs, ITEM_NONE  # noqa: E402
from ceph_tpu.osd.osdmap import build_hierarchical, build_simple  # noqa: E402
from ceph_tpu.osd.pipeline_jax import PoolMapper as JaxPoolMapper  # noqa: E402
from ceph_tpu.osd.types import PgId, PgPool, PoolType  # noqa: E402
from ceph_tpu_torch.crush import mapper  # noqa: E402
from ceph_tpu_torch.osd.carry import osdmap_from_reference  # noqa: E402
from ceph_tpu_torch.osd.pipeline import PoolMapper, map_cluster  # noqa: E402
from test_torch_crush_mapper import crush_dict  # noqa: E402


def osdmap_dict(m) -> dict:
    """A ceph_tpu OSDMap as the plain data `osdmap_from_reference` reads
    (JSON-able)."""
    d = crush_dict(m.crush)
    d.update({
        "max_osd": int(m.max_osd),
        "osd_state": [int(s) for s in m.osd_state],
        "osd_weight": [int(w) for w in m.osd_weight],
        "osd_primary_affinity": (
            None if m.osd_primary_affinity is None
            else [int(a) for a in m.osd_primary_affinity]),
        "pools": [
            {"id": pid, "name": m.pool_name.get(pid, ""),
             "type": int(p.type), "size": p.size, "min_size": p.min_size,
             "pg_num": p.pg_num, "pgp_num": p.pgp_num,
             "crush_rule": p.crush_rule, "flags": p.flags}
            for pid, p in sorted(m.pools.items())
        ],
        "pg_upmap": [[pg.pool, pg.seed, [int(o) for o in v]]
                     for pg, v in sorted(m.pg_upmap.items())],
        "pg_upmap_items": [[pg.pool, pg.seed,
                            [[int(f), int(t)] for f, t in v]]
                           for pg, v in sorted(m.pg_upmap_items.items())],
        "pg_temp": [[pg.pool, pg.seed, [int(o) for o in v]]
                    for pg, v in sorted(m.pg_temp.items())],
        "primary_temp": [[pg.pool, pg.seed, int(o)]
                         for pg, o in sorted(m.primary_temp.items())],
    })
    return d


def has_overlays(m, pool_id) -> bool:
    return any(pg.pool == pool_id for d in (
        m.pg_upmap, m.pg_upmap_items, m.pg_temp, m.primary_temp) for pg in d)


def check_pool(m, pool_id: int):
    pm = PoolMapper(osdmap_from_reference(osdmap_dict(m)), pool_id,
                    device="cpu")
    got = pm.map_all()
    want = JaxPoolMapper(m, pool_id).map_all()
    W = want[0].shape[1]
    assert got[0].shape == want[0].shape
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    up, upp, acting, actp = got
    pad = lambda v: (list(v) + [ITEM_NONE] * W)[:W]  # noqa: E731
    n = m.pools[pool_id].pg_num
    raw = pm.raw_rows(np.arange(n))
    w_raws = {ps: m._pg_to_raw_osds(m.pools[pool_id], PgId(pool_id, ps))
              for ps in range(n)}
    # the oracle's up/acting walk reuses its own raw rows (each call gets
    # a copy: the walk edits the list it is given)
    m._pg_to_raw_osds = lambda pool, pg: (list(w_raws[pg.seed][0]),
                                          w_raws[pg.seed][1])
    try:
        for ps in range(n):
            w_up, w_upp, w_act, w_actp = m.pg_to_up_acting_osds(
                PgId(pool_id, ps))
            assert list(up[ps]) == pad(w_up), ps
            assert upp[ps] == w_upp, ps
            assert list(acting[ps]) == pad(w_act), ps
            assert actp[ps] == w_actp, ps
            assert list(raw[ps]) == pad(w_raws[ps][0]), ps
    finally:
        del m._pg_to_raw_osds
    # a shuffled subset through map_batch gives the same rows
    rng = np.random.default_rng(pool_id + 17)
    sub = rng.permutation(m.pools[pool_id].pg_num)[:37]
    for g, w in zip(pm.map_batch(sub), got):
        np.testing.assert_array_equal(g, w[sub])
    if not has_overlays(m, pool_id):
        dev_up = pm.map_all_device()
        assert dev_up.device.type == "cpu" and dev_up.dtype == torch.int32
        np.testing.assert_array_equal(dev_up.numpy(), up)
    return pm


def hier_map(rng, pool=None, n_host=8, osd_per_host=4, **kw):
    pool = pool or PgPool(pg_num=128, size=3)
    return build_hierarchical(
        n_host, osd_per_host, pool=pool,
        weight_fn=lambda i: int(rng.integers(1, 4)) * 0x8000, **kw
    )


def test_replicated_clean(rng):
    check_pool(hier_map(rng), 0)


def test_build_simple():
    check_pool(build_simple(8, pg_bits=4), 1)


def test_replicated_down_out(rng):
    m = hier_map(rng)
    for o in rng.choice(m.max_osd, 6, replace=False):
        m.mark_down(int(o))
    for o in rng.choice(m.max_osd, 5, replace=False):
        m.mark_out(int(o))
    check_pool(m, 0)


def _ec_map(rng, size, pg_num):
    pool = PgPool(type=PoolType.ERASURE, size=size, pg_num=pg_num,
                  crush_rule=1)
    m = hier_map(rng, pool)
    m.crush.make_erasure_rule(
        min(m.crush.buckets.keys(), key=lambda b: -m.crush.buckets[b].type), 1
    )
    return m


def test_erasure_down_out(rng):
    m = _ec_map(rng, 6, 128)
    for o in rng.choice(m.max_osd, 6, replace=False):
        m.mark_down(int(o))
    for o in rng.choice(m.max_osd, 4, replace=False):
        m.mark_out(int(o))
    check_pool(m, 0)


def test_primary_affinity(rng):
    m = hier_map(rng)
    for o in range(m.max_osd):
        r = rng.integers(0, 4)
        if r == 0:
            m.set_primary_affinity(o, 0)
        elif r == 1:
            m.set_primary_affinity(o, int(rng.integers(0, 0x10000)))
    check_pool(m, 0)


def test_upmap_full_and_items(rng):
    m = hier_map(rng)
    pool = m.pools[0]
    for ps in rng.choice(pool.pg_num, 20, replace=False):
        ps = int(ps)
        if rng.integers(0, 2) == 0:
            tgt = [int(o) for o in rng.choice(m.max_osd, 3, replace=False)]
            m.pg_upmap[PgId(0, ps)] = tgt
        else:
            frm = int(rng.integers(0, m.max_osd))
            to = int(rng.integers(0, m.max_osd))
            m.pg_upmap_items[PgId(0, ps)] = [(frm, to)]
    for o in rng.choice(m.max_osd, 4, replace=False):
        m.mark_out(int(o))
    check_pool(m, 0)


def test_upmap_multi_pairs(rng):
    m = hier_map(rng)
    pool = m.pools[0]
    for ps in range(0, pool.pg_num, 3):
        raw, _ = m.pg_to_raw_osds(PgId(0, ps))
        if len(raw) < 2:
            continue
        to1 = int((raw[0] + 1) % m.max_osd)
        to2 = int((raw[1] + 7) % m.max_osd)
        m.pg_upmap_items[PgId(0, ps)] = [(raw[0], to1), (raw[1], to2)]
    check_pool(m, 0)


def test_pg_temp_primary_temp(rng):
    m = hier_map(rng)
    pool = m.pools[0]
    for ps in rng.choice(pool.pg_num, 24, replace=False):
        ps = int(ps)
        kind = rng.integers(0, 3)
        if kind == 0:
            tgt = [int(o) for o in rng.choice(m.max_osd, 3, replace=False)]
            m.pg_temp[PgId(0, ps)] = tgt
        elif kind == 1:
            m.primary_temp[PgId(0, ps)] = int(rng.integers(0, m.max_osd))
        else:
            tgt = [int(o) for o in rng.choice(m.max_osd, 2, replace=False)]
            m.pg_temp[PgId(0, ps)] = tgt
            m.primary_temp[PgId(0, ps)] = tgt[-1]
    for o in rng.choice(m.max_osd, 8, replace=False):
        m.mark_down(int(o))
    check_pool(m, 0)


def test_ec_pg_temp(rng):
    m = _ec_map(rng, 4, 64)
    for ps in rng.choice(64, 10, replace=False):
        m.pg_temp[PgId(0, int(ps))] = [
            int(o) for o in rng.choice(m.max_osd, 4, replace=False)
        ]
    for o in rng.choice(m.max_osd, 6, replace=False):
        m.mark_down(int(o))
    check_pool(m, 0)


def test_everything_at_once(rng):
    """All overlays + degraded cluster + affinity, replicated."""
    m = hier_map(rng, PgPool(pg_num=256, size=3), n_host=12, n_rack=3)
    pool = m.pools[0]
    for o in range(m.max_osd):
        if rng.integers(0, 5) == 0:
            m.set_primary_affinity(o, int(rng.integers(0, 0x10001)))
    for o in rng.choice(m.max_osd, 10, replace=False):
        m.mark_down(int(o))
    for o in rng.choice(m.max_osd, 8, replace=False):
        m.mark_out(int(o))
    for ps in rng.choice(pool.pg_num, 40, replace=False):
        ps = int(ps)
        k = rng.integers(0, 4)
        if k == 0:
            m.pg_upmap[PgId(0, ps)] = [
                int(o) for o in rng.choice(m.max_osd, 3, replace=False)
            ]
        elif k == 1:
            m.pg_upmap_items[PgId(0, ps)] = [
                (int(rng.integers(0, m.max_osd)),
                 int(rng.integers(0, m.max_osd))),
                (int(rng.integers(0, m.max_osd)),
                 int(rng.integers(0, m.max_osd))),
            ]
        elif k == 2:
            m.pg_temp[PgId(0, ps)] = [
                int(o) for o in rng.choice(m.max_osd, 3, replace=False)
            ]
        else:
            m.primary_temp[PgId(0, ps)] = int(rng.integers(0, m.max_osd))
    check_pool(m, 0)


def test_nonhashpspool(rng):
    check_pool(hier_map(rng, PgPool(pg_num=64, size=3, flags=0)), 0)


def test_non_pow2_pg_num(rng):
    check_pool(hier_map(rng, PgPool(pg_num=100, size=3, pgp_num=96)), 0)


def test_upmap_rejected_full_skips_items(rng):
    m = hier_map(rng)
    m.mark_out(1)
    for ps in range(0, 32):
        raw, _ = m.pg_to_raw_osds(PgId(0, ps))
        m.pg_upmap[PgId(0, ps)] = [0, 1, 2]  # osd.1 is out -> rejected
        if raw:
            m.pg_upmap_items[PgId(0, ps)] = [(raw[0], (raw[0] + 9) % 32)]
    check_pool(m, 0)


def test_primary_temp_without_pg_temp(rng):
    m = hier_map(rng)
    for ps in range(0, 64, 5):
        m.primary_temp[PgId(0, ps)] = int(rng.integers(0, m.max_osd))
    check_pool(m, 0)


def test_choose_args_default_fallback(rng):
    m = hier_map(rng)
    ca = ChooseArgs()
    for bid, b in m.crush.buckets.items():
        ca.weight_sets[bid] = [
            [max(1, w // 2 + int(rng.integers(0, w + 1))) for w in b.weights]
        ]
    m.crush.choose_args[-1] = ca
    check_pool(m, 0)


def test_choose_args_positions_gt1_pipeline(rng):
    m = hier_map(rng, pool=PgPool(pg_num=64, size=3), n_host=4)
    pid = sorted(m.pools)[0]
    ca = ChooseArgs()
    for bid, b in m.crush.buckets.items():
        ca.weight_sets[bid] = [
            [int(w) for w in rng.integers(1, 3 * 0x10000, b.size)]
            for _ in range(2)
        ]
    m.crush.choose_args[pid] = ca
    pm = check_pool(m, pid)
    assert pm.arrays.positions == 2


# -- the port's own rules ------------------------------------------------------

def test_pool_mapper_defaults_to_the_card(rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    m = osdmap_from_reference(osdmap_dict(hier_map(rng)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoolMapper(m, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        map_cluster(m)


def test_map_cluster_and_no_kernel_on_cpu(rng):
    """map_cluster maps every pool; the CPU path never counts a kernel
    launch (a CPU tensor never reaches the kernel)."""
    jm = hier_map(rng)
    jm.add_pool("two", PgPool(pg_num=32, size=2, flags=0))
    m = osdmap_from_reference(osdmap_dict(jm))
    before = mapper.crush_rule_cuda.launches
    got = map_cluster(m, device="cpu")
    assert sorted(got) == [0, 1]
    for pid, rows in got.items():
        for g, w in zip(rows, JaxPoolMapper(jm, pid).map_all()):
            np.testing.assert_array_equal(g, w)
    assert mapper.crush_rule_cuda.launches == before


def test_overlay_free_paths_refuse_overlays(rng):
    m = hier_map(rng)
    m.pg_temp[PgId(0, 3)] = [1, 2, 3]
    pm = PoolMapper(osdmap_from_reference(osdmap_dict(m)), 0, device="cpu")
    with pytest.raises(ValueError, match="overlay-free"):
        pm.map_all_device()
    with pytest.raises(ValueError, match="outside"):
        pm.map_batch([0, 128])


def test_refresh_dev_follows_osd_state(rng):
    jm = hier_map(rng)
    m = osdmap_from_reference(osdmap_dict(jm))
    pm = PoolMapper(m, 0, device="cpu")
    for o in (3, 9, 17):
        jm.mark_out(o)
        m.mark_out(o)
    pm.refresh_dev()
    for g, w in zip(pm.map_all(), JaxPoolMapper(jm, 0).map_all()):
        np.testing.assert_array_equal(g, w)


def test_carry_checks_shapes(rng):
    d = osdmap_dict(hier_map(rng))
    d["osd_weight"] = d["osd_weight"][:-1]
    with pytest.raises(ValueError, match="osd_weight"):
        osdmap_from_reference(d)
    d = osdmap_dict(hier_map(rng))
    d["buckets"][0]["weights"] = d["buckets"][0]["weights"] + [1]
    with pytest.raises(ValueError, match="weights"):
        osdmap_from_reference(d)
    d = osdmap_dict(hier_map(rng))
    d["max_osd"] = 1.5
    with pytest.raises(ValueError, match="max_osd"):
        osdmap_from_reference(d)
