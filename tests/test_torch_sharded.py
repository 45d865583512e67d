"""`ceph_tpu_torch.parallel.sharded` against `ceph_tpu.parallel.sharded`.

The cases of tests/test_sharded.py on the port: `ShardedClusterMapper`
over a mesh of one CPU device repeated (the port's stand-in for XLA's
forced host devices, so the split-block equivalence runs on one device)
gives the JAX `ShardedClusterMapper`'s rows and histograms on the
conftest's 8 forced CPU devices, exactly, at the same shapes (uneven
shards, several pools).  B.14's `rebalance_step` gives the JAX `step`'s
`new_w` exactly and its `stddev` within the JAX test's 1e-3 relative
tolerance, and the split pipeline launches the rule once per block.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ceph_tpu.osd.osdmap import build_hierarchical as jax_build
from ceph_tpu.osd.types import PgPool as JPgPool
from ceph_tpu.osd.types import PoolType as JPoolType
from ceph_tpu.parallel import sharded as jsharded

from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.osd.osdmap import build_hierarchical
from ceph_tpu_torch.osd.pipeline import PoolMapper
from ceph_tpu_torch.osd.types import PgId, PgPool, PoolType
from ceph_tpu_torch.parallel import sharded
from ceph_tpu_torch.parallel.sharded import Mesh, ShardedClusterMapper

CPU = torch.device("cpu")


def hier(pkg_build, pool_cls, ptype, pg_num=96, size=3, wf=None):
    pool = pool_cls(type=ptype.REPLICATED, size=size, crush_rule=0,
                    pg_num=pg_num, pgp_num=pg_num)
    kw = {"weight_fn": wf} if wf is not None else {}
    return pkg_build(4, 4, n_rack=2, pool=pool, **kw)


def both(pg_num=96, size=3, wf=None):
    return (hier(build_hierarchical, PgPool, PoolType, pg_num, size, wf),
            hier(jax_build, JPgPool, JPoolType, pg_num, size, wf))


def cpu_mesh(n):
    return Mesh([CPU] * n)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n_dev, pg_num", [(2, 96), (8, 96), (2, 101),
                                           (8, 101)])
def test_sharded_equals_jax_and_unsharded(n_dev, pg_num):
    m, jm = both(pg_num)
    out = ShardedClusterMapper(m, 0, cpu_mesh(n_dev)).map_stats()
    jout = jsharded.ShardedClusterMapper(
        jm, 0, jsharded.make_mesh(n_dev)).map_stats()
    for k in ("up", "up_primary", "acting", "acting_primary",
              "pgs_per_osd", "primary_per_osd", "first_per_osd"):
        assert np.array_equal(_np(out[k]), np.asarray(jout[k])), k
    want = PoolMapper(m, 0, device="cpu", overlays=False).map_all()
    for got, w in zip((out["up"], out["up_primary"], out["acting"],
                       out["acting_primary"]), want):
        assert np.array_equal(_np(got)[:pg_num], w)


def test_histograms_match_host_recount():
    pg_num = 101
    m, _ = both(pg_num)
    scm = ShardedClusterMapper(m, 0, cpu_mesh(8))
    out = scm.map_stats()
    acting = _np(out["acting"])[:pg_num]
    actp = _np(out["acting_primary"])[:pg_num]
    n = scm.DV
    hist, phist, fhist = (np.zeros(n, np.int64) for _ in range(3))
    for row, p in zip(acting, actp):
        osds = [o for o in row if o != ITEM_NONE and o >= 0]
        for o in osds:
            hist[o] += 1
        if osds:
            fhist[osds[0]] += 1
        if p >= 0:
            phist[p] += 1
    assert np.array_equal(_np(out["pgs_per_osd"]), hist)
    assert np.array_equal(_np(out["primary_per_osd"]), phist)
    assert np.array_equal(_np(out["first_per_osd"]), fhist)


def test_sharded_matches_host_oracle_rows():
    pg_num = 64
    m, _ = both(pg_num)
    out = ShardedClusterMapper(m, 0, cpu_mesh(4)).map_stats()
    acting = _np(out["acting"])[:pg_num]
    actp = _np(out["acting_primary"])[:pg_num]
    for ps in range(0, pg_num, 7):
        _, _, a, ap = m.pg_to_up_acting_osds(PgId(0, ps))
        w = acting.shape[1]
        assert list(acting[ps]) == list(a) + [ITEM_NONE] * (w - len(a))
        assert int(actp[ps]) == ap


def test_multi_pool():
    m, jm = both(64)
    for mm, pool_cls, ptype in ((m, PgPool, PoolType),
                                (jm, JPgPool, JPoolType)):
        mm.add_pool("small", pool_cls(type=ptype.REPLICATED, size=2,
                                      crush_rule=0, pg_num=33,
                                      pgp_num=33))
    for pid, pool in m.pools.items():
        out = ShardedClusterMapper(m, pid, cpu_mesh(8)).map_stats()
        jout = jsharded.ShardedClusterMapper(
            jm, pid, jsharded.make_mesh(8)).map_stats()
        acting = _np(out["acting"])[:pool.pg_num]
        assert np.array_equal(acting,
                              np.asarray(jout["acting"])[:pool.pg_num])
        assert np.array_equal(_np(out["pgs_per_osd"]),
                              np.asarray(jout["pgs_per_osd"]))
        assert int(_np(out["pgs_per_osd"]).sum()) == int(
            (acting != ITEM_NONE).sum())


def _skewed():
    rng = np.random.default_rng(7)
    ws = [int(rng.integers(1, 4) * 0x10000) for _ in range(16)]
    return both(256, wf=lambda i: ws[i])


@pytest.mark.parametrize("case", ["uniform", "skewed"])
def test_rebalance_step_equals_jax(case):
    """B.14: three steps fed back, as the JAX convergence test feeds
    them; new_w exact, stddev within 1e-3 relative, hist exact."""
    m, jm = both(128) if case == "uniform" else _skewed()
    scm = ShardedClusterMapper(m, 0, cpu_mesh(8))
    jscm = jsharded.ShardedClusterMapper(jm, 0, jsharded.make_mesh(8))
    w = jw = None
    for _ in range(3):
        new_w, sd, hist = scm.rebalance_step(w)
        jnew_w, jsd, jhist = jscm.rebalance_step(jw)
        assert np.array_equal(_np(hist), np.asarray(jhist))
        assert np.array_equal(_np(new_w), np.asarray(jnew_w).astype(
            np.int64))
        assert abs(float(sd) - float(jsd)) <= 1e-3 * max(float(jsd), 1.0)
        w, jw = _np(new_w), np.asarray(jnew_w)


def test_rebalance_update_follows_the_documented_rule():
    pg_num = 128
    m, _ = both(pg_num)
    scm = ShardedClusterMapper(m, 0, cpu_mesh(8))
    new_w, stddev, hist = scm.rebalance_step()
    hist = _np(hist)
    assert np.array_equal(hist, _np(scm.map_stats()["pgs_per_osd"]))
    w = _np(scm.pm.dev["weight"]).astype(np.float64)
    target = pg_num * 3 * w / max(w.sum(), 1.0)
    ratio = np.clip(target / np.maximum(hist.astype(np.float64), 1.0),
                    0.5, 2.0)
    expect = np.where((w > 0) & (target > 0),
                      np.clip(w * ratio, 1.0, None), w).astype(np.int64)
    assert np.array_equal(_np(new_w), expect)
    expect_sd = np.sqrt(((hist - target) ** 2).sum()
                        / max(int((w > 0).sum()), 1))
    assert abs(float(stddev) - expect_sd) < 1e-3 * max(expect_sd, 1.0)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_one_rule_launch_per_block(n_dev, monkeypatch):
    from ceph_tpu_torch.osd import pipeline

    calls = []
    real = pipeline.map_rule

    def counting(T, prog, x, weight):
        calls.append(int(x.numel()))
        return real(T, prog, x, weight)

    monkeypatch.setattr(pipeline, "map_rule", counting)
    m, _ = both(101)
    ShardedClusterMapper(m, 0, cpu_mesh(n_dev)).map_stats()
    pad = -(-101 // n_dev) * n_dev
    assert calls == [pad // n_dev] * n_dev


def test_split_mapper_equals_unsplit_across_entry_points():
    m, _ = both(101)
    one = PoolMapper(m, 0, device="cpu", overlays=False)
    split = PoolMapper(m, 0, device="cpu", overlays=False,
                       mesh=cpu_mesh(3))
    for a, b in zip(one.map_all(), split.map_all()):
        assert np.array_equal(a, b)
    assert torch.equal(one.map_all_device(), split.map_all_device())
    seeds = np.arange(0, 101, 5)
    assert np.array_equal(one.raw_rows(seeds), split.raw_rows(seeds))
