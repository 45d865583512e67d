"""Every `mesh=` of the port against the JAX package's, on the CPU.

The cases of tests/test_multichip.py: the `CEPH_TPU_MESH_DEVICES` knob
and the requested-vs-actual record of `make_mesh`; a split ClusterState
serves the unsplit state's rows and the JAX meshed state's, across a
value-only delta; the mgr scores a split state as the JAX mgr scores its
meshed one; `calc_pg_upmaps(mesh=...)` plans the JAX meshed plan on the
device and device_loop backends; a lifetime run and a fleet on a split
mesh chain the unsplit digests (the JAX corpus's); the placement
service answers the same on any split and reports its mesh; and the
`meshcheck` worker's digest is the JAX worker's
(tests/data/meshcheck.json, rewritten by `python
tests/test_torch_multichip.py`).

A split here is a `Mesh` of the CPU repeated N times: every block is one
rule launch of its own and the rows are gathered on the first device,
as a mesh of cards does (the JAX side uses the conftest's 8 forced CPU
devices).
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from ceph_tpu_torch import runtime  # noqa: E402
from ceph_tpu_torch.crush.types import ITEM_NONE  # noqa: E402
from ceph_tpu_torch.osd.incremental import Incremental  # noqa: E402
from ceph_tpu_torch.osd.osdmap import build_hierarchical  # noqa: E402
from ceph_tpu_torch.osd.state import ClusterState  # noqa: E402
from ceph_tpu_torch.osd.types import PgId, PgPool, PoolType  # noqa: E402
from ceph_tpu_torch.parallel import sharded  # noqa: E402
from ceph_tpu_torch.parallel.sharded import Mesh  # noqa: E402
from ceph_tpu_torch.utils import platform  # noqa: E402

MESHCHECK = ROOT / "tests" / "data" / "meshcheck.json"
CPU = torch.device("cpu")


def cpu_mesh(n: int) -> Mesh:
    return Mesh([CPU] * n)


def hier(pkg_build, pool_cls, ptype, pg_num=96, n_host=4, per=4):
    pool = pool_cls(type=ptype.REPLICATED, size=3, crush_rule=0,
                    pg_num=pg_num, pgp_num=pg_num)
    return pkg_build(n_host, per, n_rack=2, pool=pool)


def port_hier(**kw):
    return hier(build_hierarchical, PgPool, PoolType, **kw)


def jax_hier(**kw):
    from ceph_tpu.osd.osdmap import build_hierarchical as jb
    from ceph_tpu.osd.types import PgPool as JP
    from ceph_tpu.osd.types import PoolType as JT

    return hier(jb, JP, JT, **kw)


def skew(m, down=6, seed=5, n=32):
    rng = np.random.default_rng(seed)
    for o in rng.choice(n, down, replace=False):
        m.osd_weight[int(o)] = int(0x10000 * 0.6)
    return m


@pytest.fixture
def on_cpu_ladder(monkeypatch):
    """The backend ladder descends to the host: one device."""
    monkeypatch.setenv("CEPH_TPU_LADDER", "cuda,cpu")
    platform._checked = None
    sharded._DEFAULT_MESH.clear()
    with pytest.warns(RuntimeWarning) if not torch.cuda.is_available() \
            else contextlib.nullcontext():
        runtime.acquire_backend(watchdog=False, attempts=1)
    yield
    platform._checked = None
    sharded._DEFAULT_MESH.clear()


# -- mesh knob + provenance -------------------------------------------------

def test_default_mesh_none_when_unset(monkeypatch):
    monkeypatch.delenv("CEPH_TPU_MESH_DEVICES", raising=False)
    assert sharded.default_mesh() is None
    monkeypatch.setenv("CEPH_TPU_MESH_DEVICES", "1")
    assert sharded.default_mesh() is None  # <=1 = one device


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_make_mesh_records_requested_vs_actual(on_cpu_ladder):
    mesh = sharded.make_mesh(64, allow_fewer=True)
    prov = sharded.last_mesh_provenance()
    assert mesh.size == prov["actual"] == 1
    assert prov["requested"] == 64 and prov["degraded"] is True
    assert prov["backend"] == "cpu" and "no CUDA device" in \
        prov["fallback_reason"]
    with pytest.raises(RuntimeError, match="need 64 devices"):
        sharded.make_mesh(64)
    sharded.make_mesh(1)
    assert sharded.last_mesh_provenance()["degraded"] is False


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_mesh_degrades_oversized_knob(on_cpu_ladder, monkeypatch):
    monkeypatch.setenv("CEPH_TPU_MESH_DEVICES", "4")
    mesh = sharded.default_mesh()
    assert mesh is not None and mesh.size == 1
    assert sharded.last_mesh_provenance()["degraded"] is True
    # a consumer on the host is never split by the knob
    st = ClusterState(port_hier(pg_num=32), device="cpu")
    assert st.mesh is None


@pytest.mark.parametrize("consumer", ["state", "service", "lifetime"])
def test_host_consumer_reads_no_mesh_knob(consumer, monkeypatch):
    """With CEPH_TPU_MESH_DEVICES=4 and no ladder named, a consumer asked
    onto the host builds unsplit, walks no backend ladder (which raises
    without a card) and builds no default mesh."""
    monkeypatch.setenv("CEPH_TPU_MESH_DEVICES", "4")
    monkeypatch.delenv("CEPH_TPU_LADDER", raising=False)
    platform._checked = None
    sharded._DEFAULT_MESH.clear()
    m = port_hier(pg_num=32)
    if consumer == "state":
        assert ClusterState(m, device="cpu").mesh is None
    elif consumer == "service":
        from ceph_tpu_torch.serve.service import PlacementService

        svc = PlacementService(m, device="cpu")
        try:
            assert svc.mesh is None
            assert svc.status()["mesh"]["devices"] == 1
        finally:
            svc.close()
    else:
        from ceph_tpu_torch.sim.lifetime import LifetimeSim

        sim = LifetimeSim("epochs=2,pgs=16,ec=,checkpoint_every=0",
                          device="cpu")
        assert sim.mesh is None and sim.state.mesh is None
    assert platform._checked is None
    assert sharded._DEFAULT_MESH == {}


# -- split ClusterState == unsplit == JAX meshed == oracle -------------------

@pytest.fixture(scope="module")
def states():
    from ceph_tpu.osd.state import ClusterState as JClusterState
    from ceph_tpu.parallel.sharded import make_mesh as jmake_mesh

    return (ClusterState(port_hier(), device="cpu", mesh=cpu_mesh(2)),
            ClusterState(port_hier(), device="cpu"),
            JClusterState(jax_hier(), mesh=jmake_mesh(2)))


def test_rows_equal_and_oracle(states):
    split, one, jst = states
    a = split.rows(0)[0].numpy()
    assert np.array_equal(a, one.rows(0)[0].numpy())
    assert np.array_equal(a, np.asarray(jst.rows(0)[0]))
    for ps in range(0, 96, 7):
        up = split.m.pg_to_up_acting_osds(PgId(0, ps))[0]
        assert [int(o) for o in a[ps] if o != ITEM_NONE] == up


def test_value_delta_apply_under_mesh(states):
    from ceph_tpu.osd.incremental import Incremental as JIncremental

    for st, Inc in zip(states, (Incremental, Incremental, JIncremental)):
        inc = Inc(epoch=st.m.epoch + 1)
        inc.new_weight[3] = int(0x10000 * 0.7)
        inc.new_state[7] = 4  # OSD_UP xor: mark osd.7 down
        assert st.apply(inc) == "delta"
    split, one, jst = states
    r, _, t1 = split.rows(0)
    assert np.array_equal(r.numpy(), one.rows(0)[0].numpy())
    assert np.array_equal(r.numpy(), np.asarray(jst.rows(0)[0]))
    _, _, t2 = split.rows(0)
    assert t1 == t2


def test_mgr_eval_scores_identically(states):
    from ceph_tpu.mgr import MappingState as JMappingState
    from ceph_tpu.mgr import synthetic_pg_stats as jstats
    from ceph_tpu.mgr.eval import calc_eval as jcalc

    from ceph_tpu_torch.mgr import MappingState, synthetic_pg_stats
    from ceph_tpu_torch.mgr.eval import calc_eval

    split, one, jst = states
    pe_split = calc_eval(MappingState(split.m, synthetic_pg_stats(split.m),
                                      state=split))
    pe = calc_eval(MappingState(one.m, synthetic_pg_stats(one.m),
                                state=one))
    # the standalone mapping path splits over the mesh argument
    pe_arg = calc_eval(MappingState(one.m, synthetic_pg_stats(one.m),
                                    device="cpu", mesh=cpu_mesh(3)))
    jpe = jcalc(JMappingState(jst.m, jstats(jst.m), state=jst))
    assert pe_split.score == pe.score == pe_arg.score == jpe.score
    assert pe_split.count_by_pool == jpe.count_by_pool


# -- calc_pg_upmaps under a mesh --------------------------------------------

@pytest.mark.parametrize("backend", ["device", "device_loop"])
def test_mesh_plan_equals_jax(backend):
    from ceph_tpu.balancer import calc_pg_upmaps as jcalc
    from ceph_tpu.parallel.sharded import make_mesh as jmake_mesh

    from ceph_tpu_torch.balancer import calc_pg_upmaps

    m1 = skew(port_hier(pg_num=512, n_host=8))
    m2 = skew(port_hier(pg_num=512, n_host=8))
    jm = skew(jax_hier(pg_num=512, n_host=8))
    kw = dict(max_deviation=2, max_iter=48, backend=backend)
    r1 = calc_pg_upmaps(m1, rng=np.random.default_rng(5), device="cpu",
                        **kw)
    r2 = calc_pg_upmaps(m2, rng=np.random.default_rng(5),
                        mesh=cpu_mesh(2), **kw)
    jr = jcalc(jm, rng=np.random.default_rng(5), mesh=jmake_mesh(2), **kw)

    def items(d):
        return {(pg.pool, pg.seed): [tuple(map(int, p)) for p in v]
                for pg, v in d.items()}

    assert items(m1.pg_upmap_items) == items(m2.pg_upmap_items) \
        == items(jm.pg_upmap_items)
    assert r1.moves == r2.moves
    assert r2.stddev == jr.stddev and r2.max_deviation == jr.max_deviation


# -- lifetime and fleet digests under a mesh ---------------------------------

def test_split_lifetime_digest_identity():
    """A lifetime run whose ClusterState splits over 4 blocks chains the
    unsplit digest, the JAX corpus's."""
    from test_torch_lifetime import SCENARIOS, _corpus

    from ceph_tpu_torch.sim.lifetime import LifetimeSim

    out = LifetimeSim(SCENARIOS["tiny"][0], backend="torch",
                      mesh=cpu_mesh(4)).run()
    assert out["digest"] == _corpus()["tiny"]["digest"]
    assert out["invariant_violations"] == 0


def test_split_fleet_digest_identity():
    from ceph_tpu_torch.fleet.engine import FleetSim
    from ceph_tpu_torch.fleet.spec import parse_fleet

    spec = ("base=epochs=3,hosts=4,osds_per_host=3,racks=2,pgs=32,"
            "ec_pgs=16,chunk=256,balance_every=2;axis=correlated:0|1")
    one = FleetSim(parse_fleet(spec), device="cpu")
    one.run()
    split = FleetSim(parse_fleet(spec), mesh=cpu_mesh(3))
    split.run()
    assert split.digests() == one.digests()
    assert all(s.state.mesh.size == 3 for s in split.engines)


# -- the serving buffer and the meshcheck worker -----------------------------

@pytest.mark.parametrize("split", [1, 2, 8])
def test_meshcheck_digest_equals_jax(split):
    from ceph_tpu_torch.serve import meshcheck

    want = json.loads(MESHCHECK.read_text())
    out = meshcheck.run(device="cpu", split=split)
    assert out["digest"] == want["digest"]
    assert out["oracle_match"] is True
    assert out["mesh"]["devices"] == split
    assert out["devices"] == 1


def test_meshcheck_main_prints_one_json_line():
    from ceph_tpu_torch.serve import meshcheck

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert meshcheck.main(["--device", "cpu", "--split", "2",
                               "--pgs", "64", "--osds", "8"]) == 0
    out = json.loads(buf.getvalue())
    assert set(out) == {"digest", "oracle_match", "devices", "mesh"}
    assert out["oracle_match"] is True


def test_service_under_mesh_answers_the_same():
    from ceph_tpu_torch.serve import meshcheck
    from ceph_tpu_torch.serve.service import PlacementService, ServeConfig

    m = meshcheck.build_default(pgs=64, osds=8)
    cfg = ServeConfig(block=32, bulk_max=64, deadline_s=5.0)
    digests = []
    for mesh in (None, cpu_mesh(2)):
        svc = PlacementService(m, config=cfg, name="test.mesh",
                               device="cpu", mesh=mesh)
        try:
            digests.append(svc.sample_digest())
            assert svc.status()["mesh"]["devices"] == \
                (1 if mesh is None else 2)
            assert svc._active.state.mesh is mesh
        finally:
            svc.close()
    assert digests[0] == digests[1]


def _write_meshcheck() -> None:
    from ceph_tpu.serve import meshcheck as jmeshcheck

    r = jmeshcheck.run()
    MESHCHECK.write_text(json.dumps({
        "_doc": "ceph_tpu.serve.meshcheck.run() of the default witness "
                "map on the JAX package, on the CPU; rewritten by "
                "python tests/test_torch_multichip.py",
        "digest": r["digest"], "oracle_match": r["oracle_match"],
        "pgs": jmeshcheck.DEFAULT_PGS, "osds": jmeshcheck.DEFAULT_OSDS,
    }, indent=1) + "\n")


if __name__ == "__main__":
    _write_meshcheck()
