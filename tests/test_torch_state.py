"""The port's ClusterState (`ceph_tpu_torch.osd.state`, on the CPU) held
exact against `ceph_tpu.osd.state.ClusterState`.

Both states start from the same map (`tests/test_state.py::_mk_map`, the
port's copy carried over as plain data) and take the same Incremental
chains: value-only, a structural split, a choose_args value delta,
destroy/revive, the CEPH_TPU_STATE_DELTA knob, a fork, and a delta on OSD
DV - 1 (the last real slot of the vectors, beside the scatter's spare
slot).  After every step these are equal, with no tolerance:
`classify_incremental`'s kind and info, the kind `apply` returns, the
instance counts `delta_applies` / `full_rebuilds`, `rows(pid)` (and the
rows of a fresh state on the same map), and `host_up` on the overlay
seeds and on sampled seeds.
"""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu.crush.codec import encode_crushmap as jax_encode_crushmap  # noqa: E402
from ceph_tpu.mgr.module import compat_ws_to_choose_args as jax_compat_ws  # noqa: E402
from ceph_tpu.osd import incremental as jax_incremental  # noqa: E402
from ceph_tpu.osd import state as jax_state  # noqa: E402
from ceph_tpu.osd.osdmap import IN_WEIGHT, OSD_EXISTS, OSD_UP  # noqa: E402
from ceph_tpu.osd.osdmap import build_hierarchical  # noqa: E402
from ceph_tpu.osd.types import PgId as JaxPgId  # noqa: E402
from ceph_tpu.osd.types import PgPool, PoolType  # noqa: E402
from ceph_tpu_torch.osd import incremental  # noqa: E402
from ceph_tpu_torch.osd import state  # noqa: E402
from ceph_tpu_torch.osd.carry import osdmap_from_reference  # noqa: E402
from ceph_tpu_torch.osd.pipeline import PoolMapper  # noqa: E402
from ceph_tpu_torch.osd.types import PgId  # noqa: E402
from test_torch_pipeline import osdmap_dict  # noqa: E402

N_PGS = 32


def _mk_map(n_host=4, per=2):
    """tests/test_state.py::_mk_map (4 hosts of 2 OSDs in 2 racks)."""
    return build_hierarchical(n_host, per, n_rack=2, pool=PgPool(
        type=PoolType.REPLICATED, size=3, crush_rule=0,
        pg_num=N_PGS, pgp_num=N_PGS))


def _pgs(d, pg_cls):
    """{(pool, seed): v} or {(pool, seed)} with one package's PgId."""
    if isinstance(d, dict):
        return {pg_cls(*k): v for k, v in d.items()}
    return {pg_cls(*k) for k in d}


_PG_FIELDS = ("new_pg_temp", "new_primary_temp", "new_pg_upmap_items",
              "old_pg_upmap_items", "new_pg_upmap", "old_pg_upmap")


class Twin:
    """A JAX ClusterState and the port's on copies of one map."""

    def __init__(self, jm):
        self.j = jax_state.ClusterState(jm, chunk=256)
        self.p = state.ClusterState(osdmap_from_reference(osdmap_dict(jm)),
                                    device="cpu")

    def incs(self, **kw):
        """The same Incremental for both maps: PG keys as (pool, seed)."""
        out = []
        for mod, m, pg_cls in ((jax_incremental, self.j.m, JaxPgId),
                               (incremental, self.p.m, PgId)):
            inc = mod.Incremental(epoch=m.epoch + 1)
            for k, v in kw.items():
                setattr(inc, k, _pgs(v, pg_cls) if k in _PG_FIELDS else v)
            out.append(inc)
        return out

    def step(self, want_kind, **kw):
        """Classify and apply one delta on both; hold everything equal."""
        jinc, pinc = self.incs(**kw)
        jk, jinfo = jax_state.classify_incremental(jinc, self.j.m)
        pk, pinfo = state.classify_incremental(pinc, self.p.m)
        assert (pk, pinfo) == (jk, jinfo)
        c0 = dict(state.COUNTERS)
        got = self.p.apply(pinc)
        moved = {k: state.COUNTERS[k] - c0[k] for k in c0}
        assert got == self.j.apply(jinc) == want_kind
        self.check()
        return moved

    def check(self, pid=0, samples=8):
        j, p = self.j, self.p
        assert (p.delta_applies, p.full_rebuilds) == \
            (j.delta_applies, j.full_rebuilds)
        prows, _, ptag = p.rows(pid)
        jrows, _, jtag = j.rows(pid)
        assert ptag == jtag
        assert prows.dtype == torch.int32
        assert np.array_equal(prows.numpy(), np.asarray(jrows))
        fresh, _, _ = state.ClusterState(p.m, device="cpu").rows(pid)
        assert torch.equal(fresh, prows)
        n = p.m.pools[pid].pg_num
        seeds = set(p._overlay_seeds(pid))
        seeds |= {int(s) for s in np.random.default_rng(n).integers(
            0, n, samples)}
        for s in sorted(seeds):
            assert p.host_up(pid, s) == j.host_up(pid, s), s


def _upmap_pair(t, seed):
    """A valid pg_upmap_items pair for `seed`: (first up OSD, an up and
    in OSD outside the set)."""
    m = t.j.m
    up = t.j.host_up(0, seed)
    to = next(o for o in range(m.max_osd)
              if o not in up and m.is_up(o) and m.is_in(o))
    return up[0], to


def test_value_only_chain():
    t = Twin(_mk_map())
    t.check()
    block = 32 * (4 + 1 + 1 + 4 + 4)  # the scatter's operands
    for kw, uploads in (
            ({"new_weight": {2: IN_WEIGHT // 2}}, block),
            ({"new_state": {1: OSD_UP}}, block),  # down
            ({"new_primary_affinity": {3: 0x4000}}, block),  # first table
            ({"new_pg_upmap_items": {(0, 5): [_upmap_pair(t, 5)]}}, 0),
            ({"new_pg_temp": {(0, 8): t.j.host_up(0, 8)[::-1]}}, 0),
            ({"new_state": {1: OSD_UP}}, block),  # revive
            ({"new_primary_temp": {(0, 2): -1}}, 0),
            ({"old_pg_upmap_items": {(0, 5)}}, 0)):
        moved = t.step("delta", **kw)
        # O(delta): the apply uploads one 32-lane block or nothing
        assert moved["device_put_bytes"] == uploads, kw
        assert moved["delta_applies"] == 1 and moved["full_rebuilds"] == 0
    assert t.p.delta_applies == 8 and t.p.full_rebuilds == 1
    # the pg_temp / primary_temp deltas leave the up rows' tag alone
    _, _, tag = t.p.rows(0)
    t.step("delta", new_primary_temp={(0, 3): -1})
    assert t.p.rows(0)[2] == tag


def test_structural_split():
    t = Twin(_mk_map())
    t.step("delta", new_pg_upmap_items={(0, 7): [_upmap_pair(t, 7)]})
    jinc, pinc = t.incs()
    for inc, m in ((jinc, t.j.m), (pinc, t.p.m)):
        pool = inc.get_new_pool(0, m.pools[0])
        pool.pg_num *= 2
        pool.pgp_num = pool.pg_num
    assert jax_state.classify_incremental(jinc, t.j.m) == \
        state.classify_incremental(pinc, t.p.m) == ("rebuild", None)
    assert t.p.apply(pinc) == t.j.apply(jinc) == "rebuild"
    assert t.p.full_rebuilds == 2
    t.check()
    assert t.p.rows(0)[0].shape[0] == 2 * N_PGS


def test_choose_args_value_delta():
    jm = _mk_map()
    ws = {o: 1.0 for o in range(jm.max_osd)}
    jm.crush.choose_args[-1] = jax_compat_ws(jm.crush, ws)
    t = Twin(jm)
    t.check()
    c2 = copy.deepcopy(t.j.m.crush)
    ws2 = {**ws, 0: 0.5, 5: 1.5}
    c2.choose_args[-1] = jax_compat_ws(c2, ws2)
    t.step("delta", crush=jax_encode_crushmap(c2),
           new_weight={4: IN_WEIGHT // 2})
    assert t.p.m.crush.choose_args[-1].weight_sets == \
        c2.choose_args[-1].weight_sets
    # the tables took the new weight-set planes: the kernel's view of the
    # map is what a fresh upload of it is
    pm = t.p.mapper(0)
    pm2 = PoolMapper(t.p.m, 0, device="cpu", overlays=False)
    assert torch.equal(pm.tables.records, pm2.tables.records)
    assert torch.equal(pm.tables.pos_weights, pm2.tables.pos_weights)


def test_destroy_revive():
    t = Twin(_mk_map())
    t.step("delta", new_pg_upmap_items={(0, 5): [_upmap_pair(t, 5)]})
    victim = t.j.host_up(0, 5)[0]
    jinc, _ = t.incs(new_state={victim: OSD_EXISTS})
    assert jax_state.classify_incremental(jinc, t.j.m)[1]["raw"]
    t.step("delta", new_state={victim: OSD_EXISTS})  # destroy
    t.step("delta", new_state={victim: OSD_EXISTS})  # revive
    t.step("delta", new_up_client={victim: b""},
           new_weight={victim: IN_WEIGHT})
    t.check(samples=N_PGS)


def test_delta_knob_forces_rebuild(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_STATE_DELTA", "0")
    t = Twin(_mk_map())
    t.step("forced_rebuild", new_weight={1: 77})
    assert t.p.full_rebuilds == 2 and t.p.delta_applies == 0


def test_fork_isolation():
    t = Twin(_mk_map())
    t.step("delta", new_pg_upmap_items={(0, 9): [_upmap_pair(t, 9)]})
    c0 = dict(state.COUNTERS)
    jinc, pinc = t.incs(new_weight={5: IN_WEIGHT // 8},
                        new_state={2: OSD_UP})
    jf, pf = t.j.fork(jinc), t.p.fork(pinc)
    assert state.COUNTERS["value_forks"] == c0["value_forks"] + 1
    assert pf.m.crush is t.p.m.crush and pf.m.epoch == t.p.m.epoch + 1
    assert t.p.m.osd_weight[5] == IN_WEIGHT
    assert pf.vectors["weight"][5] == IN_WEIGHT // 8
    assert t.p.vectors["weight"][5] == IN_WEIGHT
    assert (pf.delta_applies, pf.full_rebuilds) == \
        (jf.delta_applies, jf.full_rebuilds) == (1, 0)
    for pid in (0,):
        assert np.array_equal(pf.rows(pid)[0].numpy(),
                              np.asarray(jf.rows(pid)[0]))
    t.check()  # the parents still agree, and map the parent epoch
    jinc, pinc = t.incs(new_max_osd=32)
    for s, inc in ((t.j, jinc), (t.p, pinc)):
        with pytest.raises(ValueError, match="value-only"):
            s.fork(inc)


def test_delta_on_the_last_real_slot():
    """32 OSDs: DV is 32, so OSD 31 sits beside the spare slot the
    scatter block's unused lanes write.  Marking it down and reweighting
    it must land on OSD 31 and nowhere else."""
    t = Twin(_mk_map(n_host=8, per=4))
    assert t.p.DV == t.p.m.max_osd == 32
    last = t.p.DV - 1
    t.step("delta", new_weight={last: IN_WEIGHT // 4})
    assert int(t.p.vectors["weight"][last]) == IN_WEIGHT // 4
    t.step("delta", new_state={last: OSD_UP})  # down
    assert not bool(t.p.vectors["up"][last])
    assert bool(t.p.vectors["exists"][last])
    t.check(samples=N_PGS)
    # a wide delta (16 OSDs, half of DV) re-uploads the vectors instead
    moved = t.step("delta", new_weight={o: IN_WEIGHT // 2 for o in range(16)})
    assert moved["device_put_bytes"] == 33 * (1 + 1 + 4 + 4)
