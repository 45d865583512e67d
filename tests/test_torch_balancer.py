"""The port's upmap balancer (`ceph_tpu_torch.balancer`, on the CPU) held
exact against the JAX package's.

Each case builds a map with `ceph_tpu`'s build_hierarchical, carries it as
plain data (`osd.carry.osdmap_from_reference`), runs `calc_pg_upmaps` of
both packages with the same arguments and seeds, and compares with no
tolerance: `pg_upmap_items`, `old_pg_upmap_items`, `num_changed`, the
device_loop `moves` and the counter deltas (the JAX package's "balancer"
perf counters against the port's `upmap.COUNTERS`); `stddev` and
`max_deviation` within 1e-9.  The helpers under it (crush_analysis,
try_remap_rule, try_pg_upmap, clean_pg_upmaps, overlay_fixup_rows and the
overlay-free PoolMapper) are compared the same way.

tests/data/balancer_corpus.json holds the JAX package's plan digests
(bench.py::_plan_digest) for BASELINE config 2 on every backend and for
three device_loop rounds of config 5, with their inputs; `chip_smoke.py`
holds the card to them.  `python tests/test_torch_balancer.py` rewrites
it (config 5 takes about 15 minutes on the CPU); the port reproduces the
config-2 entries here, and the slow tier checks the JAX package still
gives them.
"""

import hashlib
import inspect
import json
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu import obs  # noqa: E402
from ceph_tpu.balancer import crush_analysis as jax_ca  # noqa: E402
from ceph_tpu.balancer.upmap import calc_pg_upmaps as jax_calc  # noqa: E402
from ceph_tpu.balancer.upmap import try_pg_upmap as jax_try_pg_upmap  # noqa: E402
from ceph_tpu.balancer.upmap import try_remap_rule as jax_try_remap  # noqa: E402
from ceph_tpu.osd import osdmap as jax_osdmap  # noqa: E402
from ceph_tpu.osd.pipeline_jax import PoolMapper as JaxPoolMapper  # noqa: E402
from ceph_tpu.osd.pipeline_jax import overlay_fixup_rows as jax_fixup  # noqa: E402
from ceph_tpu.osd.types import PgId as JaxPgId  # noqa: E402
from ceph_tpu.osd.types import PgPool, PoolType  # noqa: E402
from ceph_tpu_torch.balancer import calc_pg_upmaps  # noqa: E402
from ceph_tpu_torch.balancer import crush_analysis as ca  # noqa: E402
from ceph_tpu_torch.balancer import upmap  # noqa: E402
from ceph_tpu_torch.osd import osdmap as port_osdmap  # noqa: E402
from ceph_tpu_torch.osd.carry import osdmap_from_reference  # noqa: E402
from ceph_tpu_torch.osd.pipeline import PoolMapper, overlay_fixup_rows  # noqa: E402
from ceph_tpu_torch.osd.types import PgId  # noqa: E402
from test_torch_pipeline import osdmap_dict  # noqa: E402

CORPUS = ROOT / "tests" / "data" / "balancer_corpus.json"
COUNTER_KEYS = ("rounds", "changes_accepted", "changes_rejected",
                "candidate_batches", "candidates_scored",
                "candidate_conflicts", "plan_dispatches",
                "plan_readback_reverts")


# -- maps ----------------------------------------------------------------------

def flat(pg_num=512, n_host=8, per=4):
    """tests/test_balancer.py::_map: hosts under the root, equal weights."""
    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                  pg_num=pg_num, pgp_num=pg_num)
    return jax_osdmap.build_hierarchical(n_host, per, pool=pool)


def skewed(pg_num=512, n_host=8, per=4, down=6, seed=5):
    """tests/test_multichip.py::skewed: two racks, `down` OSDs reweighted
    to 0.6."""
    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                  pg_num=pg_num, pgp_num=pg_num)
    m = jax_osdmap.build_hierarchical(n_host, per, n_rack=2, pool=pool)
    rng = np.random.default_rng(seed)
    for o in rng.choice(n_host * per, down, replace=False):
        m.osd_weight[int(o)] = int(0x10000 * 0.6)
    return m


def frozen():
    """skewed() with full remaps (frozen PGs) and pg_upmap_items."""
    m = skewed(pg_num=256)
    for ps in (3, 17, 40):
        raw, _ = m.pg_to_raw_osds(JaxPgId(0, ps))
        m.pg_upmap[JaxPgId(0, ps)] = list(reversed(raw))
    for ps in (5, 9):
        raw, _ = m.pg_to_raw_osds(JaxPgId(0, ps))
        spare = [o for o in range(m.max_osd) if o not in raw
                 and jax_ca.get_parent_of_type(m.crush, o, 1, 0)
                 not in {jax_ca.get_parent_of_type(m.crush, r, 1, 0)
                         for r in raw}]
        m.pg_upmap_items[JaxPgId(0, ps)] = [(raw[1], spare[ps % 3])]
    return m


def piled_on_last_osd():
    """flat(256) with pg_upmap_items that move 24 PGs onto the highest
    OSD id, so it is the most overfull OSD while low-index PGs hold no
    overfull OSD: a scatter whose drop slot (index dv) were moved onto
    the last real slot (dv - 1) would give that OSD the wrong PG."""
    m = flat(pg_num=256)
    last = m.max_osd - 1
    host = jax_ca.get_parent_of_type(m.crush, last, 1, 0)
    for ps in range(100, 256):
        raw, _ = m.pg_to_raw_osds(JaxPgId(0, ps))
        if all(jax_ca.get_parent_of_type(m.crush, o, 1, 0) != host
               for o in raw):
            m.pg_upmap_items[JaxPgId(0, ps)] = [(raw[0], last)]
        if len(m.pg_upmap_items) == 24:
            break
    return m


def drop_slots():
    """flat(256) built so that each device_loop scatter's drop slot, moved
    onto the last real slot, changes the plan.  OSD Y (the lowest id off
    the last PG and off the last OSD's host) is the most overfull, every
    PG on it frozen (a full remap), so it is the round's first candidate
    and has no PG to move; OSD X (the last PG's first member) is next,
    with the last PG its only movable PG; the last OSD is the most
    underfull (12 PGs moved off it), X's best target.  A `used` scatter
    whose dropped write landed on the last OSD would use it up at Y; a
    row scatter whose dropped write landed on the last PG would rewrite
    the row that X's move changes."""
    m = flat(pg_num=256)

    def host(o):
        return jax_ca.get_parent_of_type(m.crush, o, 1, 0)

    last, lastpg = m.max_osd - 1, 255
    raws = {ps: list(m.pg_to_raw_osds(JaxPgId(0, ps))[0])
            for ps in range(256)}
    x = raws[lastpg][0]
    y = next(o for o in range(m.max_osd)
             if o not in raws[lastpg] and host(o) != host(last))
    for ps, raw in raws.items():
        if ps != lastpg and (x in raw or y in raw):
            m.pg_upmap[JaxPgId(0, ps)] = list(raw)
    free = [ps for ps, raw in raws.items() if ps != lastpg
            and JaxPgId(0, ps) not in m.pg_upmap and last not in raw]
    for osd, n in ((y, 20), (x, 6)):  # frozen PGs piled on y, then x
        for ps in [ps for ps in free
                   if host(osd) not in map(host, raws[ps][1:])][:n]:
            m.pg_upmap[JaxPgId(0, ps)] = [osd] + raws[ps][1:]
            free.remove(ps)
    moved = 0
    for ps, raw in raws.items():
        if moved == 12:
            break
        if ps != lastpg and last in raw and JaxPgId(0, ps) not in m.pg_upmap:
            hosts = {host(o) for o in raw if o != last}
            spare = [o for o in range(m.max_osd) if host(o) not in hosts
                     and o not in raw and o not in (x, y)
                     and host(o) != host(last)]
            m.pg_upmap_items[JaxPgId(0, ps)] = [(last,
                                                 spare[moved % len(spare)])]
            moved += 1
    return m


def carried(m):
    """The port's copy of a ceph_tpu map."""
    return osdmap_from_reference(osdmap_dict(m))


# -- comparison ----------------------------------------------------------------

def items(d) -> dict:
    return {(pg.pool, pg.seed): [tuple(int(x) for x in p) for p in v]
            for pg, v in d.items()}


def plan(m, r, counters) -> dict:
    """What a calc_pg_upmaps call decided, in package-free values."""
    return {
        "pg_upmap_items": items(m.pg_upmap_items),
        "new_pg_upmap_items": items(r.new_pg_upmap_items),
        "old_pg_upmap_items": sorted((pg.pool, pg.seed)
                                     for pg in r.old_pg_upmap_items),
        "num_changed": r.num_changed,
        "moves": [((pg.pool, pg.seed), int(f), int(t), int(rnd))
                  for pg, f, t, rnd in r.moves],
        "counters": counters,
        "stddev": r.stddev, "max_deviation": r.max_deviation,
    }


def assert_same_plan(want: dict, got: dict) -> None:
    for k in want:
        if k in ("stddev", "max_deviation"):
            assert abs(got[k] - want[k]) <= 1e-9, k
        else:
            assert got[k] == want[k], k


def jax_counters() -> dict:
    d = obs.perf_dump().get("balancer") or {}
    return {k: int(d.get(k, 0)) for k in COUNTER_KEYS}


def port_counters() -> dict:
    return {k: upmap.COUNTERS[k] for k in COUNTER_KEYS}


def run_jax(m, **kw):
    c0 = jax_counters()
    r = jax_calc(m, **kw)
    c1 = jax_counters()
    return plan(m, r, {k: c1[k] - c0[k] for k in COUNTER_KEYS})


def run_port(m, **kw):
    c0 = port_counters()
    r = calc_pg_upmaps(m, device="cpu", **kw)
    c1 = port_counters()
    return plan(m, r, {k: c1[k] - c0[k] for k in COUNTER_KEYS})


def mark_osd5_out(m):
    m.osd_weight[5] = 0


# name -> (map, [(calc_pg_upmaps kwargs without rng, rng seed, then)]):
# `then(m)` runs on both maps after that round
SEQ = dict(max_deviation=2, max_iter=8)
LOOP = dict(max_deviation=2, max_iter=200, backend="device_loop",
            candidate_batch=16)
CASES = {
    "sets_host": (skewed, [(dict(SEQ, use_tpu=False), 42, None)]),
    "sets_pool_mapper": (skewed, [(dict(SEQ, use_tpu=True), 42, None)]),
    "device": (skewed, [(dict(SEQ, backend="device"), 42, None)]),
    "sets_batched": (skewed, [(dict(SEQ, use_tpu=False, max_iter=24,
                                    candidate_batch=16), 42, None)]),
    "device_batched": (skewed, [(dict(SEQ, backend="device", max_iter=24,
                                      candidate_batch=16), 42, None)]),
    "device_loop": (skewed, [(LOOP, 42, None)]),
    "device_loop_piled_on_last_osd": (
        piled_on_last_osd, [(dict(LOOP, max_deviation=3, max_iter=48), 42,
                             None)]),
    # equal weights: deviations tie across most OSDs
    "device_loop_equal_weights": (
        flat, [(dict(LOOP, max_deviation=1, max_iter=48), 5, None)]),
    # tests/test_balancer.py::test_equivalent_second_round_drops
    "drops_sets": (flat, [
        (dict(max_deviation=1, max_iter=6, backend="sets"), 7,
         mark_osd5_out),
        (dict(max_deviation=1, max_iter=6, backend="sets"), 8, None)]),
    "drops_device": (flat, [
        (dict(max_deviation=1, max_iter=6, backend="device"), 7,
         mark_osd5_out),
        (dict(max_deviation=1, max_iter=6, backend="device"), 8, None)]),
    "drops_device_loop": (flat, [
        (dict(LOOP, max_deviation=1, max_iter=6), 7, mark_osd5_out),
        (dict(LOOP, max_deviation=1, max_iter=6), 8, None)]),
    "frozen_sets": (frozen, [(dict(SEQ, backend="sets"), 3, None)]),
    "frozen_device_batched": (frozen, [
        (dict(SEQ, backend="device", candidate_batch=8), 3, None)]),
    "frozen_device_loop": (frozen, [(dict(LOOP, max_iter=24), 3, None)]),
    # full remaps, like frozen: run with the pg_ps_alias fixture
    "device_loop_drop_slots": (drop_slots, [(dict(LOOP, max_iter=24), 42,
                                             None)]),
}


@pytest.fixture
def pg_ps_alias(monkeypatch):
    """The JAX package's device_loop reads `pg.ps` of the map's pg_upmap
    keys, a name its PgId lacks (it says `seed`); lend it the alias so
    the reference runs on maps with full remaps."""
    monkeypatch.setattr(JaxPgId, "ps", property(lambda pg: pg.seed),
                        raising=False)


def run_case(name):
    make, rounds = CASES[name]
    jm = make()
    pm = carried(jm)
    out = []
    for kw, seed, then in rounds:
        want = run_jax(jm, rng=np.random.default_rng(seed), **kw)
        got = run_port(pm, rng=np.random.default_rng(seed), **kw)
        out.append((want, got))
        if then is not None:
            then(jm)
            then(pm)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_calc_pg_upmaps_equals_jax(name, pg_ps_alias):
    runs = run_case(name)
    for want, got in runs:
        assert_same_plan(want, got)
    # every case makes changes, and the device_loop ones leave an audit
    assert runs[0][1]["num_changed"] > 0
    if CASES[name][1][0][0].get("backend") == "device_loop":
        assert len(runs[0][1]["moves"]) == runs[0][1]["num_changed"]


def test_frozen_pgs_stay(pg_ps_alias):
    """No plan touches a PG with a full remap."""
    for name in ("frozen_sets", "frozen_device_batched",
                 "frozen_device_loop"):
        got = run_case(name)[0][1]
        assert not {(0, 3), (0, 17), (0, 40)} & set(got["pg_upmap_items"])


def test_device_cache_across_rounds():
    """bench.py::bench_rebalance's loop: three device_loop runs sharing
    one mapper cache (refresh_dev between them) give the JAX plans."""
    jm = skewed()
    pm = carried(jm)
    jcache, pcache = {}, {}
    for rnd in range(3):
        kw = dict(max_deviation=1, max_iter=10, backend="device_loop",
                  candidate_batch=16, rng=np.random.default_rng(100 + rnd))
        want = run_jax(jm, device_cache=jcache, **kw)
        got = run_port(pm, device_cache=pcache, **kw)
        assert_same_plan(want, got)
    assert list(pcache) == [0] and pcache[0].ov.any is False


# -- mutation checks: the comparison catches one wrong decision ----------------

def test_tie_order_mutation_is_caught(monkeypatch):
    """With the top-B taking equal deviations HIGHEST index first (an
    order torch.topk may give), the equal-weight plan differs from the
    JAX plan, and the comparison says so."""
    def top_b_reversed(key, b):
        v, i = torch.sort(key.flip(0), descending=True, stable=True)
        return v[:b], key.numel() - 1 - i[:b]

    monkeypatch.setattr(upmap, "_top_b", top_b_reversed)
    (want, got), = run_case("device_loop_equal_weights")
    with pytest.raises(AssertionError):
        assert_same_plan(want, got)


def mutated_loop_plan(old: str, new: str):
    """A copy of the plain plan `upmap._loop_plan` with `old` (once in
    its source) replaced by `new`."""
    src = textwrap.dedent(inspect.getsource(upmap._loop_plan))
    assert src.count(old) == 1, old
    ns = dict(vars(upmap))
    exec(compile(src.replace(old, new), "<mutated _loop_plan>", "exec"), ns)
    return ns["_loop_plan"]


# each drop slot of the plain plan's scatters moved onto the last real
# slot (the last OSD, the last PG)
DROP_SLOT_MUTATIONS = {
    "used_target": ("torch.where(cand_ok, t, dv)",
                    "torch.where(cand_ok, t, dv - 1)"),
    "used_from": ("torch.where(accept, frm, dv)",
                  "torch.where(accept, frm, dv - 1)"),
    "rows": ("rows_x.index_put_((apg, aslot)",
             "rows_x.index_put_((apg.clamp(max=npg - 1), aslot)"),
}


@pytest.mark.parametrize("name", sorted(DROP_SLOT_MUTATIONS))
def test_drop_slot_mutation_is_caught(name, monkeypatch, pg_ps_alias):
    """With a scatter's drop slot on the last real slot, the drop-slot
    case's plan differs from the JAX plan, and the comparison says so."""
    monkeypatch.setattr(upmap, "_loop_plan",
                        mutated_loop_plan(*DROP_SLOT_MUTATIONS[name]))
    (want, got), = run_case("device_loop_drop_slots")
    with pytest.raises(AssertionError):
        assert_same_plan(want, got)


def test_one_swap_is_caught():
    (want, got), = run_case("device_loop")
    pg = sorted(got["pg_upmap_items"])[0]
    (frm, to), *rest = got["pg_upmap_items"][pg]
    swapped = dict(got["pg_upmap_items"])
    swapped[pg] = [(to, frm), *rest]
    bad = dict(got, pg_upmap_items=swapped)
    assert_same_plan(want, got)
    with pytest.raises(AssertionError):
        assert_same_plan(want, bad)
    moved = dict(got, moves=[got["moves"][0][:3] + (got["moves"][0][3]
                                                    + 1,)]
                 + got["moves"][1:])
    with pytest.raises(AssertionError):
        assert_same_plan(want, moved)


# -- the helpers ---------------------------------------------------------------

ANALYSIS_MAPS = {"skewed": skewed, "flat": lambda: flat(pg_num=128),
                 "frozen": frozen}


@pytest.mark.parametrize("name", sorted(ANALYSIS_MAPS))
def test_crush_analysis_equals_jax(name):
    jm = ANALYSIS_MAPS[name]()
    jc, pc = jm.crush, carried(jm).crush
    buckets = sorted(jc.buckets)
    everything = buckets + list(range(jm.max_osd))
    types = sorted({b.type for b in jc.buckets.values()} | {0})
    for root in buckets + [0, -999]:
        for item in everything:
            assert ca.subtree_contains(pc, root, item) == \
                jax_ca.subtree_contains(jc, root, item)
        for t in types:
            assert ca.get_children_of_type(pc, root, t) == \
                jax_ca.get_children_of_type(jc, root, t)
    for item in everything:
        assert ca.get_immediate_parent_id(pc, item) == \
            jax_ca.get_immediate_parent_id(jc, item)
        for t in types:
            for ruleno in (-1, 0):
                assert ca.get_parent_of_type(pc, item, t, ruleno) == \
                    jax_ca.get_parent_of_type(jc, item, t, ruleno)
    assert ca.find_takes_by_rule(pc, 0) == jax_ca.find_takes_by_rule(jc, 0)
    assert ca.get_rule_weight_osd_map(pc, 0) == \
        jax_ca.get_rule_weight_osd_map(jc, 0)
    for t in types:
        table = ca.parent_of_type_map(pc, t, 0)
        for item in everything:
            assert table.get(item, 0) == \
                jax_ca.get_parent_of_type(jc, item, t, 0)


def test_try_remap_rule_and_try_pg_upmap_equal_jax():
    jm = skewed(pg_num=128)
    pm = carried(jm)
    rng = np.random.default_rng(11)
    n_out = 0
    for ps in range(128):
        raw, _ = jm.pg_to_raw_osds(JaxPgId(0, ps))
        pool = jm.pools[0]
        orig = list(raw)
        jm._apply_upmap(pool, JaxPgId(0, ps), orig)
        osds = rng.permutation(jm.max_osd).tolist()
        overfull = set(osds[:4]) | {orig[ps % 3]}
        underfull, more = osds[4:10], osds[10:14]
        want = jax_try_remap(jm, 0, 3, overfull, underfull, more,
                             list(orig))
        got = upmap.try_remap_rule(pm, 0, 3, overfull, underfull, more,
                                   list(orig))
        assert got == want, ps
        want = jax_try_pg_upmap(jm, JaxPgId(0, ps), overfull, underfull,
                                more, list(orig))
        got = upmap.try_pg_upmap(pm, PgId(0, ps), overfull, underfull,
                                 more, list(orig))
        assert got == want, ps
        n_out += want is not None
    assert n_out > 0


def stale(m, pg_cls):
    """Upmap entries clean_pg_upmaps cancels or simplifies (see
    tests/test_torch_cli.py::stale_upmaps), on either package's map."""
    raw = {ps: m.pg_to_raw_osds(pg_cls(0, ps))[0] for ps in range(6)}
    free = [o for o in range(m.max_osd) if o not in raw[2]]
    m.pg_upmap_items[pg_cls(0, 0)] = [(99, 5)]
    m.pg_upmap_items[pg_cls(0, 2)] = [(raw[2][0], free[0]),
                                      (77, free[1])]
    m.pg_upmap_items[pg_cls(0, 3)] = [(raw[3][1], 15)]
    m.pg_upmap_items[pg_cls(0, 4)] = [(raw[4][0], raw[4][1])]  # duplicate
    m.pg_upmap[pg_cls(0, 1)] = list(raw[1])
    m.pg_upmap_items[pg_cls(0, 9999)] = [(1, 2)]  # no such PG
    m.pg_upmap_items[pg_cls(7, 1)] = [(1, 2)]  # no such pool
    m.osd_weight[15] = 0
    return m


def test_clean_pg_upmaps_equals_jax():
    jm = stale(skewed(pg_num=64), JaxPgId)
    pm = carried(jm)
    jc, jr = jm.clean_pg_upmaps()
    pc, pr = pm.clean_pg_upmaps()
    assert [(pg.pool, pg.seed) for pg in pc] == \
        [(pg.pool, pg.seed) for pg in jc]
    assert items(pr) == items(jr)
    assert len(jc) >= 4 and jr
    assert items(pm.pg_upmap_items) == items(jm.pg_upmap_items)
    assert items(pm.pg_upmap) == items(jm.pg_upmap)


def test_overlay_free_mapper_and_fixups_equal_jax():
    jm = stale(skewed(pg_num=64), JaxPgId)
    jm.clean_pg_upmaps()
    jm.pg_upmap_items[JaxPgId(0, 7)] = [
        (jm.pg_to_raw_osds(JaxPgId(0, 7))[0][0], 31)]
    jm.pg_temp[JaxPgId(0, 8)] = [0, 1, 2]
    pm = carried(jm)
    want = np.asarray(JaxPoolMapper(jm, 0, overlays=False).map_all_device())
    mapper = PoolMapper(pm, 0, "cpu", overlays=False)
    assert not mapper.ov.any and not mapper._ov
    got = mapper.map_all_device()
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    js, jrows = jax_fixup(jm, 0, want.shape[1])
    ps, prows = overlay_fixup_rows(pm, 0, want.shape[1])
    assert len(js) >= 2
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(prows, jrows)
    # the rows with the fixups scattered in are the overlay mapper's
    full = PoolMapper(pm, 0, "cpu").map_all()[0]
    fixed = got.numpy().copy()
    fixed[ps] = prows
    np.testing.assert_array_equal(fixed, full)
    with pytest.raises(ValueError, match="overlay-free"):
        PoolMapper(pm, 0, "cpu").map_all_device()


def test_entry_point_refusals():
    from ceph_tpu_torch.parallel.sharded import Mesh

    pm = carried(skewed(pg_num=64))
    # a mesh is accepted since the runtime slice: the split plan is the
    # unsplit one (tests/test_torch_multichip.py holds it to the JAX plan)
    pm2 = carried(skewed(pg_num=64))
    r1 = calc_pg_upmaps(pm, backend="device", device="cpu",
                        rng=np.random.default_rng(1))
    r2 = calc_pg_upmaps(pm2, backend="device", mesh=Mesh(["cpu"] * 2),
                        rng=np.random.default_rng(1))
    assert pm.pg_upmap_items == pm2.pg_upmap_items and r1.moves == r2.moves
    with pytest.raises(ValueError, match="backend"):
        calc_pg_upmaps(pm, backend="nope", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calc_pg_upmaps(pm, backend="device_loop")


def test_rows_source_stands_in_for_the_mapping():
    """rows_source(pid) -> rows replaces the build's mapping: given the
    rows of the map with its upmaps, the plan is the one the build's own
    mapping gives."""
    jm = piled_on_last_osd()
    kw = dict(LOOP, max_deviation=3, max_iter=24, device="cpu")
    a, b = carried(jm), carried(jm)
    rows = PoolMapper(a, 0, "cpu").map_all_tensors()[0]
    asked = []

    def source(pid):
        asked.append(pid)
        return rows

    ra = calc_pg_upmaps(a, rng=np.random.default_rng(1), **kw)
    rb = calc_pg_upmaps(b, rng=np.random.default_rng(1), rows_source=source,
                        **kw)
    assert asked == [0] and ra.num_changed > 0
    assert items(a.pg_upmap_items) == items(b.pg_upmap_items)
    assert ra.moves == rb.moves


# -- the corpus ------------------------------------------------------------------

def plan_digest(m) -> str:
    """bench.py::_plan_digest: order-independent digest of the plan."""
    h = hashlib.sha256()
    for pg in sorted(m.pg_upmap_items):
        h.update(repr((pg, m.pg_upmap_items[pg])).encode())
    return h.hexdigest()[:16]


def bench_map(pkg: str, n_pgs: int, n_osds: int, seed: int = 5):
    """bench.py::bench_rebalance's map: build_map(n_pgs, n_osds) (hosts
    of 8 OSDs, racks of 16 hosts, one size-3 pool) with 2 % of the OSDs
    reweighted to 0.85 by default_rng(seed)."""
    mod = jax_osdmap if pkg == "jax" else port_osdmap
    n_host = max(1, n_osds // 8)
    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                  pg_num=n_pgs, pgp_num=n_pgs)
    if pkg != "jax":
        from ceph_tpu_torch.osd.types import PgPool as P, PoolType as T

        pool = P(type=T.REPLICATED, size=3, crush_rule=0, pg_num=n_pgs,
                 pgp_num=n_pgs)
    m = mod.build_hierarchical(n_host, 8, n_rack=max(1, n_host // 16),
                               pool=pool)
    rng = np.random.default_rng(seed)
    for o in rng.choice(n_osds, max(1, n_osds // 50), replace=False):
        m.osd_weight[int(o)] = int(0x10000 * 0.85)
    return m


def corpus() -> dict:
    return json.loads(CORPUS.read_text())


def config2_run(pkg: str, kwargs: dict):
    c = corpus()["config2"]
    m = bench_map(pkg, c["pgs"], c["osds"])
    calc = jax_calc if pkg == "jax" else calc_pg_upmaps
    extra = {} if pkg == "jax" else {"device": "cpu"}
    r = calc(m, max_deviation=c["max_deviation"], max_iter=c["max_iter"],
             rng=np.random.default_rng(c["rng"]), **kwargs, **extra)
    return {"digest": plan_digest(m), "num_changed": r.num_changed,
            "stddev": r.stddev, "max_deviation": r.max_deviation}


CONFIG2_BACKENDS = {
    "sets": {"backend": "sets"},
    "device": {"backend": "device"},
    "device_batched": {"backend": "device", "candidate_batch": 16},
    "device_loop": {"backend": "device_loop", "candidate_batch": 16},
}


def test_corpus_holds_every_backend():
    c = corpus()
    assert {k: v["kwargs"] for k, v in c["config2"]["backends"].items()} \
        == CONFIG2_BACKENDS
    assert len(c["config5"]["rounds"]) == 3


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=() if n == "device_loop" else pytest.mark.slow)
    for n in sorted(CONFIG2_BACKENDS)])
def test_port_reproduces_config2_corpus(name):
    """config 2 on the CPU; the host-heavy backends at this size are in
    the slow tier (the card runs all four in chip_smoke.py)."""
    entry = corpus()["config2"]["backends"][name]
    got = config2_run("port", entry["kwargs"])
    assert got["digest"] == entry["digest"]
    assert got["num_changed"] == entry["num_changed"]
    assert abs(got["stddev"] - entry["stddev"]) <= 1e-9
    assert abs(got["max_deviation"] - entry["max_deviation"]) <= 1e-9


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CONFIG2_BACKENDS))
def test_corpus_config2_is_the_jax_package(name):
    entry = corpus()["config2"]["backends"][name]
    got = config2_run("jax", entry["kwargs"])
    assert got == {k: entry[k] for k in got}


def write_corpus(with_config5: bool = True) -> None:
    """Rewrite tests/data/balancer_corpus.json from the JAX package."""
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    out = {
        "about": "plan digests (bench.py::_plan_digest) of the JAX "
                 "package's calc_pg_upmaps on BASELINE configs 2 and 5 "
                 "(bench.py::bench_rebalance's map and reweight); written "
                 "by `python tests/test_torch_balancer.py`",
        "config2": {"pgs": 100000, "osds": 1024, "reweight_seed": 5,
                    "max_deviation": 5, "max_iter": 10, "rng": 100,
                    "backends": {}},
    }
    CORPUS.write_text(json.dumps(out, indent=1) + "\n")  # config2_run reads
    for name, kw in CONFIG2_BACKENDS.items():
        out["config2"]["backends"][name] = dict(kwargs=kw,
                                                **config2_run("jax", kw))
        print(name, out["config2"]["backends"][name], flush=True)
    if with_config5:
        c5 = {"pgs": 10_000_000, "osds": 10_000, "reweight_seed": 5,
              "max_deviation": 5, "max_iter": 10,
              "kwargs": {"backend": "device_loop", "candidate_batch": 16},
              "rounds": []}
        m = bench_map("jax", c5["pgs"], c5["osds"])
        cache: dict = {}
        for rnd in range(3):
            r = jax_calc(m, max_deviation=5, max_iter=10,
                         rng=np.random.default_rng(100 + rnd),
                         device_cache=cache, **c5["kwargs"])
            c5["rounds"].append({
                "rng": 100 + rnd, "digest": plan_digest(m),
                "num_changed": r.num_changed, "stddev": r.stddev,
                "max_deviation": r.max_deviation,
                "upmap_items": len(m.pg_upmap_items)})
            print("config5", c5["rounds"][-1], flush=True)
        out["config5"] = c5
    CORPUS.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    write_corpus(with_config5="--no-config5" not in sys.argv)
