"""`fleet/` (FleetSim, the sweep grammar, the pareto front) held against
the JAX package.

The digest contract: every member of a stacked port fleet lands on the
SHA-256 replay digest the JAX `FleetSim` gives it, and on the digest of a
solo port `LifetimeSim` of the same scenario, including a `correlated=1`
member, a balanced member (its rounds on the `device_loop` backend) and a
member whose starved recovery pipe loses PGs (the DATA_LOSS latch must
hold).  The JAX fleet's digests are tests/data/fleet_corpus.json's (the
JAX `DIGEST_SPEC` run takes about 20 s on the CPU);
`python tests/test_torch_fleet.py` rewrites the file (about 1 min).

Beside the cases of tests/test_fleet.py (grammar and its errors,
registries, pareto and triage on fixed points, digests, stacked ==
unstacked, checkpoint round trip and drift refusals, the mid-cascade
kill), what is new in the port: the lane-batched epoch stats
(`lifetime._stats_lanes`) lane by lane equal to the L = 1 call and to
`_stats_np` on lanes of mixed N and W; a small fleet's rule calls and
stats calls epoch by epoch; checkpoints across the two packages; an
injected device loss raising out of `FleetSim.step()`; and no card
without `device="cpu"`.  The CLI is in test_torch_fleet_cli.py.
"""

import json
import sys
from dataclasses import fields
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from ceph_tpu_torch import obs  # noqa: E402
from ceph_tpu_torch.crush.types import ITEM_NONE  # noqa: E402
from ceph_tpu_torch.fleet import engine as fleet_engine  # noqa: E402
from ceph_tpu_torch.fleet.engine import FleetSim  # noqa: E402
from ceph_tpu_torch.fleet.pareto import (  # noqa: E402
    Point,
    dominates,
    pareto_front,
    triage_table,
)
from ceph_tpu_torch.fleet.spec import (  # noqa: E402
    FLEET_KNOBS,
    SWEEP_AXES,
    parse_fleet,
)
from ceph_tpu_torch.osd import pipeline  # noqa: E402
from ceph_tpu_torch.runtime import DeviceLostError, faults  # noqa: E402
from ceph_tpu_torch.sim import lifetime  # noqa: E402
from ceph_tpu_torch.sim.lifetime import LifetimeSim, Scenario  # noqa: E402

CORPUS = ROOT / "tests" / "data" / "fleet_corpus.json"

# tests/test_fleet.py's specs
BASE = ("epochs=8,seed=5,hosts=4,osds_per_host=3,racks=2,pgs=32,"
        "ec=2+1,ec_pgs=16,chunk=256,balance_every=0,spotcheck_every=0,"
        "checkpoint_every=0,recovery=queue,max_backfills=4,"
        "recovery_mbps=200,osd_mbps=400")
LOSS = ("epochs=14,hosts=3,osds_per_host=2,racks=1,pgs=16,ec_pgs=8,"
        "chunk=64,seed=7,p_death=0.25,p_flap=0.05,p_host_outage=0.10,"
        "p_reweight=0,p_pg_temp=0,p_pool_create=0,p_split=0,"
        "p_expand=0,p_remove=0.02,max_backfills=1,recovery_mbps=2,"
        "osd_mbps=4,correlated=1,flappers=1")
# plain, balanced (device_loop rounds), correlated, data-loss
DIGEST_SPEC = (f"base={BASE};"
               "axis=correlated:0|1;"
               "axis=recovery_mbps:100|400;"
               "cluster=1:balance_every=3;"
               f"cluster=3:{LOSS}")
REF_SPEC = (f"base={BASE},epochs=6;"
            "axis=seed:1|2;axis=p_death:0.02|0.1;"
            "backend=ref")
UNSTACKED_SPEC = f"base={BASE},epochs=5;axis=correlated:0|1"
# the cross-package checkpoint fleet: device members spelled "jax"
CROSS_SPEC = (f"base={BASE},epochs=6,workload=1;"
              "axis=correlated:0|1;backend=jax")
CROSS_STOP = 3
CASCADE_SPEC = (f"base={BASE},epochs=12,correlated=1,flappers=2,"
                "p_host_outage=0.3,p_rack_outage=0.1;"
                "axis=seed:11|12;backend=ref")

# member-row fields that read the wall clock
WALL_MEMBER = ("cluster_years_per_hour",)


def reset_observers(obs_mod) -> None:
    obs_mod.health.reset()
    obs_mod.timeline.reset()


@pytest.fixture(autouse=True)
def _clean():
    from ceph_tpu import obs as jobs
    from ceph_tpu.runtime import faults as jfaults

    reset_observers(obs)
    reset_observers(jobs)
    yield
    faults.disarm_all()
    jfaults.disarm_all()
    reset_observers(obs)
    reset_observers(jobs)


def _corpus() -> dict:
    return json.loads(CORPUS.read_text())


def comparable_members(summary: dict) -> list[dict]:
    """The member rows without their wall-clock objective."""
    out = []
    for m in summary["members"]:
        row = dict(m, pareto={k: v for k, v in m["pareto"].items()
                              if k not in WALL_MEMBER})
        out.append(row)
    return json.loads(json.dumps(out))


def port_fleet(spec, **kw):
    return FleetSim(parse_fleet(spec), device="cpu", **kw)


def solo_digest(member) -> str:
    """The oracle: a solo port LifetimeSim of the member's pinned
    scenario (the fleet's balancer backend on device members)."""
    sim = LifetimeSim(Scenario.parse(member.scenario.spec()),
                      backend=member.backend, device="cpu"
                      if member.backend != "ref" else None)
    if member.backend != "ref":
        sim.balancer_options = {"upmap_state_backend": "device_loop"}
    out = sim.run()["digest"]
    reset_observers(obs)
    return out


# -- sweep grammar ---------------------------------------------------------

def test_sweep_axes_are_scenario_fields():
    names = {f.name for f in fields(Scenario)}
    for key in SWEEP_AXES:
        assert key in names, key
    for key in FLEET_KNOBS:
        assert key not in names, key


def test_registries_equal_jax():
    from ceph_tpu.fleet import spec as jspec

    assert SWEEP_AXES == jspec.SWEEP_AXES
    assert list(SWEEP_AXES) == list(jspec.SWEEP_AXES)
    assert FLEET_KNOBS == jspec.FLEET_KNOBS


def test_parse_fleet_sweeps_every_registered_axis():
    spec = (f"base={BASE};"
            "axis=seed:1|2;axis=epochs:6|8;axis=pgs:16|32;"
            "axis=ec:2+1|4+2;axis=ec_pgs:8|16;axis=hosts:3|4;"
            "axis=p_flap:0|0.05;axis=p_death:0|0.1;"
            "axis=correlated:0|1;axis=recovery_mbps:100|400;"
            "axis=max_backfills:1|4;axis=osd_mbps:200|400;"
            "axis=balance_every:0|4;axis=workload:0|1;"
            "axis=base_qps:500|1000;"
            "clusters=4")
    ms = parse_fleet(spec)
    assert len(ms) == 4
    assert ms[0].scenario.seed == 1 and ms[0].scenario.workload == 0
    assert ms[0].scenario.base_qps == 500.0
    assert ms[1].scenario.base_qps == 1000.0
    assert ms[1].scenario.workload == 0
    assert ms[2].scenario.workload == 1
    assert len({m.spec() for m in ms}) == 4


def test_clusters_cycle_offsets_seed_per_repetition():
    ms = parse_fleet(f"base={BASE};axis=p_death:0.02|0.1;clusters=5")
    assert [m.scenario.seed for m in ms] == [5, 5, 6, 6, 7]
    assert len({m.spec() for m in ms}) == 5
    dup = parse_fleet(f"base={BASE};axis=seed:1|2;clusters=4")
    assert dup[0].spec() == dup[2].spec()
    assert dup[1].spec() == dup[3].spec()


def test_cluster_overrides_and_backend_knob():
    ms = parse_fleet(f"base={BASE};axis=seed:1|2|3;backend=ref;"
                     "cluster=1:p_flap=0.5,backend=jax;"
                     "cluster=2:backend=torch")
    assert [m.backend for m in ms] == ["ref", "jax", "torch"]
    assert ms[0].scenario.p_flap != 0.5
    assert ms[1].scenario.p_flap == 0.5
    assert "p_flap=0.5" in ms[1].spec()
    assert parse_fleet(f"base={BASE}")[0].backend == "torch"


def test_specs_are_the_jax_tests():
    """BASE, LOSS and DIGEST_SPEC are tests/test_fleet.py's, and the
    corpus stores the DIGEST_SPEC its digests came from."""
    import test_fleet

    assert (BASE, LOSS, DIGEST_SPEC) == (
        test_fleet.BASE, test_fleet.LOSS, test_fleet.DIGEST_SPEC)
    assert _corpus()["digest_spec"]["spec"] == DIGEST_SPEC


@pytest.mark.parametrize("spec", [
    DIGEST_SPEC, REF_SPEC, UNSTACKED_SPEC, CROSS_SPEC, CASCADE_SPEC,
    f"base={BASE};axis=p_death:0.02|0.1;clusters=5",
    f"base={BASE};axis=seed:1|2;clusters=4;cluster=3:pgs=16,hosts=5",
])
def test_parse_fleet_equals_jax(spec):
    from ceph_tpu.fleet.spec import parse_fleet as jparse

    got = [(m.index, m.spec(), m.backend) for m in parse_fleet(spec)]
    want = [(m.index, m.spec(), m.backend) for m in jparse(spec)]
    if "backend=" not in spec:  # the default's name differs
        want = [(i, s, "torch") for i, s, _ in want]
    assert got == want


# unregistered axis built dynamically: a bare literal would trip the JAX
# package's sweep-grammar lint
BAD_SPECS = [
    ("unknown sweep axis", f"base={BASE};axis=flap" + "pers:1|2"),
    ("bad fleet directive", "nonsense"),
    ("sweeps no values", f"base={BASE};axis=seed:|"),
    ("bad axis directive", f"base={BASE};axis=seed"),
    ("beyond the fleet size", f"base={BASE};cluster=7:seed=1"),
    ("neither a Scenario field", f"base={BASE};cluster=0:bogus_field=1"),
    ("want >= 1", f"base={BASE};clusters=0"),
    ("unknown fleet directive", f"base={BASE};colour=red"),
    ("bad cluster override", f"base={BASE};cluster=0"),
]


@pytest.mark.parametrize("match, spec", BAD_SPECS,
                         ids=[m for m, _ in BAD_SPECS])
def test_parse_fleet_errors_equal_jax(match, spec):
    from ceph_tpu.fleet.spec import parse_fleet as jparse

    with pytest.raises(ValueError, match=match) as got:
        parse_fleet(spec)
    with pytest.raises(ValueError) as want:
        jparse(spec)
    msg, jmsg = str(got.value), str(want.value)
    if match == "unknown sweep axis":  # the port's hint names no lint
        msg, jmsg = msg.split(" (declared")[0], jmsg.split(" (declared")[0]
    assert msg == jmsg


def test_backend_error_and_empty_fleet():
    with pytest.raises(ValueError, match="want jax or ref"):
        parse_fleet(f"base={BASE};backend=gpu")
    with pytest.raises(ValueError, match="no members"):
        FleetSim([])


# -- pareto ----------------------------------------------------------------

def _pt(i, cyrs, qps, lost, exp):
    return Point(index=i, spec=f"s{i}", values={
        "cluster_years_per_hour": cyrs, "served_qps": qps,
        "pg_lost": lost, "exposure": exp})


def test_dominates_needs_strict_improvement():
    a = _pt(0, 1.0, 100.0, 0, 0)
    assert not dominates(a.values, _pt(1, 1.0, 100.0, 0, 0).values)
    c = _pt(2, 1.0, 100.0, 1, 0)
    assert dominates(a.values, c.values)
    assert not dominates(c.values, a.values)
    d = _pt(3, 2.0, 50.0, 0, 0)
    assert not dominates(a.values, d.values)
    assert not dominates(d.values, a.values)


def test_pareto_front_accounts_dominated_points():
    pts = [_pt(0, 2.0, 100.0, 0, 0), _pt(1, 1.0, 50.0, 2, 10),
           _pt(2, 0.5, 200.0, 0, 0)]
    front, dominated = pareto_front(pts)
    assert [p.index for p in front] == [0, 2]
    assert [p.index for p in dominated] == [1]
    assert dominated[0].dominated_by == 0


def test_triage_table_renders_front_first():
    pts = [_pt(0, 1.0, 50.0, 2, 10), _pt(1, 2.0, 100.0, 0, 0)]
    pareto_front(pts)
    lines = triage_table(pts).splitlines()
    assert "beaten-by" in lines[0]
    assert lines[1].startswith("1")
    assert "front 1 / dominated 1 of 2 clusters" in lines[-1]


def test_point_from_summary_reads_durability_ledger():
    p = Point.from_summary(3, "spec", {
        "pareto": {"cluster_years_per_hour": 1.5, "served_qps": 42.0},
        "durability": {"pg_lost": 2, "exposure_pg_epochs": 7},
    })
    assert p.values == {"cluster_years_per_hour": 1.5,
                        "served_qps": 42.0, "pg_lost": 2.0,
                        "exposure": 7.0}


def _fixed_points(seed: int, n: int) -> list[tuple]:
    """n points of small integer-valued objectives (ties and dominance
    both frequent), and a long spec to exercise the truncation."""
    rng = np.random.default_rng(seed)
    return [(i, "x" * int(rng.integers(10, 70)) + f"{i}",
             float(rng.integers(0, 4)) / 2, float(rng.integers(0, 3)) * 25,
             int(rng.integers(0, 3)), int(rng.integers(0, 5)))
            for i in range(n)]


@pytest.mark.parametrize("seed, n", [(1, 2), (2, 7), (3, 16), (4, 40)])
def test_pareto_and_triage_equal_jax(seed, n):
    from ceph_tpu.fleet import pareto as jpareto

    def make(mod):
        return [mod.Point(index=i, spec=s, values={
            "cluster_years_per_hour": c, "served_qps": q,
            "pg_lost": float(lo), "exposure": float(ex)})
            for i, s, c, q, lo, ex in _fixed_points(seed, n)]

    got, want = make(sys.modules[Point.__module__]), make(jpareto)
    gf, gd = pareto_front(got)
    wf, wd = jpareto.pareto_front(want)
    assert [(p.index, p.dominated_by) for p in gf + gd] \
        == [(p.index, p.dominated_by) for p in wf + wd]
    assert triage_table(got) == jpareto.triage_table(want)
    assert triage_table(got, max_spec=20) == jpareto.triage_table(
        want, max_spec=20)


# -- the lane-batched stats ------------------------------------------------

def _lane(rng, n_rows, w, n, osds):
    """(prev, rows, n): random rows over `osds` with NONE holes,
    duplicates and moves; n may cut the rows short."""
    rows = rng.integers(0, osds, (n_rows, w)).astype(np.int32)
    rows[rng.random((n_rows, w)) < 0.1] = ITEM_NONE
    prev = rows.copy()
    flip = rng.random((n_rows, w)) < 0.3
    prev[flip] = rng.integers(0, osds, int(flip.sum()))
    prev[rng.random((n_rows, w)) < 0.05] = ITEM_NONE
    return prev, rows, n


LANE_SETS = {
    # (N, W, n, size, tol) per lane: replicated width 3 beside EC 4+2
    "mixed": [(32, 3, 32, 3, 2), (16, 6, 16, 6, 2), (48, 3, 40, 3, 1),
              (1, 6, 1, 6, 2), (64, 4, 64, 4, 1)],
    "same_shape": [(20, 3, 20, 3, 2)] * 3,
    "empty_and_cut": [(8, 3, 0, 3, 2), (12, 6, 5, 6, 2), (4, 2, 4, 2, 0)],
    # n past int32 (wraps if carried as int32, as the JAX uint32 lane
    # scalar is not), tol past size (size - tol < 0), OSD ids near the
    # int32 top and negative ones
    "wide_ints": [(16, 3, 2 ** 32 - 1, 3, 5), (10, 6, 2 ** 31, 6, 2),
                  (6, 3, 6, 3, 2)],
}


@pytest.mark.parametrize("name", sorted(LANE_SETS))
def test_stats_lanes_equal_solo_and_numpy(name):
    rng = np.random.default_rng(len(name))
    lanes = []
    for N, W, n, size, tol in LANE_SETS[name]:
        osds = 2 ** 31 - 2 if name == "wide_ints" else 12
        prev, rows, n = _lane(rng, N, W, n, osds)
        if name == "wide_ints":
            rows[rng.random(rows.shape) < 0.1] = -1
            rows[0, :2] = 2 ** 31 - 2  # a duplicate at the top
        lanes.append((torch.from_numpy(prev), torch.from_numpy(rows), n,
                      size, tol))
    out, moved = lifetime._stats_lanes(*zip(*lanes))
    assert out.dtype == torch.int64 and out.shape == (len(lanes), 6)
    for i, (prev, rows, n, size, tol) in enumerate(lanes):
        solo, solo_moved = lifetime._stats_torch(prev, rows, n, size, tol)
        want, want_moved = lifetime._stats_np(prev.numpy(), rows.numpy(),
                                              n, size, tol)
        assert out[i].tolist() == solo.tolist() == want
        assert moved[i].dtype == torch.int64
        assert moved[i].shape == (rows.shape[0],)
        assert torch.equal(moved[i], solo_moved)
        assert np.array_equal(moved[i].numpy(), want_moved)


def test_stats_lanes_write_no_lane():
    rng = np.random.default_rng(9)
    lanes = [_lane(rng, N, W, N, 12) for N, W in ((9, 3), (5, 6))]
    prevs = [torch.from_numpy(p) for p, _, _ in lanes]
    rowss = [torch.from_numpy(r) for _, r, _ in lanes]
    snaps = [t.clone() for t in prevs + rowss]
    out, moved = lifetime._stats_lanes(prevs, rowss, [9, 5], [3, 6], [2, 2])
    for t, s in zip(prevs + rowss, snaps):
        assert torch.equal(t, s)
    assert all(m.data_ptr() not in {t.data_ptr() for t in prevs + rowss}
               for m in moved)


# -- digests ---------------------------------------------------------------

def test_fleet_digests_match_jax_and_solo():
    """Every member of the stacked port fleet (plain, balanced,
    correlated, data-loss) equals the JAX fleet's digest and member row,
    and a solo port run's digest; the DATA_LOSS latch holds."""
    corpus = _corpus()["digest_spec"]
    assert corpus["spec"] == DIGEST_SPEC  # chip_smoke.py runs the stored one
    members = parse_fleet(DIGEST_SPEC)
    assert members[1].scenario.balance_every == 3
    assert members[2].scenario.correlated == 1
    fleet = port_fleet(DIGEST_SPEC)
    fleet.warm()
    out = fleet.run()
    assert out["clusters"] == 4 and out["balancer_backend"] == "device_loop"
    assert fleet.digests() == corpus["digests"]
    assert comparable_members(out) == corpus["members"]
    assert out["members"][3]["pg_lost"] > 0
    chk = obs.health.checks().get("DATA_LOSS")
    assert chk and chk["severity"] == obs.health.ERR
    t = out["trace_once"]
    assert t["steady_compiles"] == 0 and t["total_compiles"] == 0
    assert t["structural_epochs"] + t["steady_epochs"] \
        == out["fleet_epochs"] == 14
    assert out["cluster_epochs"] == corpus["cluster_epochs"]
    assert out["pareto"]["front_size"] >= 1
    assert out["pareto"]["front_size"] \
        + len(out["pareto"]["dominated"]) == 4
    reset_observers(obs)
    assert [solo_digest(m) for m in members] == corpus["digests"]


def test_fleet_unstacked_matches_stacked(monkeypatch):
    stacked = port_fleet(UNSTACKED_SPEC)
    c0 = dict(fleet_engine.COUNTERS)
    a = stacked.run()
    assert fleet_engine.COUNTERS["stats_calls"] > c0["stats_calls"]
    assert fleet_engine.COUNTERS["solo_lanes"] == c0["solo_lanes"]
    monkeypatch.setenv("CEPH_TPU_FLEET_STACK", "0")
    reset_observers(obs)
    solo = port_fleet(UNSTACKED_SPEC)
    assert not solo.stack
    c1 = dict(fleet_engine.COUNTERS)
    b = solo.run()
    assert fleet_engine.COUNTERS["stats_calls"] == c1["stats_calls"]
    assert fleet_engine.COUNTERS["solo_lanes"] > c1["solo_lanes"]
    assert [m["digest"] for m in a["members"]] \
        == [m["digest"] for m in b["members"]] \
        == _corpus()["unstacked_spec"]["digests"]


class Calls:
    """Rule calls (`pipeline.map_rule` with seeds) and the lane count of
    each `_stats_lanes` call, while the context is open."""

    def __init__(self):
        self.rule = 0
        self.stats = []

    def __enter__(self):
        self._real = real_map, real_stats = (pipeline.map_rule,
                                             lifetime._stats_lanes)

        def map_rule(T, prog, x, weight):
            self.rule += int(x.numel() > 0)
            return real_map(T, prog, x, weight)

        def stats_lanes(prevs, rowss, *a):
            self.stats.append(len(rowss))
            return real_stats(prevs, rowss, *a)

        pipeline.map_rule, lifetime._stats_lanes = map_rule, stats_lanes
        return self

    def __exit__(self, *exc):
        pipeline.map_rule, lifetime._stats_lanes = self._real

    def take(self):
        out = (self.rule, self.stats)
        self.rule, self.stats = 0, []
        return out


def test_small_fleet_rule_and_stats_calls():
    """A fleet epoch makes the rule calls its members make solo, and
    exactly one stats call holding every lane whose rows' tag changed
    (none when no tag changed): the counts `chip_smoke.py`'s
    `fleet_main` holds the card's launches to."""
    with Calls() as calls:
        members = parse_fleet(UNSTACKED_SPEC + ";cluster=1:balance_every=2")
        solo_rule, solo_lanes = [], []
        for m in members:
            sim = LifetimeSim(m.scenario.spec(), device="cpu")
            sim.balancer_options = {"upmap_state_backend": "device_loop"}
            calls.take()
            per = []
            for _ in range(sim.scenario.epochs):
                sim.step()
                rule, stats = calls.take()
                per.append((rule, sum(stats)))
            solo_rule.append([r for r, _ in per])
            solo_lanes.append([s for _, s in per])
            reset_observers(obs)
        fleet = FleetSim(members, device="cpu")
        calls.take()
        for e in range(fleet.members[0].scenario.epochs):
            tags0 = [{p: t[0] for p, t in s._prev_rows.items()}
                     for s in fleet.engines]
            fleet.step()
            rule, stats = calls.take()
            changed = sum(
                sum(1 for p, t in s._prev_rows.items() if t0.get(p) != t[0])
                for s, t0 in zip(fleet.engines, tags0))
            assert rule == sum(r[e] for r in solo_rule)
            lanes = sum(s[e] for s in solo_lanes)
            assert stats == ([lanes] if lanes else [])
            assert lanes == changed
    assert fleet.digests() == [solo_digest(m) for m in members]


@pytest.mark.parametrize("case", ["plan_stacked", "plan_unstacked",
                                  "stats_call"])
def test_device_loss_degrades_like_jax(case, monkeypatch):
    """A device loss degrades the lanes it hits to the bit-exact host
    path, as the JAX engine does: an armed `epoch_apply.3=lost` (through
    the stacked plan, or each member's solo accounting with
    CEPH_TPU_FLEET_STACK=0) records one fallback in the first member,
    as the JAX fleet under the same fault does; a lost stats call
    degrades every lane it carried.  The digests are the unarmed ones."""
    from ceph_tpu.fleet.engine import FleetSim as JFleetSim
    from ceph_tpu.fleet.spec import parse_fleet as jparse
    from ceph_tpu.runtime import faults as jfaults

    clean = port_fleet(UNSTACKED_SPEC)
    clean.run()
    if case == "plan_unstacked":
        monkeypatch.setenv("CEPH_TPU_FLEET_STACK", "0")
    fleet = port_fleet(UNSTACKED_SPEC)
    if case == "stats_call":
        real = lifetime._stats_lanes
        lost = {"left": 1}

        def once(*a, **kw):
            if lost["left"] and fleet.steps >= 2:
                lost["left"] -= 1
                raise DeviceLostError("stats call lost")
            return real(*a, **kw)

        monkeypatch.setattr(lifetime, "_stats_lanes", once)
    else:
        faults.configure("epoch_apply.3=lost:injected x1")
    fleet.run()
    assert fleet.digests() == clean.digests()
    events = [s.provenance()["fallback_events"] for s in fleet.engines]
    if case == "stats_call":
        assert lost["left"] == 0
        assert all(len(ev) >= 1 and "stats call lost" in ev[0]
                   for ev in events)
        return
    jfaults.configure("epoch_apply.3=lost:injected x1")
    try:
        jfleet = JFleetSim(jparse(UNSTACKED_SPEC + ";backend=ref"))
        jfleet.run()
    finally:
        jfaults.disarm_all()
    assert fleet.digests() == jfleet.digests()
    assert events == [s.provenance()["fallback_events"]
                      for s in jfleet.engines]
    assert [len(ev) for ev in events] == [1] + [0] * (len(events) - 1)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetSim(parse_fleet(UNSTACKED_SPEC))
    # an all-host fleet needs no card
    assert FleetSim(parse_fleet(REF_SPEC)).device is None


def test_kept_tensors_are_never_written_in_place():
    """No tensor a member keeps from an epoch (prev rows, moved lanes,
    device backlogs) changes in a later fleet epoch: the moved lanes are
    slices of the stats call's own output."""
    fleet = port_fleet(UNSTACKED_SPEC + ",p_death=0.2,workload=1")
    kept = []
    for _ in range(5):
        fleet.step()
        for sim in fleet.engines:
            for t in ([ent[1] for ent in sim._prev_rows.values()]
                      + [v for v in sim._moved.values() if v is not None]
                      + list(sim.recovery._dev.values())):
                kept.append((t, t.clone()))
        for t, snap in kept:
            assert torch.equal(t, snap)


@pytest.mark.slow
def test_fleet_64_clusters_digest_equivalence():
    spec = (f"base={BASE},epochs=5,seed=3;"
            "axis=correlated:0|1;axis=p_death:0.02|0.12;"
            "axis=recovery_mbps:100|400;axis=pgs:24|32;"
            "clusters=64")
    members = parse_fleet(spec)
    assert len({m.spec() for m in members}) == 64
    solo = [solo_digest(m) for m in members]
    out = port_fleet(spec).run()
    assert [r["digest"] for r in out["members"]] == solo
    assert out["cluster_epochs"] == 64 * 5


# -- checkpoint / resume ---------------------------------------------------

def test_fleet_checkpoint_resume_roundtrip(tmp_path):
    straight = port_fleet(REF_SPEC).run()
    ck = tmp_path / "fleet.json"
    a = port_fleet(REF_SPEC, checkpoint=str(ck))
    a.run(stop_after=3)
    assert a.steps == 3
    b = port_fleet(REF_SPEC, checkpoint=str(ck), resume=True)
    assert b.resumed_from == 3
    out = b.run()
    assert out["resumed_from"] == 3
    assert [m["digest"] for m in out["members"]] \
        == [m["digest"] for m in straight["members"]] \
        == _corpus()["ref_spec"]["digests"]


def _stopped(tmp_path, spec=REF_SPEC):
    ck = tmp_path / "fleet.json"
    port_fleet(spec, checkpoint=str(ck)).run(stop_after=2)
    return ck


def _refusal(ck, members) -> str:
    with pytest.raises(ValueError) as ei:
        FleetSim(members, checkpoint=str(ck), resume=True, device="cpu")
    return str(ei.value)


def test_fleet_resume_refuses_count_mismatch(tmp_path):
    ck = _stopped(tmp_path)
    msg = _refusal(ck, parse_fleet(
        f"base={BASE},epochs=6;axis=seed:1|2;backend=ref"))
    assert "cluster count: checkpoint 4 != requested 2" in msg


def test_fleet_resume_refuses_order_drift(tmp_path):
    ck = _stopped(tmp_path)
    reordered = parse_fleet(REF_SPEC)
    reordered[1], reordered[2] = reordered[2], reordered[1]
    msg = _refusal(ck, reordered)
    assert "cluster 1" in msg and "cluster 2" in msg
    assert "checkpoint" in msg and "requested" in msg


def test_fleet_resume_refuses_single_spec_drift(tmp_path):
    ck = _stopped(tmp_path)
    msg = _refusal(ck, parse_fleet(REF_SPEC + ";cluster=2:recovery_mbps=50"))
    assert "cluster 2: recovery_mbps" in msg
    assert "'200.0'" in msg and "'50.0'" in msg
    assert "cluster 0" not in msg and "cluster 1" not in msg


def test_fleet_resume_refuses_backend_drift(tmp_path):
    ck = _stopped(tmp_path)
    drifted = parse_fleet(REF_SPEC)
    drifted[0].backend = "torch"
    msg = _refusal(ck, drifted)
    assert "cluster 0: backend: checkpoint 'ref' != requested 'torch'" \
        in msg


@pytest.mark.parametrize("drift", ["count", "order", "spec", "backend"])
def test_resume_refusals_equal_jax(drift, tmp_path):
    """The four drift refusals give the JAX engine's message, byte for
    byte, on the same checkpoint."""
    from ceph_tpu.fleet.engine import FleetSim as JaxFleet
    from ceph_tpu.fleet.spec import parse_fleet as jparse

    ck = _stopped(tmp_path)
    specs = {"count": f"base={BASE},epochs=6;axis=seed:1|2;backend=ref",
             "order": REF_SPEC, "spec": REF_SPEC + ";cluster=1:pgs=16",
             "backend": REF_SPEC}
    mine, theirs = parse_fleet(specs[drift]), jparse(specs[drift])
    if drift == "order":
        mine[0], mine[3] = mine[3], mine[0]
        theirs[0], theirs[3] = theirs[3], theirs[0]
    if drift == "backend":
        mine[2].backend = theirs[2].backend = "jax"
    with pytest.raises(ValueError) as want:
        JaxFleet(theirs, checkpoint=str(ck), resume=True)
    assert _refusal(ck, mine) == str(want.value)


def test_jax_and_torch_spellings_resume_each_other(tmp_path):
    """jax and torch are one backend to the port's resume; ref is not."""
    ck = _stopped(tmp_path, UNSTACKED_SPEC + ";backend=jax")
    ref = parse_fleet(UNSTACKED_SPEC + ";backend=ref")
    assert "cluster 0: backend: checkpoint 'jax' != requested 'ref'" \
        in _refusal(ck, ref)
    members = parse_fleet(UNSTACKED_SPEC)  # spelled torch
    b = FleetSim(members, checkpoint=str(ck), resume=True, device="cpu")
    assert b.resumed_from == 2
    assert [m["digest"] for m in b.run()["members"]] \
        == _corpus()["unstacked_spec"]["digests"]


def test_fleet_resume_needs_fleet_state(tmp_path):
    with pytest.raises(ValueError, match="no fleet state"):
        port_fleet(REF_SPEC, checkpoint=str(tmp_path / "empty.json"),
                   resume=True)


def test_fleet_fault_kill_mid_cascade_then_resume(tmp_path):
    """A member mid-cascade (open hazard windows) when an armed
    `hazard_decay` fault kills the whole stack: the checkpoint holds the
    pre-decay strengths and the resumed fleet replays every member to the
    straight run's digests."""
    straight = port_fleet(CASCADE_SPEC).run()
    assert [m["digest"] for m in straight["members"]] \
        == _corpus()["cascade_spec"]["digests"]
    reset_observers(obs)
    probe_sc = parse_fleet(CASCADE_SPEC)[0].scenario
    probe = LifetimeSim(probe_sc.spec(), backend="ref")
    stop = None
    for e in range(1, probe_sc.epochs - 2):
        probe.step()
        if probe.hazards:
            stop = e
            break
    assert stop is not None, "scenario opened no hazard window"
    reset_observers(obs)
    ck = tmp_path / "fleet.json"
    a = port_fleet(CASCADE_SPEC, checkpoint=str(ck))
    a.run(stop_after=stop)
    assert a.engines[0].hazards
    faults.arm("hazard_decay", "fail", "mid-cascade fleet kill", 1)
    with pytest.raises(faults.FaultInjected):
        a.step()
    faults.disarm("hazard_decay")
    b = port_fleet(CASCADE_SPEC, checkpoint=str(ck), resume=True)
    assert b.resumed_from == stop
    assert b.engines[0].hazards
    out = b.run()
    assert [m["digest"] for m in out["members"]] \
        == [m["digest"] for m in straight["members"]]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_the_packages(writer, tmp_path):
    """A fleet checkpoint written by one package, device members spelled
    "jax", resumes in the other to the straight-run digests."""
    from ceph_tpu import obs as jobs
    from ceph_tpu.fleet.engine import FleetSim as JaxFleet
    from ceph_tpu.fleet.spec import parse_fleet as jparse

    want = _corpus()["cross_spec"]["digests"]
    ck = tmp_path / "fleet.json"
    if writer == "jax":
        JaxFleet(jparse(CROSS_SPEC), checkpoint=str(ck)).run(
            stop_after=CROSS_STOP)
        reset_observers(jobs)
        b = port_fleet(CROSS_SPEC, checkpoint=str(ck), resume=True)
    else:
        port_fleet(CROSS_SPEC, checkpoint=str(ck)).run(
            stop_after=CROSS_STOP)
        state = json.loads(ck.read_text())["fleet"]
        assert [m["backend"] for m in state["members"]] == ["jax", "jax"]
        reset_observers(obs)
        b = JaxFleet(jparse(CROSS_SPEC), checkpoint=str(ck), resume=True)
    assert b.resumed_from == CROSS_STOP
    assert [m["digest"] for m in b.run()["members"]] == want


def port_counts(spec: str) -> dict:
    """The port's rule calls and the lane count of each stats call, fleet
    epoch by fleet epoch, on the CPU: what `chip_smoke.py`'s
    `fleet_corpus` holds the card's launches to."""
    rule, stats = [], []
    reset_observers(obs)
    with Calls() as calls:
        fleet = port_fleet(spec)
        init = calls.take()[0]
        while fleet.live():
            fleet.step()
            r, st = calls.take()
            rule.append(r)
            stats.append(st)
    reset_observers(obs)
    return {"init_rule_calls": init, "rule_calls": rule,
            "stats_lanes": stats}


def test_digest_spec_calls_equal_the_corpus():
    want = _corpus()["digest_spec"]
    got = port_counts(DIGEST_SPEC)
    assert {k: want[k] for k in got} == got
    assert all(len(s) <= 1 for s in got["stats_lanes"])


# -- the corpus --------------------------------------------------------------

def _jax_run(spec: str) -> dict:
    from ceph_tpu import obs as jobs
    from ceph_tpu.fleet.engine import FleetSim as JaxFleet
    from ceph_tpu.fleet.spec import parse_fleet as jparse

    reset_observers(jobs)
    fleet = JaxFleet(jparse(spec))
    fleet.warm()
    out = fleet.run()
    rows = comparable_members(out)
    for r in rows:  # the default backend's name differs
        if "backend=" not in spec:
            r["backend"] = "torch"
    reset_observers(jobs)
    return {"spec": spec, "digests": fleet.digests(), "members": rows,
            "cluster_epochs": out["cluster_epochs"]}


if __name__ == "__main__":
    from test_torch_fleet_cli import jax_cli_outputs

    CORPUS.write_text(json.dumps({
        "cli": jax_cli_outputs(),
        "digest_spec": dict(_jax_run(DIGEST_SPEC),
                            **port_counts(DIGEST_SPEC)),
        "unstacked_spec": _jax_run(UNSTACKED_SPEC),
        "ref_spec": _jax_run(REF_SPEC),
        "cross_spec": _jax_run(CROSS_SPEC),
        "cascade_spec": _jax_run(CASCADE_SPEC),
    }, indent=1, sort_keys=True) + "\n")
    print(f"wrote {CORPUS}")
