"""`sim/failure.py` (ClusterSim, MovementReport, diff_mappings) held
against the JAX package.

- ClusterSim on the card's path (backend "torch", here on the CPU) and on
  the host oracle (backend "ref") gives the JAX ClusterSim's reports,
  diag_history and rows on the maps of tests/test_aux.py::TestClusterSim
  and tests/test_explain.py::TestEpochAccounting, through fail (out and
  not out), revive, reweight, pg_temp and balance events;
- `thrash(rounds, default_rng(s))` gives the JAX thrasher's events;
- `diff_mappings` (tensor ops) equals the JAX per-PG loop on random rows
  with ITEM_NONE holes, reordered lists and primary changes, on numpy
  and on tensors, widths equal or not;
- BASELINE config 2 (100k PGs / 1024 OSDs) through a fail and a
  reweight (slow-marked).

The JAX package's outputs are stored in tests/data/sim_corpus.json;
`python tests/test_torch_sim_failure.py` rewrites it (about 1 min on the
CPU; config 2's scenario is kept unless `--config2` is given, which
takes a few minutes more).
"""

import dataclasses
import functools
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu_torch.crush.types import ITEM_NONE  # noqa: E402
from ceph_tpu_torch.sim import failure  # noqa: E402

CORPUS = ROOT / "tests" / "data" / "sim_corpus.json"


# -- the scenarios (ceph_tpu OSDMaps, events by name) --------------------------

def _aux_map(pg_num=128):
    from ceph_tpu.osd.osdmap import build_hierarchical
    from ceph_tpu.osd.types import PgPool, PoolType

    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                  pg_num=pg_num, pgp_num=pg_num)
    return build_hierarchical(6, 4, pool=pool)


def _accounting_map():
    from ceph_tpu.osd.osdmap import build_hierarchical
    from ceph_tpu.osd.types import PgPool

    return build_hierarchical(4, 4, pool=PgPool(pg_num=64, size=3))


def _config2():
    from ceph_tpu.osd.osdmap import build_hierarchical
    from ceph_tpu.osd.types import PgPool, PoolType

    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                  pg_num=100_000, pgp_num=100_000)
    return build_hierarchical(128, 8, n_rack=8, pool=pool)


# (method, args, kwargs) in order; ("pg_temp", ...) takes (seed, acting)
SCENARIOS = {
    "aux_events": (_aux_map, [
        ("fail_osd", (5,), {}),
        ("fail_osd", (9,), {"out": False}),
        ("revive_osd", (5,), {}),
        ("reweight_osd", (3, 0.5), {}),
        ("pg_temp", (1, [0, 4, 8]), {}),
        ("balance", (), {"max_deviation": 1}),
    ]),
    "fail_revive": (_aux_map, [("fail_osd", (7,), {}),
                               ("revive_osd", (7,), {})]),
    "epoch_accounting": (_accounting_map, [("fail_osd", (3,), {})]),
    "config2": (_config2, [("fail_osd", (0,), {}),
                           ("reweight_osd", (9, 0.5), {})]),
}
THRASH = {"thrash_64": (lambda: _aux_map(64), 8, 3)}
# the scenarios run with diagnostics (config 2's host-oracle accounting of
# 100k PGs an epoch would take most of an hour to store)
DIAGNOSED = ("aux_events", "fail_revive", "epoch_accounting")


def run_scenario(sim, events) -> None:
    for method, args, kw in events:
        if method == "pg_temp":
            from ceph_tpu_torch.osd.types import PgId as PortPgId

            pg = (PortPgId if isinstance(sim, failure.ClusterSim) else
                  __import__("ceph_tpu.osd.types",
                             fromlist=["PgId"]).PgId)(0, args[0])
            sim.set_pg_temp(pg, list(args[1]))
        else:
            getattr(sim, method)(*args, **kw)


def rows_digest(current: dict) -> str:
    h = hashlib.sha256()
    for pid in sorted(current):
        up, upp, acting, actp = current[pid]
        for a in (up, upp, acting, actp):
            a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
            a = np.asarray(a, np.int32)
            if a.ndim == 2:  # the rows' width is the pool size
                a = a[:, :3]
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def record(sim) -> dict:
    return {
        "reports": [[label, dataclasses.asdict(r)]
                    for label, r in sim.history],
        "diag_history": json.loads(json.dumps(sim.diag_history)),
        "rows_sha256": rows_digest(sim.current),
        "epoch": sim.epoch,
    }


def jax_scenario(name: str) -> dict:
    """The JAX ClusterSim's record, with each epoch's diagnostics also
    derived from its host oracle (`host_diag_history`): the JAX window
    leaves some lanes unresolved, the port's kernel none."""
    from ceph_tpu.obs import placement
    from ceph_tpu.sim.failure import ClusterSim as JaxClusterSim
    from test_torch_diag import host_summary

    host: list = []

    class Sim(JaxClusterSim):
        def _diagnose_epoch(self, label):
            agg = {"epoch": int(self.epoch), "label": label}
            for pid in sorted(self.m.pools):
                placement.fold_summary(agg, host_summary(self.m, pid))
            host.append([label, agg])
            return super()._diagnose_epoch(label)

    make, events = SCENARIOS[name]
    sim = Sim(make(), backend="jax", diagnostics=name in DIAGNOSED)
    run_scenario(sim, events)
    return dict(record(sim), host_diag_history=host)


def jax_thrash(name: str) -> dict:
    from ceph_tpu.sim.failure import ClusterSim as JaxClusterSim

    make, rounds, seed = THRASH[name]
    sim = JaxClusterSim(make(), backend="ref")
    sim.thrash(rounds, rng=np.random.default_rng(seed))
    return record(sim)


@functools.cache
def corpus() -> dict:
    return json.loads(CORPUS.read_text())


def port_map(make):
    from ceph_tpu_torch.osd.carry import osdmap_from_reference
    from test_torch_pipeline import osdmap_dict

    return osdmap_from_reference(osdmap_dict(make()))


def port_scenario(name: str, backend: str) -> dict:
    make, events = SCENARIOS[name]
    sim = failure.ClusterSim(port_map(make), backend=backend,
                             diagnostics=name in DIAGNOSED,
                             device="cpu" if backend == "torch" else None)
    run_scenario(sim, events)
    return record(sim)


def _compare(got: dict, want: dict, backend: str) -> None:
    assert got["reports"] == want["reports"]
    assert got["rows_sha256"] == want["rows_sha256"]
    assert got["epoch"] == want["epoch"]
    if backend == "ref":
        # the JAX ref pass's accounting: bad mappings counted from the up
        # rows, no retry visibility (the stored history is the device's)
        assert [(lab, agg["pgs"], agg["diag_exact"])
                for lab, agg in got["diag_history"]] == \
            [(lab, agg["pgs"], False) for lab, agg in want["diag_history"]]
        return
    for (lab, agg), (_, wagg), (_, hagg) in zip(
            got["diag_history"], want["diag_history"],
            want["host_diag_history"], strict=True):
        # the JAX summary where it is exact and resolved every lane,
        # else the host oracle's
        exact = wagg["diag_exact"] and wagg["unresolved"] == 0
        assert agg == (wagg if exact else hagg), lab
        if exact:
            assert wagg == hagg


@pytest.mark.parametrize("backend", ["torch", "ref"])
@pytest.mark.parametrize("name", ["aux_events", "fail_revive",
                                  "epoch_accounting"])
def test_cluster_sim_equals_jax(name, backend):
    _compare(port_scenario(name, backend), corpus()["scenarios"][name],
             backend)


@pytest.mark.slow
def test_cluster_sim_config2_equals_jax():
    """BASELINE config 2, without diagnostics: about 8 s on an idle CPU,
    about 240 s beside three other test workers."""
    _compare(port_scenario("config2", "torch"),
             corpus()["scenarios"]["config2"], "torch")


@pytest.mark.parametrize("backend", ["torch", "ref"])
def test_thrash_equals_jax(backend):
    make, rounds, seed = THRASH["thrash_64"]
    sim = failure.ClusterSim(port_map(make), backend=backend,
                             device="cpu" if backend == "torch" else None)
    reports = sim.thrash(rounds, rng=np.random.default_rng(seed))
    assert len(reports) == rounds
    got = record(sim)
    want = corpus()["thrash"]["thrash_64"]
    assert got["reports"] == want["reports"]
    assert got["rows_sha256"] == want["rows_sha256"]
    up = sim.current[0][0]
    assert bool((torch.as_tensor(up) != ITEM_NONE).any(1).all())


def test_stored_scenarios_are_the_jax_packages():
    assert jax_scenario("epoch_accounting") == \
        corpus()["scenarios"]["epoch_accounting"]
    assert jax_thrash("thrash_64") == corpus()["thrash"]["thrash_64"]


def test_torch_rows_stay_on_the_device():
    sim = failure.ClusterSim(port_map(_accounting_map), device="cpu")
    assert all(isinstance(t, torch.Tensor) for t in sim.current[0])
    sim.fail_osd(1)
    assert all(isinstance(t, torch.Tensor) for t in sim.current[0])
    assert sim.provenance() == {"backend": "torch",
                                "device_loss_fallbacks": 0,
                                "fallback_events": []}


def test_diagnostics_off_by_default(monkeypatch):
    monkeypatch.delenv("CEPH_TPU_PLACEMENT_DIAG", raising=False)
    sim = failure.ClusterSim(port_map(_accounting_map), device="cpu")
    sim.fail_osd(1)
    assert sim.diag_history == []
    monkeypatch.setenv("CEPH_TPU_PLACEMENT_DIAG", "1")
    sim = failure.ClusterSim(port_map(_accounting_map), device="cpu")
    assert [lab for lab, _ in sim.diag_history] == ["init"]


def test_no_card_raises_and_unknown_backend():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        failure.ClusterSim(port_map(_accounting_map))
    with pytest.raises(ValueError, match="unknown backend"):
        failure.ClusterSim(port_map(_accounting_map), backend="native")


# -- diff_mappings ---------------------------------------------------------------

def random_mapping(rng, n: int, w: int, n_osd: int, base=None):
    """(up, up_primary, acting, acting_primary) numpy rows with ITEM_NONE
    holes; from `base`, some rows reordered, some changed, some primaries
    moved."""
    if base is None:
        up = rng.integers(0, n_osd, (n, w)).astype(np.int32)
    else:
        up = base[0][:, :w].copy() if base[0].shape[1] >= w else np.concatenate(
            [base[0], np.full((n, w - base[0].shape[1]), ITEM_NONE,
                              np.int32)], 1)
        k = rng.random(n)
        for i in np.nonzero(k < 0.2)[0]:
            up[i] = rng.permutation(up[i])
        for i in np.nonzero((k >= 0.2) & (k < 0.5))[0]:
            up[i, rng.integers(w)] = rng.integers(0, n_osd)
    up[rng.random((n, w)) < 0.15] = ITEM_NONE
    upp = np.where(rng.random(n) < 0.1, rng.integers(0, n_osd, n),
                   up[:, 0]).astype(np.int32)
    return (up, upp, up.copy(), upp.copy())


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("widths", [(3, 3), (3, 5), (6, 4)])
def test_diff_mappings_equals_jax_loop(widths, as_tensor):
    from ceph_tpu.sim.failure import diff_mappings as jax_diff

    rng = np.random.default_rng(sum(widths) + 7 * as_tensor)
    pools = {0: type("P", (), {"size": 3})(), 1: type("P", (), {"size": 4})()}
    before, after = {}, {}
    for pid, n in ((0, 500), (1, 300)):
        before[pid] = random_mapping(rng, n, widths[0], 12)
        after[pid] = random_mapping(rng, n, widths[1], 12, before[pid])
    want = jax_diff(before, after, pools)
    if as_tensor:
        before = {p: tuple(torch.from_numpy(a) for a in v)
                  for p, v in before.items()}
        after = {p: tuple(torch.from_numpy(a) for a in v)
                 for p, v in after.items()}
    got = failure.diff_mappings(before, after, pools)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert want.pgs_remapped and want.replicas_moved \
        and want.pgs_primary_changed and want.degraded_pgs


def test_diff_mappings_counts_distinct_new_osds():
    """len(set(after) - set(before)): a repeated new OSD counts once."""
    from ceph_tpu.sim.failure import diff_mappings as jax_diff

    pools = {0: type("P", (), {"size": 3})()}
    b = np.array([[1, 2, 3]], np.int32)
    a = np.array([[4, 4, ITEM_NONE]], np.int32)
    p = np.array([1], np.int32)
    before, after = {0: (b, p, b, p)}, {0: (a, p, a, p)}
    want = jax_diff(before, after, pools)
    got = failure.diff_mappings(before, after, pools)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.replicas_moved == 1 and got.degraded_pgs == 1


def test_movement_report_merge():
    a = failure.MovementReport(total_pgs=10, pgs_remapped=2)
    a.merge(failure.MovementReport(total_pgs=10, pgs_remapped=3,
                                   replicas_moved=4))
    assert (a.total_pgs, a.pgs_remapped, a.replicas_moved) == (20, 5, 4)
    assert a.moved_fraction == 0.25


def write_corpus(with_config2: bool) -> None:
    old = json.loads(CORPUS.read_text()) if CORPUS.exists() else {}
    names = [n for n in SCENARIOS if with_config2 or n != "config2"]
    scenarios = {n: jax_scenario(n) for n in names}
    if not with_config2 and "config2" in old.get("scenarios", {}):
        scenarios["config2"] = old["scenarios"]["config2"]
    CORPUS.write_text(json.dumps({
        "about": "the JAX ClusterSim's reports, diag_history and rows "
                 "digests (python tests/test_torch_sim_failure.py "
                 "[--config2] rewrites it)",
        "scenarios": scenarios,
        "thrash": {n: jax_thrash(n) for n in THRASH},
    }))


if __name__ == "__main__":
    write_corpus("--config2" in sys.argv)
