"""LifetimeSim's checkpoints, CLI, fault points, observers and invariant
negative controls, held against the JAX package.

- A checkpoint the JAX package writes resumes in the port to the JAX
  final digest, and one the port writes resumes in the JAX package
  (queue recovery with the workload, and correlated failures mid-cascade
  with wounds open);
- the deterministic kill (`CEPH_TPU_FAULTS="lifetime_step.8=exit:9"`)
  of `python -m ceph_tpu_torch.cli.sim run` and `--resume` give the
  uninterrupted digest; `--resume` without `--scenario` adopts the
  checkpoint's scenario;
- on a run placed on the host, `epoch_apply=lost` and
  `recovery_step=lost` degrade to the host mapper with the JAX engine's
  digest and fallback events (on a card they raise:
  tests/test_torch_runtime.py);
- `DATA_LOSS` latches as in the JAX package;
- `cli.sim digest` prints the JAX CLI's bytes, and `run` its lines but
  the ones that print wall-clock rates;
- `corrupt_hook` and `recovery_corrupt_hook` give the JAX package's
  violation messages, and `check_rows_invariants` /
  `check_pg_temp_invariants` its messages on seeded bad rows;
- no tensor the engine keeps from an epoch (the previous rows, the moved
  lanes, the backlog vectors) is written in place by a later epoch;
- `runtime.Checkpoint` writes and resumes the JAX store's layout, and
  `obs.health`'s registry, muting and dump equal the JAX package's.

The digests are tests/data/lifetime_corpus.json's (test_torch_lifetime.py
writes it).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from ceph_tpu_torch import obs  # noqa: E402
from ceph_tpu_torch.runtime import DeviceLostError, faults  # noqa: E402
from ceph_tpu_torch.sim import lifetime  # noqa: E402
from test_torch_lifetime import (  # noqa: E402
    CORR,
    SCENARIOS,
    TINY,
    _corpus,
    reset_observers,
)


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


def _jax_sim(*a, **kw):
    from ceph_tpu.sim.lifetime import LifetimeSim

    return LifetimeSim(*a, **kw)


# -- checkpoints across the packages ---------------------------------------

@pytest.mark.parametrize("name, stop", [("tiny_wl", 5), ("corr", 7)])
def test_port_resumes_a_jax_checkpoint(name, stop, tmp_path):
    spec, forced = SCENARIOS[name]
    assert not forced
    ck = tmp_path / "ck.json"
    _jax_sim(spec, backend="ref", checkpoint=str(ck)).run(stop_after=stop)
    sim = lifetime.LifetimeSim(spec, backend="torch", device="cpu",
                               checkpoint=str(ck), resume=True)
    assert sim.resumed_from == stop
    out = sim.run()
    assert out["digest"] == _corpus()[name]["digest"]
    assert out["epochs"] == sim.scenario.epochs
    assert out["resumed_from"] == stop
    assert out["health"]["timeline_samples"] == sim.scenario.epochs


@pytest.mark.parametrize("name, stop", [("tiny_wl", 5), ("corr", 7)])
def test_jax_resumes_a_port_checkpoint(name, stop, tmp_path):
    spec, _ = SCENARIOS[name]
    ck = tmp_path / "ck.json"
    lifetime.LifetimeSim(spec, backend="torch", device="cpu",
                         checkpoint=str(ck)).run(stop_after=stop)
    state = json.loads(ck.read_text())["lifetime"]
    assert state["steps"] == stop and state["scenario"] == \
        lifetime.Scenario.parse(spec).spec()
    sim = _jax_sim(spec, backend="ref", checkpoint=str(ck), resume=True)
    assert sim.resumed_from == stop
    assert sim.run()["digest"] == _corpus()[name]["digest"]


def test_resume_rejects_a_different_scenario(tmp_path):
    ck = tmp_path / "ck.json"
    spec = TINY + ",balance_every=0,epochs=2,spotcheck_every=0"
    lifetime.LifetimeSim(spec, backend="torch", device="cpu",
                         checkpoint=str(ck)).run()
    with pytest.raises(ValueError, match="different scenario"):
        lifetime.LifetimeSim(spec + ",seed=99", backend="torch",
                             device="cpu", checkpoint=str(ck), resume=True)


# -- the kill, the CLI -----------------------------------------------------

def _cli(argv, env_extra=None, cwd=ROOT):
    env = {**os.environ, **(env_extra or {})}
    if env_extra is None:
        env.pop("CEPH_TPU_FAULTS", None)
    return subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.cli.sim"] + argv,
        env=env, capture_output=True, text=True, timeout=240, cwd=cwd)


def test_kill_and_cli_resume_digest_identical(tmp_path):
    """The armed `lifetime_step.8=exit:9` dies mid-run (os._exit);
    `--resume` continues from the last checkpoint to the digest an
    uninterrupted run gives."""
    spec = (TINY + ",balance_every=0,epochs=14,checkpoint_every=4,"
            "spotcheck_every=0")
    ck = tmp_path / "ck.json"
    r = _cli(["run", "--scenario", spec, "--device", "cpu",
              "--checkpoint", str(ck)],
             {"CEPH_TPU_FAULTS": "lifetime_step.8=exit:9"})
    assert r.returncode == 9, r.stderr[-500:]
    assert json.loads(ck.read_text())["lifetime"]["steps"] == 4
    r2 = _cli(["digest", "--device", "cpu", "--checkpoint", str(ck),
               "--resume"])
    assert r2.returncode == 0, r2.stderr[-500:]
    straight = lifetime.LifetimeSim(spec, backend="torch",
                                    device="cpu").run()
    assert r2.stdout == straight["digest"] + "\n"


def _main_stdout(main, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_cli_digest_prints_the_jax_bytes():
    from ceph_tpu.cli import sim as jax_cli
    from ceph_tpu_torch.cli import sim as port_cli

    spec, _ = SCENARIOS["tiny_wl"]
    want = _main_stdout(jax_cli.main, ["digest", "--scenario", spec,
                                       "--backend", "ref"])
    reset_observers(obs)
    got = _main_stdout(port_cli.main, ["digest", "--scenario", spec,
                                       "--device", "cpu"])
    assert got == want
    assert want[1] == _corpus()["tiny_wl"]["digest"] + "\n"


RATE_LINES = ("rate ", "pareto ")  # the lines that print wall-clock rates


@pytest.mark.parametrize("backend", ["ref", "jax"])
def test_cli_run_prints_the_jax_lines(backend):
    """`run` on a correlated, workload scenario (every section printed):
    the JAX CLI's stdout but its wall-clock rate lines, on the port's
    host backend and on its device backend (named "jax", so the backend
    line reads as the JAX one; its trace-once line reads the port's 0
    compiles)."""
    from ceph_tpu.cli import sim as jax_cli
    from ceph_tpu_torch.cli import sim as port_cli

    spec, _ = SCENARIOS["corr_wl_outages"]
    rc_j, want = _main_stdout(jax_cli.main, ["run", "--scenario", spec,
                                             "--backend", "ref"])
    argv = ["run", "--scenario", spec, "--backend", backend]
    if backend == "jax":
        argv += ["--device", "cpu"]
    rc_p, got = _main_stdout(port_cli.main, argv)
    assert rc_p == rc_j == 0

    def kept(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith(RATE_LINES)
                and not (backend == "jax" and ln.startswith(
                    ("trace-once ", "backend ")))]

    assert kept(got) == kept(want)
    assert "chaos " in got and "durability " in got and "workload " in got
    if backend == "jax":
        assert "backend         jax (0 device-loss degradations)" in got


def test_cli_resume_adopts_checkpoint_scenario(tmp_path):
    from ceph_tpu_torch.cli import sim as port_cli

    spec = TINY + ",balance_every=0,epochs=6,spotcheck_every=0"
    ck = tmp_path / "ck.json"
    rc, _ = _main_stdout(port_cli.main, [
        "digest", "--scenario", spec, "--device", "cpu",
        "--checkpoint", str(ck), "--stop-after", "4"])
    assert rc == 0
    rc, resumed = _main_stdout(port_cli.main, [
        "digest", "--device", "cpu", "--checkpoint", str(ck), "--resume"])
    assert rc == 0
    straight = lifetime.LifetimeSim(spec, backend="ref").run()
    assert resumed.strip() == straight["digest"]
    assert _main_stdout(port_cli.main, ["digest", "--resume"]) == (2, "")


# -- faults: a device loss degrades to the host, as in the JAX package ------

@pytest.mark.parametrize("name, point", [
    ("tiny", "epoch_apply.6"),     # tests/test_lifetime.py's arming
    ("tiny", "recovery_step.3"),   # tests/test_recovery.py's arming
    ("tiny_wl", "recovery_step.3"),
    ("corr", "epoch_apply.4"),
])
def test_device_loss_degrades_like_jax(name, point):
    """On a run placed on the host (device "cpu") an armed device loss
    degrades that epoch's pool accounting (or the rest of its recovery
    drain) to the host mapper: the port's digest,
    fallback events and recovery fallback epochs equal the JAX engine's
    under the same fault, and the digest equals the unarmed one."""
    from ceph_tpu.runtime import faults as jfaults

    spec = SCENARIOS[name][0]
    arm = f"{point}=lost:chaos x1"
    faults.configure(arm)
    out = lifetime.LifetimeSim(spec, backend="torch", device="cpu").run()
    jfaults.configure(arm)
    jout = _jax_sim(spec, backend="ref").run()
    assert out["digest"] == jout["digest"] == _corpus()[name]["digest"]
    prov, jprov = out["provenance"], jout["provenance"]
    assert prov["device_loss_fallbacks"] == jprov["device_loss_fallbacks"]
    assert prov["device_loss_fallbacks"] == 1
    assert prov["fallback_events"] == jprov["fallback_events"]
    assert f"epoch {point.split('.')[1]}" in prov["fallback_events"][0]
    assert prov["backend"] == "torch"
    if "recovery" in out:
        assert out["recovery"]["fallback_epochs"] == \
            jout["recovery"]["fallback_epochs"]
    assert out["invariant_violations"] == 0
    assert faults.COUNTERS["faults_fired"] >= 1


def test_fault_grammar_matches_the_jax_package():
    from ceph_tpu.runtime import faults as jfaults

    spec = "lifetime_step.8=exit:9,epoch_apply=lost@p0.3x2,stage=fail"
    faults.configure(spec)
    jfaults.configure(spec)
    assert faults.active() == jfaults.active()
    assert faults.FAULT_POINTS.keys() == jfaults.FAULT_POINTS.keys()
    fired = []
    for _ in range(12):  # the same deterministic @p fire/skip sequence
        try:
            faults.check("epoch_apply", "4")
            fired.append(False)
        except DeviceLostError:
            fired.append(True)
    jfired = []
    for _ in range(12):
        try:
            jfaults.check("epoch_apply", "4")
            jfired.append(False)
        except jfaults.DeviceLostError:
            jfired.append(True)
    assert fired == jfired and sum(fired) == 2
    with pytest.raises(ValueError, match="unknown fault action"):
        faults.configure("x=explode")
    assert faults.looks_like_device_loss(DeviceLostError("x"))
    assert not faults.looks_like_device_loss(RuntimeError("device lost"))


# -- health: DATA_LOSS latches ----------------------------------------------

def test_data_loss_latches_as_in_jax():
    spec, _ = SCENARIOS["data_loss"]
    out = lifetime.LifetimeSim(spec, backend="torch", device="cpu").run()
    assert out["durability"]["pg_lost"] > 0
    h = obs.health
    chk = h.checks().get("DATA_LOSS")
    assert chk and chk["severity"] == h.ERR
    h.evaluate()  # standard evaluation never clears the latch
    assert "DATA_LOSS" in h.checks() and h.status() == h.ERR
    h.clear("DATA_LOSS")  # the explicit operator ack
    assert "DATA_LOSS" not in h.checks()
    assert out["health"] == _corpus()["data_loss"]["summary"]["health"]


def test_health_and_timeline_are_pure_observers(monkeypatch):
    """CEPH_TPU_HEALTH=0 and CEPH_TPU_TIMELINE_CAP=0 change no digest."""
    spec, _ = SCENARIOS["corr"]
    monkeypatch.setenv("CEPH_TPU_HEALTH", "0")
    monkeypatch.setenv("CEPH_TPU_TIMELINE_CAP", "0")
    out = lifetime.LifetimeSim(spec, backend="torch", device="cpu").run()
    assert out["digest"] == _corpus()["corr"]["digest"]
    assert out["health"]["epochs"] == {"ok": 0, "warn": 0, "err": 0}
    assert out["health"]["timeline_samples"] == 0


def test_timeline_state_round_trips_as_in_jax(monkeypatch):
    from ceph_tpu import obs as jobs

    monkeypatch.setenv("CEPH_TPU_TIMELINE_CAP", "4")
    for mod in (obs.timeline, jobs.timeline):
        for i in range(23):
            mod.sample("s", {"a": i, "b": i * 0.5} if i % 3 else {"a": i})
    st = obs.timeline.state("s")
    assert st == jobs.timeline.state("s")
    assert obs.timeline.dump("s") == jobs.timeline.dump("s")
    obs.timeline.reset()
    obs.timeline.restore("s", st)
    assert obs.timeline.next_index("s") == 23
    assert obs.timeline.last("s") == jobs.timeline.last("s")


# -- invariants ---------------------------------------------------------------

def test_corrupt_hook_gives_the_jax_violations():
    spec = TINY + ",balance_every=0,epochs=3,spotcheck_every=0"

    def corrupt(pid, rows):
        if pid == 0:
            rows = rows.copy()
            rows[1, 1] = rows[1, 0]  # duplicate OSD in pg 0.1
        return rows

    j = _jax_sim(spec, backend="ref")
    j.corrupt_hook = corrupt
    want = j.run()
    p = lifetime.LifetimeSim(spec, backend="ref")
    p.corrupt_hook = corrupt
    got = p.run()
    assert got["invariant_violations"] == want["invariant_violations"] > 0
    assert got["violations"] == want["violations"]
    assert got["digest"] == want["digest"]


def test_recovery_corrupt_hook_gives_the_jax_violations():
    spec, _ = SCENARIOS["tiny_wl"]

    def corrupt(pid, scal):
        if pid == 1 and scal["drained"]:
            return dict(scal, drained=scal["drained"] - 1)
        return None

    j = _jax_sim(spec, backend="ref")
    j.recovery_corrupt_hook = corrupt
    want = j.run()
    p = lifetime.LifetimeSim(spec, backend="torch", device="cpu")
    p.recovery_corrupt_hook = corrupt
    got = p.run()
    assert want["invariant_violations"] > 0
    assert got["violations"] == want["violations"]
    assert any("byte conservation" in v for v in got["violations"])
    assert got["recovery"] == want["recovery"]


def _tiny_maps():
    from ceph_tpu.osd.osdmap import build_hierarchical as jbuild
    from ceph_tpu.osd.types import PgPool as JPool
    from ceph_tpu.osd.types import PoolType as JType
    from ceph_tpu_torch.osd.osdmap import build_hierarchical
    from ceph_tpu_torch.osd.types import PgPool, PoolType

    return (jbuild(4, 2, n_rack=2, pool=JPool(
                type=JType.REPLICATED, size=3, crush_rule=0, pg_num=16,
                pgp_num=16)),
            build_hierarchical(4, 2, n_rack=2, pool=PgPool(
                type=PoolType.REPLICATED, size=3, crush_rule=0,
                pg_num=16, pgp_num=16)))


def test_rows_and_pg_temp_checkers_give_the_jax_messages():
    from ceph_tpu.osd.types import PgId as JPgId
    from ceph_tpu.sim import lifetime as jl
    from ceph_tpu_torch.osd.types import PgId

    jm, m = _tiny_maps()
    rows = np.stack([
        np.asarray(m.pg_to_up_acting_osds(PgId(0, s))[0], np.int32)
        for s in range(16)])
    assert lifetime.check_rows_invariants(m, 0, rows, 16) == []
    bad = rows.copy()
    bad[3, 1] = bad[3, 0]
    bad[7] = lifetime.ITEM_NONE  # an empty row the oracle maps
    frm = int(rows[5, 0])
    to = next(o for o in range(m.max_osd)
              if o not in rows[5] and m.is_up(o))
    m.pg_upmap_items[PgId(0, 5)] = [(frm, to)]
    jm.pg_upmap_items[JPgId(0, 5)] = [(frm, to)]
    m.pg_upmap[PgId(0, 9)] = [int(o) for o in rows[10]]
    jm.pg_upmap[JPgId(0, 9)] = [int(o) for o in rows[10]]
    got = lifetime.check_rows_invariants(m, 0, bad, 16)
    assert got == jl.check_rows_invariants(jm, 0, bad, 16)
    assert any("duplicate" in v for v in got)
    assert any("not respected" in v for v in got)
    assert any("device row empty" in v for v in got)
    sub = lifetime.check_rows_invariants(m, 0, bad, 16, only_seeds={3, 5})
    assert sub == jl.check_rows_invariants(jm, 0, bad, 16,
                                           only_seeds={3, 5})
    assert len(sub) == 2
    # the sampled seeds' rows alone (what the engine's overlay check
    # fetches) give the same messages
    assert lifetime.check_rows_invariants(
        m, 0, bad[[3, 5]], 16, only_seeds={5, 3}) == sub

    up = m.pg_to_up_acting_osds(PgId(0, 2))[0]
    for mm, pg in ((m, PgId(0, 2)), (jm, JPgId(0, 2))):
        mm.pg_temp[pg] = up[1:] + up[:1]
        mm.primary_temp[pg] = up[1]
    assert lifetime.check_pg_temp_invariants(m) == []
    # a mapping that ignores the override: acting is the up set
    for mm in (m, jm):
        honours = mm.pg_to_up_acting_osds

        def ignores(pg, honours=honours):
            u, upp, _, _ = honours(pg)
            return u, upp, list(u), upp

        mm.pg_to_up_acting_osds = ignores
    got = lifetime.check_pg_temp_invariants(m)
    assert got == jl.check_pg_temp_invariants(jm)
    assert len(got) == 2 and "primary_temp" in got[1]


# -- aliasing ---------------------------------------------------------------

def test_kept_tensors_are_never_written_in_place():
    """Every tensor the engine keeps from an epoch (the previous rows,
    the moved lanes, the device backlogs) still holds its values after
    every later epoch: nothing updates a tensor a cache or `prev` still
    refers to (the JAX arrays are immutable)."""
    spec, _ = SCENARIOS["growth"]
    sim = lifetime.LifetimeSim(spec, backend="torch", device="cpu")
    kept = []
    for _ in range(sim.scenario.epochs):
        sim.step()
        for t in ([ent[1] for ent in sim._prev_rows.values()]
                  + [v for v in sim._moved.values() if v is not None]
                  + list(sim.recovery._dev.values())):
            kept.append((t, t.clone()))
        for t, snap in kept:
            assert torch.equal(t, snap)
    assert sim.digest == _corpus()["growth"]["digest"]


def test_corr_scenario_resumes_mid_cascade_in_the_port(tmp_path):
    """A correlated run checkpointed with hazard windows open and wounds
    held, resumed in the port: the same windows, wounds and digest."""
    spec = CORR + ",epochs=14,p_host_outage=0.3,p_rack_outage=0.1"
    straight = lifetime.LifetimeSim(spec, backend="ref").run()
    ck = tmp_path / "ck.json"
    a = lifetime.LifetimeSim(spec, backend="torch", device="cpu",
                             checkpoint=str(ck))
    while not a.hazards:
        a.step()
    a._checkpoint()
    b = lifetime.LifetimeSim(spec, backend="torch", device="cpu",
                             checkpoint=str(ck), resume=True)
    assert b.hazards == a.hazards and b.resumed_from == a.steps
    for pid, w in a.wounded.items():
        assert (b.wounded[pid] == w).all()
    assert b.run()["digest"] == straight["digest"]


# -- the checkpoint store and the health registry ----------------------------

def test_checkpoint_store_keeps_the_jax_layout(tmp_path):
    """put / progress / done / fail and the atomic flush: the file the
    port writes has the JAX store's keys, and each store resumes the
    other's file."""
    from ceph_tpu.runtime.scheduler import Checkpoint as JaxCheckpoint
    from ceph_tpu_torch.runtime import Checkpoint

    path = tmp_path / "ck.json"
    ck = Checkpoint(path)
    ck.put("stage_a", {"x": 1})
    ck.progress("lifetime", {"steps": 3})
    ck.fail("stage_b", ValueError("boom"))
    assert ck.done("stage_a") and not ck.done("lifetime")
    assert not path.with_suffix(".tmp").exists()
    data = json.loads(path.read_text())
    assert data["stages_done"] == ["stage_a"]
    assert data["errors"] == {"stage_b": "ValueError: boom"}
    assert data["lifetime"] == {"steps": 3}
    # the perf registry, keyed by perf group as the JAX file is
    assert "sim" in data["perf"] and "perf" in data["stage_a"]
    j = JaxCheckpoint(path, resume=True)
    assert j.done("stage_a") and j.data["lifetime"] == {"steps": 3}
    j.progress("lifetime", {"steps": 4})
    back = Checkpoint(path, resume=True)
    assert back.data["lifetime"] == {"steps": 4}
    assert back.data["resumed"] == 2
    assert Checkpoint(tmp_path / "none.json", resume=True).data == {
        "stages_done": []}


def test_health_registry_and_muting_match_jax(monkeypatch):
    from ceph_tpu import obs as jobs

    assert obs.health.HEALTH_CHECKS == jobs.health.HEALTH_CHECKS
    monkeypatch.setenv("CEPH_TPU_HEALTH_MUTE", "PG_UNMAPPED, OSD_DOWN")
    kw = dict(osds_down=2, osd_count=10, degraded=3, unmapped=1,
              backlog_gb=0.25)
    for h in (obs.health, jobs.health):
        h.reset()
        assert h.evaluate(**kw) == h.WARN  # PG_UNMAPPED (ERR) is muted
    assert obs.health.dump() == jobs.health.dump()
    with pytest.raises(KeyError, match="undeclared"):
        obs.health.raise_check("NOPE", obs.health.WARN, "x")
    with pytest.raises(ValueError, match="severity"):
        obs.health.raise_check("OSD_DOWN", obs.health.OK, "x")
    monkeypatch.setenv("CEPH_TPU_HEALTH", "0")
    assert obs.health.evaluate(**kw) == obs.health.OK


def test_flagged_check_on_the_card_reads_only_the_flagged_rows():
    """When the device scalars flag a pool (a duplicate, or an empty row
    while enough OSDs are up), the torch backend checks only the empty,
    duplicate and upmap-carrying rows: the violations equal a full
    check_rows_invariants pass over every row."""
    spec, _ = SCENARIOS["tiny_wl"]
    sim = lifetime.LifetimeSim(spec, backend="torch", device="cpu")
    for _ in range(5):  # past the balance of epoch 4: upmap items exist
        sim.step()
    assert any(pg.pool == 0 for pg in sim.m.pg_upmap_items)
    tag, rows = sim._prev_rows[0]
    bad = rows.clone()
    bad[1, 1] = bad[1, 0]          # a duplicate OSD in pg 0.1
    bad[5] = lifetime.ITEM_NONE    # an empty row the host oracle maps
    up = {pg.seed for pg in sim.m.pg_upmap_items if pg.pool == 0}
    seed = min(up)
    bad[seed] = torch.flip(bad[seed], [0])  # reordered: no message
    sim._prev_rows[0] = (tag, bad)
    n = sim.m.pools[0].pg_num
    want = lifetime.check_rows_invariants(
        sim.m, 0, bad.numpy(), n, oracle=lambda s: sim._host_up(0, s))
    assert any("duplicate" in v for v in want)
    assert any("device row empty" in v for v in want)
    seeds = sim._flagged_seeds(0, bad, n)
    assert {1, 5} | up <= set(seeds.tolist()) and len(seeds) < n
    sim.violations = []
    stats = {0: {"n": n, "dup": 1, "unmapped": 1}}
    sim._invariants(99, np.random.default_rng(0), stats)
    assert sim.violations == [f"epoch 99: {v}" for v in want]
