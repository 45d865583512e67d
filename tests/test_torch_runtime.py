"""The port's runtime layer (`ceph_tpu_torch.runtime`: preflight, ladder,
stage scheduler) and its device-loss degradations, against the JAX
package's on the CPU.

- The cases of tests/test_runtime.py on the port: the in-process and
  watchdogged probes, an injected hang killed by the watchdog, retries
  with backoff, the descent's provenance, the native rung, the
  exhausted ladder and the `require=` gate; the stage scheduler's
  priority order, budget skip, failure checkpointing, watchdog overrun,
  resume, and the kill-at-`stage_end` resume in a child process; the
  admin socket's `runtime` answer.
- The difference by design: the default ladder is the card alone, so
  without a card (and with no ladder named) an entry point raises; a
  named `cuda,cpu` ladder descends with a recorded warning.
- Device loss (`faults.degrade_or_raise`, the one rule): on a card a
  loss raises at every site (ClusterSim, ClusterState, LifetimeSim);
  on a run placed on the host it degrades as the JAX package does:
  `ClusterSim` under `map_batch=lost` gives the JAX ClusterSim's rows,
  report and fallback count under the same fault; the mgr's
  post-execute diagnosis skips its accounting; a ClusterState whose
  delta apply loses the device defers its re-key.  A kernel wrapper's
  own RuntimeError is not a device loss and raises everywhere.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from ceph_tpu_torch import runtime
from ceph_tpu_torch.runtime import faults, ladder, preflight
from ceph_tpu_torch.utils import platform


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    from ceph_tpu.runtime import faults as jfaults

    monkeypatch.delenv("CEPH_TPU_LADDER", raising=False)
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    yield
    faults.disarm_all()
    jfaults.disarm_all()
    platform._checked = None
    ladder._last = None


# ---------------------------------------------------------------- preflight

def test_inprocess_cpu_probe():
    r = runtime.probe("cpu", watchdog=False)
    assert r.ok and r.backend == "cpu" and r.n_devices == 1


def test_inprocess_probe_reports_injected_failure():
    faults.arm("init.cpu", "fail", "EAGAIN", 1)
    r = runtime.probe("cpu", watchdog=False)
    assert not r.ok and "EAGAIN" in r.error


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_watchdogged_probe_of_the_missing_card():
    """The child process finds no card and says so; the parent stays
    healthy and the diagnosis is never empty."""
    r = runtime.probe("cuda", timeout_s=30)
    assert not r.ok and not r.timed_out
    assert "no CUDA device" in r.error
    assert r.diagnosis and all(isinstance(d, str) for d in r.diagnosis)
    assert runtime.probe("cpu", timeout_s=30).ok


def test_watchdog_kills_a_hung_probe(monkeypatch):
    """`init.cuda=hang` fires in the child before torch loads: the
    watchdog kills the group after its budget, and a ladder of the card
    alone raises with the hang in its reason."""
    monkeypatch.setenv(faults.ENV_VAR, "init.cuda=hang:600")
    monkeypatch.setattr(preflight, "IMPORT_GRACE_S", 1.5)
    t0 = time.time()
    with pytest.raises(runtime.RequiredBackendError, match="hung"):
        runtime.acquire_backend(ladder=["cuda"], timeout_s=1.0, attempts=1)
    assert time.time() - t0 < 20


def test_diagnosis_never_empty(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "7")
    finds = runtime.diagnose_init_failure("cuda")
    assert "env CUDA_VISIBLE_DEVICES=7" in finds


def test_probe_child_imports_no_jax_and_fires_before_torch():
    """The child is the port's own module: no jax, no ceph_tpu, and an
    armed `init.cpu=fail` kills it before torch is imported."""
    env = dict(os.environ, CEPH_TPU_FAULTS="init.cpu=fail:early",
               PYTHONPATH=str(ROOT))
    code = ("import runpy, sys; sys.argv = ['x', '--child', 'cpu']\n"
            "try:\n"
            "    runpy.run_module('ceph_tpu_torch.runtime.preflight',"
            " run_name='__main__')\n"
            "except BaseException as e:\n"
            "    print(type(e).__name__, 'torch' in sys.modules,"
            " 'jax' in sys.modules, 'ceph_tpu' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.split() == ["FaultInjected", "False", "False",
                                  "False"], out.stderr


# ------------------------------------------------------------------- ladder

def test_retry_then_success_records_attempts():
    faults.arm("init.cpu", "fail", "flake", 2)
    info = runtime.acquire_backend(ladder=["cpu"], watchdog=False,
                                   attempts=3, sleep=lambda s: None)
    assert info.backend == "cpu"
    assert info.attempts == 3
    assert info.fallback_reason is None
    assert len(info.failures) == 2


def test_degradation_records_fallback_reason():
    faults.arm("init.cuda", "fail", "transport down")
    with pytest.warns(RuntimeWarning, match="transport down"):
        info = runtime.acquire_backend(ladder=["cuda", "cpu"],
                                       watchdog=False, attempts=1)
    assert info.backend == "cpu"
    assert "transport down" in info.fallback_reason
    assert info.rungs_tried == ["cuda", "cpu"]
    prov = info.provenance()
    for key in ("backend", "fallback_reason", "attempts", "init_seconds"):
        assert key in prov
    assert runtime.last_provenance()["backend"] == "cpu"
    from ceph_tpu_torch.utils.perf_counters import perf_dump

    assert perf_dump()["runtime"]["fallbacks"] >= 1


def test_native_terminal_rung():
    faults.arm("init.cpu", "fail", "even cpu is gone")
    with pytest.warns(RuntimeWarning):
        info = runtime.acquire_backend(ladder=["cpu", "native"],
                                       watchdog=False, attempts=1)
    assert info.backend == "native"


def test_ladder_exhausted_raises():
    faults.arm("init.cpu", "fail", "gone")
    with pytest.raises(runtime.RequiredBackendError, match="gone"):
        runtime.acquire_backend(ladder=["cpu"], watchdog=False, attempts=1)


def test_require_gate_blocks_degraded_result():
    faults.arm("init.cuda", "fail", "down")
    with pytest.raises(runtime.RequiredBackendError, match="cuda"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runtime.acquire_backend(ladder=["cuda", "cpu"], watchdog=False,
                                attempts=1, require="cuda")


def test_backoff_is_exponential_and_bounded():
    slept = []
    faults.arm("init.cpu", "fail", "flake", 3)
    runtime.acquire_backend(ladder=["cpu"], watchdog=False, attempts=4,
                            sleep=slept.append)
    assert len(slept) == 3
    for i, s in enumerate(slept):
        base = min(ladder.BACKOFF_BASE_S * (2 ** i), ladder.BACKOFF_MAX_S)
        assert base <= s <= base * 1.25 + 1e-9
    assert slept[0] < slept[1] < slept[2]


def test_default_ladder_is_the_card_alone(monkeypatch):
    assert runtime.default_ladder() == ["cuda"]
    monkeypatch.setenv("CEPH_TPU_LADDER", "cuda, cpu,native")
    assert runtime.default_ladder() == ["cuda", "cpu", "native"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("entry", ["resolve_device", "pool_mapper",
                                   "cluster_state", "lifetime"])
def test_no_card_and_no_ladder_raises(entry):
    """Without a card and with no ladder named, an entry point raises;
    it does not run on the CPU."""
    from ceph_tpu_torch.device import resolve_device
    from ceph_tpu_torch.osd.osdmap import build_hierarchical
    from ceph_tpu_torch.osd.pipeline import PoolMapper
    from ceph_tpu_torch.osd.state import ClusterState
    from ceph_tpu_torch.sim.lifetime import LifetimeSim

    m = build_hierarchical(2, 2)
    calls = {
        "resolve_device": lambda: resolve_device(None),
        "pool_mapper": lambda: PoolMapper(m, 0),
        "cluster_state": lambda: ClusterState(m),
        "lifetime": lambda: LifetimeSim("epochs=2"),
    }
    with pytest.raises(runtime.RequiredBackendError, match="no CUDA device"):
        calls[entry]()
    assert runtime.last_provenance() is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_named_ladder_descends_with_a_recorded_warning(monkeypatch):
    from ceph_tpu_torch.device import resolve_device

    monkeypatch.setenv("CEPH_TPU_LADDER", "cuda,cpu")
    with pytest.warns(RuntimeWarning, match="running on cpu"):
        assert resolve_device(None) == torch.device("cpu")
    prov = runtime.last_provenance()
    assert prov["backend"] == "cpu" and "no CUDA device" in \
        prov["fallback_reason"]
    # cached: one acquisition per process
    assert resolve_device(None) == torch.device("cpu")


def test_admin_socket_runtime_command():
    from ceph_tpu_torch.obs import admin_socket

    faults.arm("init.xpu", "fail", "down")
    out = json.loads(admin_socket.handle_command("runtime"))
    assert out["faults_armed"] == {"init.xpu": "fail:down"}
    assert out["default_ladder"] == ["cuda"]
    assert out["provenance"] is None
    runtime.acquire_backend(ladder=["cpu"], watchdog=False, attempts=1)
    out = json.loads(admin_socket.handle_command("runtime"))
    assert out["provenance"]["backend"] == "cpu"


# ---------------------------------------------------------------- scheduler

def test_priority_order_beats_declaration_order(tmp_path):
    ran = []
    ck = runtime.Checkpoint(tmp_path / "ck.json")
    s = runtime.StageScheduler(ck, deadline_s=60)
    s.add("low", lambda h: ran.append("low") or {}, priority=10)
    s.add("high", lambda h: ran.append("high") or {}, priority=90)
    s.run()
    assert ran == ["high", "low"]


def test_budget_skip_records_reason(tmp_path):
    ck = runtime.Checkpoint(tmp_path / "ck.json")
    s = runtime.StageScheduler(ck, deadline_s=5)
    s.add("huge", lambda h: {}, priority=90, est_s=500)
    s.add("fits", lambda h: {"ok": 1}, priority=10, est_s=1)
    out = s.run()
    assert "huge" not in out["stages_done"]
    assert out["huge_skipped"]["needed_s"] == 500
    assert "fits" in out["stages_done"]


def test_failure_checkpointed_run_continues(tmp_path):
    ck = runtime.Checkpoint(tmp_path / "ck.json")
    s = runtime.StageScheduler(ck, deadline_s=60)

    def boom(h):
        raise ValueError("stage exploded")

    s.add("bad", boom, priority=90)
    s.add("good", lambda h: {"ok": 1}, priority=10)
    out = s.run()
    assert "ValueError" in out["errors"]["bad"]
    assert "good" in out["stages_done"]


def test_overrun_watchdog_abandons_stage(tmp_path):
    faults.arm("stage.wedged", "overrun", "5", 1)
    ck = runtime.Checkpoint(tmp_path / "ck.json")
    s = runtime.StageScheduler(ck, deadline_s=60)
    s.add("wedged", lambda h: {"never": 1}, priority=90,
          soft_timeout_s=0.5)
    s.add("next", lambda h: {"ok": 1}, priority=10)
    t0 = time.time()
    out = s.run()
    assert time.time() - t0 < 3
    assert "overrun" in out["errors"]["wedged"]
    assert "wedged" not in out["stages_done"]
    assert "next" in out["stages_done"]


def test_resume_skips_done_keeps_results(tmp_path):
    p = tmp_path / "ck.json"
    s = runtime.StageScheduler(runtime.Checkpoint(p), deadline_s=60)
    s.add("a", lambda h: {"v": 1}, priority=90)
    s.run()
    ran = []
    s2 = runtime.StageScheduler(runtime.Checkpoint(p, resume=True),
                                deadline_s=60)
    s2.add("a", lambda h: ran.append("a") or {"v": 99}, priority=90)
    s2.add("b", lambda h: ran.append("b") or {"v": 2}, priority=10)
    out = s2.run()
    assert ran == ["b"]
    assert out["a"]["v"] == 1
    assert out["resumed_stages"] == ["a"]
    assert out["resumed"] == 1


def test_checkpoint_atomic_and_progress_not_done(tmp_path):
    p = tmp_path / "ck.json"
    ck = runtime.Checkpoint(p)
    ck.progress("partial_stage", {"rounds": 1})
    on_disk = json.loads(p.read_text())
    assert on_disk["partial_stage"]["rounds"] == 1
    assert "partial_stage" not in on_disk["stages_done"]
    assert not runtime.Checkpoint(p, resume=True).done("partial_stage")


def test_scheduler_equals_jax_on_the_same_stages(tmp_path):
    """The same declared stages (one skipped for budget, one failing,
    one overrunning) leave the same stage record in both packages."""
    from ceph_tpu import runtime as jruntime

    def declare(rt, path, fz):
        fz.arm("stage.slow", "overrun", "3", 1)
        s = rt.StageScheduler(rt.Checkpoint(path), deadline_s=120)
        s.add("map", lambda h: {"rows": 3}, priority=50)
        s.add("big", lambda h: {}, priority=80, est_s=999)
        s.add("bad", lambda h: 1 / 0, priority=60)
        s.add("slow", lambda h: {}, priority=70, soft_timeout_s=0.3)
        out = s.run()
        fz.disarm_all()
        return (out["stages_done"], sorted(out["errors"]),
                out["map"]["rows"], out["big_skipped"]["needed_s"])

    assert declare(runtime, tmp_path / "p.json", faults) == \
        declare(jruntime, tmp_path / "j.json", jruntime.faults)


def test_kill_at_stage_end_and_resume(tmp_path):
    """A child killed by `stage_end.b=exit:3` after stage b's checkpoint
    resumes without re-running a or b, with the uninterrupted results."""
    code = (
        "import sys, json\n"
        "from ceph_tpu_torch import runtime\n"
        "ck = runtime.Checkpoint(sys.argv[1], resume=sys.argv[2] == '1')\n"
        "s = runtime.StageScheduler(ck, deadline_s=60)\n"
        "for i, n in enumerate('abc'):\n"
        "    s.add(n, lambda h, n=n: {'v': n * 2, 'pid': __import__('os')"
        ".getpid()}, priority=90 - i)\n"
        "print(json.dumps(s.run()['stages_done']))\n")
    p = tmp_path / "ck.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               CEPH_TPU_FAULTS="stage_end.b=exit:3")
    r1 = subprocess.run([sys.executable, "-c", code, str(p), "0"], env=env,
                        capture_output=True, text=True, timeout=120)
    assert r1.returncode == 3
    first = json.loads(p.read_text())
    assert first["stages_done"] == ["a", "b"]
    env.pop("CEPH_TPU_FAULTS")
    r2 = subprocess.run([sys.executable, "-c", code, str(p), "1"], env=env,
                        capture_output=True, text=True, timeout=120)
    assert r2.returncode == 0, r2.stderr
    done = json.loads(p.read_text())
    assert done["stages_done"] == ["a", "b", "c"]
    assert done["resumed_stages"] == ["a", "b"]
    assert [done[n]["v"] for n in "abc"] == ["aa", "bb", "cc"]
    assert done["a"]["pid"] == first["a"]["pid"] != done["c"]["pid"]


# ------------------------------------------ C.3: recorded degradations

def _cs_map(P, pg_num=32):
    pool = P.PgPool(type=P.PoolType.REPLICATED, size=3, crush_rule=0,
                    pg_num=pg_num, pgp_num=pg_num)
    return P.build_hierarchical(6, 4, pool=pool)


def _pkgs():
    from types import SimpleNamespace

    from ceph_tpu.osd.osdmap import build_hierarchical as jb
    from ceph_tpu.osd.types import PgPool as JP
    from ceph_tpu.osd.types import PoolType as JT

    from ceph_tpu_torch.osd.osdmap import build_hierarchical as pb
    from ceph_tpu_torch.osd.types import PgPool, PoolType

    return (SimpleNamespace(build_hierarchical=pb, PgPool=PgPool,
                            PoolType=PoolType),
            SimpleNamespace(build_hierarchical=jb, PgPool=JP,
                            PoolType=JT))


@pytest.mark.parametrize("losses, rounds", [(1, 0), (2, 3)])
def test_cluster_sim_degrades_like_jax(losses, rounds):
    """`map_batch=lost` degrades the lost pass to the host mapper: rows,
    reports and fallback counts equal the JAX ClusterSim's under the
    same fault (tests/test_aux.py's fail_osd and thrash arms)."""
    from ceph_tpu.runtime import faults as jfaults
    from ceph_tpu.sim.failure import ClusterSim as JClusterSim

    from ceph_tpu_torch.sim.failure import ClusterSim
    from ceph_tpu_torch.utils.perf_counters import perf_dump

    P, J = _pkgs()
    sim = ClusterSim(_cs_map(P), backend="torch", device="cpu")
    jsim = JClusterSim(_cs_map(J), backend="jax")
    before = perf_dump().get("runtime", {}).get("device_loss_fallbacks", 0)
    faults.arm("map_batch", "lost", "injected transport loss", losses)
    jfaults.arm("map_batch", "lost", "injected transport loss", losses)
    if rounds:
        reps = sim.thrash(rounds, rng=np.random.default_rng(7))
        jreps = jsim.thrash(rounds, rng=np.random.default_rng(7))
    else:
        reps, jreps = [sim.fail_osd(5)], [jsim.fail_osd(5)]
    assert [vars(r) for r in reps] == [vars(r) for r in jreps]
    for j in range(4):
        assert np.array_equal(np.asarray(sim.current[0][j]),
                              np.asarray(jsim.current[0][j]))
    prov, jprov = sim.provenance(), jsim.provenance()
    assert prov["device_loss_fallbacks"] == jprov["device_loss_fallbacks"]
    assert prov["device_loss_fallbacks"] == losses
    assert prov["fallback_events"] == jprov["fallback_events"]
    after = perf_dump()["runtime"]["device_loss_fallbacks"]
    assert after == before + losses


def _torch_loss():
    """An error of the shape a torch transport loss takes."""
    cls = type("AcceleratorError", (RuntimeError,),
               {"__module__": "torch.cuda"})
    return cls("CUDA error: unavailable (transport)")


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:0", None])
def test_degrade_or_raise_is_the_one_rule(device):
    """A device loss degrades (and books `device_loss_fallbacks`) only on
    the host; on a card, or with no device, it raises; a non-loss raises
    everywhere."""
    from ceph_tpu_torch.utils.perf_counters import perf_dump

    def booked():
        return perf_dump().get("runtime", {}).get(
            "device_loss_fallbacks", 0)

    for exc in (faults.DeviceLostError("lost"), _torch_loss()):
        before = booked()
        if device == "cpu":
            faults.degrade_or_raise(exc, torch.device(device))
            assert booked() == before + 1
            faults.degrade_or_raise(exc, device, book=False)
            assert booked() == before + 1
        else:
            dev = torch.device(device) if device else None
            with pytest.raises(type(exc)):
                faults.degrade_or_raise(exc, dev)
            assert booked() == before
    with pytest.raises(RuntimeError, match="boom"):
        faults.degrade_or_raise(RuntimeError("boom"), "cpu")


@pytest.mark.parametrize("site", ["cluster_sim", "cluster_state",
                                  "lifetime"])
def test_a_device_loss_on_a_card_raises(site, monkeypatch):
    """Each site's decision reads its device: "cuda" raises the loss and
    records nothing, "cpu" degrades.  The work itself stays on the host
    (the device attribute alone reads "cuda"), so no card is needed."""
    cuda = torch.device("cuda")
    P, _ = _pkgs()
    if site == "cluster_sim":
        from ceph_tpu_torch.osd import pipeline
        from ceph_tpu_torch.sim import failure

        class Lost:
            def __init__(self, *a, **kw):
                raise faults.DeviceLostError("lost at launch")

        monkeypatch.setattr(pipeline, "PoolMapper", Lost)
        m = _cs_map(P)
        events: list = []
        with pytest.raises(faults.DeviceLostError):
            failure._map_all(m, "torch", cuda, events)
        assert events == []
        rows = failure._map_all(m, "torch", torch.device("cpu"), events)
        assert len(events) == len(m.pools)
        assert np.array_equal(rows[0][0], failure._map_ref(m, 0)[0])
    elif site == "cluster_state":
        from ceph_tpu_torch.osd.incremental import Incremental
        from ceph_tpu_torch.osd.state import ClusterState

        st = ClusterState(_cs_map(P, 64), device="cpu")
        st.rows(0)

        def lost(self, idx):
            raise faults.DeviceLostError("scatter lost")

        monkeypatch.setattr(ClusterState, "_scatter_vectors", lost)
        st.device = cuda
        inc = Incremental(epoch=st.m.epoch + 1)
        inc.new_weight[3] = int(0x10000 * 0.5)
        with pytest.raises(faults.DeviceLostError):
            st.apply(inc)
        assert not st._pending_rebuild
    else:
        from ceph_tpu_torch.sim.lifetime import LifetimeSim

        sim = LifetimeSim("epochs=3,pgs=16,ec=,checkpoint_every=0",
                          device="cpu")
        sim.device = cuda
        with pytest.raises(faults.DeviceLostError):
            sim._degrade(1, 0, faults.DeviceLostError("lost"))
        assert sim.provenance()["fallback_events"] == []
        sim.device = torch.device("cpu")
        sim._degrade(1, 0, faults.DeviceLostError("lost"))
        assert sim.provenance()["device_loss_fallbacks"] == 1


def test_kernel_error_is_not_a_device_loss(monkeypatch):
    """A kernel wrapper's own RuntimeError raises out of ClusterSim and
    LifetimeSim: nothing degrades."""
    from ceph_tpu_torch.osd import pipeline
    from ceph_tpu_torch.sim.failure import ClusterSim
    from ceph_tpu_torch.sim.lifetime import LifetimeSim

    def failing(*a, **kw):
        raise RuntimeError("crush_rule kernel launch failed: boom")

    P, _ = _pkgs()
    sim = ClusterSim(_cs_map(P), backend="torch", device="cpu")
    monkeypatch.setattr(pipeline, "map_rule", failing)
    with pytest.raises(RuntimeError, match="boom"):
        sim.fail_osd(5)
    assert sim.provenance()["device_loss_fallbacks"] == 0
    with pytest.raises(RuntimeError, match="boom"):
        LifetimeSim("epochs=3,pgs=16,ec=,checkpoint_every=0",
                    device="cpu").run()


def test_cluster_state_defers_its_rekey_on_a_device_loss(monkeypatch):
    """A delta apply that loses the device leaves the host map advanced
    and returns "deferred"; the next rows() re-keys and gives the host
    oracle's rows (the JAX ClusterState's contract)."""
    from ceph_tpu_torch.osd.incremental import Incremental
    from ceph_tpu_torch.osd.state import ClusterState
    from ceph_tpu_torch.osd.types import PgId

    P, _ = _pkgs()
    st = ClusterState(_cs_map(P, 64), device="cpu")
    st.rows(0)

    def lost(self, idx):
        raise faults.DeviceLostError("scatter lost")

    monkeypatch.setattr(ClusterState, "_scatter_vectors", lost)
    inc = Incremental(epoch=st.m.epoch + 1)
    inc.new_weight[3] = int(0x10000 * 0.5)
    assert st.apply(inc) == "deferred"
    monkeypatch.undo()
    rows = st.rows(0)[0].numpy()
    for ps in range(64):
        up = st.m.pg_to_up_acting_osds(PgId(0, ps))[0]
        assert [o for o in rows[ps] if o != 0x7FFFFFFF] == up
    inc2 = Incremental(epoch=st.m.epoch + 1)
    inc2.new_weight[4] = int(0x10000 * 0.5)
    assert st.apply(inc2) == "delta"


def test_mgr_execute_survives_device_loss_in_diagnosis(monkeypatch):
    """tests/test_explain.py's case on the port: the diagnosis loses the
    device after the Incremental landed; the execute still succeeds and
    no `mgr.<plan>` source is booked."""
    from ceph_tpu_torch.mgr.eval import MappingState
    from ceph_tpu_torch.mgr.module import Balancer
    from ceph_tpu_torch.obs import placement
    from ceph_tpu_torch.osd.osdmap import build_hierarchical
    from ceph_tpu_torch.osd.pipeline import PoolMapper
    from ceph_tpu_torch.osd.types import PgPool

    monkeypatch.setenv("CEPH_TPU_PLACEMENT_DIAG", "1")
    placement.reset()

    def boom(self, ps=None, source=None, record=True):
        raise faults.DeviceLostError("wedged")

    monkeypatch.setattr(PoolMapper, "diagnose", boom)
    m = build_hierarchical(4, 4, pool=PgPool(pg_num=64, size=3),
                           weight_fn=lambda i: 0x10000 * (1 + (i % 3)))
    b = Balancer()
    plan = b.plan_create("lost", MappingState(m, device="cpu"),
                         mode="upmap")
    rc, _ = b.optimize(plan)
    assert rc == 0
    assert b.execute(plan, m) == (0, "")
    assert "mgr.lost" not in placement.dump()["sources"]


# -- the stored JAX records of the armed losses (the CPU port degrades to
# them; chip_smoke.py's runtime_main holds the card's device rows to them) --

RUNTIME_CORPUS = ROOT / "tests" / "data" / "runtime_corpus.json"
LOSS_SCENARIO = ("tiny", "epoch_apply.6=lost:chaos x1")


def _lifetime_loss(P_sim, **kw) -> dict:
    from test_torch_lifetime import SCENARIOS

    out = P_sim(SCENARIOS[LOSS_SCENARIO[0]][0], **kw).run()
    return {"digest": out["digest"],
            "fallback_events": out["provenance"]["fallback_events"]}


def _jax_records() -> dict:
    from ceph_tpu.runtime import faults as jfaults
    from ceph_tpu.sim.lifetime import LifetimeSim as JLifetimeSim
    from test_torch_serve import _loss_script, _map, _svc, jax_pkg

    jfaults.configure(LOSS_SCENARIO[1])
    try:
        life = _lifetime_loss(JLifetimeSim, backend="ref")
    finally:
        jfaults.disarm_all()
    P = jax_pkg()
    svc = _svc(P, _map(P), "corpus.loss")
    try:
        serve = _loss_script(P, svc, "lookup")
    finally:
        svc.close()
    return {"lifetime": dict(life, scenario=LOSS_SCENARIO[0],
                             arm=LOSS_SCENARIO[1]),
            "serve": serve}


def test_runtime_corpus_is_the_jax_package_and_the_port():
    """tests/data/runtime_corpus.json holds the JAX package's records of
    the armed losses runtime_main arms on the card; the JAX package
    still gives them, and so does the port placed on the host."""
    from test_torch_serve import _loss_script, _map, _svc, port_pkg

    from ceph_tpu_torch.sim.lifetime import LifetimeSim

    stored = json.loads(RUNTIME_CORPUS.read_text())
    assert _jax_records() == {k: stored[k] for k in ("lifetime", "serve")}
    faults.configure(LOSS_SCENARIO[1])
    life = _lifetime_loss(LifetimeSim, backend="torch", device="cpu")
    faults.disarm_all()
    assert life == {k: stored["lifetime"][k]
                    for k in ("digest", "fallback_events")}
    P = port_pkg()
    svc = _svc(P, _map(P), "corpus.loss.port")
    try:
        assert _loss_script(P, svc, "lookup") == stored["serve"]
    finally:
        svc.close()


def write_corpus() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    rec = _jax_records()
    RUNTIME_CORPUS.write_text(json.dumps(dict(
        _doc="the JAX package's records of two armed device losses: "
             "a lifetime corpus scenario under epoch_apply=lost (ref "
             "backend: the digest and fallback events) and the service "
             "script of tests/test_torch_serve.py::_loss_script "
             "(lookups, degraded_batches=1).  The port on the CPU "
             "degrades to the same records; chip_smoke.py's "
             "runtime_main arms the same losses on the card, where they "
             "raise or answer EFAULT, and holds the device replies to "
             "these rows.  Rewritten by "
             "`python tests/test_torch_runtime.py`", **rec),
        indent=1) + "\n")


if __name__ == "__main__":
    write_corpus()
