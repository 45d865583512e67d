"""`sim/lifetime.py` (LifetimeSim) held against the JAX package.

The corpus (tests/data/lifetime_corpus.json) holds, for every scenario of
SCENARIOS (the scenarios of tests/test_lifetime.py, test_recovery.py and
test_correlated.py, with queue and flat recovery, the workload,
pipelined repair, correlated failures, DATA_LOSS, every forced event
kind and growth), the JAX package's `Scenario.spec()`, final digest and
summary from its "ref" backend (its own tests hold "ref" equal to its
"jax" backend), the "jax" backend's structure counts where the generator
ran it, and the per-epoch rule calls of the port's torch backend (what
`chip_smoke.py` holds the card's kernel launches to).

Here, for every scenario, on the port's "torch" backend (device="cpu")
and on its "ref" backend:

- the digest and the summary equal the corpus (the wall-clock fields and
  the documented differences excepted: the provenance's backend name,
  `state`, `trace_once` and `jit_compiles_per_epoch`, which the "torch"
  run holds to the JAX "jax" backend's where the corpus has it, with 0
  compiles);
- on "torch", each epoch's rule calls equal the corpus, and an epoch in
  which no pool's rows tag changed makes none.

`python tests/test_torch_lifetime.py` rewrites the corpus (about 3 min
on the CPU).  Checkpoints across the packages, the CLI, fault points and
the invariant negative controls are in test_torch_lifetime_resume.py.
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu_torch import obs  # noqa: E402
from ceph_tpu_torch.osd import pipeline  # noqa: E402
from ceph_tpu_torch.sim import lifetime  # noqa: E402

CORPUS = ROOT / "tests" / "data" / "lifetime_corpus.json"

# tests/test_lifetime.py TINY and its variants
TINY = ("epochs=12,seed=5,hosts=6,osds_per_host=2,racks=2,pgs=32,"
        "ec=2+2,ec_pgs=16,chunk=256,balance_every=6,spotcheck_every=4,"
        "checkpoint_every=0")
# tests/test_recovery.py TINY_WL
TINY_WL = ("epochs=8,seed=5,hosts=6,osds_per_host=2,racks=2,pgs=32,"
           "ec=2+2,ec_pgs=16,chunk=256,balance_every=4,"
           "spotcheck_every=0,checkpoint_every=0,workload=1")
# tests/test_correlated.py CORR and its undersized DATA_LOSS scenario
CORR = ("epochs=16,seed=11,hosts=4,osds_per_host=3,racks=2,pgs=32,"
        "ec=2+1,ec_pgs=16,chunk=256,balance_every=0,spotcheck_every=0,"
        "checkpoint_every=0,recovery=queue,max_backfills=4,"
        "recovery_mbps=200,osd_mbps=400,correlated=1,flappers=2")
DATA_LOSS = (
    "epochs=14,hosts=3,osds_per_host=2,racks=1,pgs=16,ec=2+1,"
    "ec_pgs=8,chunk=64,seed=7,p_death=0.25,p_flap=0.05,"
    "p_host_outage=0.10,p_reweight=0,p_pg_temp=0,p_pool_create=0,"
    "p_split=0,p_expand=0,p_remove=0.02,balance_every=0,"
    "spotcheck_every=0,checkpoint_every=0,recovery=queue,"
    "max_backfills=1,recovery_mbps=2,osd_mbps=4,correlated=1,"
    "flappers=1")
# tests/test_lifetime.py::test_risk_model_integrates_at_risk_window
RISK = ("epochs=14,seed=1,hosts=8,osds_per_host=2,racks=2,pgs=16,"
        "ec=2+1,ec_pgs=16,chunk=64,balance_every=0,spotcheck_every=0,"
        "checkpoint_every=0,interval_s=10,flap_len=30")
EVERY_KIND = ["death", "remove", "expand", "split", "pool_create",
              "pg_temp", "host_outage", "reweight", "flap", "rack_outage"]

# name -> (scenario spec, events forced on the first epochs)
SCENARIOS = {
    "tiny": (TINY, []),
    "tiny_flat": (TINY + ",recovery=flat", []),
    "tiny_wl": (TINY_WL, []),
    "tiny_wl_pipelined": (TINY_WL + ",pipeline_repair=1,ec_gbps=0.05,"
                          "max_backfills=1,recovery_mbps=40", []),
    "no_ec": ("epochs=10,seed=2,hosts=5,osds_per_host=2,racks=1,pgs=32,"
              "ec=,balance_every=5,spotcheck_every=2,checkpoint_every=0,"
              "p_pg_temp=0.3,p_reweight=0.3", []),
    "every_kind": (TINY + ",balance_every=0,epochs=12", EVERY_KIND),
    "risk": (RISK, ["flap"] * 12),
    "corr": (CORR, []),
    "corr_wl_outages": (CORR + ",epochs=12,workload=1,p_host_outage=0.3,"
                        "p_rack_outage=0.1", []),
    "data_loss": (DATA_LOSS, []),
    "growth": ("epochs=24,seed=3,hosts=6,osds_per_host=2,racks=3,pgs=32,"
               "ec=2+1,ec_pgs=16,chunk=64,balance_every=5,"
               "spotcheck_every=3,checkpoint_every=0,workload=1,"
               "correlated=1,p_expand=0.1,p_split=0.08,"
               "p_pool_create=0.06,p_death=0.08,p_remove=0.05,"
               "max_pgs=128,recovery_mbps=20,osd_mbps=40", []),
}
# scenarios the generator also runs on the JAX "jax" backend
JAX_CONFIRMED = ("tiny", "every_kind", "growth")

# summary keys that read the wall clock, and those that differ by design
WALL_KEYS = ("wall_s", "epochs_per_sec", "cluster_years_per_hour")
BY_DESIGN = ("provenance", "state", "trace_once", "jit_compiles_per_epoch")


def comparable(summary: dict) -> dict:
    """The summary without its wall-clock fields and the documented
    differences, JSON-normalised."""
    out = {k: v for k, v in summary.items()
           if k not in WALL_KEYS + BY_DESIGN}
    if "pareto" in out:
        out["pareto"] = {k: v for k, v in out["pareto"].items()
                         if k != "cluster_years_per_hour"}
    return json.loads(json.dumps(out))


def reset_observers(obs_mod) -> None:
    obs_mod.health.reset()
    obs_mod.timeline.reset()


def drive(sim, forced) -> dict:
    for ev in forced:
        sim.step(force_event=ev)
    return sim.run()


class RuleCalls:
    """Counts the rule's dispatches (`pipeline.map_rule` calls with
    seeds; one kernel launch each on the card at these sizes)."""

    def __init__(self, monkeypatch=None):
        self.n = 0
        self._orig = pipeline.map_rule

        def counted(T, prog, x, weight):
            if x.numel():
                self.n += 1
            return self._orig(T, prog, x, weight)

        if monkeypatch is not None:
            monkeypatch.setattr(pipeline, "map_rule", counted)
        else:
            pipeline.map_rule = counted

    def restore(self):
        pipeline.map_rule = self._orig


def epoch_trace(sim, forced, calls: RuleCalls) -> tuple[list, list]:
    """Run the port's sim epoch by epoch: (rule calls per epoch, whether
    any pool's rows tag changed in that epoch)."""
    counts, changed = [], []
    todo = list(forced) + [None] * (sim.scenario.epochs - len(forced))
    for ev in todo:
        before = {pid: ent[0] for pid, ent in sim._prev_rows.items()}
        calls.n = 0
        sim.step(force_event=ev)
        after = {pid: ent[0] for pid, ent in sim._prev_rows.items()}
        counts.append(calls.n)
        changed.append(before != after)
    return counts, changed


def _corpus():
    return json.loads(CORPUS.read_text())["scenarios"]


@pytest.fixture(autouse=True)
def _clean():
    from ceph_tpu_torch.runtime import faults

    reset_observers(obs)
    yield
    faults.disarm_all()
    reset_observers(obs)


def test_corpus_matches_scenarios():
    """Every scenario is in the corpus with the spec it was made from,
    and the JAX package's `Scenario.spec()` string equals the port's."""
    from ceph_tpu.sim.lifetime import Scenario as JaxScenario

    corpus = _corpus()
    assert sorted(corpus) == sorted(SCENARIOS)
    for name, (spec, forced) in SCENARIOS.items():
        ent = corpus[name]
        assert (ent["spec"], ent["forced"]) == (spec, forced), name
        assert lifetime.Scenario.parse(spec).spec() == ent["jax_spec"]
        assert JaxScenario.parse(spec).spec() == ent["jax_spec"]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_torch_backend_equals_jax(name, monkeypatch):
    """The port's device path (here its plain versions on the CPU): the
    JAX digest and summary, the per-epoch rule calls, and no call on an
    epoch where no pool's rows tag changed."""
    spec, forced = SCENARIOS[name]
    ent = _corpus()[name]
    calls = RuleCalls(monkeypatch)
    sim = lifetime.LifetimeSim(spec, backend="torch", device="cpu")
    counts, changed = epoch_trace(sim, forced, calls)
    out = sim.run()
    assert out["digest"] == ent["digest"]
    assert comparable(out) == ent["summary"]
    assert out["provenance"] == {"backend": "torch",
                                 "device_loss_fallbacks": 0,
                                 "fallback_events": []}
    assert counts == ent["rule_calls"]
    assert changed == ent["tags_changed"]
    assert all(n == 0 for n, c in zip(counts, changed) if not c)
    # the port compiles nothing; a steady epoch never rebuilds the state
    to = out["trace_once"]
    assert to["total_compiles"] == to["steady_compiles"] == 0
    assert to["steady_full_rebuilds"] == 0
    assert out["jit_compiles_per_epoch"] == 0.0
    jx = ent.get("jax_backend")
    if jx is not None:
        assert out["state"] == jx["state"]
        assert {k: to[k] for k in ("structural_epochs", "steady_epochs",
                                   "steady_full_rebuilds")} == {
            k: jx["trace_once"][k] for k in (
                "structural_epochs", "steady_epochs",
                "steady_full_rebuilds")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ref_backend_equals_jax(name):
    """The port's host oracle and numpy mirrors: the JAX "ref" run's
    digest, summary and provenance."""
    spec, forced = SCENARIOS[name]
    ent = _corpus()[name]
    out = drive(lifetime.LifetimeSim(spec, backend="ref"), forced)
    assert out["digest"] == ent["digest"]
    assert comparable(out) == ent["summary"]
    assert out["provenance"] == ent["provenance"]
    assert out["state"] is None


def test_scenario_defaults_follow_the_env(monkeypatch):
    """The three CEPH_TPU_SIM_* knobs resolve as the JAX package's do."""
    from ceph_tpu.sim.lifetime import Scenario as JaxScenario

    monkeypatch.setenv("CEPH_TPU_SIM_CHECKPOINT_EVERY", "7")
    monkeypatch.setenv("CEPH_TPU_SIM_SPOTCHECK", "3")
    monkeypatch.setenv("CEPH_TPU_SIM_RECOVERY", "flat")
    sc = lifetime.Scenario.parse("epochs=2")
    assert (sc.checkpoint_every, sc.spotcheck_every, sc.recovery) == (
        7, 3, "flat")
    assert sc.spec() == JaxScenario.parse("epochs=2").spec()
    with pytest.raises(ValueError, match="bad scenario item"):
        lifetime.Scenario.parse("epochs=5,bogus=1")
    with pytest.raises(ValueError, match="known models"):
        lifetime.Scenario.parse("recovery=bogus")


def test_event_kinds_match_the_jax_registry():
    from ceph_tpu.sim import lifetime as jl

    assert lifetime.EVENT_KINDS == jl.EVENT_KINDS
    assert [k for k, _ in lifetime.Scenario().event_probs()] == [
        k for k, _ in jl.Scenario().event_probs()]


def test_torch_backend_needs_a_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lifetime.LifetimeSim(TINY, backend="torch")
    with pytest.raises(ValueError, match="unknown backend"):
        lifetime.LifetimeSim(TINY, backend="native", device="cpu")


# -- the corpus ----------------------------------------------------------------

def write_corpus() -> None:
    from ceph_tpu import obs as jobs
    from ceph_tpu.sim.lifetime import LifetimeSim as JaxSim
    from ceph_tpu.sim.lifetime import Scenario as JaxScenario

    out = {}
    for name, (spec, forced) in SCENARIOS.items():
        reset_observers(jobs)
        ref = drive(JaxSim(spec, backend="ref"), forced)
        ent = {"spec": spec, "forced": forced,
               "jax_spec": JaxScenario.parse(spec).spec(),
               "digest": ref["digest"], "summary": comparable(ref),
               "provenance": ref["provenance"]}
        if name in JAX_CONFIRMED:
            reset_observers(jobs)
            jx = drive(JaxSim(spec, backend="jax"), forced)
            assert jx["digest"] == ref["digest"], name
            assert comparable(jx) == comparable(ref), name
            ent["jax_backend"] = {"trace_once": jx["trace_once"],
                                  "state": jx["state"]}
        reset_observers(obs)
        calls = RuleCalls()
        try:
            sim = lifetime.LifetimeSim(spec, backend="torch", device="cpu")
            ent["rule_calls"], ent["tags_changed"] = epoch_trace(
                sim, forced, calls)
        finally:
            calls.restore()
        assert sim.digest == ref["digest"], name
        out[name] = ent
        print(f"{name}: {ref['digest']} calls {ent['rule_calls']}",
              flush=True)
    CORPUS.write_text(json.dumps({"scenarios": out}, indent=1,
                                 sort_keys=True) + "\n")


if __name__ == "__main__":
    write_corpus()
