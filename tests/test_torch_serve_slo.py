"""The serve SLO engine, the latency quantiles and the kernels' first
load across threads, on the CPU.

- `ceph_tpu_torch.serve.slo` runs tests/test_health.py's SLO cases
  (raise then clear SLO_BURN, error and shed ratios, objectives from the
  environment) and scores the same samples as `ceph_tpu.serve.slo`;
- `ceph_tpu_torch.obs.quantiles`' `estimate` / `summarize` equal the
  JAX package's on seeded observations, and a `Quantile` dumps what a
  JAX perf-counter quantile dumps for the same observations;
- eight threads that load a kernel library at once run one build
  (`ceph_tpu_torch.build.load`, `crush.mapper._lib`).
"""

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu_torch import build  # noqa: E402
from ceph_tpu_torch.crush import mapper  # noqa: E402
from ceph_tpu_torch.obs import health, quantiles, timeline  # noqa: E402
from ceph_tpu_torch.serve import slo  # noqa: E402
from ceph_tpu_torch.serve.slo import Objectives, SloEngine  # noqa: E402


@pytest.fixture(autouse=True)
def _clean():
    from ceph_tpu.obs import health as jhealth

    for h in (health, jhealth):
        h.reset()
    timeline.reset()
    yield
    for h in (health, jhealth):
        h.reset()
    timeline.reset()


# -- tests/test_health.py's SLO cases ---------------------------------------

def test_slo_engine_raises_then_clears_slo_burn():
    obj = Objectives(p99_s=0.1, error_ratio=0.01, shed_ratio=0.05)
    assert obj.as_dict() == {"p99_ms": 100.0, "error_pct": 1.0,
                             "shed_pct": 5.0}
    eng = SloEngine(obj)
    c0 = dict(slo.COUNTERS)
    t = 0.0
    r = eng.observe(p99_s=0.5, queries=100, errors=0, shed=0, wall_t=t)
    assert r["breach"] and r["reasons"] == ["p99"] and not r["burning"]
    t += 1.0  # second breaching sample: fast=1.0, slow=1.0 -> raise
    r = eng.observe(p99_s=0.5, queries=100, errors=0, shed=0, wall_t=t)
    assert r["burning"] and eng.burns_raised == 1
    assert "SLO_BURN" in health.checks()
    assert health.status() == health.WARN
    # clears only after a full fast window of clean samples
    for k in range(SloEngine.FAST):
        t += 1.0
        r = eng.observe(p99_s=0.01, queries=100, errors=0, shed=0, wall_t=t)
        assert r["burning"] == (k < SloEngine.FAST - 1)
    assert eng.burns_cleared == 1
    assert "SLO_BURN" not in health.checks()
    st = eng.status()
    assert st["samples"] == 10 and st["breaches"] == 2
    assert st["burn_minutes"] == pytest.approx(8 / 60.0, abs=1e-3)
    assert {k: slo.COUNTERS[k] - c0[k] for k in c0} == {
        "slo_samples": 10, "slo_breaches": 2, "burns_raised": 1,
        "burns_cleared": 1}


def test_slo_engine_scores_error_and_shed_ratios():
    eng = SloEngine(Objectives(p99_s=1.0, error_ratio=0.01, shed_ratio=0.05))
    r = eng.observe(p99_s=0.001, queries=100, errors=2, shed=6, wall_t=0.0)
    assert r["reasons"] == ["errors", "shed"]
    r = eng.observe(p99_s=None, queries=100, errors=1, shed=5, wall_t=1.0)
    assert not r["breach"]  # at-objective is not a breach; p99 unknown


def test_slo_objectives_from_env(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_SLO_P99_MS", "100")
    monkeypatch.setenv("CEPH_TPU_SLO_ERROR_PCT", "2")
    monkeypatch.setenv("CEPH_TPU_SLO_SHED_PCT", "10")
    obj = Objectives.from_env()
    assert obj == Objectives(p99_s=0.1, error_ratio=0.02, shed_ratio=0.1)


def test_slo_engine_equals_jax_on_seeded_samples():
    from ceph_tpu.serve import slo as jslo

    rng = np.random.default_rng(5)
    obj = dict(p99_s=0.05, error_ratio=0.02, shed_ratio=0.05)
    port = SloEngine(Objectives(**obj))
    ref = jslo.SloEngine(jslo.Objectives(**obj))
    for t in range(120):
        # bursts of breaches, then quiet stretches
        bad = (t // 15) % 2 == 0 and rng.random() < 0.8
        kw = dict(p99_s=float(rng.random() * (0.2 if bad else 0.04)),
                  queries=int(rng.integers(1, 500)),
                  errors=int(rng.integers(0, 20 if bad else 2)),
                  shed=int(rng.integers(0, 30 if bad else 2)),
                  wall_t=float(t))
        assert port.observe(**kw) == ref.observe(**kw)
    assert port.status() == ref.status()
    assert port.burns_raised >= 2


# -- the quantiles ------------------------------------------------------------

def _observations(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # log-normal latencies around 1 ms, a heavy tail and a few spikes
    v = np.exp(rng.normal(np.log(1e-3), 1.2, n))
    v[rng.random(n) < 0.02] *= 100
    return v


@pytest.mark.parametrize("seed,n", [(1, 1), (2, 7), (3, 100), (4, 5000)])
def test_quantiles_equal_the_jax_estimator(seed, n):
    from ceph_tpu.obs import quantiles as jq

    obs = _observations(seed, n)
    bounds = list(quantiles.DEFAULT_BOUNDS)
    assert bounds == list(jq.DEFAULT_BOUNDS)
    buckets = [0] * (len(bounds) + 1)
    for v in obs:
        buckets[int(np.searchsorted(bounds, v, side="left"))] += 1
    lo, hi = float(obs.min()), float(obs.max())
    for q in (0.01, 0.5, 0.9, 0.99, 0.999):
        assert quantiles.estimate(bounds, buckets, q, lo, hi) == \
            jq.estimate(bounds, buckets, q, lo, hi)
        assert quantiles.estimate(bounds, buckets, q) == \
            jq.estimate(bounds, buckets, q)
    assert quantiles.summarize(bounds, buckets, lo, hi) == \
        jq.summarize(bounds, buckets, lo, hi)
    # summarize is value-equal to per-quantile estimate()
    s = quantiles.summarize(bounds, buckets, lo, hi)
    for name, q in quantiles.REPORTED:
        assert s[name] == quantiles.estimate(bounds, buckets, q, lo, hi)


@pytest.mark.parametrize("bounds", [None, [1, 2, 4, 8, 16, 32, 64]])
def test_quantile_dump_equals_a_jax_perf_counter(bounds):
    from ceph_tpu.utils.perf_counters import PerfCounters

    obs = _observations(9, 300) * (1e4 if bounds else 1.0)
    ref = PerfCounters("test_quantile_dump")
    ref.add_quantile("q", bounds=bounds)
    port = quantiles.Quantile(bounds)
    assert port.dump()["count"] == 0 and port.dump()["p99"] == 0.0
    for v in obs:
        ref.observe("q", float(v))
        port.observe(float(v))
    assert port.dump() == ref.dump()["q"]
    port.reset()
    assert port.dump()["count"] == 0 and sum(port.dump()["buckets"]) == 0


def test_counts_are_thread_safe():
    """16 threads (more than this machine's cores) observe and count at
    a shortened switch interval: no update is lost."""
    from ceph_tpu_torch.serve import service

    q = quantiles.Quantile()
    n0 = service.COUNTERS["bulk_lookups"]

    def work():
        for _ in range(2000):
            q.observe(1e-3)
            service._inc("bulk_lookups")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=work) for _ in range(16)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ths)
    d = q.dump()
    assert d["count"] == 32000 and sum(d["buckets"]) == 32000
    assert service.COUNTERS["bulk_lookups"] - n0 == 32000


# -- a kernel's first load from several threads -------------------------------

def test_first_load_from_eight_threads_builds_once(monkeypatch):
    source = "crush/csrc/crush_rule.cu"
    started: list = []
    finished: list = []
    gate = threading.Barrier(8)

    def start(src):
        started.append(threading.get_ident())
        time.sleep(0.05)  # nvcc's seconds, shortened: the race window
        return ("job", src)

    def finish(src, job):
        assert job == ("job", src)
        finished.append(src)

    class Lib:
        pass

    monkeypatch.setattr(build, "_start", start)
    monkeypatch.setattr(build, "_finish", finish)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.setattr(build, "_LIBS", {})
    got: list = []

    def first_use():
        gate.wait()
        got.append(build.load(source))

    ths = [threading.Thread(target=first_use) for _ in range(8)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=30)
    assert len(got) == 8 and all(g is got[0] for g in got)
    assert len(started) == 1 and finished == [source]


def test_rule_library_is_declared_once_across_threads(monkeypatch):
    """`mapper._lib` publishes a library only once its signatures are
    set, and every thread gets the same one."""
    loads: list = []

    class Fn:
        argtypes = restype = None

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn

    def load(src):
        loads.append(src)
        time.sleep(0.05)
        return Lib()

    monkeypatch.setattr(mapper.build, "load", load)
    monkeypatch.setattr(mapper, "_LIBS", {})
    gate = threading.Barrier(8)
    got: list = []

    def first_use():
        gate.wait()
        got.append(mapper._lib())

    ths = [threading.Thread(target=first_use) for _ in range(8)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=30)
    assert loads == ["crush/csrc/crush_rule.cu"]
    assert all(g is got[0] for g in got)
    assert got[0].crush_rule_launch.restype is not None


def test_temporary_build_names_are_per_thread(tmp_path, monkeypatch):
    """Two threads building one source never share a temporary file."""
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    monkeypatch.setattr(build, "PACKAGE", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc", lambda: "true")
    names: list = []

    class Popen:
        def __init__(self, argv, **kw):
            names.append(argv[argv.index("-o") + 1])

    monkeypatch.setattr(build.subprocess, "Popen", Popen)
    gate = threading.Barrier(4)  # all alive at once: no ident reused

    def start():
        gate.wait()
        build._start("k.cu")
        gate.wait()

    ths = [threading.Thread(target=start) for _ in range(4)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    assert len(names) == 4 and len(set(names)) == 4
