"""The port's operator surface against `ceph_tpu`'s, on the CPU.

- the perf registry: one script of declarations and updates of every
  kind runs against both registries under one fresh group name; the
  dumps, schemas, `reset_values` and the error types are equal;
- Prometheus: `prometheus_text` is byte-equal for the same registry, and
  the health-check and timeline gauges for the same checks and samples;
- trace: the same span / instant / counter script gives equal events but
  for `ts`, `dur`, `pid` and `tid` (names, phases, nesting order, args);
  the ring's dropped count, nothing recorded while off, thread safety;
- dout's line shape and `CEPH_TPU_DEBUG` parsing, and `Config`
  layering (defaults < file < env < set_val, observers);
- static scans of `ceph_tpu_torch/**`: every `CEPH_TPU_*` read goes
  through `knobs.get` and is registered, every registered knob is read;
  every literal span / instant / counter name is declared in the port's
  `spans.py` and is a JAX name, or one of the port's own (`ADDED`, none
  of them a JAX name);
- spans in the profiler's trace: nested `user_annotation` ranges while a
  torch profiler records, no `record_function` while it does not, the
  Chrome file's events unchanged by it; the batched EC entries' copies
  in spans of their own;
- the perf groups: each group's key set after importing every module
  is the JAX group's less the keys absent by design, plus the added
  ones; a port `Checkpoint`'s `"perf"` has the JAX layout;
- the kernel registry and launch accounting, on a stand-in launch.

`python tests/test_torch_obs.py` rewrites tests/data/obs_corpus.json:
the JAX daemon self-test's `perf dump`, `bad dump` and `explain 0.Y`
(one fresh process, the CPU), the seeds its fast window left unresolved,
and the JAX psim's stdout for 40 and 12 OSDs (about 30 s).
"""

from __future__ import annotations

import ast
import importlib
import io
import json
import pkgutil
import re
import subprocess
import sys
import threading
import uuid
from collections import deque
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu_torch import obs  # noqa: E402
from ceph_tpu_torch.obs import (  # noqa: E402
    cuda_accounting,
    executables,
    spans,
    trace,
)
from ceph_tpu_torch.utils import (  # noqa: E402
    config,
    dout,
    knobs,
    perf_counters,
)

CORPUS = ROOT / "tests" / "data" / "obs_corpus.json"
PORT = ROOT / "ceph_tpu_torch"
METRIC_LINE = re.compile(
    r"^[a-zA-Z_][a-zA-Z0-9_]*(\{[^}]*\})? -?[0-9.e+-]+$|"
    r"^[a-zA-Z_][a-zA-Z0-9_]*(\{[^}]*\})? (NaN|\+Inf|-Inf)$")
EXPLAIN_SEEDS = (0, 7, 42, 255)


def _jax():
    from ceph_tpu import obs as jobs
    from ceph_tpu.utils import perf_counters as jpc

    return jobs, jpc


# -- the perf registry ----------------------------------------------------------

def registry_script(pc, name: str) -> dict:
    """Declarations and updates of every kind, re-declarations and the
    errors, against one registry module; returns what it observed."""
    L = pc.logger_for(name)
    L.add_u64("ops", "op count")
    L.add_avg("batch", "batch sizes")
    L.add_time_avg("lat", "latency")
    L.add_histogram("sz", [1.0, 10.0, 100.0], "sizes")
    L.add_quantile("ql", "latencies", bounds=[0.25, 2.0, 16.0])
    L.add_quantile("qd", "default bounds")
    L.add_u64("ops")  # idempotent: keeps the live counter
    L.add_histogram("tries", [0.0, 1.0, 2.0, 3.0], "retry counts")
    L.inc("ops", 3)
    L.inc("ops")
    L.set("ops", 11)
    for v in (4.0, 6.0):
        L.observe("batch", v)
    L.observe("lat", 0.25)
    for v in (0.5, 5.0, 50.0, 500.0):
        L.observe("sz", v)
    for v in (0.125, 0.5, 0.5, 4.0, 32.0):
        L.observe("ql", v)
    for v in (3e-6, 2e-3, 0.7):
        L.observe("qd", v)
    L.merge_histogram("tries", [5, 0, 2, 1, 4])
    L.merge_histogram("sz", [1, 2], values=[0.5, 20.0])
    errors = []
    for bad in (lambda: L.inc("nope"), lambda: L.observe("nope", 1.0),
                lambda: L.inc("lat"), lambda: L.set("batch", 1),
                lambda: L.observe("ops", 1.0),
                lambda: L.merge_histogram("ops", [1]),
                lambda: L.add_avg("ops"),
                lambda: L.add_histogram("sz", [2.0, 3.0])):
        try:
            bad()
            errors.append(None)
        except (pc.UndeclaredCounterError, pc.CounterKindError) as e:
            errors.append((type(e).__name__, str(e)))
    out = {
        "dump": pc.perf_dump()[name],
        "schema": pc.perf_schema()[name],
        "errors": errors,
        "error_bases": [issubclass(pc.UndeclaredCounterError, KeyError),
                        issubclass(pc.CounterKindError, ValueError)],
    }
    L.reset_values()
    out["after_reset"] = pc.perf_dump()[name]
    L.inc("ops", 2)
    pc.reset()
    out["after_registry_reset"] = pc.perf_dump()[name]
    return out


def test_registry_script_equals_jax():
    _, jpc = _jax()
    name = f"t_torch_obs_{uuid.uuid4().hex[:8]}"
    assert registry_script(perf_counters, name) == \
        registry_script(jpc, name)


def test_group_view_and_counters_attr():
    name = f"t_view_{uuid.uuid4().hex[:8]}"
    assert perf_counters.group_view(name) == {}
    assert name not in perf_counters.perf_dump()  # reading creates nothing
    L = perf_counters.logger_for(name)
    L.add_u64("a")
    L.add_avg("b")
    L.inc("a", 4)
    L.observe("b", 2.0)
    get = perf_counters.counters_attr(name, "m", ("a", "b", "later"))
    assert get("COUNTERS") == {"a": 4, "b": {"avgcount": 1, "sum": 2.0},
                               "later": 0}
    view = get("COUNTERS")
    view["a"] = 99  # a snapshot: writing it books nothing
    assert perf_counters.group_view(name)["a"] == 4
    with pytest.raises(AttributeError):
        get("OTHER")


# -- Prometheus ----------------------------------------------------------------

def test_prometheus_text_byte_equal():
    from ceph_tpu.obs import prometheus as jprom

    from ceph_tpu_torch.obs import prometheus

    _, jpc = _jax()
    name = f"t_prom_{uuid.uuid4().hex[:8]}"
    texts = []
    for pc, prom in ((perf_counters, prometheus), (jpc, jprom)):
        registry_script(pc, name)
        L = pc.logger_for(name)
        L.inc("ops", 7)
        L.observe("ql", 1.0)
        L.observe("batch", float("nan"))
        dump = {name: pc.perf_dump()[name], "executables": {"n": 1}}
        texts.append(prom.prometheus_text(dump, pc.perf_schema()))
        # a dump without a schema entry: kinds inferred from the shapes
        texts.append(prom.prometheus_text({"foreign.g-1": {
            "n": 3, "a": {"avgcount": 2, "sum": 1.5}, "skip": {"x": 1}}},
            {}))
    assert texts[0] == texts[2] and texts[1] == texts[3]
    for line in texts[0].rstrip("\n").split("\n"):
        assert line.startswith("#") or METRIC_LINE.match(line), line
    assert f"ceph_tpu_{name}_ops 7" in texts[0]
    assert prometheus.escape_label('a"b\\c\nd') == \
        jprom.escape_label('a"b\\c\nd')


def test_health_timeline_placement_gauges_byte_equal(monkeypatch):
    from ceph_tpu.obs import health as jhealth
    from ceph_tpu.obs import placement as jplacement
    from ceph_tpu.obs import timeline as jtimeline

    from ceph_tpu_torch.obs import health, placement, timeline

    monkeypatch.setenv("CEPH_TPU_HEALTH_MUTE", "PG_DEGRADED")
    mods = ((health, timeline, placement), (jhealth, jtimeline, jplacement))
    out = []
    try:
        for h, t, p in mods:
            h.reset()
            t.reset()
            p.reset()
            h.raise_check("OSD_DOWN", h.WARN, "1/8 osds down", count=1)
            h.raise_check("PG_DEGRADED", h.WARN,
                          '3 pgs "degraded"\nback\\slash', count=3)
            h.evaluate(osds_down=2, osd_count=8, degraded=3)
            t.sample("serve", {"p99_s": 0.25, "qps": 1000.0})
            t.sample("serve", {"p99_s": 0.5, "qps": 2000.0})
            t.sample("sim", {"health": 1.0})
            p.record('mgr."plan"', {"pgs": 4, "bad_mappings": 1,
                                    "retry_exhausted": 2,
                                    "tries_histogram": [3, 1]})
            out.append((h.prometheus_gauges(), t.prometheus_gauges(),
                        p.prometheus_gauges()))
        assert out[0] == out[1]
        assert 'muted="1"' in out[0][0]
        for line in obs.prometheus_text().rstrip("\n").split("\n"):
            assert line.startswith("#") or METRIC_LINE.match(line), line
    finally:
        for h, t, p in mods:
            h.reset()
            t.reset()
            p.reset()


# -- trace ---------------------------------------------------------------------

def trace_script(tr) -> None:
    with tr.span("pipeline.map_block", pgs=4):
        with tr.span("pipeline.fetch"):
            tr.instant("fault.fired", point="x", action="fail")
        tr.counter("balancer.stddev", 1.5)
    try:
        with tr.span("ec.encode", k=8, m=4):
            raise ValueError("boom")
    except ValueError:
        pass
    with tr.span("sim.epoch"):
        pass


def _events(path: Path) -> tuple[list, dict]:
    doc = json.loads(path.read_text())
    evs = [{k: v for k, v in e.items()
            if k not in ("ts", "dur", "pid", "tid")}
           for e in doc["traceEvents"]]
    return evs, doc["otherData"]


@pytest.fixture
def both_tracers(tmp_path, monkeypatch):
    from ceph_tpu.obs import trace as jtrace

    for tr, name in ((trace, "port"), (jtrace, "jax")):
        monkeypatch.setattr(tr, "_events", deque(maxlen=1000))
        monkeypatch.setattr(tr, "_dropped", 0)
        tr.set_trace_path(str(tmp_path / f"{name}.json"))
    yield trace, jtrace
    for tr in (trace, jtrace):
        tr.set_trace_path(None)


def test_trace_events_equal_jax(both_tracers, tmp_path):
    paths = []
    for tr in both_tracers:
        trace_script(tr)
        paths.append(Path(tr.flush()))
    (pe, po), (je, jo) = (_events(p) for p in paths)
    assert pe == je
    assert [e["name"] for e in pe] == [
        "fault.fired", "pipeline.fetch", "balancer.stddev",
        "pipeline.map_block", "ec.encode", "sim.epoch"]
    assert pe[4]["args"] == {"k": 8, "m": 4, "error": "ValueError"}
    assert "dropped_events" not in po and "dropped_events" not in jo
    # nesting by time containment, as the JAX tracer records it
    doc = json.loads(paths[0].read_text())["traceEvents"]
    outer, inner = doc[3], doc[1]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_trace_ring_drops_oldest_like_jax(both_tracers, monkeypatch):
    names = []
    for tr in both_tracers:
        monkeypatch.setattr(tr, "_events", deque(maxlen=4))
        for i in range(7):
            with tr.span("sim.epoch", epoch=i):
                pass
        other = json.loads(Path(tr.flush()).read_text())
        names.append(([e["args"]["epoch"] for e in other["traceEvents"]],
                      other["otherData"]["dropped_events"]))
    assert names[0] == names[1] == ([3, 4, 5, 6], 3)


def test_trace_off_records_nothing_and_shares_the_null_span():
    trace.set_trace_path(None)
    trace.clear()
    s1, s2 = trace.span("pipeline.map_block"), trace.span("sim.epoch")
    assert s1 is s2 is trace._NULL
    with s1:
        trace.instant("fault.fired")
        trace.counter("mgr.score", 1.0)
    assert trace.n_events() == 0 and trace.flush() is None


def _profiled(fn, tmp_path) -> list:
    """The `user_annotation` events of fn() run under a CPU torch
    profiler, from its Chrome export."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _inside(inner: dict, outer: dict) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_spans_are_nested_ranges_of_the_profilers_trace(tmp_path):
    trace.set_trace_path(None)

    def script():
        with obs.span("sim.epoch", epoch=3):
            with obs.span("state.apply"):
                with obs.span("state.rebuild"):
                    pass
            with obs.span("state.rows"):
                pass

    ev = {e["name"]: e for e in _profiled(script, tmp_path)}
    assert set(ev) == {"sim.epoch", "state.apply", "state.rebuild",
                       "state.rows"}
    assert _inside(ev["state.apply"], ev["sim.epoch"])
    assert _inside(ev["state.rebuild"], ev["state.apply"])
    assert _inside(ev["state.rows"], ev["sim.epoch"])
    assert not _inside(ev["state.rows"], ev["state.apply"])
    assert trace.n_events() == 0  # no trace file asked for: no event


@pytest.mark.parametrize("profiling", [False, True])
def test_span_calls_record_function_only_while_profiling(monkeypatch,
                                                         profiling):
    import torch

    trace.set_trace_path(None)
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    if profiling:
        prof.__enter__()
    try:
        spans_made = [obs.span("pipeline.map_block", pgs=4),
                      obs.span("ec.concat")]
        for sp in spans_made:
            with sp:
                pass
    finally:
        if profiling:
            prof.__exit__(None, None, None)
    if profiling:
        assert calls == ["pipeline.map_block", "ec.concat"]
    else:  # the shared no-op, and no range made
        assert calls == []
        assert all(sp is trace._NULL for sp in spans_made)
        assert trace.n_events() == 0


def test_trace_file_events_equal_jax_while_profiling(both_tracers,
                                                    tmp_path):
    """A profiler recording changes nothing in the Chrome file: the same
    script gives the JAX tracer's events, as it does with none."""
    import torch

    paths = []
    for tr in both_tracers:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            trace_script(tr)
        paths.append(Path(tr.flush()))
    (pe, _), (je, _) = (_events(p) for p in paths)
    assert pe == je
    doc = json.loads(paths[0].read_text())["traceEvents"]
    assert {e["cat"] for e in doc} == {"ceph_tpu"}


def _ec_calls():
    """encode_batch and decode_batch of RS(4, 2) on the CPU engine."""
    import torch

    from ceph_tpu_torch.ec.registry import create_erasure_code

    code = create_erasure_code({"plugin": "jerasure",
                                "technique": "reed_sol_van", "k": "4",
                                "m": "2"}, device="cpu")
    assert hasattr(code.engine, "matmul_batch")  # the batched path
    data = torch.randint(0, 256, (3, 4, 64), dtype=torch.uint8)

    def run():
        out = code.encode_batch(data)
        chunks = {i: out[:, i] for i in (0, 2, 3, 5)}
        got = code.decode_batch({0, 1, 2, 3}, chunks, 64)
        assert torch.equal(got[1], data[:, 1])

    return run


def _assert_copies_inside_entries(ev: list) -> None:
    by = {n: [e for e in ev if e["name"] == n]
          for n in ("ec.encode_batch", "ec.concat", "ec.decode_batch",
                    "ec.stack")}
    assert all(len(v) == 1 for v in by.values()), by
    assert _inside(by["ec.concat"][0], by["ec.encode_batch"][0])
    assert _inside(by["ec.stack"][0], by["ec.decode_batch"][0])
    assert not _inside(by["ec.concat"][0], by["ec.decode_batch"][0])


def test_ec_batch_copies_have_spans_in_the_trace_file(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(trace, "_events", deque(maxlen=1000))
    trace.set_trace_path(str(tmp_path / "ec.json"))
    try:
        _ec_calls()()
        doc = json.loads(Path(trace.flush()).read_text())["traceEvents"]
    finally:
        trace.set_trace_path(None)
    _assert_copies_inside_entries(doc)


def test_ec_batch_copies_have_spans_in_the_profilers_trace(tmp_path):
    trace.set_trace_path(None)
    _assert_copies_inside_entries(_profiled(_ec_calls(), tmp_path))


def test_trace_thread_safety(both_tracers, monkeypatch):
    tr = both_tracers[0]
    n_threads, per = 8, 200
    monkeypatch.setattr(tr, "_events", deque(maxlen=4 * n_threads * per))

    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait()  # every thread alive at once: distinct tids
        for _ in range(per):
            with tr.span("serve.batch"):
                tr.instant("serve.degraded")
        barrier.wait()

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tr.n_events() == 2 * n_threads * per
    doc = json.loads(Path(tr.flush()).read_text())
    assert len(doc["traceEvents"]) == 2 * n_threads * per
    assert len({e["tid"] for e in doc["traceEvents"]}) == n_threads


def test_trace_max_events_knob(monkeypatch):
    for raw, want in (("16", 16), ("junk", 1_000_000), ("0", 1_000_000)):
        monkeypatch.setenv("CEPH_TPU_TRACE_MAX_EVENTS", raw)
        assert trace._max_events() == want


# -- dout and config -------------------------------------------------------------

def test_dout_line_shape_and_late_set_output():
    from ceph_tpu.utils import dout as jdout

    lines = []
    for d in (dout, jdout):
        log = d.subsys_logger("t_dout")  # created BEFORE set_output
        d.set_subsys_level("t_dout", 5)
        buf = io.StringIO()
        d.set_output(buf)
        try:
            log(5, "hello", 42)
            log(6, "hidden")
            assert log.enabled(5) and not log.enabled(6)
        finally:
            d.set_output(None)
        lines.append(buf.getvalue().rstrip("\n"))
    for line in lines:
        assert re.match(
            r"^\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}\.\d{6}[+-]\d{4} "
            r"[0-9a-f]+ +5 t_dout: hello 42$", line), line
    assert [x.split(" ", 2)[2] for x in lines] == \
        [lines[1].split(" ", 2)[2]] * 2


@pytest.mark.parametrize("spec", [
    "crush=10,osd=5", " ec = 3 ,bogus,sim=x, serve=20,,", "",
])
def test_dout_debug_env_parsing_equals_jax(monkeypatch, spec):
    from ceph_tpu.utils import dout as jdout

    got = []
    for d in (dout, jdout):
        monkeypatch.setattr(d, "_levels", dict(d.SUBSYS_DEFAULTS))
        monkeypatch.setenv("CEPH_TPU_DEBUG", spec)
        d._parse_env()
        got.append(dict(d._levels))
    assert got[0] == got[1]
    assert dout.SUBSYS_DEFAULTS == jdout.SUBSYS_DEFAULTS


def config_script(cfg_mod, conf_file: Path, monkeypatch) -> list:
    out = []
    c = cfg_mod.Config(env=False)
    out.append(c.show_config())
    monkeypatch.setenv("CEPH_TPU_UPMAP_MAX_DEVIATION", "7")
    monkeypatch.setenv("CEPH_TPU_OSD_CALC_PG_UPMAPS_AGGRESSIVELY", "no")
    c = cfg_mod.Config(str(conf_file))
    out.append(c.show_config())
    seen = []
    c.add_observer(lambda n, v: seen.append((n, v)))
    c.set_val("upmap_max_deviation", "9")
    c.set_val("osd_calc_pg_upmaps_aggressively", "on")
    out.append((c.show_config(), seen))
    for bad in (lambda: c.get("nope"), lambda: c.set_val("nope", 1),
                lambda: c.set_val("upmap_max_deviation", "x")):
        try:
            bad()
            out.append(None)
        except (cfg_mod.ConfigError, ValueError) as e:
            out.append(type(e).__name__)
    monkeypatch.delenv("CEPH_TPU_UPMAP_MAX_DEVIATION")
    monkeypatch.delenv("CEPH_TPU_OSD_CALC_PG_UPMAPS_AGGRESSIVELY")
    c = cfg_mod.Config(str(conf_file))
    out.append(c.show_config())
    return out


def test_config_layering_equals_jax(tmp_path, monkeypatch):
    """defaults < file < env < set_val with observers: both modules run
    the script over one table, two of the JAX package's options (the
    port declares only the options it reads, and reads none yet)."""
    from ceph_tpu.utils import config as jconfig

    names = ("osd_calc_pg_upmaps_aggressively", "upmap_max_deviation")
    monkeypatch.setattr(jconfig, "OPTIONS",
                        {n: jconfig.OPTIONS[n] for n in names})
    monkeypatch.setattr(config, "OPTIONS", {
        n: config.Option(**vars(jconfig.OPTIONS[n])) for n in names})
    conf = tmp_path / "ceph.conf"
    conf.write_text("# comment\nupmap max deviation = 3\n"
                    "osd_calc_pg_upmaps_aggressively = false  # inline\n"
                    "unknown_option = 1\nnot a line\n")
    got = config_script(config, conf, monkeypatch)
    want = config_script(jconfig, conf, monkeypatch)
    assert got == want
    assert got[1] == {"osd_calc_pg_upmaps_aggressively": False,
                      "upmap_max_deviation": 7}
    assert config.global_config() is config.global_config()


def test_config_declares_only_jax_options():
    from ceph_tpu.utils import config as jconfig

    for name, opt in config.OPTIONS.items():
        assert vars(opt) == vars(jconfig.OPTIONS[name])


# -- static scans ------------------------------------------------------------------

def _port_sources():
    for path in sorted(PORT.rglob("*.py")):
        yield path, ast.parse(path.read_text(), str(path))


def _call_name(node: ast.Call) -> str:
    f = node.func
    parts = []
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


def test_every_knob_read_is_registered_and_every_knob_is_read():
    reads: set[str] = set()
    for path, tree in _port_sources():
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            arg = node.args[0]
            literal = (isinstance(arg, ast.Constant)
                       and isinstance(arg.value, str))
            name = _call_name(node)
            if name in ("os.environ.get", "os.getenv", "environ.get"):
                assert not (literal and arg.value.startswith("CEPH_TPU_")), \
                    f"{path}: {arg.value} read past knobs.get"
            if name.endswith("knobs.get"):
                assert literal, f"{path}:{node.lineno}: knobs.get of a " \
                                "non-literal name"
                reads.add(arg.value)
        for node in ast.walk(tree):  # os.environ["CEPH_TPU_..."] reads
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.slice, ast.Constant)
                    and str(node.slice.value).startswith("CEPH_TPU_")
                    and isinstance(node.ctx, ast.Load)):
                raise AssertionError(f"{path}: {node.slice.value} read "
                                     "past knobs.get")
    assert reads <= set(knobs.KNOBS), reads - set(knobs.KNOBS)
    assert set(knobs.KNOBS) <= reads, set(knobs.KNOBS) - reads
    from ceph_tpu.utils import knobs as jknobs

    assert set(knobs.KNOBS) <= set(jknobs.KNOBS)  # the JAX names
    with pytest.raises(KeyError):
        knobs.get("CEPH_TPU_NOT_A_KNOB")
    table = knobs.render_table()
    assert table.count("\n") == len(knobs.KNOBS) + 2
    assert "| `CEPH_TPU_TRACE` |" in table


def test_every_span_name_is_declared_and_a_jax_name():
    from ceph_tpu.obs import spans as jspans

    declared = (set(spans.SPANS) | set(spans.INSTANTS)
                | set(spans.COUNTERS) | set(spans.ADDED))
    used: set[str] = set()
    for path, tree in _port_sources():
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            name = _call_name(node)
            if name.split(".")[-1] not in ("span", "instant", "counter"):
                continue
            if not any(name.startswith(p) for p in ("obs.", "trace.")):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                assert arg.value in declared, f"{path}: {arg.value}"
                used.add(arg.value)
            else:  # dynamic names carry no declared static head
                assert isinstance(arg, (ast.JoinedStr, ast.Name,
                                        ast.Attribute)), path
    assert used == declared, declared - used  # every entry is emitted
    for table, jtable in ((spans.SPANS, jspans.SPANS),
                          (spans.INSTANTS, jspans.INSTANTS),
                          (spans.COUNTERS, jspans.COUNTERS)):
        assert set(table) <= set(jtable), set(table) - set(jtable)
    # the port's own names: emitted, and none of them a JAX name
    jdeclared = set(jspans.SPANS) | set(jspans.INSTANTS) | set(jspans.COUNTERS)
    assert set(spans.ADDED) <= used
    assert not set(spans.ADDED) & jdeclared, set(spans.ADDED) & jdeclared
    assert not set(spans.ADDED) & set(spans.SPANS)
    assert set(spans.DISPATCH_SPANS) <= set(jspans.DISPATCH_SPANS)
    assert spans.known("pipeline.map_block") and not spans.known("x.y")
    assert spans.known("ec.concat") and spans.known("ec.stack")


# -- perf groups and the checkpoint ---------------------------------------------------

def _import_all(pkg: str) -> None:
    root = importlib.import_module(pkg)
    for m in pkgutil.walk_packages(root.__path__, pkg + "."):
        if ".cli." not in m.name:
            importlib.import_module(m.name)


def test_perf_groups_are_the_jax_groups():
    _jobs, jpc = _jax()
    _import_all("ceph_tpu")
    _import_all("ceph_tpu_torch")
    jschema, pschema = jpc.perf_schema(), perf_counters.perf_schema()
    groups = set(cuda_accounting.ADDED) | {
        "ec", "pipeline", "balancer", "mgr", "state", "sim", "recovery",
        "workload", "fleet", "serve", "slo", "health", "timeline",
        "placement"}
    def static(keys):
        # timed_fetch declares <key>_fetch_* at first use, in both
        # packages: which of them exist depends on what this process ran
        return {k for k in keys
                if not k.endswith(("_fetch_seconds", "_fetch_hist"))}

    for g in sorted(groups):
        want = {k for k in static(jschema[g])
                if not cuda_accounting.absent_by_design(g, k)}
        want |= set(cuda_accounting.ADDED.get(g, ()))
        assert static(pschema[g]) == want, (g, static(pschema[g]) ^ want)
        for k in set(pschema[g]) & set(jschema[g]):
            assert pschema[g][k]["type"] == jschema[g][k]["type"], (g, k)
    # every absent key names a JAX key of its group (or a JitAccount key)
    for g, keys in cuda_accounting.ABSENT.items():
        assert g in jschema or g == "runtime"


def _shape(v):
    return sorted(v) if isinstance(v, dict) else type(v).__name__


def test_checkpoint_perf_has_the_jax_layout(tmp_path):
    from ceph_tpu.runtime.scheduler import Checkpoint as JaxCheckpoint

    from ceph_tpu_torch.runtime import Checkpoint, scheduler

    _jobs, jpc = _jax()
    _import_all("ceph_tpu_torch")
    ck = Checkpoint(tmp_path / "p.json")
    ck.put("stage", {"x": 1})
    port = json.loads((tmp_path / "p.json").read_text())
    JaxCheckpoint(tmp_path / "j.json").put("stage", {"x": 1})
    jax = json.loads((tmp_path / "j.json").read_text())
    assert port["perf"] == scheduler.perf_snapshot()
    assert port["stage"]["perf"] == port["perf"]
    shared = set(port["perf"]) & set(jax["perf"])
    assert {"ec", "pipeline", "sim", "serve", "mgr"} <= shared
    for g in shared:
        for k in set(port["perf"][g]) & set(jax["perf"][g]):
            assert _shape(port["perf"][g][k]) == \
                _shape(jax["perf"][g][k]), (g, k)


# -- the kernel registry and launch accounting -----------------------------------------

def test_launch_account_books_group_and_registry():
    name = f"t_kern_{uuid.uuid4().hex[:8]}"
    L = obs.logger_for(name)
    acct = obs.LaunchAccount(L, name, "ec/csrc/gf_matmul.cu",
                             work=lambda shape: (10 * shape[0], 3 * shape[0]))
    calls = []
    assert acct.load(lambda: calls.append(1) or "lib") == "lib"
    assert acct.load(lambda: "lib") == "lib"

    def wrapper(n):
        return acct.launch(lambda a: 0 if a else 7, n, shape=(n,))

    entry = acct.entry(wrapper)
    assert entry.__name__ == "wrapper"
    assert entry(2) == 0 and entry(5) == 0 and entry(0) == 7
    d = obs.perf_dump()[name]
    assert d[f"{name}_launches"] == 2 == entry.launches
    assert d[f"{name}_launch_seconds"]["avgcount"] == 2
    assert d[f"{name}_build_seconds"]["avgcount"] == 1
    rec = executables.record(name)
    s = rec.summary()
    assert (s["bytes_per_launch"], s["ops_per_launch"]) == (50, 15)
    assert s["enqueue_seconds"]["count"] == 2 and s["last_use_unix"] > 0
    entry.launches = 0  # a caller counting from 0
    assert rec.launches == 0 and entry.launches == 0
    # one count: the group's launch keys read the record
    d = obs.perf_dump()[name]
    assert d[f"{name}_launches"] == 0
    assert d[f"{name}_launch_seconds"]["avgcount"] == 0
    assert rec.summary()["enqueue_seconds"]["count"] == 0
    with pytest.raises(ValueError):
        entry.launches = 3
    with pytest.raises(perf_counters.CounterKindError):
        L.inc(f"{name}_launches")
    entry(4)
    L.reset_values()  # `perf reset` zeroes the record's launches too
    assert entry.launches == 0 == obs.perf_dump()[name][f"{name}_launches"]
    rec.note_timed(0.5, nbytes=1_000_000_000, ops=2_000_000_000)
    s = rec.summary(analyze=True)
    assert s["roofline"]["achieved_gbps"] == 2.0
    assert s["roofline"]["achieved_gops"] == 4.0
    assert len(s["source_hash"]) == 16
    with pytest.raises(ValueError):
        executables.register(name, "crush/csrc/crush_rule.cu")


def test_counters_and_launches_lose_no_update_under_threads():
    """More threads than cores, a short switch interval: every inc,
    observe and booked launch lands exactly once."""
    import os

    name = f"t_stress_{uuid.uuid4().hex[:8]}"
    L = obs.logger_for(name)
    L.add_u64("n")
    L.add_quantile("q")
    acct = obs.LaunchAccount(L, name, "ec/csrc/gf_matmul.cu")
    n_threads = 4 * (os.cpu_count() or 1) + 4
    per = 300
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait(timeout=60)
        for _ in range(per):
            L.inc("n")
            L.observe("q", 1e-3)
            acct.launch(lambda: 0, shape=(2,))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    total = n_threads * per
    d = obs.perf_dump()[name]
    assert d["n"] == total and d["q"]["count"] == total
    assert d[f"{name}_launches"] == total
    rec = executables.record(name)
    assert rec.launches == total and rec.enqueue.count == total
    assert d[f"{name}_launch_seconds"]["avgcount"] == total


def test_kernel_registry_holds_the_three_kernels():
    from ceph_tpu_torch.crush import mapper
    from ceph_tpu_torch.ec import torch_backend

    names = {r.name: r.source for r in executables.records()}
    assert names["gf_matmul"] == "ec/csrc/gf_matmul.cu"
    assert names["crush_rule"] == "crush/csrc/crush_rule.cu"
    assert names["crush_rule_diag"] == "crush/csrc/crush_rule_diag.cu"
    for entry, key in ((torch_backend.gf_matmul_cuda, "gf_matmul"),
                       (mapper.crush_rule_cuda, "crush_rule"),
                       (mapper.crush_rule_diag_cuda, "crush_rule_diag")):
        assert entry.launches == executables.record(key).launches
        assert entry.record is executables.record(key)
    d = executables.dump(analyze=False)
    assert {e["kernel"] for e in d["entries"]} >= set(names) >= {
        "gf_matmul", "crush_rule", "crush_rule_diag"}
    text = executables.prometheus_gauges()
    assert 'ceph_tpu_executables_dispatches_total{cache="crush_rule"}' \
        in text
    for line in text.rstrip("\n").split("\n"):
        assert line.startswith("#") or METRIC_LINE.match(line), line


def test_timed_fetch_books_the_jax_keys():
    import torch

    _, jpc = _jax()
    name = f"t_fetch_{uuid.uuid4().hex[:8]}"
    L = obs.logger_for(name)
    out = obs.timed_fetch(L, "result", (torch.arange(3), torch.ones(2)))
    assert isinstance(out, tuple) and out[0].tolist() == [0, 1, 2]
    assert obs.timed_fetch(L, "one", torch.arange(4)).shape == (4,)
    from ceph_tpu.obs import timed_fetch as jtimed

    JL = jpc.logger_for(name)
    jtimed(JL, "result", np.arange(3))
    assert set(obs.perf_schema()[name]) >= set(jpc.perf_schema()[name])
    assert obs.perf_dump()[name]["result_fetch_seconds"]["avgcount"] == 1


# -- the corpus writer ---------------------------------------------------------------

_JAX_SELFTEST = r"""
import json, sys
import numpy as np
from ceph_tpu.cli import daemon
asok = daemon._import_obs_without_serving()
daemon._selftest()
out = {"perf": json.loads(asok.handle_command("perf dump")),
       "bad": json.loads(asok.handle_command("bad dump")),
       "explain": {str(y): json.loads(asok.handle_command(f"explain 0.{y}"))
                   for y in SEEDS}}
import jax.numpy as jnp
from ceph_tpu.osd.osdmap import build_hierarchical
from ceph_tpu.osd.pipeline_jax import PoolMapper
from ceph_tpu.osd.types import PgPool, PoolType
n = daemon.SELFTEST_PGS
pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0, pg_num=n,
              pgp_num=n)
m = build_hierarchical(daemon.SELFTEST_OSDS // 4, 4, n_rack=1, pool=pool)
pm = PoolMapper(m, 0, overlays=False)
flg = pm.jitted_fast()(jnp.asarray(np.arange(n, dtype=np.uint32)),
                       pm.dev, {})[4]
out["unresolved_seeds"] = [int(s) for s in np.nonzero(np.asarray(flg))[0]]
json.dump(out, sys.stdout)
"""


def write_corpus() -> None:
    env = {"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT),
           "PATH": "/usr/bin:/bin"}
    import os

    env = dict(os.environ, **env)
    env.pop("CEPH_TPU_ADMIN_SOCKET", None)
    run = subprocess.run(
        [sys.executable, "-c",
         _JAX_SELFTEST.replace("SEEDS", repr(EXPLAIN_SEEDS))],
        capture_output=True, text=True, env=env, cwd=ROOT, check=True,
        timeout=600)
    jax = json.loads(run.stdout)
    perf = {g: {k: (v if isinstance(v, int) else None)
                for k, v in sorted(grp.items())}
            for g, grp in sorted(jax["perf"].items())
            if g != "executables"}
    psim = {}
    for n in ("40", "12"):
        psim[n] = subprocess.run(
            [sys.executable, "-m", "ceph_tpu.cli.psim", n],
            capture_output=True, text=True, env=env, cwd=ROOT, check=True,
            timeout=600).stdout
    bad = jax["bad"]
    corpus = {
        "about": "JAX daemon self-test (`python -m ceph_tpu.cli.daemon`, "
                 "CPU, one process): perf dump groups/keys with u64 "
                 "values (null for other kinds), bad dump, explain 0.Y; "
                 "the seeds its fast window left unresolved; psim "
                 "stdout.  Written by `python tests/test_torch_obs.py`.",
        "perf": perf,
        "bad": {"sources": bad["sources"],
                "counters": {k: v for k, v in bad["counters"].items()
                             if isinstance(v, int)},
                "choose_tries": bad["counters"]["choose_tries"]["buckets"],
                "explainers": bad["explainers"]},
        "explain": jax["explain"],
        "unresolved_seeds": jax["unresolved_seeds"],
        "psim": psim,
    }
    CORPUS.write_text(json.dumps(corpus, indent=1, sort_keys=True) + "\n")
    print(f"wrote {CORPUS}")


if __name__ == "__main__":
    write_corpus()
