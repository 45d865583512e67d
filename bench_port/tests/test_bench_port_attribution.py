"""The traced window put down to the program's spans (`attribution.py`,
`attribute.py` and the readers of `attribute.PENDING`)."""

import copy

import pytest
import torch

from bench_port import attribute, attribution, harness, peaks, trace
from bench_port.tests.conftest import BENCH
from bench_port.tests.test_bench_port_metrics import EVENTS, H100

HOST = 1


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py",
                               f"bench_port.metrics.{name}")


def host(name, ts, dur, tid=HOST):
    return {"ph": "X", "name": name, "cat": "user_annotation", "ts": ts,
            "dur": dur, "tid": tid}


def device(name, ts, dur, corr, cat="kernel"):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
          "tid": 7}
    if corr is not None:
        ev["args"] = {"correlation": corr, "stream": 7}
    return ev


def launch(ts, corr, tid=HOST, cat="cuda_runtime"):
    return {"ph": "X", "name": "cudaLaunchKernel", "cat": cat, "ts": ts,
            "dur": 3, "tid": tid, "args": {"correlation": corr}}


# an epoch: the program's spans inside the benchmark's, a kernel launched
# inside pipeline.map_block, a copy launched inside state.apply
CHURN = [
    host("bench.window", 0, 1000),
    {"ph": "X", "name": "bench.window", "cat": "gpu_user_annotation",
     "ts": 200, "dur": 300, "tid": 7},
    host("bench.apply", 0, 100), host("state.apply", 10, 80),
    host("bench.rows", 100, 500), host("state.rows", 120, 460),
    host("pipeline.map_block", 130, 20),
    # a range ending a little after its parent (the clock's rounding)
    host("pipeline.map_block.launch", 140, 15),
    host("bench.sync", 600, 400),
    launch(20, 8, cat="cuda_driver"), launch(140, 7),
    device("void pipeline_kernel<1>(Map)", 200, 300, 7),
    device("Memcpy HtoD", 250, 150, 8, cat="gpu_memcpy"),
    {"ph": "X", "name": "aten::add", "cat": "cpu_op", "ts": 0, "dur": 900,
     "tid": HOST},
]


def test_idle_is_split_by_intersection_and_sums_to_the_idle_time():
    a = attribution.attribute(CHURN)
    r = trace.read(CHURN)
    # idle: [0, 200) and [500, 1000)
    assert sum(a.idle.values()) == pytest.approx(
        r.window_s - r.busy_s, abs=1e-6)
    assert a.idle == pytest.approx({
        ("bench.apply",): 20e-6,
        ("bench.apply", "state.apply"): 80e-6,
        ("bench.rows",): 40e-6,
        ("bench.rows", "state.rows"): 140e-6,
        ("bench.rows", "state.rows", "pipeline.map_block"): 10e-6,
        ("bench.rows", "state.rows", "pipeline.map_block",
         "pipeline.map_block.launch"): 10e-6,
        ("bench.sync",): 400e-6})
    assert a.idle_in({"state.apply"}) == pytest.approx(80e-6)
    assert a.idle_in({"state.rows"}) == pytest.approx(160e-6)
    assert a.idle_in({"ec.encode_batch"}) is None  # never ran
    assert list(a.idle_by_innermost())[:2] == ["bench.sync", "state.rows"]
    # the midpoint rule put all of [0, 200) on bench.rows
    assert r.gaps == pytest.approx({"bench.rows": 200e-6,
                                    "bench.sync": 500e-6})


def test_device_time_goes_to_the_launching_span():
    a = attribution.attribute(CHURN)
    assert a.device == pytest.approx({
        ("bench.rows", "state.rows", "pipeline.map_block",
         "pipeline.map_block.launch"): 300e-6,
        ("bench.apply", "state.apply"): 150e-6})
    assert a.unlinked_s == 0.0
    assert a.min_lead_us == pytest.approx(60.0)  # launched at 140, ran at 200
    assert a.device_in({"state.rows"}) == pytest.approx(300e-6)
    assert a.device_in({"state.apply"}) == pytest.approx(150e-6)


def test_a_device_clock_set_early_reads_a_negative_lead():
    early = [dict(e, ts=e["ts"] - 80) if e.get("cat") in trace.DEVICE_CATS
             else e for e in CHURN]
    a = attribution.attribute(early)
    assert a.min_lead_us == pytest.approx(-20.0)
    # the idle time is the same; its split moved with the clock
    assert sum(a.idle.values()) == pytest.approx(700e-6)
    assert a.idle[("bench.rows", "state.rows")] == pytest.approx(160e-6)
    assert ("bench.rows", "state.rows", "pipeline.map_block") not in a.idle


def readings(events, ops=1):
    r = trace.read(events)
    r.events = events
    r.traced = (0, ops)
    r.traced_ops = ops
    return r


def test_churn_readers():
    r = readings(CHURN, ops=2)
    assert reader("apply_idle_ms").read(r) == pytest.approx(0.04)
    assert reader("rows_idle_ms").read(r) == pytest.approx(0.08)
    # readings made by `run.py` carry no events: nothing is read
    r.events = []
    assert reader("apply_idle_ms").read(r) is None


# a write: the GF kernel launched in ec.gf_dispatch, the copy in ec.concat,
# a fill launched on another thread
WRITE = [
    host("bench.window", 0, 1000),
    host("bench.encode", 0, 800), host("ec.encode_batch", 10, 780),
    host("ec.gf_dispatch", 20, 80), host("ec.concat", 100, 100),
    host("bench.sync", 800, 200),
    launch(50, 1), launch(150, 2), launch(160, 3, tid=2),
    device("gf_matmul_kernel", 100, 200, 1),
    device("CatArrayBatchedCopy", 300, 600, 2),
    device("fill", 900, 10, 3, cat="gpu_memset"),
]


def test_ec_readers():
    r = readings(WRITE)
    # idle [0, 100) and [910, 1000): 90 us inside ec.encode_batch
    assert reader("ec_entry_idle_ms").read(r) == pytest.approx(0.09)
    assert reader("ec_entry_copy_ms").read(r) == pytest.approx(0.6)
    a = attribution.of(r)
    assert a.device[()] == pytest.approx(10e-6)  # no span on its thread
    # the same call decoding: ec.stack inside ec.decode_batch
    dec = copy.deepcopy(WRITE)
    for e in dec:
        e["name"] = {"ec.encode_batch": "ec.decode_batch",
                     "ec.concat": "ec.stack"}.get(e["name"], e["name"])
    assert reader("ec_entry_copy_ms").read(readings(dec)) == \
        pytest.approx(0.6)
    assert reader("ec_entry_idle_ms").read(readings(dec)) == \
        pytest.approx(0.09)


@pytest.mark.parametrize("dur,reads", [(5, True), (10, False)])
def test_unlinked_device_work_over_one_percent_reads_nothing(dur, reads):
    r = readings(WRITE + [device("lost", 950, dur, None)])
    v = reader("ec_entry_copy_ms").read(r)
    assert (v is not None) == reads
    # a launch record with another correlation does not link it
    r = readings(WRITE + [device("lost", 950, dur, 99)])
    assert (reader("ec_entry_copy_ms").read(r) is not None) == reads


def test_pending_metrics_have_readers_that_read_nothing_empty():
    names = set()
    for m in attribute.PENDING:
        names.add(m["name"])
        assert reader(m["name"]).read(trace.Readings()) is None
        assert set(m["workloads"]) <= set(attribute.CHURN + attribute.EC)
    assert names == {"apply_idle_ms", "rows_idle_ms", "ec_entry_idle_ms",
                     "ec_entry_copy_ms"}


def with_program_spans(events):
    """EVENTS with the program's spans and launch records added."""
    return events + [
        host("state.apply", 5, 90, tid=None),
        host("state.rows", 110, 480, tid=None),
        host("pipeline.map_block", 280, 5, tid=None),
        launch(281, 4, tid=None),
    ]


def test_existing_readings_unchanged_by_the_programs_spans(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: H100)
    monkeypatch.setattr(peaks, "max_sm_clock_hz", lambda: 1e9)
    got = []
    for events in (EVENTS, with_program_spans(EVENTS)):
        r = trace.read(events)
        r.spans = {"bench.apply": [1e-3, 3e-3], "bench.rows": [5e-4, 5e-4],
                   "bench.sync": [1e-4, 3e-4]}
        r.traced, r.traced_ops = (0, 2), 2
        r.info = {"draws": [1000, 3000], "pgs": 10, "bytes": 64,
                  "gf_bytes": [335]}
        values = {f.stem: reader(f.stem).read(r)
                  for f in sorted((BENCH / "metrics").glob("*.py"))
                  if f.stem not in {m["name"] for m in attribute.PENDING}}
        got.append((r.kernels, r.busy_s, r.window_s, r.gaps,
                    r.breakdown(), values))
    assert got[0] == got[1]
    assert got[0][5]["state_apply_ms"] == pytest.approx(2.0)


def test_traced_window_holds_the_programs_spans(tiny_root, monkeypatch):
    """On the CPU, the churn cell's traced window: the program's spans
    nest inside the benchmark's, and with no device work all the window
    is idle, put down to them."""
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.0)
    monkeypatch.setattr(harness, "TRACE_MIN_OPS", 2)
    cell = harness.Cell.load("c5_rep3.churn", tiny_root)
    drv = harness.make_driver(harness.Ctx(cell, 2147483659, "cpu"))
    drv.setup()
    harness.warm_profiler("cpu")
    w = harness.run_window(drv, "cpu", 3.0, True, max_ops=12)
    assert w.traced is not None and w.traced[1] - w.traced[0] >= 2
    drv.release()
    assert all(v <= lim for _, v, lim in drv.check())
    rd = attribute.readings(cell, drv, w, 1)
    a = attribution.of(rd)
    assert {"bench.apply", "state.apply", "bench.rows",
            "state.rows"} <= a.seen
    stacks = set(a.idle)
    assert ("bench.apply", "state.apply") in stacks
    assert any(st[:2] == ("bench.rows", "state.rows") for st in stacks)
    assert sum(a.idle.values()) == pytest.approx(rd.window_s, abs=1e-6)
    assert reader("apply_idle_ms").read(rd) > 0
    assert reader("rows_idle_ms").read(rd) > 0


def test_attribute_run_of_a_write_on_the_cpu(tiny_root, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.0)
    monkeypatch.setattr(harness, "TRACE_MIN_OPS", 2)
    out = attribute.run("c5_ec84.write", 2147483659, 1.0, "cpu",
                        root=tiny_root)
    assert out["correct"] and out["traced_ops"] >= 2
    assert out["idle_s"] == pytest.approx(out["window_s"], abs=1e-6)
    assert "ec.concat" in out["idle_split"]
    assert out["metrics"]["ec_entry_idle_ms"] > 0
    # the CPU runs no device work: no copy time to read
    assert out["metrics"]["ec_entry_copy_ms"] is None
