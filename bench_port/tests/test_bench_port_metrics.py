"""The per-layer readers and the tail do their arithmetic right."""

import json

import pytest
import torch

from bench_port import harness, peaks, trace
from bench_port.tests.conftest import BENCH, REPO

H100 = "NVIDIA H100 80GB HBM3"


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py",
                               f"bench_port.metrics.{name}")


def test_tail_moves_with_one_stall():
    samples = [1.0] * 19 + [2.0]
    assert harness.p95(samples) == 1.0
    assert harness.p95(samples + [50.0]) == 2.0
    assert harness.p95([3.0]) == 3.0


def test_every_per_layer_metric_has_a_reader_that_reads_nothing_empty():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert reader(m["name"]).read(trace.Readings()) is None, m["name"]


EVENTS = [
    {"ph": "X", "name": "bench.window", "cat": "gpu_user_annotation",
     "ts": 100, "dur": 600},
    {"ph": "X", "name": "bench.window", "cat": "user_annotation",
     "ts": 0, "dur": 1000},
    {"ph": "X", "name": "bench.apply", "cat": "user_annotation",
     "ts": 0, "dur": 100},
    {"ph": "X", "name": "bench.rows", "cat": "user_annotation",
     "ts": 100, "dur": 500},
    {"ph": "X", "name": "bench.sync", "cat": "user_annotation",
     "ts": 600, "dur": 400},
    {"ph": "X", "name": "void (anonymous namespace)::pipeline_kernel<1>("
     "crush_rule::Map)", "cat": "kernel", "ts": 100, "dur": 200},
    {"ph": "X", "name": "Memcpy HtoD", "cat": "gpu_memcpy",
     "ts": 250, "dur": 150},
    {"ph": "X", "name": "void pipeline_kernel<1>(Map)", "cat": "kernel",
     "ts": 600, "dur": 100},
    {"ph": "X", "name": "aten::add", "cat": "cpu_op", "ts": 0, "dur": 900},
    {"ph": "X", "name": "early kernel", "cat": "kernel", "ts": -20,
     "dur": 50},
]


def test_trace_union_gaps_and_breakdown():
    r = trace.read(EVENTS)
    assert r.window_s == pytest.approx(1e-3)
    # [0, 30), [100, 400) and [600, 700): the early kernel is the window's
    assert r.busy_s == pytest.approx(430e-6)
    assert r.gaps == pytest.approx({"bench.apply": 70e-6,
                                    "bench.rows": 200e-6,
                                    "bench.sync": 300e-6})
    assert r.launches("pipeline_kernel") == 2
    assert r.device_seconds("pipeline_kernel") == pytest.approx(300e-6)
    b = r.breakdown()
    assert b["device_ops"][0] == ["void pipeline_kernel<1>",
                                  pytest.approx(300e-6)]
    assert b["idle_gaps"][0] == ["bench.sync", pytest.approx(300e-6)]
    assert trace.read(EVENTS, n_chips=2).busy_s == pytest.approx(215e-6)


def readings(**kw):
    r = trace.read(EVENTS)
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_churn_readers(monkeypatch):
    r = readings(spans={"bench.apply": [1e-3, 3e-3, 5e-3],
                        "bench.rows": [9.0, 0.5e-3, 0.5e-3],
                        "bench.sync": [9.0, 0.1e-3, 0.3e-3]},
                 traced=(1, 3), traced_ops=2,
                 info={"draws": [1000, 3000], "pgs": 10, "bytes": 64})
    assert reader("state_apply_ms").read(r) == pytest.approx(3.0)
    assert reader("pipeline_kernel_ms").read(r) == pytest.approx(0.15)
    # the traced epochs: host 0.7 ms an epoch, kernel 0.15
    assert reader("rows_overhead_ms").read(r) == pytest.approx(0.55)
    assert reader("idle_share.churn").read(r) == pytest.approx(57.0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: H100)
    monkeypatch.setattr(peaks, "max_sm_clock_hz", lambda: 1e9)
    ops = 4000 * peaks.OPS_PER_DRAW + 20 * peaks.HASH2_OPS
    want = 100 * ops / (132 * 4 * 32 * 1e9) / 300e-6
    assert reader("pipeline_roofline").read(r) == pytest.approx(want)
    # bytes bound it where they take longer: 2 x 3.35 GB is 2 ms
    r.info["bytes"] = 3_350_000_000
    assert reader("pipeline_roofline").read(r) == pytest.approx(
        100 * 2e-3 / 300e-6)
    # a launch per epoch, or nothing is read
    r.info = {"draws": [1000], "pgs": 10, "bytes": 64}
    assert reader("pipeline_roofline").read(r) is None


def test_ec_readers(monkeypatch):
    ev = [e for e in EVENTS if "pipeline" not in e["name"]] + [
        {"ph": "X", "name": "void gf_matmul_kernel(long const*)",
         "cat": "kernel", "ts": 500, "dur": 100}]
    r = trace.read(ev)
    r.traced_ops = 1
    r.info = {"gf_bytes": [335_000_000]}
    assert reader("gf_kernel_ms").read(r) == pytest.approx(0.1)
    # every device interval but the GF kernel: 50 + 150 us
    assert reader("ec_copy_ms").read(r) == pytest.approx(0.2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: H100)
    # 335 MB at 3.35 TB/s is 100 us: the bound equals the kernel's time
    assert reader("gf_matmul_roofline").read(r) == pytest.approx(100.0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "other")
    assert reader("gf_matmul_roofline").read(r) is None
    assert reader("idle_share.io").read(r) == pytest.approx(72.0)
