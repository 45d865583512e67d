"""The check decides `correct`: sound runs pass, and a run whose timed
path is broken underneath it (the faults a cell can have), or whose
program is the cell's control, comes out as not correct.  One chip only:
no cell has an exchange between chips to leave out."""

import json

import pytest
import torch

from bench_port import controls
from bench_port.tests.cellrun import run_cell

CELLS = ("c5_rep3.churn", "c5_ec84.churn", "c5_ec84.write",
         "c5_ec84.degraded_read")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    out = run_cell(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert set(out["checks"].values()) == {0}


# -- placement: faults under ClusterState -------------------------------

def _state_cls():
    from ceph_tpu_torch.osd.state import ClusterState

    return ClusterState


def fault_stale_state(monkeypatch):
    """A step that returns its state unchanged: apply does nothing."""
    monkeypatch.setattr(_state_cls(), "apply", lambda self, inc: "delta")


def fault_half_rows(monkeypatch):
    """Half of the PGs left out: the second half keeps the rows before
    the epoch."""
    cls = _state_cls()
    real = cls.rows
    prev = {}

    def rows(self, pid):
        r, skey, tag = real(self, pid)
        old = prev.get(id(self))
        prev[id(self)] = r
        if old is not None and old.shape == r.shape:
            r = torch.cat([r[:r.shape[0] // 2], old[r.shape[0] // 2:]])
        return r, skey, tag
    monkeypatch.setattr(cls, "rows", rows)


def fault_altered_row(monkeypatch):
    """One answer altered where it is produced: one PG's first OSD."""
    cls = _state_cls()
    real = cls.rows

    def rows(self, pid):
        r, skey, tag = real(self, pid)
        r = r.clone()
        r[r.shape[0] // 3, 0] += 1
        return r, skey, tag
    monkeypatch.setattr(cls, "rows", rows)


@pytest.mark.parametrize("cell", ("c5_rep3.churn", "c5_ec84.churn"))
@pytest.mark.parametrize("fault", (fault_stale_state, fault_half_rows,
                                   fault_altered_row))
def test_placement_fault_is_not_correct(tiny_root, monkeypatch, cell,
                                        fault):
    fault(monkeypatch)
    out = run_cell(tiny_root, cell)
    assert not out["correct"], out["checks"]


# -- erasure code: faults under RSErasureCode ---------------------------

def _rs():
    from ceph_tpu_torch.ec.rs import RSErasureCode

    return RSErasureCode


def fault_stale_encode(monkeypatch):
    """A step that returns its state unchanged: each call gives back the
    previous call's chunks."""
    cls, real, prev = _rs(), _rs().encode_batch, []

    def encode_batch(self, data):
        out = real(self, data)
        prev.append(out)
        return prev[-2] if len(prev) > 1 else out
    monkeypatch.setattr(cls, "encode_batch", encode_batch)


def fault_half_encode(monkeypatch):
    """Half of the batch left out: the second half's parity unwritten."""
    cls, real = _rs(), _rs().encode_batch

    def encode_batch(self, data):
        out = real(self, data).clone()
        out[out.shape[0] // 2:, self.k:] = 0
        return out
    monkeypatch.setattr(cls, "encode_batch", encode_batch)


def fault_altered_encode(monkeypatch):
    """One byte altered where it is produced."""
    cls, real = _rs(), _rs().encode_batch

    def encode_batch(self, data):
        out = real(self, data).clone()
        out[-1, -1, -1] ^= 1
        return out
    monkeypatch.setattr(cls, "encode_batch", encode_batch)


def fault_stale_decode(monkeypatch):
    """Each call gives back the previous call's rebuilt chunks."""
    cls, real, prev = _rs(), _rs().decode_batch, []

    def decode_batch(self, want, chunks, size):
        out = real(self, want, chunks, size)
        prev.append(out)
        return prev[-2] if len(prev) > 1 else out
    monkeypatch.setattr(cls, "decode_batch", decode_batch)


def fault_half_decode(monkeypatch):
    """Half of the batch left out: the second half's rebuilt bytes zero."""
    cls, real = _rs(), _rs().decode_batch

    def decode_batch(self, want, chunks, size):
        out = dict(real(self, want, chunks, size))
        for i in set(want) - set(chunks):
            v = out[i].clone()
            v[v.shape[0] // 2:] = 0
            out[i] = v
        return out
    monkeypatch.setattr(cls, "decode_batch", decode_batch)


def fault_altered_decode(monkeypatch):
    cls, real = _rs(), _rs().decode_batch

    def decode_batch(self, want, chunks, size):
        out = dict(real(self, want, chunks, size))
        i = min(set(want) - set(chunks))
        v = out[i].clone()
        v[0, 0] ^= 1
        out[i] = v
        return out
    monkeypatch.setattr(cls, "decode_batch", decode_batch)


@pytest.mark.parametrize("fault", (fault_stale_encode, fault_half_encode,
                                   fault_altered_encode))
def test_write_fault_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    assert not run_cell(tiny_root, "c5_ec84.write", ops=20)["correct"]


@pytest.mark.parametrize("fault", (fault_stale_decode, fault_half_decode,
                                   fault_altered_decode))
def test_degraded_read_fault_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    assert not run_cell(tiny_root, "c5_ec84.degraded_read",
                        ops=20)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    drv = json.loads((tiny_root / "bench_port" / "traffic"
                      / f"{cell}.json").read_text())["driver"]
    out = run_cell(tiny_root, cell, program=controls.CONTROLS[drv], ops=16)
    assert not out["correct"], out["checks"]


def test_a_cell_added_by_data_files_alone(tiny_root):
    """A new traffic mix and cell: one traffic file and one entry in
    BENCHMARK.json, nothing else."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "c5_rep3.flap", "config": "c5_rep3", "traffic": "flap",
        "chips": 1, "why": "a host flapping down and up"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    (tiny_root / "bench_port" / "traffic" / "c5_rep3.flap.json").write_text(
        json.dumps({"config": "c5_rep3", "traffic": "flap",
                    "driver": "churn", "why": "a host flapping",
                    "params": {"cycle": ["host_down", "restore"],
                               "reweight_osds": 1, "reweight_to": 0.5,
                               "check_sample_pgs": 32}}))
    out = run_cell(tiny_root, "c5_rep3.flap", ops=5)
    assert out["correct"] and out["window"].ops == 5


def test_traced_window_reads_the_spans(tiny_root, monkeypatch):
    """The traced path on the CPU: the profiler runs around the traced
    operations and the readers find the benchmark's spans (the card's
    kernels exist only on the card)."""
    from bench_port import harness

    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.0)
    monkeypatch.setattr(harness, "TRACE_MIN_OPS", 2)
    cell = harness.Cell.load("c5_rep3.churn", tiny_root)
    drv = harness.make_driver(harness.Ctx(cell, 9, "cpu"))
    drv.setup()
    harness.warm_profiler("cpu")
    w = harness.run_window(drv, "cpu", 3.0, True, max_ops=12)
    drv.check()
    assert w.traced is not None and w.traced[1] - w.traced[0] >= 2
    assert len(w.spans.seconds["bench.apply"]) == w.ops
    metrics, device, breakdown = harness.per_layer(cell, drv, w, 1)
    assert metrics["state_apply_ms"]["value"] > 0
    assert device["window_s"] > 0
    assert set(breakdown) == {"device_ops", "idle_gaps"}
