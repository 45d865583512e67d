"""What the benchmark loads: never JAX nor the JAX package, by whole
top-level module name (`ceph_tpu_torch` begins with `ceph_tpu`)."""

import json
import subprocess
import sys

import pytest

from bench_port import harness
from bench_port.tests.conftest import REPO

# import every module of the harness and its reference, load every
# driver and reader, drive a small churn and a small write cell through
# the port's CPU path, then report the top-level names loaded
PROBE = r"""
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, {repo!r})
from bench_port import (control, controls, ecdata, harness, keep, peaks,
                        system, trace)
from bench_port.reference import crush, gf, lntable, placement
from bench_port.tests.cellrun import run_cell
from bench_port.tests.conftest import make_tiny_root
for f in sorted((harness.HERE / "metrics").glob("*.py")):
    harness.load_module(f, "bench_port.metrics." + f.stem)
root = make_tiny_root(Path(tempfile.mkdtemp()))
ok = [run_cell(root, c, ops=4)["correct"]
      for c in ("c5_rep3.churn", "c5_ec84.write")]
print(json.dumps({{"ok": ok, "forbidden": harness.loaded_forbidden(),
                  "port": "ceph_tpu_torch" in sys.modules}}))
"""


def test_harness_and_reference_load_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(repo=str(REPO))],
                         capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"ok": [True, True], "forbidden": [], "port": True}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ceph_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", sys)
    assert "ceph_tpu" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "ceph_tpu.osd", sys)
    assert "ceph_tpu" in harness.loaded_forbidden()


def test_benchmark_json_names_what_the_harness_finds():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.Cell.load(w["name"])
        kind = cell.traffic["driver"]
        assert (harness.HERE / "drivers" / f"{kind}.py").exists()
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
    for m in bench["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.chip
def test_a_cell_runs_on_the_card(card):
    """On the card: the command as the driver runs it, a short window."""
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "c5_ec84.degraded_read", "--seed", "2147483659", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"


def test_without_the_card_or_the_port_no_result(tmp_path):
    """Without the card the command exits non-zero and prints no result;
    so it does (on the card too) in a directory holding only
    BENCHMARK.json and the benchmark's folder, without the port."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (REPO, tmp_path):
        out = subprocess.run(
            [sys.executable, "bench_port/run.py", "--workload",
             "c5_ec84.write", "--seed", "5", "--seconds", "1", "--trace",
             "0"], capture_output=True, text=True, timeout=900, cwd=cwd)
        import torch

        if cwd == REPO and torch.cuda.is_available():
            continue
        assert out.returncode != 0
        assert out.stdout.strip() == ""
