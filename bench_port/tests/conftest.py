"""Fixtures of the benchmark's CPU tests: the cells at a size a test run
holds, in a checkout of their own (BENCHMARK.json and the data files),
run on the port's CPU path.

    python -m pytest bench_port/tests -q

Tests marked `chip` need the card; each decides inside itself, through
the `card` fixture, whether there is one, and skips without it.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "bench_port"

# the cells' configurations, cut to a map of 34 hosts (32 under 4 racks,
# 2 under none, as config 5 leaves 2 of its 1250) and a few PGs and
# stripes; every width is as the configuration states it
TINY = {"hosts": 34, "racks": 4}
TINY_PGS = {"c5_rep3": 3000, "c5_ec84": 1024}
TINY_EC = {"object_bytes": 8 * 512 * 2, "stripe_unit": 512}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


def make_tiny_root(root: Path) -> Path:
    """A checkout holding BENCHMARK.json and the configuration and traffic
    files of every cell, cut to a test's size."""
    (root / "bench_port" / "configs").mkdir(parents=True)
    (root / "bench_port" / "traffic").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for f in (BENCH / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg.update(TINY)
        cfg["pool"]["pg_num"] = TINY_PGS[cfg["name"]]
        if "ec_profile" in cfg:
            cfg.update(TINY_EC)
        (root / "bench_port" / "configs" / f.name).write_text(
            json.dumps(cfg))
    for f in (BENCH / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        p = t["params"]
        if "objects_per_batch" in p:
            p["objects_per_batch"] = 4
        if "check_sample_pgs" in p:
            p["check_sample_pgs"] = 64
        (root / "bench_port" / "traffic" / f.name).write_text(json.dumps(t))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
