"""`python -m ceph_tpu_torch.cli.daemon` and `cli.psim` against the JAX
package's, on the CPU.

The daemon's self-test runs in a fresh process (`--device cpu`, the
kernels' plain versions) and its `perf dump` is held to the JAX
self-test's in tests/data/obs_corpus.json: the same group names, the
same keys and the same u64 values, apart from the differences by design:

- keys: the JAX JitAccount, compile and cache keys are absent, the
  launch accounts of the hand kernels added
  (`obs.cuda_accounting.absent_by_design`, `ADDED`); the `runtime`
  group (the backend ladder's) is absent: `--device cpu` asks for the
  host, so no ladder is walked (the JAX self-test walks its ladder to
  the pinned CPU);
- values (VALUE_DIFFERENCES): the JAX CPU engine's default strategy is
  `xor` (schedule counts), the port's the kernel's plain version; the
  JAX fast window left three seeds to its exact loop (`unresolved_pgs`,
  `rescue_invocations`) and masks them out of the diagnostics
  (`unresolved_masked`, and their collisions and retries), where every
  lane of the port's kernel is exact.  The port's collisions and retry
  histogram equal the JAX ones plus those of the three seeds, counted by
  the port on the CPU.

`bad dump` and `explain 0.Y` are held to the corpus the same way, and
psim's stdout byte for byte for 40 and 12 OSDs.  Without a card and
without `--device cpu` the self-test raises.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu_torch.obs import cuda_accounting  # noqa: E402

CORPUS = json.loads(
    (ROOT / "tests" / "data" / "obs_corpus.json").read_text())
VALUE_DIFFERENCES = {
    ("ec", "xor_schedules_built"), ("ec", "xor_schedule_cache_hits"),
    ("pipeline", "unresolved_pgs"), ("pipeline", "rescue_invocations"),
    ("placement", "unresolved_masked"), ("placement", "collisions"),
}
METRIC_LINE = re.compile(
    r"^[a-zA-Z_][a-zA-Z0-9_]*(\{[^}]*\})? (-?[0-9.e+-]+|NaN|\+Inf)$")


def _run(*argv: str, module: str = "ceph_tpu_torch.cli.daemon",
         check: bool = True):
    env = dict(os.environ)
    env.pop("CEPH_TPU_ADMIN_SOCKET", None)
    out = subprocess.run([sys.executable, "-m", module, *argv],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=300)
    if check:
        assert out.returncode == 0, out.stderr[-800:]
    return out


@pytest.fixture(scope="module")
def dumps() -> dict:
    """One self-test process answering every command in-process."""
    script = (
        "import json\n"
        "from ceph_tpu_torch.cli import daemon\n"
        "asok = daemon._import_obs_without_serving()\n"
        "daemon._selftest('cpu')\n"
        "cmds = ['perf dump', 'bad dump', 'cache dump', 'metrics']\n"
        "cmds += ['explain 0.%s' % y for y in " +
        repr(sorted(CORPUS["explain"], key=int)) + "]\n"
        "print(json.dumps({c: asok.handle_command(c) for c in cmds}))\n")
    env = dict(os.environ)
    env.pop("CEPH_TPU_ADMIN_SOCKET", None)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-800:]
    return json.loads(out.stdout)


@pytest.fixture(scope="module")
def masked() -> dict:
    """The port's diagnostics of the seeds the JAX fast window left
    unresolved (the lanes the JAX summary masks out)."""
    from ceph_tpu_torch.cli import daemon
    from ceph_tpu_torch.osd.osdmap import build_hierarchical
    from ceph_tpu_torch.osd.pipeline import PoolMapper
    from ceph_tpu_torch.osd.types import PgPool, PoolType

    n = daemon.SELFTEST_PGS
    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0, pg_num=n,
                  pgp_num=n)
    m = build_hierarchical(daemon.SELFTEST_OSDS // 4, 4, n_rack=1, pool=pool)
    pm = PoolMapper(m, 0, device="cpu", overlays=False)
    seeds = np.asarray(CORPUS["unresolved_seeds"], np.int64)
    assert len(seeds) > 0
    return {"unresolved": pm.diagnose(seeds, record=False),
            "resolved": pm.diagnose(np.setdiff1d(np.arange(n), seeds),
                                    record=False)}


def test_perf_dump_groups_keys_and_values_equal_jax(dumps, masked):
    port = json.loads(dumps["perf dump"])
    jax = CORPUS["perf"]
    assert "executables" in port
    port.pop("executables")
    # `--device cpu` walks no backend ladder: no `runtime` group
    assert set(port) == set(jax) - {"runtime"}
    for g in sorted(port):
        want = {k for k in jax[g]
                if not cuda_accounting.absent_by_design(g, k)}
        want |= set(cuda_accounting.ADDED.get(g, ())) & set(port[g])
        assert set(port[g]) == want, (g, set(port[g]) ^ want)
        for k, v in jax[g].items():
            if v is None or k not in port[g]:
                continue
            if (g, k) in VALUE_DIFFERENCES:
                continue
            assert port[g][k] == v, (g, k, port[g][k], v)
    assert port["pipeline"]["pgs_mapped"] == 256
    assert port["ec"]["bytes_encoded"] == jax["ec"]["bytes_encoded"]
    # the differences by design, each what the port's design gives
    assert port["ec"]["xor_schedules_built"] == 0
    assert port["ec"]["xor_schedule_cache_hits"] == 0
    assert port["pipeline"]["unresolved_pgs"] == 0
    assert port["pipeline"]["rescue_invocations"] == 0
    assert port["placement"]["unresolved_masked"] == 0
    assert port["placement"]["collisions"] == \
        jax["placement"]["collisions"] + masked["unresolved"]["collisions"]
    assert jax["pipeline"]["unresolved_pgs"] == \
        len(CORPUS["unresolved_seeds"])
    # no kernel launches on the CPU: the plain versions ran
    assert port["pipeline"]["crush_rule_launches"] == 0
    assert port["pipeline"]["pipeline_launches"] == 0
    assert port["ec"]["gf_matmul_launches"] == 0


def test_bad_dump_equals_jax(dumps, masked):
    port = json.loads(dumps["bad dump"])
    jax = CORPUS["bad"]
    assert port["explainers"] == jax["explainers"] == ["pool0"]
    ps, js = port["sources"]["pool0"], jax["sources"]["pool0"]
    assert set(ps) == set(js)
    for k in set(ps) - {"collisions", "tries_histogram", "unresolved"}:
        assert ps[k] == js[k], k
    assert ps["unresolved"] == 0 and js["unresolved"] == 3
    # where the JAX summary is exact (its resolved lanes) the port's
    # equals it; the whole run adds the masked lanes
    res, unres = masked["resolved"], masked["unresolved"]
    assert res["collisions"] == js["collisions"]
    assert res["tries_histogram"] == js["tries_histogram"]
    assert ps["collisions"] == res["collisions"] + unres["collisions"]
    assert ps["tries_histogram"] == [
        a + b for a, b in zip(res["tries_histogram"],
                              unres["tries_histogram"])]
    counters = port["counters"]
    for k, v in jax["counters"].items():
        if k not in ("collisions", "unresolved_masked"):
            assert counters[k] == v, k
    assert counters["choose_tries"]["buckets"][:len(ps["tries_histogram"])] \
        == ps["tries_histogram"]


def test_explain_equals_jax(dumps):
    for y, want in CORPUS["explain"].items():
        assert json.loads(dumps[f"explain 0.{y}"]) == want, y


def test_cache_dump_and_metrics(dumps):
    cache = json.loads(dumps["cache dump"])
    entries = {e["kernel"]: e for e in cache["entries"]}
    assert set(entries) == {"gf_matmul", "crush_rule", "crush_rule_diag",
                            "pipeline"}
    for e in entries.values():
        assert e["launches"] == 0 and len(e["source_hash"]) == 16
        assert e["enqueue_seconds"]["count"] == 0
    text = dumps["metrics"]
    assert text.endswith("\n")
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("#"):
            assert re.match(r"^# (HELP|TYPE) [a-zA-Z_][a-zA-Z0-9_]* ", line)
        else:
            assert METRIC_LINE.match(line), line
    assert "ceph_tpu_pipeline_pgs_mapped 256" in text


def test_daemon_cli_perf_dump_on_cpu():
    out = _run("--device", "cpu", "perf", "dump")
    d = json.loads(out.stdout)
    assert d["pipeline"]["pgs_mapped"] == 256
    assert d["ec"]["bytes_encoded"] == CORPUS["perf"]["ec"]["bytes_encoded"]
    out = _run("--no-selftest", "help")
    assert "perf dump" in json.loads(out.stdout)


def test_daemon_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    out = _run("perf", "dump", check=False)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("n_osd", ["40", "12"])
def test_psim_stdout_equals_jax(n_osd):
    out = _run(n_osd, "--device", "cpu", module="ceph_tpu_torch.cli.psim")
    assert out.stdout == CORPUS["psim"][n_osd]
