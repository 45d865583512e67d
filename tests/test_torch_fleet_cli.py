"""`python -m ceph_tpu_torch.cli.fleet` held against the JAX package's
`ceph_tpu.cli.fleet`.

The wall clock is pinned (`time.perf_counter` returns 0.0 in both
packages, so every measured rate prints as 0.0) and the two CLIs then
print the same bytes: `run`, `run --json`, `pareto` (the triage table),
`pareto --json`, `digest` and `digest --json`, the `--stop-after` /
`--resume` pair, the exit code 1 of a run with an invariant violation,
and `--resume` without `--checkpoint` (exit 2); stderr only where the
JAX package's logger stays silent.  The all-host fleet
(`backend=ref`) runs through both CLIs here; the device fleet
(`backend=jax`, the port with `--device cpu`) is held to the JAX CLI's
stdout stored in tests/data/fleet_corpus.json
(`python tests/test_torch_fleet.py` rewrites it).
"""

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from ceph_tpu_torch import obs  # noqa: E402
from ceph_tpu_torch.cli import fleet as port_cli  # noqa: E402
from ceph_tpu_torch.sim import lifetime  # noqa: E402
from test_torch_fleet import (  # noqa: E402
    BASE,
    CORPUS,
    CROSS_SPEC,
    reset_observers,
)

# the all-host fleet both CLIs run here (the host mapper takes about
# 0.1 s a pool-epoch, so it stays short)
REF_SPEC = f"base={BASE},epochs=4;axis=p_death:0.02|0.1;backend=ref"

# (name, argv) of the device fleet held to the stored JAX stdout
DEVICE_CASES = [
    ("run", ["run", "--spec", CROSS_SPEC]),
    ("run_json", ["run", "--spec", CROSS_SPEC, "--json"]),
    ("pareto", ["pareto", "--spec", CROSS_SPEC]),
    ("digest", ["digest", "--spec", CROSS_SPEC]),
]
REF_CASES = [
    ["run", "--spec", REF_SPEC],
    ["run", "--spec", REF_SPEC, "--json"],
    ["pareto", "--spec", REF_SPEC],
    ["pareto", "--spec", REF_SPEC, "--json"],
    ["digest", "--spec", REF_SPEC],
    ["digest", "--spec", REF_SPEC, "--json"],
    ["digest", "--spec", REF_SPEC, "--epochs", "2"],
]


def _jax_cli():
    from ceph_tpu.cli import fleet as jax_cli

    return jax_cli


def _both_observers():
    from ceph_tpu import obs as jobs

    reset_observers(obs)
    reset_observers(jobs)


@pytest.fixture(autouse=True)
def _clean():
    _both_observers()
    yield
    _both_observers()


@contextlib.contextmanager
def pinned_clock():
    real = time.perf_counter
    time.perf_counter = lambda: 0.0
    try:
        yield
    finally:
        time.perf_counter = real


def run_cli(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    _both_observers()
    with pinned_clock(), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def jax_cli_outputs() -> dict:
    """The JAX CLI's exit code and stdout sha256 of each DEVICE_CASES
    argv (the corpus entry)."""
    out = {}
    for name, argv in DEVICE_CASES:
        rc, text, _ = run_cli(_jax_cli().main, argv)
        out[name] = {"rc": rc, "stdout_sha256": sha(text),
                     "lines": len(text.splitlines())}
    return out


@pytest.mark.parametrize("argv", REF_CASES, ids=[
    "_".join(a for a in argv if a != REF_SPEC) for argv in REF_CASES])
def test_host_fleet_cli_bytes_equal_jax(argv):
    want = run_cli(_jax_cli().main, argv)
    got = run_cli(port_cli.main, argv)
    assert got == want
    assert got[0] == 0 and got[1]


@pytest.mark.parametrize("name, argv", DEVICE_CASES,
                         ids=[n for n, _ in DEVICE_CASES])
def test_device_fleet_cli_bytes_equal_jax(name, argv):
    want = json.loads(CORPUS.read_text())["cli"][name]
    rc, text, _ = run_cli(port_cli.main, argv + ["--device", "cpu"])
    assert (rc, sha(text)) == (want["rc"], want["stdout_sha256"]), text


def test_resume_bytes_equal_jax(tmp_path):
    """`--stop-after 2` then `--resume`: the resumed digests are the
    straight run's, and each step prints the JAX CLI's stdout."""
    outs = {}
    for who, main in (("jax", _jax_cli().main), ("port", port_cli.main)):
        ck = tmp_path / f"{who}.json"
        a = run_cli(main, ["run", "--spec", REF_SPEC, "--checkpoint",
                           str(ck), "--stop-after", "2"])
        b = run_cli(main, ["digest", "--spec", REF_SPEC, "--checkpoint",
                           str(ck), "--resume"])
        outs[who] = (a[:2], b[:2])
    assert outs["port"] == outs["jax"]
    assert "fleet epochs    2 (4 cluster-epochs)" in outs["port"][0][1]
    straight = run_cli(port_cli.main, ["digest", "--spec", REF_SPEC])
    assert outs["port"][1] == straight[:2]


def test_resume_needs_checkpoint():
    want = run_cli(_jax_cli().main, ["run", "--resume"])
    assert run_cli(port_cli.main, ["run", "--resume"]) == want
    assert want[0] == 2 and "--resume needs --checkpoint" in want[2]


def test_violation_exits_1(monkeypatch):
    """A member that books an invariant violation makes every verb exit
    1, with the JAX CLI's stdout (the JAX package also logs the violation
    to stderr; the port's simulator keeps no log)."""
    from ceph_tpu.sim.lifetime import LifetimeSim as JaxSim

    def violate(real):
        def inv(self, e, rng, stats):
            real(self, e, rng, stats)
            if e == 2 and self.scenario.p_death == 0.1:
                self._violate(e, ["pool 0: injected"])
        return inv

    for cls in (JaxSim, lifetime.LifetimeSim):
        monkeypatch.setattr(cls, "_invariants", violate(cls._invariants))
    for verb in ("run", "digest", "pareto"):
        argv = [verb, "--spec", REF_SPEC]
        want = run_cli(_jax_cli().main, argv)
        assert want[0] == 1
        assert run_cli(port_cli.main, argv)[:2] == want[:2]


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["digest", "--spec", CROSS_SPEC])


def test_cli_subprocess_digest():
    """`python -m ceph_tpu_torch.cli.fleet digest` in a process of its
    own: one `<index> <digest>` line a member, each a solo host run's
    digest."""
    env = dict(os.environ)
    env.pop("CEPH_TPU_FAULTS", None)
    spec = f"base={BASE},epochs=4;axis=seed:1|2"
    r = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.cli.fleet", "digest",
         "--spec", spec, "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert [ln.split()[0] for ln in lines] == ["0", "1"]
    solo = [lifetime.LifetimeSim(f"{BASE},epochs=4,seed={s}",
                                 backend="ref").run()["digest"]
            for s in (1, 2)]
    assert [ln.split()[1] for ln in lines] == solo
