"""`python -m ceph_tpu_torch.cli.serve` held against the JAX package's
`ceph_tpu.cli.serve`, on the CPU (`--device cpu`).

- `query` (`<pool>.<seed>`, `--object`, `--json`, an unknown pool, a
  checkpointed epoch with `--resume`, the usage errors) prints the JAX
  CLI's bytes with its exit status;
- `run --json` and `chaos --json` print a record with the JAX CLI's keys
  and its deterministic values (the epochs, the lifetime digest, the
  sample digest), exit 0 and drop nothing; the exit status is 1 when a
  query was dropped;
- the kill mid-chaos (`CEPH_TPU_FAULTS="serve_dispatch.30=exit:9"`) and
  `--resume` answer as an independent resume does (slow, as in the JAX
  suite).

The JAX CLI's outputs are stored in tests/data/serve_corpus.json
(`python tests/test_torch_serve.py` rewrites it).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu_torch.cli import serve as port_cli  # noqa: E402

CORPUS = ROOT / "tests" / "data" / "serve_corpus.json"

# (name, argv) of the query cases; "{ck}" is a checkpoint holding the
# stored JAX serve entry
QUERY_CASES = [
    ("pg", ["query", "0.42"]),
    ("pg_hex_json", ["query", "0.0x2a", "--json"]),
    ("object", ["query", "--object", "rbd_data.1f3a.0000000000000007"]),
    ("object_small_json", ["query", "--object", "foo", "--pgs", "64",
                           "--osds", "8", "--json"]),
    ("unknown_pool", ["query", "7.1"]),
    ("no_pgid", ["query"]),
    ("resume_no_checkpoint", ["query", "0.5", "--resume"]),
    ("resumed", ["query", "0.3", "--checkpoint", "{ck}", "--resume"]),
]
RUN_ARGV = ["run", "--pgs", "64", "--osds", "8", "--seconds", "0.5",
            "--clients", "1", "--batch", "16", "--json"]
CHAOS_ARGV = ["chaos", "--epochs", "3", "--clients", "1", "--batch", "16",
              "--json"]
# the values of a run / chaos record that do not depend on timing
RUN_FIXED = ("epoch", "dropped", "sample_digest")
CHAOS_FIXED = ("scenario", "epochs", "final_epoch", "dropped",
               "swaps_ok", "swaps_rejected", "sim_digest", "sim_violations",
               "sample_digest", "traffic", "structural_swap_stalls")


def _corpus() -> dict:
    return json.loads(CORPUS.read_text())


def _ck_file(tmp: Path) -> str:
    ck = tmp / "serve_ck.json"
    ck.write_text(json.dumps({"stages_done": [],
                              "serve": _corpus()["checkpoint"]["ck"]}))
    return str(ck)


def _call(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _argv(argv, tmp: Path) -> list[str]:
    return [_ck_file(tmp) if a == "{ck}" else a for a in argv]


def jax_cli_outputs(tmp: Path) -> dict:
    """The JAX CLI's outputs on every case (the corpus's "cli" entry)."""
    from ceph_tpu.cli import serve as jax_cli

    os.environ["CEPH_TPU_SERVE_PREWARM"] = "0"  # no output depends on it
    out = {"query": {}}
    for name, argv in QUERY_CASES:
        rc, stdout, stderr = _call(jax_cli.main, _argv(argv, tmp))
        out["query"][name] = {"rc": rc, "stdout": stdout,
                              "stderr": stderr if rc == 2 else None}
    for key, argv, fixed in (("run", RUN_ARGV, RUN_FIXED),
                             ("chaos", CHAOS_ARGV, CHAOS_FIXED)):
        rc, stdout, _ = _call(jax_cli.main, argv)
        rec = json.loads(stdout.strip().splitlines()[-1])
        out[key] = {"rc": rc, "keys": sorted(rec),
                    "fixed": {k: rec[k] for k in fixed}}
    return out


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """A deadline no loaded test machine misses: the records compared
    here do not depend on it (the JAX outputs were taken with the
    default), but a request the CLI's 250 ms default expires is not
    answered ok."""
    from ceph_tpu_torch import obs
    from ceph_tpu_torch.runtime import faults

    monkeypatch.setenv("CEPH_TPU_SERVE_DEADLINE_MS", "30000")
    yield
    faults.disarm_all()
    obs.health.reset()
    obs.timeline.reset()


@pytest.mark.parametrize("name,argv", QUERY_CASES,
                         ids=[n for n, _ in QUERY_CASES])
def test_query_prints_the_jax_bytes(name, argv, tmp_path):
    want = _corpus()["cli"]["query"][name]
    rc, stdout, stderr = _call(port_cli.main,
                               _argv(argv, tmp_path) + ["--device", "cpu"])
    assert rc == want["rc"]
    assert stdout == want["stdout"]
    if want["stderr"] is not None:  # the usage errors (exit 2)
        assert stderr == want["stderr"]


@pytest.mark.parametrize("key,argv,fixed", [
    ("run", RUN_ARGV, RUN_FIXED), ("chaos", CHAOS_ARGV, CHAOS_FIXED)],
    ids=["run", "chaos"])
def test_json_record_has_the_jax_keys_and_values(key, argv, fixed):
    want = _corpus()["cli"][key]
    rc, stdout, _ = _call(port_cli.main, argv + ["--device", "cpu"])
    rec = json.loads(stdout.strip().splitlines()[-1])
    assert rc == want["rc"] == 0
    assert sorted(rec) == want["keys"]
    assert {k: rec[k] for k in fixed} == want["fixed"]
    assert rec["dropped"] == 0 and rec["answered_ok"] > 0


def test_exit_status_is_one_when_a_query_was_dropped():
    args = port_cli._parser().parse_args(["run", "--json"])
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_cli._emit(args, {"dropped": 1}) == 1
        assert port_cli._emit(args, {"dropped": 0}) == 0


def test_text_output_prints_the_jax_lines():
    """`run` without --json prints the JAX CLI's lines, in its order and
    layout (the values that time nothing are checked)."""
    rc, stdout, _ = _call(port_cli.main,
                          [a for a in RUN_ARGV if a != "--json"]
                          + ["--device", "cpu"])
    assert rc == 0
    keys = [line.split()[0] for line in stdout.splitlines()]
    assert keys == ["sample_digest", "epoch", "wall_s", "submitted",
                    "dropped", "answered_ok", "qps", "p50_s", "p99_s",
                    "queries_shed", "queries_expired", "degraded_answered"]
    want = _corpus()["cli"]["run"]["fixed"]
    assert f"{'sample_digest':20} {want['sample_digest']}" in stdout


@pytest.mark.slow
def test_cli_kill_mid_serve_and_restart_answers_identically(tmp_path):
    """The daemon dies (exit:9 via the serve_dispatch fault) mid-chaos
    after several epoch swaps; a restart with --resume serves the
    checkpointed epoch with the digest an in-process resume gives."""
    from ceph_tpu_torch.crush.types import ITEM_NONE
    from ceph_tpu_torch.osd.types import PgId
    from ceph_tpu_torch.serve import PlacementService, ServeConfig

    scenario = (
        "hosts=4,osds_per_host=3,racks=1,pgs=32,ec=,size=3,"
        "balance_every=0,p_pg_temp=0,p_split=0,p_pool_create=0,"
        "p_expand=0,p_remove=0,p_death=0.1,p_flap=0.5,p_reweight=0.3,"
        "spotcheck_every=0,checkpoint_every=0,seed=31")
    ck = str(tmp_path / "serve_kill_ck.json")
    env = dict(os.environ, CEPH_TPU_FAULTS="serve_dispatch.30=exit:9")
    p = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.cli.serve", "chaos",
         "--scenario", scenario, "--epochs", "40", "--checkpoint", ck,
         "--clients", "2", "--batch", "32", "--json", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 9, (p.returncode, p.stderr[-500:])
    state = json.loads(Path(ck).read_text())["serve"]
    assert state["epoch"] >= 2
    env.pop("CEPH_TPU_FAULTS")
    p2 = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.cli.serve", "chaos",
         "--checkpoint", ck, "--resume", "--clients", "1", "--batch",
         "32", "--json", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert p2.returncode == 0, (p2.returncode, p2.stderr[-500:])
    out = json.loads(p2.stdout.strip().splitlines()[-1])
    assert out["resumed_epoch"] == state["epoch"]
    assert out["dropped"] == 0
    svc = PlacementService(
        config=ServeConfig(block=64, max_queue=8, deadline_s=5.0),
        checkpoint=ck, resume=True, name="test.kill", device="cpu")
    try:
        assert svc.epoch == state["epoch"]
        assert svc.sample_digest() == out["sample_digest"]
        m = svc._active.m
        for seed in (0, 7, 19):
            r = svc.lookup(0, seed)
            _, _, a, ap = m.pg_to_up_acting_osds(PgId(0, seed))
            got = [int(o) for o in r.acting[0] if o != ITEM_NONE]
            assert got == list(a) and int(r.acting_primary[0]) == ap
    finally:
        svc.close()
