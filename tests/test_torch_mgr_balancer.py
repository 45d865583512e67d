"""The port's mgr balancer (`ceph_tpu_torch.mgr`, `cli/balancer.py`, on
the CPU) held exact against the JAX package's.

tests/data/mgr_corpus.json holds, for the cases of
tests/test_mgr_balancer.py (eval, upmap, max_optimizations, EALREADY,
crush-compat, its failure restore, a stale plan, and a device_loop upmap
plan), what the JAX package gives with its host mapper: the Eval scores
and `show(verbose=True)` text, the return code and detail, the plan's
`show()` text, the sha256 of the plan Incremental's wire bytes, the final
score, and the sha256 of pool 0's `up` rows (int32 [pg_num, size],
ITEM_NONE padded) after the plan is executed; and the balancer CLI's
stdout and files for its verbs (status, eval, optimize with --plan-out
and --execute, show, execute; upmap and crush-compat).  Each case's map
is `cli/balancer.py::build_synthetic` of its spec.

The port reproduces every entry with no tolerance: with its rule kernel's
plain version (mapper "torch", device "cpu"), with a ClusterState behind
the MappingState (the plan executed into the state, which must take it
as one delta), and with its host mapper.  `chip_smoke.py` holds the card
to the same file.  `python tests/test_torch_mgr_balancer.py` rewrites it
(a few seconds).
"""

import contextlib
import errno
import hashlib
import io
import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import ceph_tpu.cli.balancer as jax_cli  # noqa: E402
import ceph_tpu.mgr as jax_mgr  # noqa: E402
from ceph_tpu.osd import incremental as jax_incremental  # noqa: E402
import ceph_tpu_torch.cli.balancer as cli  # noqa: E402
import ceph_tpu_torch.mgr as mgr  # noqa: E402
from ceph_tpu_torch.crush.types import ITEM_NONE  # noqa: E402
from ceph_tpu_torch.mgr.eval import EXACT_SUM  # noqa: E402
from ceph_tpu_torch.mgr.module import get_compat_weight_set_weights  # noqa: E402
from ceph_tpu_torch.osd import incremental  # noqa: E402
from ceph_tpu_torch.osd.pipeline import PoolMapper  # noqa: E402
from ceph_tpu_torch.osd.state import ClusterState  # noqa: E402
from ceph_tpu_torch.osd.types import PgId  # noqa: E402

CORPUS = ROOT / "tests" / "data" / "mgr_corpus.json"

# (name, build_synthetic spec, mode or None for eval only, options, rng
# seed, whether the map moves an epoch before execute)
CASES = [
    ("eval_skew", "4,4,128", None, {}, 0, False),
    ("upmap", "4,4,256", "upmap", {}, 42, False),
    ("upmap_max_optimizations", "4,4,256", "upmap",
     {"upmap_max_optimizations": 3}, 1, False),
    ("upmap_ealready", "4,4,64,1.0", "upmap",
     {"upmap_max_deviation": 100}, 0, False),
    ("upmap_device_loop", "4,4,256", "upmap",
     {"upmap_state_backend": "device_loop", "upmap_candidate_batch": 16},
     42, False),
    ("crush_compat", "4,4,128", "crush-compat",
     {"crush_compat_max_iterations": 8}, 7, False),
    ("crush_compat_failure", "4,4,128", "crush-compat",
     {"crush_compat_max_iterations": 3, "target_max_misplaced_ratio": 0.0},
     7, False),
    ("stale_plan", "4,4,128", "crush-compat",
     {"crush_compat_max_iterations": 2}, 7, True),
]

# argv run in order in one directory; files to hash after each
CLI_CASES = [
    ("status", ["status"], []),
    ("eval", ["--synthetic", "4,4,64", "--mapper", "host", "eval", "-v"],
     []),
    ("optimize_upmap", ["--synthetic", "4,4,128", "--mapper", "host",
                        "optimize", "t1", "--mode", "upmap", "--plan-out",
                        "plan.inc", "--execute", "-o", "out.bin"],
     ["plan.inc", "out.bin"]),
    ("show_upmap", ["show", "plan.inc"], []),
    ("execute_upmap", ["--synthetic", "4,4,128", "execute", "plan.inc",
                       "-o", "out2.bin"], ["out2.bin"]),
    ("optimize_compat", ["--synthetic", "4,4,64", "--mapper", "host",
                         "optimize", "c1", "--mode", "crush-compat",
                         "--plan-out", "compat.inc"], ["compat.inc"]),
    ("show_compat", ["show", "compat.inc"], []),
]

JAX = types.SimpleNamespace(
    mgr=jax_mgr, build_synthetic=jax_cli.build_synthetic,
    encode_incremental=jax_incremental.encode_incremental, main=jax_cli.main)
PORT = types.SimpleNamespace(
    mgr=mgr, build_synthetic=cli.build_synthetic,
    encode_incremental=incremental.encode_incremental, main=cli.main)


def sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def rows_digest(rows) -> str:
    rows = rows.cpu().numpy() if isinstance(rows, torch.Tensor) else rows
    return sha256(np.ascontiguousarray(rows, np.int32).tobytes())


def scores(pe) -> dict:
    return {"score": pe.score, "score_by_root": pe.score_by_root,
            "score_by_pool": pe.score_by_pool}


def run_case(case, pkg, mapper="host", device=None, with_state=False):
    """One case through one package: the corpus entry's outputs."""
    name, spec, mode, options, seed, stale = case
    m = pkg.build_synthetic(spec)
    kw = {} if pkg is JAX else {"device": device}
    st = ClusterState(m, device=device) if with_state else None
    if st is not None:
        kw["state"] = st
    ms = pkg.mgr.MappingState(m, pkg.mgr.synthetic_pg_stats(m),
                              desc="current", mapper=mapper, **kw)
    bal = pkg.mgr.Balancer(options=dict(options),
                           rng=np.random.default_rng(seed))
    pe0 = bal.eval(ms)
    out = {"eval": scores(pe0), "eval_show": pe0.show(verbose=True)}
    if mode is None:
        return out
    weights = list(m.osd_weight)
    plan = bal.plan_create("p", ms, mode=mode)
    rc, detail = bal.optimize(plan)
    out.update(rc=rc, detail=detail, show=plan.show())
    if rc != 0:
        out["restored"] = (-1 not in plan.osdmap.crush.choose_args
                           and plan.osdmap.osd_weight == weights)
        return out
    pe1 = plan.final_eval or bal.eval(plan.final_state())
    out["final"] = scores(pe1)
    out["inc_sha256"] = sha256(pkg.encode_incremental(plan.finalize_inc()))
    if stale:
        m.epoch += 1
    rc, detail = bal.execute(plan, m, **({"state": st} if st else {}))
    out["execute"] = [rc, detail]
    if rc == 0:
        if st is not None:
            out["state"] = [st.delta_applies, st.full_rebuilds]
            rows = st.rows(0)[0]
        else:
            rows = pkg.mgr.MappingState(m, mapper=mapper, **kw).pool_up(0)
        out["rows_sha256"] = rows_digest(rows)
    return out


def run_cli(pkg, tmp: Path, mapper_args=None) -> dict:
    """The CLI cases in order in `tmp`: {name: {"rc", "stdout",
    "files"}}.  mapper_args replaces `--mapper host`."""
    out = {}
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        for name, argv, files in CLI_CASES:
            argv = list(argv)
            if mapper_args is not None and "--mapper" in argv:
                i = argv.index("--mapper")
                argv[i:i + 2] = mapper_args
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = pkg.main(argv)
            out[name] = {"rc": rc, "stdout": buf.getvalue(),
                         "files": {f: sha256((tmp / f).read_bytes())
                                   for f in files}}
    finally:
        os.chdir(cwd)
    return out


def corpus() -> dict:
    return json.loads(CORPUS.read_text())


# -- the port against the corpus ------------------------------------------------

@pytest.mark.parametrize("how", ["torch", "state", "host"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_port_equals_corpus(case, how):
    want = corpus()["cases"][case[0]]
    got = run_case(case, PORT, mapper="host" if how == "host" else "torch",
                   device="cpu", with_state=how == "state")
    if how == "state" and "state" in got:
        # an upmap plan lands on the state as one delta, with no rebuild;
        # a first compat weight-set adds a choose_args entry, which is
        # structural (as the JAX package classifies it): one rebuild
        assert got.pop("state") == ([1, 1] if case[2] == "upmap"
                                    else [0, 2])
    assert json.loads(json.dumps(got)) == want


@pytest.mark.parametrize("mapper", ["torch", "host"])
def test_cli_equals_corpus(mapper, tmp_path):
    args = ["--mapper", "torch", "--device", "cpu"] if mapper == "torch" \
        else None
    assert run_cli(PORT, tmp_path, args) == corpus()["cli"]


def test_corpus_is_the_jax_package(tmp_path):
    """The JAX package still gives what the corpus holds (every case but
    the device_loop one, whose loop program takes long to compile on the
    CPU; the port reproduces it above)."""
    stored = corpus()
    for case in CASES:
        if case[0] != "upmap_device_loop":
            got = json.loads(json.dumps(run_case(case, JAX)))
            assert got == stored["cases"][case[0]], case[0]
    assert run_cli(JAX, tmp_path) == stored["cli"]


# -- the port's own rules ---------------------------------------------------------

def test_corpus_cases_say_what_the_jax_tests_say():
    """The corpus entries carry the JAX tests' verdicts: plans improve,
    EALREADY / EDOM / ESTALE where the JAX tests expect them, and a
    failed crush-compat plan leaves its working map as it found it."""
    c = corpus()["cases"]
    for name in ("upmap", "upmap_max_optimizations", "upmap_device_loop",
                 "crush_compat"):
        assert c[name]["rc"] == 0
        assert c[name]["final"]["score"] < c[name]["eval"]["score"]
        assert c[name]["execute"] == [0, ""]
    assert c["upmap_ealready"]["rc"] == -errno.EALREADY
    assert c["crush_compat_failure"]["rc"] == -errno.EDOM
    assert c["crush_compat_failure"]["restored"]
    assert c["stale_plan"]["execute"][0] == -errno.ESTALE
    n = len([ln for ln in c["upmap_max_optimizations"]["show"].splitlines()
             if "upmap-items" in ln])
    assert 0 < n <= 3


def test_unknown_mapper_raises():
    m = cli.build_synthetic("2,2,8")
    with pytest.raises(ValueError, match="unknown mapper"):
        mgr.MappingState(m, mapper="tpu")
    assert cli.main(["--synthetic", "2,2,8", "--mapper", "tpu", "eval"]) == 1


def test_pool_counts_refuses_inexact_sums():
    """The float64 per-OSD sums are exact only below 2^53: per-PG weights
    that could pass it raise instead of scoring a rounded sum."""
    m = cli.build_synthetic("2,2,16")
    ms = mgr.MappingState(m, device="cpu")
    n = m.pools[0].pg_num
    ok = np.full(n, 1 << 20, np.int64)
    c_pgs, c_obj, _ = ms.pool_counts(0, ok, ok)
    assert int(c_obj.sum()) == int(c_pgs.sum()) << 20
    big = np.full(n, EXACT_SUM // 2, np.int64)  # an OSD holds 2+ PGs
    with pytest.raises(OverflowError, match="not exact"):
        ms.pool_counts(0, ok, big)


def test_compat_weight_set_consumed_by_the_rule_kernel():
    """A written compat weight-set reaches the rule kernel's plain version
    (choose_args key -1) as it reaches the host oracle."""
    m = cli.build_synthetic("4,4,64")
    ws = get_compat_weight_set_weights(m.crush)
    rng = np.random.default_rng(5)
    ws = {o: w * float(rng.uniform(0.6, 1.4)) for o, w in ws.items()}
    m.crush.choose_args[-1] = mgr.compat_ws_to_choose_args(m.crush, ws)
    up, upp, _, _ = PoolMapper(m, 0, device="cpu").map_all()
    for ps in range(64):
        w_up, w_upp, _, _ = m.pg_to_up_acting_osds(PgId(0, ps))
        assert [o for o in up[ps] if o != ITEM_NONE] == w_up, ps
        assert upp[ps] == w_upp, ps


@pytest.mark.parametrize("backend", ["sets", "device", "device_loop"])
def test_upmap_plan_takes_the_state_rows(backend):
    """With a ClusterState behind the MappingState, eval and the upmap
    optimizer read the state's rows (one mapping of the pool in all), and
    the optimizer's bookkeeping leaves the state's rows as they were."""
    m = cli.build_synthetic("4,4,256")
    st = ClusterState(m, device="cpu")
    ms = mgr.MappingState(m, mgr.synthetic_pg_stats(m), state=st)
    bal = mgr.Balancer(options={"upmap_state_backend": backend},
                       rng=np.random.default_rng(42))
    from ceph_tpu_torch.osd import state as state_mod

    c0 = dict(state_mod.COUNTERS)
    bal.eval(ms)
    before = st.rows(0)[0].clone()
    plan = bal.plan_create("p", ms, mode="upmap")
    assert bal.optimize(plan)[0] == 0
    moved = {k: state_mod.COUNTERS[k] - c0[k] for k in c0}
    assert moved["rows_remapped"] == 1 and moved["rows_served"] >= 1
    assert torch.equal(st.rows(0)[0], before)
    assert bal.execute(plan, m, state=st) == (0, "")
    assert (st.delta_applies, st.full_rebuilds) == (1, 1)
    assert m.pg_upmap_items == plan.osdmap.pg_upmap_items


# -- the corpus writer ------------------------------------------------------------

def write_corpus() -> None:
    """Rewrite tests/data/mgr_corpus.json from the JAX package."""
    import tempfile

    cases = {c[0]: run_case(c, JAX) for c in CASES}
    with tempfile.TemporaryDirectory() as d:
        cli_out = run_cli(JAX, Path(d))
    CORPUS.write_text(json.dumps({
        "about": "the JAX package's mgr balancer outputs (host mapper) on "
                 "the cases of tests/test_torch_mgr_balancer.py (CASES: "
                 "name, cli/balancer.py::build_synthetic spec, mode, "
                 "options, rng seed, stale) and its balancer CLI's stdout "
                 "and file sha256s (CLI_CASES, run in order in one "
                 "directory); written by `python "
                 "tests/test_torch_mgr_balancer.py`",
        "case_inputs": [list(c) for c in CASES],
        "cli_inputs": [list(c) for c in CLI_CASES],
        "cases": cases, "cli": cli_out}, indent=1) + "\n")


if __name__ == "__main__":
    write_corpus()
