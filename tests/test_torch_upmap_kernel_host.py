"""The plan kernel's body (`balancer/csrc/upmap_loop.cuh`), built for the
host with g++ (`__host__`/`__device__` defined empty), held output for
output against the plain version `upmap._loop_plan` on the CPU and the
JAX package's `_loop_account` (jitted on the CPU, as its own tests run
it): every device_loop case of tests/test_torch_balancer.py, the
drop-slot case included, and BASELINE config 2's device_loop plan, whose
digest must be tests/data/balancer_corpus.json's.

nvcc builds the same file into the one-launch kernel on the card; here a
small shim runs the body's own schedule (`run_plan`) on `HostGrid`: the
kernel's stages in its order (the start, phase (a) with block 0's top-B,
each group's shortlists and the last block's resolve and apply, the
finish), a grid of 1 or several blocks of one thread run one after
another, each barrier's last-block section run once.  The outputs must
not depend on the grid: the selections pick distinct keys, the counts
are integers, and the one float sum, the sum of squares, is taken in a
fixed order whatever the grid (`ordered_sum`, held here to a numpy
rendering of that order).  Skips, with the reason, where g++ is missing.
"""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu.balancer import upmap as jax_upmap  # noqa: E402
from ceph_tpu_torch.balancer import calc_pg_upmaps, upmap  # noqa: E402
from test_torch_balancer import (  # noqa: E402
    CASES,
    bench_map,
    corpus,
    mark_osd5_out,
    pg_ps_alias,  # noqa: F401 (the fixture)
    plan_digest,
    run_case,
    run_jax,
)
from test_torch_pipeline import osdmap_dict  # noqa: E402

CSRC = ROOT / "ceph_tpu_torch" / "balancer" / "csrc"
LOOP_CORPUS = ROOT / "tests" / "data" / "upmap_loop_corpus.json"
THREADS = 512  # upmap_loop.cuh THREADS: the lanes of the ordered sum
GRIDS = (1, 3, 16)  # blocks of the host's grid

SHIM = r"""
#include <string.h>

#include <vector>

#include "upmap_loop.cuh"

// the kernel's launch: its schedule (run_plan) on the host, as a grid of
// nblk blocks of one thread run one after another a stage at a time; the
// scratch starts as garbage but for the state, as on the card
extern "C" void upmap_loop_host(
    const int32_t* rows_in, const int32_t* pidx, const uint8_t* movable,
    const int32_t* dom_tbl, const uint8_t* tgt_ok, const double* target,
    const double* inw, const int64_t* counts, long long npg, int w, int dv,
    int npool, int nbatch, int ncap, double max_dev, long long budget,
    int64_t* out, int nblk) {
    upmap_loop::Plan p{};
    p.rows_in = rows_in;
    p.pidx = pidx;
    p.movable = movable;
    p.dom_tbl = dom_tbl;
    p.tgt_ok = tgt_ok;
    p.target = target;
    p.inw = inw;
    p.counts_in = counts;
    p.npg = npg;
    p.w = w;
    p.dv = dv;
    p.npool = npool;
    p.nbatch = nbatch;
    p.ncap = ncap;
    p.max_dev = max_dev;
    p.budget = budget;
    p.out = out;
    const size_t n = upmap_loop::scratch_bytes(dv, nbatch, npg, w, ncap);
    std::vector<uint64_t> scratch((n + 7) / 8);
    memset(scratch.data(), 0xa5, n);
    upmap_loop::bind_scratch(p, scratch.data());
    memset(p.st, 0, sizeof(upmap_loop::State));
    upmap_loop::HostGrid grid{{}, nblk};
    upmap_loop::run_plan(grid, p);
}

// the body's sum of x[d]^2 over d < n
extern "C" double ordered_sum_host(const double* x, int n) {
    upmap_loop::Plan p{};
    p.dv = n;
    std::vector<double> part(upmap_loop::THREADS);
    p.part = part.data();
    upmap_loop::HostBlock b;
    return upmap_loop::ordered_sum(b, p, x);
}
"""


@pytest.fixture(scope="module")
def body(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel body cannot be built for "
                    "the host")
    out = tmp_path_factory.mktemp("upmap_loop_host")
    shim = out / "shim.cpp"
    shim.write_text(SHIM)
    lib = out / "libupmap_loop_host.so"
    # no fused multiply-adds: the card's body rounds each product and sum
    subprocess.run(
        [gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off",
         "-D__host__=", "-D__device__=", f"-I{CSRC}", "-o", str(lib),
         str(shim)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    import ctypes

    so = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    so.upmap_loop_host.argtypes = ([p] * 8 + [ll, i, i, i, i, i,
                                              ctypes.c_double, ll, p, i])
    so.upmap_loop_host.restype = None
    so.ordered_sum_host.argtypes = [p, i]
    so.ordered_sum_host.restype = ctypes.c_double
    return so


OPERANDS = (("rows", np.int32), ("pidx", np.int32), ("movable", np.uint8),
            ("dom_tbl", np.int32), ("tgt_ok", np.uint8),
            ("target", np.float64), ("inw", np.float64),
            ("counts", np.int64))


def run_body(so, args, blocks: int = 1):
    """The host-built body on `loop_plan`'s arguments (CPU tensors or
    arrays), as a grid of `blocks` blocks: `_loop_plan`'s return.  Checks
    that the caller's rows are not written."""
    ops = [np.ascontiguousarray(np.asarray(a), dtype)
           for a, (_, dtype) in zip(args[:8], OPERANDS)]
    max_dev, budget, nbatch, ncap = args[8:]
    rows = ops[0]
    before = rows.copy()
    npg, w = rows.shape
    dv, npool = ops[5].shape[0], ops[3].shape[0]
    out = np.zeros(4 + ncap * (4 + w) + dv, np.int64)
    so.upmap_loop_host(*(a.ctypes.data for a in ops), npg, w, dv, npool,
                       nbatch, ncap, float(max_dev), int(budget),
                       out.ctypes.data, blocks)
    np.testing.assert_array_equal(rows, before)
    return upmap.unpack_loop_out(out, w, dv, ncap)


def assert_same_outputs(want, got, what: str) -> None:
    names = ("cpg", "cfrm", "cto", "crnd", "crows", "n_rej", "rounds",
             "counts")
    for name, a, b in zip(names, want, got):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=f"{what}: {name}")


def host_args(args):
    """loop_plan's arguments with every tensor copied to numpy."""
    return tuple(a.numpy().copy() if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.fixture
def spies(monkeypatch):
    """Records every plan the two packages run: the port's loop_plan
    arguments and plain outputs, the JAX _loop_account operands and
    outputs (each JAX output cut to its n_chg changes)."""
    seen = {"port": [], "jax": []}
    plain = upmap.loop_plan

    def port_spy(*args):
        ops = host_args(args)
        got = plain(*args)
        seen["port"].append((ops, got))
        return got

    account = jax_upmap._loop_account

    def jax_spy(*key):
        acct = account(*key)

        def call(*ops):
            out = acct(*ops)
            (cpg, cfrm, cto, crnd, crows, n_chg, n_rej, rounds,
             counts_f) = (np.asarray(x) for x in out[:9])
            n = int(n_chg)
            seen["jax"].append((
                [np.asarray(x) for x in ops[:8]],
                (cpg[:n], cfrm[:n], cto[:n], crnd[:n], crows[:n],
                 int(n_rej), int(rounds), counts_f)))
            return out
        return call

    monkeypatch.setattr(upmap, "loop_plan", port_spy)
    monkeypatch.setattr(jax_upmap, "_loop_account", jax_spy)
    return seen


LOOP_CASES = sorted(n for n, (_, rounds) in CASES.items()
                    if rounds[0][0].get("backend") == "device_loop")
# what a case runs on its map between two plans (tests/test_torch_balancer
# .py CASES), by name: chip_smoke.py replays the cases from the corpus
THEN = {None: None, "mark_osd5_out": mark_osd5_out}


def outputs_digest(out) -> str:
    """sha256 (16 hex digits) of a plan's outputs, `_loop_plan`'s return:
    the changes, their final rows, the rejected count, the rounds and the
    final counts, as integers (chip_smoke.py::loop_digest)."""
    cpg, cfrm, cto, crnd, crows, n_rej, rounds, counts = out
    data = [[int(x) for x in np.asarray(a).reshape(-1)]
            for a in (cpg, cfrm, cto, crnd, crows, counts)]
    return hashlib.sha256(json.dumps(
        [data, int(n_rej), int(rounds)]).encode()).hexdigest()[:16]


def loop_corpus() -> dict:
    return json.loads(LOOP_CORPUS.read_text())


def test_loop_cases_are_every_device_loop_case():
    assert len(LOOP_CASES) == 6 and "device_loop_drop_slots" in LOOP_CASES
    assert sorted(loop_corpus()["cases"]) == LOOP_CASES
    for name in LOOP_CASES:
        then = {THEN[c["then"]] for c in loop_corpus()["cases"][name]["calls"]}
        assert then == {r[2] for r in CASES[name][1]}


@pytest.mark.parametrize("name", LOOP_CASES)
def test_body_equals_plain_and_jax(name, body, spies, pg_ps_alias):
    run_case(name)
    assert len(spies["port"]) == len(spies["jax"]) == len(CASES[name][1])
    for i, ((args, plain), (jops, jax)) in enumerate(
            zip(spies["port"], spies["jax"])):
        what = f"{name} plan {i}"
        # the two packages hand their plans the same operands
        for (op, _), a, b in zip(OPERANDS, args[:8], jops):
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {op}")
        for blocks in GRIDS:
            got = run_body(body, args, blocks)
            assert_same_outputs(plain, got,
                                f"{what}, body of {blocks} against plain")
            assert_same_outputs(jax, got,
                                f"{what}, body of {blocks} against JAX")
        assert len(got[0]) > 0 or i > 0, what
        # the corpus chip_smoke.py holds the card to is the JAX package's
        entry = loop_corpus()["cases"][name]
        assert entry["calls"][i]["digest"] == outputs_digest(jax), what
    assert entry["map"] == osdmap_dict(CASES[name][0]())


def test_config2_plan_is_the_corpus(body, monkeypatch):
    """BASELINE config 2 (100k PGs / 1024 OSDs) through calc_pg_upmaps
    with the body as the plan: equal to the plain plan on the same
    operands, and the plan's digest the JAX package's."""
    plain = upmap.loop_plan
    plans = []

    def both(*args):
        want = plain(*args)
        got = run_body(body, host_args(args), 7)
        assert_same_outputs(want, got, "config 2")
        plans.append(got)
        return got

    monkeypatch.setattr(upmap, "loop_plan", both)
    entry = corpus()["config2"]
    want = entry["backends"]["device_loop"]
    m = bench_map("port", entry["pgs"], entry["osds"])
    r = calc_pg_upmaps(m, max_deviation=entry["max_deviation"],
                       max_iter=entry["max_iter"],
                       rng=np.random.default_rng(entry["rng"]),
                       device="cpu", **want["kwargs"])
    assert len(plans) == 1 and plans[0][6] >= 1
    assert plan_digest(m) == want["digest"]
    assert r.num_changed == want["num_changed"]
    assert abs(r.stddev - want["stddev"]) <= 1e-9


def numpy_ordered_sum(x: np.ndarray) -> float:
    """upmap_loop.cuh's order: lane l adds x[l]^2, x[l + THREADS]^2, ...
    in turn; then the lanes are added pairwise, halving."""
    part = np.zeros(THREADS)
    for lane in range(THREADS):
        s = 0.0
        for v in x[lane::THREADS]:
            s = s + v * v
        part[lane] = s
    h = THREADS // 2
    while h:
        part[:h] = part[:h] + part[h:2 * h]
        h //= 2
    return float(part[0])


@pytest.mark.parametrize("n", [1, 37, 512, 10_000])
def test_ordered_sum_is_the_fixed_order(body, n):
    x = np.random.default_rng(n).normal(0.0, 50.0, n) \
        + np.random.default_rng(n + 1).random(n)
    got = body.ordered_sum_host(x.ctypes.data, n)
    assert got == numpy_ordered_sum(x)


def test_cpu_plan_reads_once_a_round_and_launches_nothing():
    """On the CPU the plan is the plain version: no launch of the kernel,
    one host read a round and one for the readback; the kernel's wrapper
    refuses CPU tensors (no quiet fallback either way)."""
    c0 = dict(upmap.COUNTERS)
    launches = upmap.upmap_loop_cuda.launches
    (_, got), = run_case("device_loop_equal_weights")
    c1 = dict(upmap.COUNTERS)
    assert got["counters"]["plan_dispatches"] == 1
    assert c1["plan_host_syncs"] - c0["plan_host_syncs"] == \
        c1["rounds"] - c0["rounds"] + 1
    assert upmap.upmap_loop_cuda.launches == launches
    t = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        upmap.upmap_loop_cuda(t, t[:, 0], t[:, 0].bool(), t[:1],
                              t[:1].bool(), torch.zeros(3, dtype=torch.float64),
                              torch.zeros(3, dtype=torch.float64),
                              torch.zeros(3, dtype=torch.int64), 1.0, 4, 1, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        upmap.loop_plan(t.to("meta"), *([None] * 11))


def test_plan_kernel_is_built_registered_and_accounted():
    """The kernel is a source of the port's build, a record of the kernel
    registry (its wrapper's count), and books the `balancer` group's
    launch keys under the balancer.device_loop span."""
    from ceph_tpu_torch import build, obs
    from ceph_tpu_torch.obs import cuda_accounting, executables, spans

    assert "balancer/csrc/upmap_loop.cu" in build.SOURCES
    rec = executables.record("upmap_loop")
    assert rec.source == "balancer/csrc/upmap_loop.cu"
    assert upmap.upmap_loop_cuda.record is rec
    assert upmap.upmap_loop_cuda.launches == rec.launches
    keys = {"upmap_loop_launches", "upmap_loop_launch_seconds",
            "upmap_loop_build_seconds"}
    assert keys <= set(cuda_accounting.ADDED["balancer"])
    assert keys <= set(obs.group_view("balancer"))
    assert spans.known("balancer.device_loop")
    # a launch's first-round bytes: 10 PGs of 3 (rows, mask, one word of
    # change bits zeroed and read), 4 OSDs, 1 pool, the output
    nbytes, ops = rec.work((10, 3, 4, 1, 2, 8))
    assert nbytes == 10 * 13 + 8 + 4 * 5 + 4 * 24 \
        + 8 * (4 + 8 * 7 + 4) and ops == 0


def write_corpus() -> None:
    """Rewrite tests/data/upmap_loop_corpus.json from the JAX package:
    each device_loop case's map, its calc_pg_upmaps calls and the digest
    of each JAX plan's outputs (`outputs_digest`)."""
    import ceph_tpu.osd.types as jax_types

    jax_types.PgId.ps = property(lambda pg: pg.seed)  # as pg_ps_alias
    plans = []
    account = jax_upmap._loop_account

    def spy(*key):
        acct = account(*key)

        def call(*ops):
            out = acct(*ops)
            o = [np.asarray(x) for x in out[:9]]
            n = int(o[5])
            plans.append(tuple(x[:n] for x in o[:5]) + (int(o[6]),
                                                        int(o[7]), o[8]))
            return out
        return call

    jax_upmap._loop_account = spy
    out = {"about": "the JAX package's device_loop plans (_loop_account) "
                    "on the device_loop cases of "
                    "tests/test_torch_balancer.py: each case's map "
                    "(osdmap_from_reference's format), its calc_pg_upmaps "
                    "calls and the digest of each plan's outputs; written "
                    "by `python tests/test_torch_upmap_kernel_host.py`",
           "cases": {}}
    for name in LOOP_CASES:
        make, rounds = CASES[name]
        m = make()
        entry = {"map": osdmap_dict(m), "calls": []}
        for kw, seed, then in rounds:
            del plans[:]
            run_jax(m, rng=np.random.default_rng(seed), **kw)
            (plan,) = plans
            entry["calls"].append({
                "kwargs": kw, "rng": seed,
                "then": next(k for k, v in THEN.items() if v is then),
                "digest": outputs_digest(plan), "changes": len(plan[0]),
                "rounds": plan[6]})
            if then is not None:
                then(m)
        out["cases"][name] = entry
        print(name, [c["digest"] for c in entry["calls"]], flush=True)
    LOOP_CORPUS.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    write_corpus()
