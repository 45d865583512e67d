"""The diagnostics kernel's body at every group size G (1, 2, 4, ..., 32
lanes a seed) in both of its modes, built for the host with g++
(`__host__`/`__device__` defined empty), held to the plain version, the
JAX package and the host oracle.

On the card `crush/csrc/crush_rule_diag.cu` runs the rule walk of
`crush/csrc/crush_rule.cuh` (built with CRUSH_RULE_DIAG) in one of two
modes: planes (the rows, the tries and steps planes and the tallies, as
`crush_rule_plain(..., diag=True)` gives them) or summary (no planes: each
seed hands its tries lanes, once each and with their final values, to a
`Summary` sink that books the histogram over [0, bound] and the coll /
rej / skip / bad / exhausted sums, `mapper.diag_summary_plain`'s layout).
A launch smaller than the card maps each seed with a group of G lanes
whose straw2 draws are split; the host build runs the G partials of a
draw in one thread in the butterfly's order (as
tests/test_torch_pipeline_group_host.py does for the pipeline), so these
tests hold the walk at every G.  The block's reduction (warp shuffles,
shared memory, 64-bit atomics) runs only on the card: `chip_smoke.py`
(diag_vs_plain) holds it there.

- planes at every G == the plain planes on the `diag_cases` of
  tests/data/explain_corpus.json and the placement corpus maps (their
  placement seeds computed in the body, `osd/csrc/placement_seed.cuh`),
  and == the JAX package's stored planes on every lane its window
  resolved;
- summary at every G == the plain summary on the same cases at the
  cases' bound and at bounds 0, 1 and 2 (values above the bound dropped);
  == the stored `diagnose` summaries (JAX where exact, else the host
  oracle's) with and without a ClusterState; == the host oracle's
  histogram and tallies;
- three mutated bodies fail: one that books the indep rounds lane every
  round (before its value is final), one whose histogram clamps values
  above the bound, one whose exhausted count takes every lane left at -1
  (the leaf-call lanes too).

Skips, with the reason, where g++ is missing.
"""

import ctypes
import functools
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
sys.path.insert(0, str(ROOT / "tests"))

from ceph_tpu_torch.core.intmath import pg_mask_for  # noqa: E402
from ceph_tpu_torch.core.lntable import LL_TBL, RH_LH_TBL  # noqa: E402
from ceph_tpu_torch.crush import mapper, soa  # noqa: E402
from ceph_tpu_torch.osd.carry import osdmap_from_reference  # noqa: E402
from ceph_tpu_torch.osd.pipeline import PoolMapper  # noqa: E402
from ceph_tpu_torch.osd.state import ClusterState  # noqa: E402
from test_torch_diag import (  # noqa: E402
    NAMES,
    PLANES,
    corpus,
    port_inputs,
    port_map,
    stored,
)

PACKAGE = ROOT / "ceph_tpu_torch"
CSRC = PACKAGE / "crush" / "csrc"
PLACEMENT = ROOT / "tests" / "data" / "placement_corpus.json"
GROUPS = mapper.GROUPS
assert GROUPS == (1, 2, 4, 8, 16, 32)
SMALL_BOUNDS = (0, 1, 2)

# the body over a batch of seeds, as the kernel runs each seed: the seed
# as given, or the placement seed of a PG computed from ps[i] (crush_rule_
# diag.cu seed_at); planes or summary at group G
SHIM = r"""
#define CRUSH_RULE_DIAG
#include "crush_rule.cuh"
#include "placement_seed.cuh"

struct Seeds {
    const uint32_t* xs;
    const int64_t* ps;
    uint32_t pool_id, pgp_num, pgp_mask;
    int32_t hashpspool;
};

static uint32_t seed_at(const Seeds& s, long long i) {
    if (s.xs) return s.xs[i];
    return placement::placement_seed((uint32_t)s.ps[i], s.pgp_num,
                                     s.pgp_mask, s.hashpspool, s.pool_id);
}

template <int G>
static void planes(const crush_rule::Map& m, const crush_rule::Rule& rule,
                   const Seeds& seeds, long long n, int32_t* out,
                   const int32_t* plan, int n_lanes, int n_steps_rows,
                   int32_t* tries, int32_t* steps, int32_t* tally) {
    for (long long i = 0; i < n; i++) {
        crush_rule::Diag d{plan, tries + i * n_lanes,
                           steps + i * n_steps_rows * rule.result_max,
                           {0, 0, 0}};
        crush_rule::map_seed_diag<G>(m, rule, seed_at(seeds, i),
                                     out + i * rule.result_max, d, n_lanes,
                                     n_steps_rows, tally + 4 * i);
    }
}

template <int G>
static void summary(const crush_rule::Map& m, const crush_rule::Rule& rule,
                    const Seeds& seeds, long long n, const int32_t* plan,
                    int n_retry, int bound, unsigned long long* out) {
    using crush_rule::N_SUMS;
    uint32_t count[crush_rule::N_COUNTS] = {};
    crush_rule::Summary s{plan, out, count, 1, bound, n_retry, true};
    for (long long i = 0; i < n; i++)
        crush_rule::summarize_seed<G>(m, rule, seed_at(seeds, i), s);
    for (int k = 0; k < N_SUMS; k++) out[bound + 1 + k] += count[k];
    for (int v = 0; v < crush_rule::LOW_BINS && v <= bound; v++)
        out[v] += count[N_SUMS + v];
}

#define DISPATCH(fn, ...)                          \
    switch (group) {                               \
    case 1: fn<1>(__VA_ARGS__); break;             \
    case 2: fn<2>(__VA_ARGS__); break;             \
    case 4: fn<4>(__VA_ARGS__); break;             \
    case 8: fn<8>(__VA_ARGS__); break;             \
    case 16: fn<16>(__VA_ARGS__); break;           \
    case 32: fn<32>(__VA_ARGS__); break;           \
    default: return -1;                            \
    }

extern "C" int diag_host(
    int group, const int32_t* headers, const int32_t* records,
    const int32_t* items, const uint32_t* nodes, const uint32_t* weight,
    const int64_t* rh_lh, const int64_t* ll, const int32_t* steps,
    int n_buckets, int positions, int max_devices, int max_depth,
    int weight_len, int n_steps, int result_max, int choose_total_tries,
    int chooseleaf_descend_once, int chooseleaf_vary_r,
    int chooseleaf_stable, const Seeds* seeds, long long n,
    const int32_t* plan, int n_lanes, int n_steps_rows, int n_retry,
    int bound, int32_t* out, int32_t* tries, int32_t* step_rows,
    int32_t* tally, unsigned long long* sums) {
    using crush_rule::Record;
    const Record* recs = reinterpret_cast<const Record*>(records);
    crush_rule::Map m{headers, recs, recs, items, weight, rh_lh, ll, 0,
                      n_buckets, positions, max_devices, max_depth,
                      weight_len, nodes};
    crush_rule::Rule rule{steps, n_steps, result_max, choose_total_tries,
                          chooseleaf_descend_once, chooseleaf_vary_r,
                          chooseleaf_stable};
    if (sums) {
        DISPATCH(summary, m, rule, *seeds, n, plan, n_retry, bound, sums)
    } else {
        DISPATCH(planes, m, rule, *seeds, n, out, plan, n_lanes,
                 n_steps_rows, tries, step_rows, tally)
    }
    return 0;
}
"""


class _Seeds(ctypes.Structure):
    _fields_ = ([("xs", ctypes.c_void_p), ("ps", ctypes.c_void_p)]
                + [(k, ctypes.c_uint32) for k in ("pool_id", "pgp_num",
                                                  "pgp_mask")]
                + [("hashpspool", ctypes.c_int32)])


# the mutants: (what the body says, what the mutant says), each line once,
# and whether the launch counts every lane as a retry lane
ROUNDS_FINAL = "    DIAG(d->lane(lane0, rounds, true);)\n"
MUTANTS = {
    # the indep rounds lane booked every round, before its value is final
    "rounds_booked_early": ([
        (ROUNDS_FINAL, ""),
        ("        DIAG(rounds++;)",
         "        DIAG(rounds++; d->lane(lane0, rounds, true);)")], False),
    # values above the bound clamped into its last bin
    "histogram_clamps": ([
        ("if (v >= 0 && v <= bound) {",
         "if (v >= 0) {\n            if (v > bound) v = bound;")], False),
    # every lane left at -1 counted exhausted, the leaf-call lanes too
    "exhausted_counts_leaf_calls": ([
        ("if (v >= 0 && retry) add(SUM_EXHAUSTED",
         "if (v >= 0) add(SUM_EXHAUSTED")], True),
}


def _build(out: Path, include: Path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel body cannot be built for "
                    "the host")
    out.mkdir(parents=True, exist_ok=True)
    shim = out / "shim.cpp"
    shim.write_text(SHIM)
    lib = out / "libshim.so"
    subprocess.run(
        [gxx, "-O1", "-shared", "-fPIC", "-std=c++17", "-Wall", "-Werror",
         "-D__host__=", "-D__device__=", f"-I{include}",
         f"-I{PACKAGE / 'osd' / 'csrc'}", "-o", str(lib), str(shim)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.diag_host.argtypes = ([i] + [p] * 8 + [i] * 11
                             + [p, ctypes.c_longlong, p] + [i] * 4
                             + [p] * 5)
    so.diag_host.restype = i
    return so


@pytest.fixture(scope="module")
def body(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("diag_group_host"), CSRC)


@pytest.fixture(scope="module", params=sorted(MUTANTS))
def mutant(request, tmp_path_factory):
    """(name, the shim over a copy of crush_rule.cuh with that mutation)."""
    out = tmp_path_factory.mktemp(f"diag_mutant_{request.param}")
    text = (CSRC / "crush_rule.cuh").read_text()
    edits, every_lane = MUTANTS[request.param]
    for a, b in edits:
        assert text.count(a) == 1, a
        text = text.replace(a, b)
    (out / "crush_rule.cuh").write_text(text)
    return request.param, _build(out, out), every_lane


def run(so, group: int, A, prog, seeds: _Seeds, n: int,
        weight: np.ndarray, bound: int | None = None,
        n_retry: int | None = None):
    """The body over n seeds at `group`: (rows, planes), or with a bound
    the summary (int64 [bound + 6]); n_retry, the retry lanes a seed,
    is the plan's unless given."""
    pk = soa.pack_buckets(A)
    headers = np.ascontiguousarray(pk.headers.view(np.int32))
    records = np.ascontiguousarray(pk.records.view(np.int32))
    items = np.ascontiguousarray(pk.items, np.int32)
    nodes = np.ascontiguousarray(pk.nodes if len(pk.nodes) else [0],
                                 np.uint32)
    weight = np.ascontiguousarray(weight if len(weight) else [0], np.uint32)
    rmax = prog.result_max
    plan = np.ascontiguousarray(prog.diag_plan, np.int32)
    out = np.empty((n, rmax), np.int32)
    tries = np.empty((n, prog.diag_lanes), np.int32)
    steps = np.empty((n, prog.diag_steps, rmax), np.int32)
    tally = np.empty((n, 4), np.int32)
    sums = None if bound is None else np.zeros(bound + 6, np.uint64)
    rc = so.diag_host(
        group, headers.ctypes.data, records.ctypes.data, items.ctypes.data,
        nodes.ctypes.data, weight.ctypes.data, RH_LH_TBL.ctypes.data,
        LL_TBL.ctypes.data, prog.steps.ctypes.data, A.n_buckets,
        A.positions, A.max_devices, A.max_depth, len(weight),
        len(prog.steps), rmax, prog.choose_total_tries,
        prog.chooseleaf_descend_once, prog.chooseleaf_vary_r,
        prog.chooseleaf_stable, ctypes.addressof(seeds), n,
        plan.ctypes.data, prog.diag_lanes, prog.diag_steps,
        int(prog.diag_retry_lanes.sum()) if n_retry is None else n_retry,
        bound or 0, out.ctypes.data,
        tries.ctypes.data, steps.ctypes.data, tally.ctypes.data,
        None if sums is None else sums.ctypes.data)
    assert rc == 0
    if sums is not None:
        return sums.astype(np.int64)
    return out, {"tries": tries, "coll": tally[:, 0], "rej": tally[:, 1],
                 "skip": tally[:, 2], "bad": tally[:, 3], "steps": steps}


# -- the cases ------------------------------------------------------------------

def _placement_entries() -> dict:
    return {e["name"]: e for e in
            json.loads(PLACEMENT.read_text())["entries"]}


CASES = [f"diag_{n}" for n in NAMES] + [
    f"placement_{n}" for n in sorted(_placement_entries())]


@functools.cache
def case(name: str):
    """(arrays, program, the body's seeds and their count, reweights u32,
    the plain version's seeds on the CPU, the keep-alive arrays)."""
    kind, key = name.split("_", 1)
    if kind == "diag":
        A, prog, xs, w = port_inputs(stored(key))
        x = np.ascontiguousarray(xs.numpy().astype(np.uint32))
        seeds = _Seeds(xs=x.ctypes.data)
        return A, prog, seeds, len(x), w.numpy().astype(np.uint32), xs, x
    e = _placement_entries()[key]
    pm = PoolMapper(osdmap_from_reference(e["map"]), e["pool_id"],
                    device="cpu")
    ps = torch.arange(pm.spec.pg_num)
    keep = np.ascontiguousarray(ps.numpy())
    spec = pm.spec
    seeds = _Seeds(ps=keep.ctypes.data, pool_id=spec.pool_id & 0xFFFFFFFF,
                   pgp_num=spec.pgp_num, pgp_mask=pg_mask_for(spec.pgp_num),
                   hashpspool=spec.hashpspool)
    w = pm.rule_weights().numpy().astype(np.uint32)
    return (pm.arrays, pm.prog, seeds, len(keep), w, pm.placement_seeds(ps),
            keep)


@functools.cache
def plain(name: str):
    """The plain version's rows and planes of a case (torch, CPU)."""
    A, prog, _, _, w, x, _ = case(name)
    rows, _, planes = mapper.crush_rule_plain(
        soa.to_device(A, "cpu"), prog, x, torch.from_numpy(w.astype(
            np.int64)), diag=True)
    return rows, planes


def plain_summary(name: str, bound: int) -> np.ndarray:
    _, prog, *_ = case(name)
    return mapper.summary_of_planes(prog, plain(name)[1], bound).numpy()


def bounds_of(prog) -> list[int]:
    return [*SMALL_BOUNDS, prog.diag_tries_bound]


# -- planes -----------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("group", GROUPS)
def test_planes_equal_plain(body, group, name):
    A, prog, seeds, n, w, *_ = case(name)
    rows, planes = run(body, group, A, prog, seeds, n, w)
    want_rows, want = plain(name)
    np.testing.assert_array_equal(rows, want_rows.numpy())
    for k in PLANES:
        np.testing.assert_array_equal(planes[k], want[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if stored(n)["jax"]["exact"]])
@pytest.mark.parametrize("group", (1, 32))
def test_planes_equal_jax(body, group, name):
    """Lane for lane on every lane the JAX window resolved."""
    A, prog, seeds, n, w, *_ = case(f"diag_{name}")
    _, got = run(body, group, A, prog, seeds, n, w)
    jax = stored(name)["jax"]
    ok = ~np.asarray(jax["flagged"], bool)
    for k in PLANES:
        np.testing.assert_array_equal(got[k][ok], np.asarray(jax[k])[ok],
                                      err_msg=k)


# -- summary ------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("group", GROUPS)
def test_summary_equals_plain(body, group, name):
    A, prog, seeds, n, w, *_ = case(name)
    for bound in bounds_of(prog):
        got = run(body, group, A, prog, seeds, n, w, bound)
        np.testing.assert_array_equal(got, plain_summary(name, bound),
                                      err_msg=f"bound {bound}")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("group", (1, 8, 32))
def test_summary_equals_host_oracle(body, group, name):
    """The histogram at the reference's bound is the host oracle's
    increments, the sums its tallies."""
    A, prog, seeds, n, w, *_ = case(f"diag_{name}")
    host = stored(name)["host"]
    bound = prog.diag_tries_bound
    got = run(body, group, A, prog, seeds, n, w, bound)
    hist = np.bincount([v for t in host["tries"] for v in t],
                       minlength=bound + 1)
    np.testing.assert_array_equal(got[:bound + 1], hist)
    assert got[bound + 1:bound + 5].tolist() == [
        sum(host[k]) for k in ("coll", "rej", "skip", "bad")]


def _summary_dict(pm: PoolMapper, got: np.ndarray, bound: int) -> dict:
    """PoolMapper.diagnose's summary from a body's [bound + 6] counts."""
    coll, rej, skip, bad, exhausted = got[bound + 1:].tolist()
    return {"pgs": pm.spec.pg_num, "pool_id": pm.pool_id,
            "tries_histogram": got[:bound + 1].tolist(),
            "tries_bound": bound, "diag_exact": True,
            "diag_lanes": pm.prog.diag_lanes, "collisions": coll,
            "rejections": rej, "skips": skip, "bad_mappings": bad,
            "retry_exhausted": exhausted, "unresolved": 0}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("name", ["hier_256", "two_hosts", "vary_r_off"])
@pytest.mark.parametrize("group", (1, 4, 32))
def test_summary_equals_stored_diagnose(body, group, name, with_state):
    """The body's summary over every PG of the pool, the placement seed
    computed in the body, is the stored `diagnose` summary: the JAX
    package's where that is exact with 0 unresolved, else the host
    oracle's."""
    e = corpus()["diagnose"][name]
    jax = e["jax"]
    want = jax if (jax["diag_exact"] and jax["unresolved"] == 0) \
        else e["host"]
    m = port_map(name)
    pm = (PoolMapper(m, 0, state=ClusterState(m, device="cpu"))
          if with_state else PoolMapper(m, 0, device="cpu", overlays=False))
    spec = pm.spec
    ps = np.arange(spec.pg_num, dtype=np.int64)
    seeds = _Seeds(ps=ps.ctypes.data, pool_id=spec.pool_id & 0xFFFFFFFF,
                   pgp_num=spec.pgp_num, pgp_mask=pg_mask_for(spec.pgp_num),
                   hashpspool=spec.hashpspool)
    bound = want["tries_bound"]
    got = run(body, group, pm.arrays, pm.prog, seeds, spec.pg_num,
              pm.rule_weights().numpy().astype(np.uint32), bound)
    assert _summary_dict(pm, got, bound) == want
    assert _summary_dict(pm, got, bound) == pm.diagnose(record=False)


# -- the mutants fail -----------------------------------------------------------------

def test_mutants_fail(mutant):
    """Each mutated body gives a summary other than the plain one on some
    case (the chooseleaf indep cases hold leaf-call lanes and rounds past
    the bound), while its planes stay the plain ones where the mutation
    touches the summary alone."""
    what, so, every_lane = mutant
    differs = []
    for name in CASES:
        A, prog, seeds, n, w, *_ = case(name)
        for bound in bounds_of(prog):
            got = run(so, 1, A, prog, seeds, n, w, bound,
                      prog.diag_lanes if every_lane else None)
            if not np.array_equal(got, plain_summary(name, bound)):
                differs.append((name, bound))
    assert differs, f"the mutant {what} passed every case"
    indep = "diag_chooseleaf_indep"
    A, prog, seeds, n, w, *_ = case(indep)
    rows, planes = run(so, 1, A, prog, seeds, n, w)
    for k in PLANES:
        np.testing.assert_array_equal(planes[k], plain(indep)[1][k].numpy(),
                                      err_msg=f"{what}: {k}")


# -- the wrapper ------------------------------------------------------------------------

def test_summary_wrapper_takes_the_card_only():
    """The summary launch takes tensors on the card only, and a range of
    PG seeds only with the pool's seed inputs; the CPU reaches the plain
    version through diag_summary, never as a fallback."""
    A, prog, xs, w = port_inputs(stored("flat_firstn"))
    T = soa.to_device(A, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        mapper.crush_rule_diag_summary_cuda(
            T, prog, mapper.u32_bits(xs), mapper.kernel_weights(w), 3)
    with pytest.raises(ValueError, match="pool"):
        mapper.crush_rule_diag_summary_cuda(
            T, prog, range(4), mapper.kernel_weights(w), 3)
    got = mapper.diag_summary(T, prog, xs, w, prog.diag_tries_bound)
    np.testing.assert_array_equal(
        got.numpy(), plain_summary("diag_flat_firstn",
                                   prog.diag_tries_bound))
