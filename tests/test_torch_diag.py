"""The rule kernel's diagnostics variant held against the JAX package and
the host oracle.

The diagnostics (`crush/csrc/crush_rule_diag.cu`: crush_rule.cuh built
with CRUSH_RULE_DIAG) return, beside each seed's row, the retry count of
every placement (`tries`), the collision / out-of-weight / skip tallies
of the firstn draws, a bad-mapping flag and the work vector after each
choose step.  Here:

- the body, built for the host with g++, equals the plain version
  (`crush_rule_plain(..., diag=True)`) plane for plane on every case;
- the plain version equals the JAX package's `explain.diag_batch` planes
  lane for lane wherever the JAX plan is diag-exact and the lane is not
  flagged unresolved;
- the plain version equals the host oracle (`ceph_tpu`'s mapper_ref) on
  every case, the JAX-inexact ones included: per seed, the multiset of
  retry counts equals the histogram increments of the walk, the tallies
  equal its `draw` events, the bad flag its result and the steps plane
  its step log;
- `PoolMapper.diagnose` equals the JAX package's summary where that is
  diag-exact with 0 unresolved, and a mapper_ref-derived one elsewhere;
- `crushtool --test --show-choose-tries` prints the same on the torch and
  ref backends as the JAX tester;
- `obs.placement` and the mgr's post-execute accounting.

The JAX package's outputs are stored in tests/data/explain_corpus.json
("diag_cases", "diagnose", "choose_tries"), written by
`python tests/test_torch_explain.py`; `test_stored_*` hold the JAX
package to what is stored.  The cases are tests/test_torch_crush_mapper.py's
CASES and two more that the JAX plan cannot make exact.
"""

import contextlib
import ctypes
import functools
import io
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

from ceph_tpu.crush.types import ChooseArgs  # noqa: E402
from ceph_tpu_torch.core.lntable import LL_TBL, RH_LH_TBL  # noqa: E402
from ceph_tpu_torch.crush import mapper, soa  # noqa: E402
from ceph_tpu_torch.osd.carry import crush_from_reference  # noqa: E402
from test_torch_crush_mapper import (  # noqa: E402
    CA_KEY,
    CASES,
    build_case,
    crush_dict,
    dev_weights,
    xs_for,
)
from util_maps import HOST, build_tree  # noqa: E402

CORPUS = ROOT / "tests" / "data" / "explain_corpus.json"
CSRC = ROOT / "ceph_tpu_torch" / "crush" / "csrc"
PLANES = ("tries", "coll", "rej", "skip", "bad", "steps")


# -- the cases ----------------------------------------------------------------

def _two_hosts_size3(rng):
    """2 hosts for 3 replicas: the JAX window flags every lane."""
    m, root = build_tree(rng, n_host=2, osd_per_host=2)
    return m, m.make_replicated_rule(root, HOST), [0x10000] * 4, 3


def _choose_args_2pos(rng):
    """Two weight-set positions: the JAX plan takes its loop path."""
    m, root = build_tree(rng, n_host=4, osd_per_host=4)
    r = m.make_replicated_rule(root, HOST)
    ca = ChooseArgs()
    for bid, b in m.buckets.items():
        ca.weight_sets[bid] = [
            [int(w) for w in rng.integers(1, 4 * 0x10000, b.size)]
            for _ in range(2)]
    m.choose_args[CA_KEY] = ca
    return m, r, [0x10000] * 16, 3, 65, CA_KEY


EXTRA = {"two_hosts_size3": _two_hosts_size3,
         "choose_args_2pos": _choose_args_2pos}
NAMES = sorted([*CASES, *EXTRA])


def diag_build_case(name: str):
    """(m, ruleno, weights, result_max, n_x, choose_args key) of a case
    (a ceph_tpu map), made from a seed."""
    if name in CASES:
        return build_case(name)
    got = EXTRA[name](np.random.default_rng(0xD1A6))
    m, ruleno, weights, rmax = got[:4]
    n_x = got[4] if len(got) > 4 else 65
    return m, ruleno, weights, rmax, n_x, got[5] if len(got) > 5 else None


# -- the JAX package's planes and the host oracle's accounting ----------------

def host_accounting(m, ruleno, xs, rmax, weights, choose_args) -> dict:
    """Per seed, from ceph_tpu's mapper_ref: the retry counts the walk
    books (sorted), the collisions / out-of-weight rejections / skips of
    its firstn draws (from the recorder's `draw` events), the bad flag
    (fewer than rmax items placed) and the step log."""
    from ceph_tpu.crush import explain as jexp
    from ceph_tpu.crush import mapper_ref as jref

    out = {k: [] for k in ("tries", "coll", "rej", "skip", "bad", "steps")}
    for x in xs:
        bound = m.tunables.choose_total_tries + 1
        m.choose_tries_histogram = [0] * bound
        rec = jexp.ExplainRecorder(detail=False)
        res = jref.do_rule(m, ruleno, int(x), rmax, list(weights),
                           choose_args, collect_choose_tries=True,
                           recorder=rec)
        out["tries"].append([v for v, c in
                             enumerate(m.choose_tries_histogram)
                             for _ in range(c)])
        coll = rej = skip = 0
        firstn = False
        for ev in rec.events:
            if ev["ev"] == "choose":
                firstn = ev["firstn"]
            elif ev["ev"] == "draw" and firstn:
                coll += ev["status"] == "collide"
                rej += ev["status"] == "out"
                skip += ev["status"].startswith("skip")
        out["coll"].append(coll)
        out["rej"].append(rej)
        out["skip"].append(skip)
        out["bad"].append(int(sum(v != 0x7FFFFFFF for v in res) < rmax))
        out["steps"].append(rec.steps)
    m.choose_tries_histogram = None
    return out


def jax_planes(m, ruleno, xs, rmax, weights, choose_args) -> dict:
    """ceph_tpu's explain.diag_batch planes, its unresolved flags and
    diag_exact."""
    from ceph_tpu.crush import explain as jexp
    from ceph_tpu.crush.soa import build_arrays

    run = jexp.diag_batch(build_arrays(m, choose_args), ruleno, rmax)
    _, flg, dg = run(xs, np.asarray(weights, np.uint32))
    out = {k: np.asarray(v).tolist() for k, v in dg.items()}
    out["flagged"] = np.asarray(flg).tolist()
    out["exact"] = bool(run.diag_exact)
    return out


def diag_case_entry(name: str) -> dict:
    """A case's inputs (as legacy_rule_cases.json holds them, so
    chip_smoke.py can run them), the JAX package's planes and the host
    oracle's accounting."""
    m, ruleno, weights, rmax, n_x, ca_key = diag_build_case(name)
    xs = xs_for(n_x)
    w = dev_weights(m, weights)
    ca = m.choose_args.get(ca_key)
    return {
        "name": name, "map": crush_dict(m), "ruleno": ruleno,
        "result_max": rmax, "xs": xs.tolist(), "weights": w.tolist(),
        "choose_args": ca_key,
        "jax": jax_planes(m, ruleno, xs, rmax, w, ca),
        "host": host_accounting(m, ruleno, xs, rmax, w, ca),
    }


@functools.cache
def corpus() -> dict:
    return json.loads(CORPUS.read_text())


@functools.cache
def stored(name: str) -> dict:
    return {e["name"]: e for e in corpus()["diag_cases"]}[name]


def port_inputs(entry: dict):
    """(arrays, program, seeds, weights) of a stored case, in the port."""
    cm = crush_from_reference(entry["map"])
    A = soa.build_arrays(cm, cm.choose_args.get(entry["choose_args"]))
    prog = mapper.compile_rule(A, entry["ruleno"], entry["result_max"])
    return (A, prog, torch.tensor(entry["xs"], dtype=torch.long),
            torch.tensor(entry["weights"], dtype=torch.long))


@functools.cache
def plain(name: str):
    """The plain version's rows and planes of a case (numpy)."""
    A, prog, xs, w = port_inputs(stored(name))
    rows, _, planes = mapper.crush_rule_plain(soa.to_device(A, "cpu"), prog,
                                              xs, w, diag=True)
    return rows.numpy(), {k: v.numpy() for k, v in planes.items()}


# -- the body, built for the host ---------------------------------------------

SHIM = r"""
#define CRUSH_RULE_DIAG
#include "crush_rule.cuh"

extern "C" void crush_rule_diag_host(
    const int32_t* headers, const int32_t* records, const int32_t* items,
    const uint32_t* nodes, const uint32_t* weight, const int64_t* rh_lh,
    const int64_t* ll, const int32_t* steps, int n_buckets, int positions,
    int max_devices, int max_depth, int weight_len, int n_steps,
    int result_max, int choose_total_tries, int chooseleaf_descend_once,
    int chooseleaf_vary_r, int chooseleaf_stable, const uint32_t* xs,
    long long n, int32_t* out, const int32_t* plan, int n_lanes,
    int n_steps_rows, int32_t* tries, int32_t* step_rows, int32_t* tally) {
    using crush_rule::Record;
    const Record* recs = reinterpret_cast<const Record*>(records);
    crush_rule::Map m{headers, recs, recs, items, weight, rh_lh, ll, 0,
                      n_buckets, positions, max_devices, max_depth,
                      weight_len, nodes};
    crush_rule::Rule rule{steps, n_steps, result_max, choose_total_tries,
                          chooseleaf_descend_once, chooseleaf_vary_r,
                          chooseleaf_stable};
    for (long long i = 0; i < n; i++) {
        crush_rule::Diag d{plan, tries + i * n_lanes,
                           step_rows + i * n_steps_rows * result_max,
                           {0, 0, 0}};
        crush_rule::map_seed_diag(m, rule, xs[i], out + i * result_max, d,
                                  n_lanes, n_steps_rows, tally + 4 * i);
    }
}
"""


@pytest.fixture(scope="module")
def body(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel body cannot be built for "
                    "the host")
    out = tmp_path_factory.mktemp("crush_rule_diag_host")
    shim = out / "shim.cpp"
    shim.write_text(SHIM)
    lib = out / "libcrush_rule_diag_host.so"
    subprocess.run(
        [gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-D__host__=",
         "-D__device__=", f"-I{CSRC}", "-o", str(lib), str(shim)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.crush_rule_diag_host.argtypes = (
        [p] * 8 + [i] * 11 + [p, ctypes.c_longlong, p, p, i, i, p, p, p])
    so.crush_rule_diag_host.restype = None
    return so


def run_body(so, A, prog, xs: np.ndarray, weight: np.ndarray):
    """The host-built diagnostics body over seeds xs: (rows, planes)."""
    pk = soa.pack_buckets(A)
    headers = np.ascontiguousarray(pk.headers.view(np.int32))
    records = np.ascontiguousarray(pk.records.view(np.int32))
    items = np.ascontiguousarray(pk.items, np.int32)
    nodes = np.ascontiguousarray(pk.nodes if len(pk.nodes) else [0],
                                 np.uint32)
    xs = np.ascontiguousarray(xs, np.uint32)
    weight = np.ascontiguousarray(weight if len(weight) else [0], np.uint32)
    n, rmax = len(xs), prog.result_max
    out = np.empty((n, rmax), np.int32)
    tries = np.empty((n, prog.diag_lanes), np.int32)
    steps = np.empty((n, prog.diag_steps, rmax), np.int32)
    tally = np.empty((n, 4), np.int32)
    plan = np.ascontiguousarray(prog.diag_plan, np.int32)
    so.crush_rule_diag_host(
        headers.ctypes.data, records.ctypes.data, items.ctypes.data,
        nodes.ctypes.data, weight.ctypes.data, RH_LH_TBL.ctypes.data,
        LL_TBL.ctypes.data, prog.steps.ctypes.data, A.n_buckets,
        A.positions, A.max_devices, A.max_depth, len(weight),
        len(prog.steps), rmax, prog.choose_total_tries,
        prog.chooseleaf_descend_once, prog.chooseleaf_vary_r,
        prog.chooseleaf_stable, xs.ctypes.data, n, out.ctypes.data,
        plan.ctypes.data, prog.diag_lanes, prog.diag_steps,
        tries.ctypes.data, steps.ctypes.data, tally.ctypes.data,
    )
    return out, {"tries": tries, "coll": tally[:, 0], "rej": tally[:, 1],
                 "skip": tally[:, 2], "bad": tally[:, 3], "steps": steps}


# -- the stored outputs are the JAX package's ---------------------------------

@pytest.mark.parametrize("name", ["chooseleaf_firstn", "chooseleaf_indep",
                                  "two_hosts_size3"])
def test_stored_planes_are_the_jax_packages(name):
    m, ruleno, weights, rmax, n_x, ca_key = diag_build_case(name)
    got = jax_planes(m, ruleno, xs_for(n_x), rmax, dev_weights(m, weights),
                     m.choose_args.get(ca_key))
    assert got == stored(name)["jax"]


@pytest.mark.parametrize("name", NAMES)
def test_stored_accounting_is_the_host_oracles(name):
    m, ruleno, weights, rmax, n_x, ca_key = diag_build_case(name)
    got = host_accounting(m, ruleno, xs_for(n_x), rmax,
                          dev_weights(m, weights), m.choose_args.get(ca_key))
    assert json.loads(json.dumps(got)) == stored(name)["host"]


# -- body, plain version, JAX planes, host oracle -------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_body_equals_plain(body, name):
    entry = stored(name)
    A, prog, xs, w = port_inputs(entry)
    rows, planes = run_body(body, A, prog, xs.numpy().astype(np.uint32),
                            w.numpy().astype(np.uint32))
    want_rows, want = plain(name)
    np.testing.assert_array_equal(rows, want_rows)
    for k in PLANES:
        np.testing.assert_array_equal(planes[k], want[k], err_msg=k)


def _jax_exact(name: str) -> bool:
    try:
        return stored(name)["jax"]["exact"]
    except (FileNotFoundError, KeyError):  # the corpus is being written
        return False


@pytest.mark.parametrize("name", [n for n in NAMES if _jax_exact(n)])
def test_plain_equals_jax_planes(name):
    """Lane for lane, on every lane the JAX window resolved."""
    jax = stored(name)["jax"]
    ok = ~np.asarray(jax["flagged"], bool)
    _, got = plain(name)
    for k in PLANES:
        want = np.asarray(jax[k])
        assert want.shape == got[k].shape, k
        np.testing.assert_array_equal(got[k][ok], want[ok], err_msg=k)


def test_jax_inexact_cases_are_covered():
    """The cases the JAX plan leaves inexact or flags (held to the host
    oracle below): loop-path tunables, leafy indep, two weight-set
    positions, 2 hosts for 3 replicas."""
    inexact = {n for n in NAMES if not _jax_exact(n)}
    flagged = {n for n in NAMES if all(stored(n)["jax"]["flagged"])}
    assert {"vary_r_stable_off", "chooseleaf_indep",
            "choose_args_2pos"} <= inexact
    assert "two_hosts_size3" in flagged


@pytest.mark.parametrize("name", NAMES)
def test_plain_equals_host_oracle(name):
    entry = stored(name)
    host = entry["host"]
    rows, got = plain(name)
    bound = crush_from_reference(entry["map"]).tunables.choose_total_tries
    for b in range(len(entry["xs"])):
        t = got["tries"][b]
        assert sorted(t[(t >= 0) & (t <= bound)].tolist()) == \
            host["tries"][b], b
    for k in ("coll", "rej", "skip", "bad"):
        np.testing.assert_array_equal(got[k], host[k], err_msg=k)
    rmax = entry["result_max"]
    for b, steps in enumerate(host["steps"]):
        for s in range(got["steps"].shape[1]):
            h = steps[s] if s < len(steps) else []
            want = (h + [0x7FFFFFFF] * rmax)[:rmax]
            assert got["steps"][b, s].tolist() == want, (b, s)


def test_diag_rows_are_the_rule_rows():
    """The diagnostics' rows are map_rule's, on every case."""
    for name in NAMES:
        A, prog, xs, w = port_inputs(stored(name))
        T = soa.to_device(A, "cpu")
        rows, _ = mapper.diag_rule(T, prog, xs, w)
        assert torch.equal(rows, mapper.map_rule(T, prog, xs, w)), name


def test_diag_rule_on_no_seeds():
    A, prog, _, w = port_inputs(stored("flat_firstn"))
    rows, planes = mapper.diag_rule(soa.to_device(A, "cpu"), prog,
                                    torch.zeros(0, dtype=torch.long), w)
    assert rows.shape == (0, prog.result_max)
    assert planes["tries"].shape == (0, prog.diag_lanes)
    assert planes["steps"].shape == (0, prog.diag_steps, prog.result_max)


def test_diag_cuda_refuses_cpu_tensors():
    """The launch wrapper takes tensors on the card only; the plain
    version is reached through diag_rule on CPU tensors, never as a
    fallback."""
    A, prog, xs, w = port_inputs(stored("flat_firstn"))
    with pytest.raises(ValueError, match="CUDA"):
        mapper.crush_rule_diag_cuda(soa.to_device(A, "cpu"), prog,
                                    mapper.u32_bits(xs), mapper.u32_bits(w))


# -- PoolMapper.diagnose -------------------------------------------------------

def diagnose_maps():
    """name -> ceph_tpu OSDMap: TestPoolMapperDiagnose's maps of
    tests/test_explain.py."""
    from ceph_tpu.crush.types import Tunables
    from ceph_tpu.osd.osdmap import build_hierarchical
    from ceph_tpu.osd.types import PgPool

    return {
        "hier_256": build_hierarchical(8, 4, n_rack=1,
                                       pool=PgPool(pg_num=256, size=3)),
        "two_hosts": build_hierarchical(2, 2,
                                        pool=PgPool(pg_num=64, size=3)),
        "vary_r_off": build_hierarchical(
            4, 4, pool=PgPool(pg_num=64, size=3),
            tunables=Tunables(chooseleaf_vary_r=0, chooseleaf_stable=0)),
    }


def host_summary(m, pid: int) -> dict:
    """PoolMapper.diagnose's summary of pool `pid` of a ceph_tpu OSDMap,
    derived from ceph_tpu's host oracle over the pool's seeds (for
    chooseleaf firstn rules: every placement lane gets one increment, so
    the lanes left unplaced are the lanes less the increments)."""
    from ceph_tpu.crush import mapper_ref as jref
    from ceph_tpu.osd.types import PgId

    pool, crush = m.pools[pid], m.crush
    ruleno = jref.find_rule(crush, pool.crush_rule, int(pool.type),
                            pool.size)
    ops = [op for op, _, _ in crush.rules[ruleno].steps]
    assert ops.count(6) == 1 and len(ops) == 3  # take, chooseleaf firstn
    ca = crush.choose_args.get(pid, crush.choose_args.get(-1))
    xs = [pool.raw_pg_to_pps(PgId(pid, ps)) for ps in range(pool.pg_num)]
    acc = host_accounting(crush, ruleno, xs, pool.size,
                          list(m.osd_weight), ca)
    bound = min(crush.tunables.choose_total_tries, 63)
    hist = [0] * (bound + 1)
    for t in acc["tries"]:
        for v in t:
            hist[v] += 1
    lanes = 2 * pool.size
    return {"pgs": pool.pg_num, "pool_id": pid, "tries_histogram": hist,
            "tries_bound": bound, "diag_exact": True, "diag_lanes": lanes,
            "collisions": sum(acc["coll"]), "rejections": sum(acc["rej"]),
            "skips": sum(acc["skip"]), "bad_mappings": sum(acc["bad"]),
            "retry_exhausted": pool.pg_num * lanes - sum(hist),
            "unresolved": 0}


def diagnose_entry(m) -> dict:
    """The JAX package's PoolMapper.diagnose summary of pool 0, and the
    same summary derived from its host oracle over the pool's seeds."""
    from ceph_tpu.osd.pipeline_jax import PoolMapper as JaxPoolMapper

    s = JaxPoolMapper(m, 0, overlays=False).diagnose(record=False)
    return {"jax": s, "host": host_summary(m, 0)}


def port_map(name: str):
    from ceph_tpu_torch.osd.carry import osdmap_from_reference
    from test_torch_pipeline import osdmap_dict

    return osdmap_from_reference(osdmap_dict(diagnose_maps()[name]))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("name", ["hier_256", "two_hosts", "vary_r_off"])
def test_diagnose_summary(name, with_state):
    """Equal to the JAX package's summary where that is exact with 0
    unresolved, else to the host oracle's."""
    from ceph_tpu_torch.osd.pipeline import PoolMapper
    from ceph_tpu_torch.osd.state import ClusterState

    e = corpus()["diagnose"][name]
    jax = e["jax"]
    want = jax if (jax["diag_exact"] and jax["unresolved"] == 0) \
        else e["host"]
    m = port_map(name)
    pm = (PoolMapper(m, 0, state=ClusterState(m, device="cpu"))
          if with_state else PoolMapper(m, 0, device="cpu", overlays=False))
    assert pm.diagnose(record=False) == want
    assert name != "hier_256" or want is jax


def test_stored_diagnose_is_the_jax_packages():
    m = diagnose_maps()["hier_256"]
    assert json.loads(json.dumps(diagnose_entry(m))) == \
        corpus()["diagnose"]["hier_256"]


def test_diagnose_with_no_card_raises():
    from ceph_tpu_torch.osd.pipeline import PoolMapper

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoolMapper(port_map("two_hosts"), 0).diagnose()


# -- --show-choose-tries -------------------------------------------------------

def choose_tries_maps() -> dict:
    """TestDeviceHistogram's maps of tests/test_explain.py (ceph_tpu
    CrushMaps): name -> (map, tester kwargs)."""
    from util_maps import build_flat, ec_rule, replicated_rule

    hier, root = build_tree(np.random.default_rng(7), n_host=8,
                            osd_per_host=4)
    replicated_rule(hier, root, fd_type=1, numrep=3)
    flat, froot = build_flat(16, weights=[0x10000] * 16)
    replicated_rule(flat, froot, fd_type=0, numrep=3)
    ec, eroot = build_tree(np.random.default_rng(3), n_host=8,
                           osd_per_host=4)
    ec_rule(ec, eroot, fd_type=1, k_m=6)
    half = {i: 0 for i in range(0, 16, 2)}
    return {"hier": (hier, {"num_rep": 3}),
            "flat_weighted": (flat, {"num_rep": 3, "weights": half}),
            "ec_leafy_indep": (ec, {"num_rep": 6})}


def run_tester(pkg: str, m, kw: dict, backend: str) -> str:
    if pkg == "jax":
        from ceph_tpu.crush.tester import CrushTester, TesterConfig
    else:
        from ceph_tpu_torch.crush.tester import CrushTester, TesterConfig

        kw = dict(kw, device="cpu") if backend == "torch" else kw
    cfg = TesterConfig(min_x=0, max_x=127, show_choose_tries=True,
                       backend=backend, show_statistics=True, **kw)
    out = io.StringIO()
    CrushTester(m, cfg, out=out).test()
    return out.getvalue()


@pytest.mark.parametrize("backend", ["torch", "ref"])
@pytest.mark.parametrize("name", ["hier", "flat_weighted",
                                  "ec_leafy_indep"])
def test_show_choose_tries_equals_jax_tester(name, backend):
    from ceph_tpu_torch.crush.codec import decode_crushmap
    from ceph_tpu.crush.codec import encode_crushmap

    m, kw = choose_tries_maps()[name]
    pm = decode_crushmap(encode_crushmap(m))
    got = run_tester("port", pm, kw, backend)
    assert "choose_tries histogram" in got
    assert got == corpus()["choose_tries"][name]


def test_show_choose_tries_reads_the_planes(monkeypatch):
    """The torch backend's histogram comes from the diagnostics, not from
    the host oracle: mapper_ref is not called."""
    from ceph_tpu_torch.crush import mapper_ref as pref
    from ceph_tpu_torch.crush.codec import decode_crushmap
    from ceph_tpu.crush.codec import encode_crushmap

    m, kw = choose_tries_maps()["hier"]

    def boom(*a, **k):
        raise AssertionError("the host oracle ran")

    monkeypatch.setattr(pref, "do_rule", boom)
    got = run_tester("port", decode_crushmap(encode_crushmap(m)), kw,
                        "torch")
    assert got == corpus()["choose_tries"]["hier"]


@pytest.mark.parametrize("name", ["hier"])
def test_stored_choose_tries_are_the_jax_testers(name):
    m, kw = choose_tries_maps()[name]
    assert run_tester("jax", m, kw, "jax") == \
        corpus()["choose_tries"][name]


# -- obs.placement and the mgr -------------------------------------------------

def test_fold_summary():
    from ceph_tpu_torch.obs import placement

    agg: dict = {}
    placement.fold_summary(agg, {
        "pgs": 4, "bad_mappings": 1, "tries_histogram": [3, 1],
        "diag_exact": True})
    placement.fold_summary(agg, {
        "pgs": 2, "collisions": 5,
        "tries_histogram": [1, 0, 2], "diag_exact": True})
    assert agg["pgs"] == 6 and agg["bad_mappings"] == 1
    assert agg["collisions"] == 5
    assert agg["tries_histogram"] == [4, 1, 2]
    assert agg["diag_exact"] is True
    placement.fold_summary(agg, {"pgs": 1})  # no diag_exact: False
    assert agg["diag_exact"] is False


def test_record_dump_and_explainer_registry():
    from ceph_tpu_torch.obs import placement
    from ceph_tpu_torch.osd.pipeline import PoolMapper

    placement.reset()
    m = port_map("hier_256")
    s = PoolMapper(m, 0, device="cpu", overlays=False).diagnose()
    dump = placement.dump()
    assert dump["sources"]["pool0"] == s
    assert dump["counters"]["pgs_diagnosed"] == 256
    assert dump["counters"]["collisions"] == s["collisions"]
    assert dump["counters"]["choose_tries"]["buckets"][
        :len(s["tries_histogram"])] == s["tries_histogram"]
    assert dump["explainers"] == ["pool0"]
    ex = placement.explain("0.5")
    assert ex.get("pool") == 0 and ex.get("seed") == 5
    assert "error" in placement.explain("9.0")
    assert "error" in placement.explain("garbage")
    assert "error" in placement.explain("0.100000")
    placement.reset()
    assert placement.dump()["counters"]["pgs_diagnosed"] == 0


def _mgr_map():
    from ceph_tpu_torch.osd.osdmap import build_hierarchical
    from ceph_tpu_torch.osd.types import PgPool

    return build_hierarchical(4, 4, pool=PgPool(pg_num=64, size=3),
                              weight_fn=lambda i: 0x10000 * (1 + (i % 3)))


@pytest.mark.parametrize("with_state", [False, True])
def test_mgr_execute_accounting(monkeypatch, with_state):
    """tests/test_explain.py's test_balancer_execute_accounting, on the
    port: with CEPH_TPU_PLACEMENT_DIAG=1 an execute books the plan's
    pools under mgr.<plan>, equal to a diagnose of the new map."""
    from ceph_tpu_torch.mgr import Balancer, MappingState
    from ceph_tpu_torch.obs import placement
    from ceph_tpu_torch.osd.pipeline import PoolMapper
    from ceph_tpu_torch.osd.state import ClusterState

    monkeypatch.setenv("CEPH_TPU_PLACEMENT_DIAG", "1")
    placement.reset()
    m = _mgr_map()
    st = ClusterState(m, device="cpu") if with_state else None
    ms = (MappingState(m, state=st) if with_state
          else MappingState(m, device="cpu"))
    b = Balancer()
    plan = b.plan_create("acct", ms, mode="upmap")
    rc, _ = b.optimize(plan)
    assert rc == 0
    target = st.m if with_state else m
    assert b.execute(plan, target, state=st) == (0, "")
    src = placement.dump()["sources"]
    assert src["mgr.acct"]["pgs"] == 64
    assert src["mgr.acct"]["epoch"] == target.epoch
    fresh = PoolMapper(target, 0, device="cpu").diagnose(record=False)
    agg = placement.fold_summary({"epoch": target.epoch, "mode": "upmap"},
                                 fresh)
    assert src["mgr.acct"] == agg


def test_mgr_execute_books_nothing_without_the_knob(monkeypatch):
    from ceph_tpu_torch.mgr import Balancer, MappingState
    from ceph_tpu_torch.obs import placement

    monkeypatch.delenv("CEPH_TPU_PLACEMENT_DIAG", raising=False)
    placement.reset()
    m = _mgr_map()
    b = Balancer()
    plan = b.plan_create("quiet", MappingState(m, device="cpu"),
                         mode="upmap")
    assert b.optimize(plan)[0] == 0
    assert b.execute(plan, m) == (0, "")
    assert placement.dump()["sources"] == {}


def write_corpus_sections() -> dict:
    """This file's sections of explain_corpus.json."""
    return {
        "diag_cases": [diag_case_entry(n) for n in NAMES],
        "diagnose": {n: diagnose_entry(m)
                     for n, m in diagnose_maps().items()},
        "choose_tries": {n: run_tester("jax", m, kw, "jax")
                         for n, (m, kw) in choose_tries_maps().items()},
    }


if __name__ == "__main__":
    with contextlib.suppress(ImportError):
        import test_torch_explain

        test_torch_explain.write_corpus()
