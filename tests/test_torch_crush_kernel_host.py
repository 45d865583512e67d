"""The rule kernel's per-lane body (`crush/csrc/crush_rule.cuh`), built
for the host with g++ (`__host__`/`__device__` defined empty), held
element-exact against `crush_rule_plain` and the JAX package's rows
(`compile_batched` and `mapper_ref`, as stored in
tests/data/placement_corpus.json) on the mapper cases of
tests/test_torch_crush_mapper.py.

nvcc builds the same file into the kernel on the card; here a small shim
loops the body over the seeds, with the arguments the kernel's C entry
takes, over the map's packed records (`soa.pack_buckets`).  The kernel
stages a prefix of the records in shared memory; the shim copies that
prefix into a buffer of its own, and the body reads it from there.  The
body's divide-free straw2 quotient is held to C's truncating division on
every numerator it can meet.  Skips, with the reason, where g++ is
missing.
"""

import ctypes
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

from ceph_tpu_torch.core.lntable import (  # noqa: E402
    LL_TBL,
    RH_LH_TBL,
    crush_ln_np,
)
from ceph_tpu_torch.crush import mapper, soa  # noqa: E402
from ceph_tpu_torch.osd.carry import osdmap_from_reference  # noqa: E402
from ceph_tpu_torch.osd.osdmap import build_hierarchical  # noqa: E402
from test_torch_crush_mapper import CASES, port_case, stored_rows  # noqa: E402

CSRC = ROOT / "ceph_tpu_torch" / "crush" / "csrc"

SHIM = r"""
#include <string.h>

#include "crush_rule.cuh"

extern "C" void crush_rule_host(
    const int32_t* headers, const int32_t* records, const int32_t* items,
    const uint32_t* nodes, const uint32_t* weight, const int64_t* rh_lh, const int64_t* ll,
    const int32_t* steps, int n_buckets, int positions, int max_devices,
    int max_depth, int weight_len, int n_steps, int result_max,
    int choose_total_tries, int chooseleaf_descend_once,
    int chooseleaf_vary_r, int chooseleaf_stable, int n_staged,
    const uint32_t* xs, long long n, int32_t* out) {
    using crush_rule::Record;
    const Record* recs = reinterpret_cast<const Record*>(records);
    // the block's shared memory: a copy of the prefix, read instead of it
    Record* staged = new Record[n_staged > 0 ? n_staged : 1];
    memcpy(staged, recs, sizeof(Record) * n_staged);
    crush_rule::Map m{headers, recs, staged, items, weight, rh_lh, ll,
                      n_staged, n_buckets, positions, max_devices,
                      max_depth, weight_len, nodes};
    crush_rule::Rule rule{steps, n_steps, result_max, choose_total_tries,
                          chooseleaf_descend_once, chooseleaf_vary_r,
                          chooseleaf_stable};
    for (long long i = 0; i < n; i++)
        crush_rule::map_seed(m, rule, xs[i], out + i * result_max);
    delete[] staged;
}

// the body's crush_ln, per input
extern "C" void crush_ln_host(const int64_t* rh_lh, const int64_t* ll,
                              const uint32_t* xs, long long n,
                              int64_t* out) {
    crush_rule::Map m{};
    m.rh_lh = rh_lh;
    m.ll = ll;
    for (long long i = 0; i < n; i++) out[i] = crush_rule::crush_ln(m, xs[i]);
}

// the body's quotient and C's truncating divide, per numerator
extern "C" void straw2_draws_host(const int64_t* ln, long long n,
                                  uint32_t w, uint64_t magic,
                                  int64_t* by_magic, int64_t* by_divide) {
    for (long long i = 0; i < n; i++) {
        by_magic[i] = -(int64_t)crush_rule::straw2_quotient(ln[i], magic);
        by_divide[i] = (ln[i] - 0x1000000000000LL) / (int64_t)w;
    }
}
"""


@pytest.fixture(scope="module")
def body(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel body cannot be built for "
                    "the host")
    out = tmp_path_factory.mktemp("crush_rule_host")
    shim = out / "shim.cpp"
    shim.write_text(SHIM)
    lib = out / "libcrush_rule_host.so"
    subprocess.run(
        [gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-D__host__=",
         "-D__device__=", f"-I{CSRC}", "-o", str(lib), str(shim)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.crush_rule_host.argtypes = (
        [p] * 8 + [i] * 12 + [p, ctypes.c_longlong, p])
    so.crush_rule_host.restype = None
    so.straw2_draws_host.argtypes = [p, ctypes.c_longlong, ctypes.c_uint32,
                                     ctypes.c_uint64, p, p]
    so.straw2_draws_host.restype = None
    so.crush_ln_host.argtypes = [p, p, p, ctypes.c_longlong, p]
    so.crush_ln_host.restype = None
    return so


def run_body(so, A, prog, xs: np.ndarray, weight: np.ndarray,
             stage: int = 0) -> np.ndarray:
    """The host-built body over seeds xs (u32) with reweights (u32), the
    first `stage` records read from the shim's staged copy."""
    pk = soa.pack_buckets(A)
    headers = np.ascontiguousarray(pk.headers.view(np.int32))
    records = np.ascontiguousarray(pk.records.view(np.int32))
    items = np.ascontiguousarray(pk.items, np.int32)
    nodes = np.ascontiguousarray(pk.nodes if len(pk.nodes) else [0],
                                 np.uint32)
    assert 0 <= stage <= len(pk.records)
    xs = np.ascontiguousarray(xs, np.uint32)
    weight = np.ascontiguousarray(weight if len(weight) else [0], np.uint32)
    out = np.empty((len(xs), prog.result_max), np.int32)
    so.crush_rule_host(
        headers.ctypes.data, records.ctypes.data, items.ctypes.data,
        nodes.ctypes.data, weight.ctypes.data, RH_LH_TBL.ctypes.data, LL_TBL.ctypes.data,
        prog.steps.ctypes.data, A.n_buckets, A.positions, A.max_devices,
        A.max_depth, len(weight), len(prog.steps), prog.result_max,
        prog.choose_total_tries, prog.chooseleaf_descend_once,
        prog.chooseleaf_vary_r, prog.chooseleaf_stable, stage,
        xs.ctypes.data, len(xs), out.ctypes.data,
    )
    return out


def stages(A) -> dict[str, int]:
    """Staged prefixes to run a case's body at: the first breadth-first
    level, a prefix that ends inside a bucket, and the whole map."""
    pk = soa.pack_buckets(A)
    total = len(pk.records)
    return {"level": pk.level_ends[0], "split": total // 2 + 1,
            "all": total}


@pytest.mark.parametrize("name", sorted(CASES))
def test_body_equals_plain_and_jax_package(body, name):
    A, prog, xs, w = port_case(name)
    got = run_body(body, A, prog, xs.numpy().astype(np.uint32),
                   w.numpy().astype(np.uint32))
    plain, _ = mapper.crush_rule_plain(soa.to_device(A, "cpu"), prog, xs, w)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, stored_rows(name))


def test_body_on_many_seeds(body):
    """More seeds than the cases carry, on a map whose lanes retry
    (weights below 1.0, devices out): body == plain version."""
    A, prog, _, w = port_case("chooseleaf_firstn")
    rng = np.random.default_rng(11)
    xs = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    got = run_body(body, A, prog, xs, w.numpy().astype(np.uint32))
    plain, _ = mapper.crush_rule_plain(
        soa.to_device(A, "cpu"), prog, torch.from_numpy(xs.astype(np.int64)),
        w)
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("stage", ["level", "split", "all"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_body_with_staged_records(body, name, stage):
    """Every staged prefix gives the same rows: the stored JAX rows, which
    test_body_equals_plain_and_jax_package holds to the plain version at
    a prefix of 0."""
    A, prog, xs, w = port_case(name)
    got = run_body(body, A, prog, xs.numpy().astype(np.uint32),
                   w.numpy().astype(np.uint32), stages(A)[stage])
    np.testing.assert_array_equal(got, stored_rows(name))


def test_body_on_many_seeds_staged(body):
    """The many-seeds map with part and all of it staged."""
    A, prog, _, w = port_case("chooseleaf_firstn")
    rng = np.random.default_rng(12)
    xs = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    want = run_body(body, A, prog, xs, w.numpy().astype(np.uint32))
    for stage in stages(A).values():
        got = run_body(body, A, prog, xs, w.numpy().astype(np.uint32),
                       stage)
        np.testing.assert_array_equal(got, want)


def _corpus_weights() -> set[int]:
    """Every distinct item weight (all weight-set positions) of the
    placement corpus maps and of BASELINE config 2."""
    corpus = json.loads((ROOT / "tests" / "data" /
                         "placement_corpus.json").read_text())
    maps = [osdmap_from_reference(e["map"]) for e in corpus["entries"]]
    maps.append(build_hierarchical(128, 8, n_rack=8))
    ws: set[int] = set()
    for m in maps:
        for ca in [None, *m.crush.choose_args.values()]:
            A = soa.build_arrays(m.crush, ca)
            ws.update(int(v) for v in np.unique(A.pos_weights))
    return ws


EDGE_WEIGHTS = sorted(
    {1, 0xFFFF, 0x10000, (1 << 32) - 1}
    | {1 << k for k in range(32)}
    | {(1 << k) + 1 for k in range(32)}
    | {(1 << k) - 1 for k in range(1, 33)}
)


@pytest.mark.parametrize("which", ["corpus_and_config2", "edges"])
def test_divide_free_draw_is_truncating_division(body, which):
    """The body's straw2 quotient, from a record's magic word, equals C's
    truncating division (ln - 2^48) / w on all 65 536 numerators
    2^48 - crush_ln(u), u < 2^16, for each weight."""
    ws = sorted(_corpus_weights() - {0}) if which != "edges" \
        else EDGE_WEIGHTS
    assert len(ws) > 3
    ln = np.ascontiguousarray(
        crush_ln_np(np.arange(1 << 16, dtype=np.uint32)).astype(np.int64))
    n = (1 << 48) - ln
    assert n.min() >= 0 and n.max() <= 1 << 48
    by_magic = np.empty_like(ln)
    by_divide = np.empty_like(ln)
    words = soa.magic_words(np.asarray(ws, np.uint64))
    for w, word in zip(ws, words.tolist()):
        body.straw2_draws_host(ln.ctypes.data, len(ln), w, word,
                               by_magic.ctypes.data, by_divide.ctypes.data)
        np.testing.assert_array_equal(by_magic, by_divide, err_msg=f"w={w}")
        np.testing.assert_array_equal(by_magic, -(n // w), err_msg=f"w={w}")


def test_body_crush_ln_on_every_input(body):
    """The body's crush_ln (32-bit, branch-free normalisation) equals the
    port's reference-table version on the whole 2^16 input domain."""
    xs = np.arange(1 << 16, dtype=np.uint32)
    got = np.empty(len(xs), np.int64)
    body.crush_ln_host(RH_LH_TBL.ctypes.data, LL_TBL.ctypes.data,
                       xs.ctypes.data, len(xs), got.ctypes.data)
    np.testing.assert_array_equal(got, crush_ln_np(xs).astype(np.int64))


def _tie_map(ids, weights):
    """One straw2 bucket of 4 OSDs whose draws tie where ids and weights
    repeat (choose_args ids), and a rule that picks one of them."""
    from ceph_tpu_torch.crush.types import (BucketAlg, ChooseArgs, CrushMap,
                                            Rule, RuleOp)

    m = CrushMap()
    root = m.add_bucket(BucketAlg.STRAW2, 1, [0, 1, 2, 3], [0x10000] * 4)
    ca = ChooseArgs(weight_sets={root: [list(weights)]}, ids={root: ids})
    r = m.add_rule(Rule([(RuleOp.TAKE, root, 0),
                         (RuleOp.CHOOSE_FIRSTN, 1, 0),
                         (RuleOp.EMIT, 0, 0)]))
    A = soa.build_arrays(m, ca)
    return A, mapper.compile_rule(A, r, 1)


@pytest.mark.parametrize("ids,weights,allowed", [
    ([5, 5, 9, 9], [0x10000] * 4, {0, 2}),  # draws tie in pairs
    ([5, 6, 7, 8], [0] * 4, {0}),  # every draw is S64_MIN
])
def test_body_first_maximum_wins(body, ids, weights, allowed):
    """Where draws tie, the first item wins (reference mapper.c:374),
    in the body as in the plain version."""
    A, prog = _tie_map(ids, weights)
    xs = np.arange(512, dtype=np.uint32)
    w = np.full(4, 0x10000, np.uint32)
    got = run_body(body, A, prog, xs, w)
    plain, _ = mapper.crush_rule_plain(
        soa.to_device(A, "cpu"), prog, torch.from_numpy(xs.astype(np.int64)),
        torch.from_numpy(w.astype(np.int64)))
    np.testing.assert_array_equal(got, plain.numpy())
    assert set(got[:, 0].tolist()) == allowed
