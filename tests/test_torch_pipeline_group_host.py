"""The pipeline kernel's body at every group size G (1, 2, 4, ..., 32 lanes
a PG), built for the host with g++ (`__host__`/`__device__` defined
empty), held element-exact to the JAX package.

On the card a launch smaller than the card maps each PG with a group of G
lanes (`osd/csrc/pipeline.cu`): every lane runs the PG's control flow, and
the straw2 draws are split, lane g drawing items g, g + G, ... and a
butterfly of shuffles combining their first minima in (q, index) order
(`crush/csrc/crush_rule.cuh` straw2_partial, straw2_combine,
straw2_group).  The host build runs the G partials of a draw in turn in one
thread and combines them in the butterfly's order, so these tests hold the
striding and the tie order at every G; only the shuffles themselves are
left to `chip_smoke.py` (pipeline_vs_plain, on the card).

- `map_pg<G>` in all three modes on the 18 maps of
  tests/data/pipeline_kernel_cases.json (the JAX package's stored rows,
  EC indep maps and every overlay among them), and on the two overlay
  edge maps of tests/test_torch_pipeline_kernel_host.py against the plain
  chain;
- `do_rule<G>` on the legacy cases of tests/data/legacy_rule_cases.json
  (uniform, list, tree and straw buckets, drawn whole by every lane, under
  straw2 roots), against the JAX package's stored rows;
- one straw2 draw at every G against the serial draw (G = 1) on seeded
  buckets, and on the ties: a bucket whose weights are all 0 gives its
  first item, two records with the same id and weight (equal q) give the
  first of the two;
- a copy of the body whose combine keeps the later index on equal q fails
  the tie cases.

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

from ceph_tpu_torch.core.lntable import (  # noqa: E402
    LL_TBL,
    RH_LH_TBL,
    ln_tables,
)
from ceph_tpu_torch.crush import mapper, soa  # noqa: E402
from ceph_tpu_torch.crush.types import BucketAlg  # noqa: E402
from ceph_tpu_torch.osd import pipeline  # noqa: E402
from ceph_tpu_torch.osd.carry import crush_from_reference  # noqa: E402
from ceph_tpu_torch.osd.pipeline import PoolMapper  # noqa: E402
from test_torch_pipeline_kernel_host import (  # noqa: E402
    CASE_NAMES,
    MODES,
    _edge_map,
    port_mappers,
    want_of,
)

PACKAGE = ROOT / "ceph_tpu_torch"
LEGACY = ROOT / "tests" / "data" / "legacy_rule_cases.json"
GROUPS = pipeline.GROUPS
assert GROUPS == (1, 2, 4, 8, 16, 32)

# one straw2 (or legacy) draw of bucket slot `slot`, at group G
DRAW = r"""
template <int G>
static int32_t draw(const crush_rule::Map& m, int slot, uint32_t x,
                    int32_t r, int position) {
    return crush_rule::bucket_choose<G>(m, crush_rule::bucket(m, slot),
                                        -1 - slot, x, r, position);
}

extern "C" int bucket_draw_host(
    int group, const int32_t* headers, const int32_t* records,
    const int32_t* items, const uint32_t* nodes, const int64_t* rh_lh,
    const int64_t* ll, int n_buckets, int positions, int slot,
    const uint32_t* xs, const int32_t* rs, long long n, int position,
    int32_t* out) {
    const crush_rule::Record* recs =
        reinterpret_cast<const crush_rule::Record*>(records);
    crush_rule::Map m{headers, recs, recs, items, nullptr, rh_lh, ll, 0,
                      n_buckets, positions, 0, 0, 0, nodes};
    for (long long i = 0; i < n; i++) {
        int32_t v;
        switch (group) {
        case 1: v = draw<1>(m, slot, xs[i], rs[i], position); break;
        case 2: v = draw<2>(m, slot, xs[i], rs[i], position); break;
        case 4: v = draw<4>(m, slot, xs[i], rs[i], position); break;
        case 8: v = draw<8>(m, slot, xs[i], rs[i], position); break;
        case 16: v = draw<16>(m, slot, xs[i], rs[i], position); break;
        case 32: v = draw<32>(m, slot, xs[i], rs[i], position); break;
        default: return -1;
        }
        out[i] = v;
    }
    return 0;
}
"""

# map_pg<G> over the seeds of a launch, and do_rule<G> over rule seeds
PIPE = r"""
#include <string.h>

template <int G>
static void map_all(const crush_rule::Map& m, const crush_rule::Rule& rule,
                    const pipeline::Pipe& p) {
    for (long long lane = 0; lane < p.n; lane++)
        pipeline::map_pg<G>(m, rule, p, lane);
}

template <int G>
static void rule_all(const crush_rule::Map& m, const crush_rule::Rule& rule,
                     const uint32_t* xs, long long n, int32_t* out) {
    for (long long i = 0; i < n; i++) {
        int32_t res[crush_rule::RMAX_CAP];
        const int got = crush_rule::do_rule<G>(m, rule, xs[i], res);
        for (int j = 0; j < rule.result_max; j++)
            out[i * rule.result_max + j] =
                j < got ? res[j] : crush_rule::ITEM_NONE;
    }
}

#define DISPATCH(fn, ...)                          \
    switch (group) {                               \
    case 1: fn<1>(__VA_ARGS__); break;             \
    case 2: fn<2>(__VA_ARGS__); break;             \
    case 4: fn<4>(__VA_ARGS__); break;             \
    case 8: fn<8>(__VA_ARGS__); break;             \
    case 16: fn<16>(__VA_ARGS__); break;           \
    case 32: fn<32>(__VA_ARGS__); break;           \
    default: rc = -1;                              \
    }

extern "C" int pipeline_host_group(
    int group, const int32_t* headers, const int32_t* records,
    const int32_t* items, const uint32_t* nodes, const int64_t* weight,
    const int64_t* rh_lh, const int64_t* ll, const int32_t* steps,
    int n_buckets, int positions, int max_devices, int max_depth,
    int weight_len, int n_steps, int result_max, int choose_total_tries,
    int chooseleaf_descend_once, int chooseleaf_vary_r,
    int chooseleaf_stable, int n_staged, int threads,
    const pipeline::Pipe* pipe, const uint32_t* xs, long long n_xs,
    int32_t* rule_out) {
    (void)threads;
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
    int rc = 0;
    if (pipe) {
        DISPATCH(map_all, m, rule, *pipe)
    } else {
        DISPATCH(rule_all, m, rule, xs, n_xs, rule_out)
    }
    delete[] staged;
    return rc;
}
"""

# the tie order of the combine, and what a mutant makes of it
TIE = "q < high_q || (q == high_q && i < high)"
LATER = "q < high_q || (q == high_q && i > high)"


def _build(out: Path, text: str, include: Path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel body cannot be built for "
                    "the host")
    out.mkdir(parents=True, exist_ok=True)
    shim = out / "shim.cpp"
    shim.write_text(text)
    lib = out / "libshim.so"
    subprocess.run(
        [gxx, "-O1", "-shared", "-fPIC", "-std=c++17", "-Wall", "-Werror",
         "-D__host__=", "-D__device__=", f"-I{include}", "-o", str(lib),
         str(shim)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.bucket_draw_host.argtypes = ([i] + [p] * 6 + [i] * 3 + [p, p]
                                    + [ctypes.c_longlong, i, p])
    so.bucket_draw_host.restype = i
    if hasattr(so, "pipeline_host_group"):
        so.pipeline_host_group.argtypes = (
            [i] + [p] * 8 + [i] * 13 + [p, p, ctypes.c_longlong, p])
        so.pipeline_host_group.restype = i
    return so


@pytest.fixture(scope="module")
def group_body(tmp_path_factory):
    """The shim over the package's own body: map_pg<G>, do_rule<G> and
    one draw at G."""
    out = tmp_path_factory.mktemp("pipeline_group_host")
    return _build(out, '#include "pipeline.cuh"\n' + PIPE + DRAW,
                  PACKAGE / "osd" / "csrc")


@pytest.fixture(scope="module")
def mutant_draw(tmp_path_factory):
    """One draw at G from a copy of crush_rule.cuh whose combine keeps the
    later index on equal q."""
    out = tmp_path_factory.mktemp("pipeline_group_mutant")
    text = (PACKAGE / "crush" / "csrc" / "crush_rule.cuh").read_text()
    assert text.count(TIE) == 1
    (out / "crush_rule.cuh").write_text(text.replace(TIE, LATER))
    return _build(out, '#include "crush_rule.cuh"\n' + DRAW, out)


# -- map_pg<G> on the stored pipeline cases -----------------------------------

def _stage(group: int, records: int) -> int:
    """The staged prefix a group's run reads from the shim's copy: none,
    half or all of the records, in turn over the groups."""
    return (0, records // 2, records)[GROUPS.index(group) % 3]


def run_pipe(so, pm: PoolMapper, ps, mode: str, group: int,
             stage: int = 0) -> tuple:
    """map_pg<group> over seeds ps of CPU mapper pm, in `mode`: the int32
    outputs `pipeline_cuda` gives."""
    ps = torch.as_tensor(np.asarray(ps, np.int64))
    out = pipeline._outputs(ps.numel(), pm.spec.out_width, mode, "cpu")
    rh_lh, ll = ln_tables(torch.device("cpu"))
    args, pipe, _ = pipeline.launch_operands(pm, ps, mode, out, stage, 1,
                                             rh_lh, ll)
    rc = so.pipeline_host_group(group, *args, ctypes.addressof(pipe), None,
                                0, None)
    assert rc == 0
    return tuple(t.numpy() for t in out)


@functools.cache
def _mappers(name: str):
    return port_mappers(name)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CASE_NAMES)
def test_group_body_equals_jax_package(group_body, name, mode, group):
    """map_pg<G> gives the JAX package's stored rows of every case, in
    every mode (the overlay-free mapper for "up", as map_all_device)."""
    pm, bare, _ = _mappers(name)
    mp = bare if mode == "up" else pm
    stage = _stage(group, int(mp.tables.records.shape[0]))
    got = run_pipe(group_body, mp, np.arange(mp.spec.pg_num), mode, group,
                   stage)
    want = want_of(name, mode, mp.spec.out_width)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@functools.cache
def _edge(name: str):
    """The overlay edge map of `name` (tests/test_torch_pipeline_kernel_host
    .py `_edge_map`): its mappers and the plain chain's outputs."""
    m, pid = _edge_map(name, np.random.default_rng(23))
    pms = {mode: PoolMapper(m, pid, device="cpu", overlays=mode != "up")
           for mode in MODES}
    ps = torch.arange(pms["rows"].spec.pg_num)
    return pms, {mode: tuple(t.numpy() for t in
                             pms[mode].pipeline_plain(ps, mode))
                 for mode in MODES}


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("name", ["random_replicated", "random_ec"])
def test_group_body_at_the_overlay_edges(group_body, name, group):
    """On the overlay edge maps (pg_temp of down OSDs, affinities equal to
    the hash they are tested against), map_pg<G> == the plain chain in
    every mode."""
    pms, plain = _edge(name)
    for mode in MODES:
        pm = pms[mode]
        got = run_pipe(group_body, pm, np.arange(pm.spec.pg_num), mode,
                       group)
        for g, p in zip(got, plain[mode]):
            np.testing.assert_array_equal(g, p)


def test_group_body_on_shuffled_repeated_seeds(group_body):
    """A batch of repeated, shuffled seeds (map_batch's form, and the
    chip's check of n not a multiple of the group): each lane at every G
    equals its seed's row at G = 1."""
    pm, _, _ = _mappers("random_ec")
    n = pm.spec.pg_num
    whole = run_pipe(group_body, pm, np.arange(n), "rows", 1)
    ps = np.random.default_rng(7).integers(0, n, 2 * n + 1)
    for group in GROUPS:
        got = run_pipe(group_body, pm, ps, "rows", group)
        for g, w in zip(got, whole):
            np.testing.assert_array_equal(g, w[ps])


# -- do_rule<G> on the legacy cases -------------------------------------------

@functools.cache
def _legacy() -> dict:
    return {e["name"]: e for e in json.loads(LEGACY.read_text())["cases"]}


def run_rule(so, A, prog, xs: np.ndarray, weight: np.ndarray,
             group: int, stage: int = 0) -> np.ndarray:
    """do_rule<group> over seeds xs (u32) with reweights (int64)."""
    pk = soa.pack_buckets(A)
    headers = np.ascontiguousarray(pk.headers.view(np.int32))
    records = np.ascontiguousarray(pk.records.view(np.int32))
    items = np.ascontiguousarray(pk.items, np.int32)
    nodes = np.ascontiguousarray(pk.nodes if len(pk.nodes) else [0],
                                 np.uint32)
    xs = np.ascontiguousarray(xs, np.uint32)
    weight = np.ascontiguousarray(weight if len(weight) else [0], np.int64)
    out = np.empty((len(xs), prog.result_max), np.int32)
    rc = so.pipeline_host_group(
        group, headers.ctypes.data, records.ctypes.data, items.ctypes.data,
        nodes.ctypes.data, weight.ctypes.data, RH_LH_TBL.ctypes.data,
        LL_TBL.ctypes.data, prog.steps.ctypes.data, A.n_buckets,
        A.positions, A.max_devices, A.max_depth, len(weight),
        len(prog.steps), prog.result_max, prog.choose_total_tries,
        prog.chooseleaf_descend_once, prog.chooseleaf_vary_r,
        prog.chooseleaf_stable, stage, 1, None, xs.ctypes.data, len(xs),
        out.ctypes.data)
    assert rc == 0
    return out


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("name", sorted(_legacy()))
def test_group_rule_on_legacy_buckets(group_body, name, group):
    """do_rule<G> on the legacy cases (legacy draws whole in every lane,
    straw2 roots and choose_args split) == the JAX package's stored
    rows."""
    e = _legacy()[name]
    cm = crush_from_reference(e["map"])
    A = soa.build_arrays(cm, cm.choose_args.get(e["choose_args"]))
    prog = mapper.compile_rule(A, e["ruleno"], e["result_max"])
    got = run_rule(group_body, A, prog, np.asarray(e["xs"], np.uint32),
                   np.asarray(e["weights"], np.int64), group,
                   _stage(group, len(soa.pack_buckets(A).records)))
    np.testing.assert_array_equal(got, np.asarray(e["rows"], np.int32))


# -- one draw at G ------------------------------------------------------------

def _bucket(ids, weights, alg=BucketAlg.STRAW2) -> dict:
    """One packed bucket (slot 0, items 1000 + i) with these records: the
    arguments of bucket_draw_host past the group."""
    n = len(ids)
    headers = np.zeros(1, soa.HEADER)
    headers["size"] = n
    headers["type"] = 1
    headers["alg"] = int(alg)
    rec = np.zeros(max(n, 1), soa.RECORD)
    rec["arg_id"][:n] = ids
    rec["weight"][:n] = weights
    rec["magic"][:n] = soa.magic_words(np.asarray(weights, np.uint32))
    return {"headers": np.ascontiguousarray(headers.view(np.int32)),
            "records": np.ascontiguousarray(rec.view(np.int32)),
            "items": np.arange(1000, 1000 + max(n, 1), dtype=np.int32)}


def draws(so, bucket: dict, xs, rs, group: int) -> np.ndarray:
    xs = np.ascontiguousarray(xs, np.uint32)
    rs = np.ascontiguousarray(rs, np.int32)
    nodes = np.zeros(1, np.uint32)
    out = np.empty(len(xs), np.int32)
    rc = so.bucket_draw_host(
        group, bucket["headers"].ctypes.data, bucket["records"].ctypes.data,
        bucket["items"].ctypes.data, nodes.ctypes.data,
        RH_LH_TBL.ctypes.data, LL_TBL.ctypes.data, 1, 1, 0,
        xs.ctypes.data, rs.ctypes.data, len(xs), 0, out.ctypes.data)
    assert rc == 0
    return out


SIZES = (1, 2, 3, 7, 8, 16, 17, 31, 32, 33, 78, 100)


@pytest.mark.parametrize("group", GROUPS[1:])
def test_split_draw_equals_serial_draw(group_body, group):
    """Seeded straw2 buckets of every size around the group sizes, some
    weights 0, some ids repeated: the draw at G == the serial draw."""
    rng = np.random.default_rng(11 + group)
    xs = rng.integers(0, 1 << 32, 64, dtype=np.uint64)
    rs = rng.integers(0, 8, 64)
    for size in SIZES:
        ids = rng.integers(0, 2 * size, size)
        weights = rng.choice([0, 1, 0x8000, 0x10000, 0x2A000, 0xFFFFF],
                             size)
        b = _bucket(ids, weights)
        np.testing.assert_array_equal(draws(group_body, b, xs, rs, group),
                                      draws(group_body, b, xs, rs, 1))


def _tie_cases():
    """(bucket, the index that must win) of the ties: every weight 0 (the
    first item), and two records of the same id and weight (equal q)
    among records of weight 0, at index pairs in one lane's stride and in
    two lanes', around every group size."""
    out = [(_bucket(np.arange(n), np.zeros(n, np.uint32)), 0)
           for n in SIZES]
    for n, i, j in ((2, 0, 1), (5, 1, 3), (33, 0, 32), (33, 3, 4),
                    (40, 5, 21), (78, 17, 49), (78, 60, 61), (100, 2, 98)):
        w = np.zeros(n, np.uint32)
        ids = np.arange(n) + 7
        w[[i, j]] = 0x10000
        ids[j] = ids[i]
        out.append((_bucket(ids, w), i))
    return out


def _ties_hold(so) -> bool:
    xs = (np.arange(16, dtype=np.uint64) * 2654435761 % (1 << 32))
    rs = np.arange(16) % 5
    for group in GROUPS:
        for b, first in _tie_cases():
            if not (draws(so, b, xs, rs, group) == 1000 + first).all():
                return False
    return True


def test_ties_give_the_first_index(group_body):
    """The ties at every G give the first index, as the serial loop's first
    minimum does."""
    assert _ties_hold(group_body)


def test_a_combine_keeping_the_later_index_fails_the_ties(mutant_draw):
    """The negative control: with the combine's tie order reversed the
    tie cases fail (at some G > 1; G = 1 has no combine)."""
    assert not _ties_hold(mutant_draw)
