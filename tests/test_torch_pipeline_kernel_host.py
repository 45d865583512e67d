"""The pipeline kernel's per-lane body (`osd/csrc/pipeline.cuh`), built for
the host with g++ (`__host__`/`__device__` defined empty), held
element-exact in each of its three modes against the JAX package's
`PoolMapper` and the port's plain chain (`PoolMapper.pipeline_plain`):

- "rows" (up, up_primary, acting, acting_primary) against `map_all`;
- "up" on a mapper built without overlays against `map_all_device`;
- "raw" against `raw_rows` of the overlay-free JAX mapper, padded to the
  width.

The cases are the 16 maps of tests/test_torch_pipeline.py and two seeded
random maps (replicated and EC) with every overlay at once, entries wider
than the pool (out_width > result_max), down and out OSDs, affinity, a
pool without hashpspool and a pgp_num that is not a power of two.  The
JAX package's rows are stored with each map in
tests/data/pipeline_kernel_cases.json (`python
tests/test_torch_pipeline_kernel_host.py` rewrites it, about 2 min); one
test recomputes two cases through `ceph_tpu` to check it still gives them.

nvcc builds the same file into the kernel on the card; here a small shim
loops the body over the seeds with the arguments the kernel's C entry
takes, marshalled by the wrapper's own `pipeline.launch_operands`, and
copies the staged prefix of the records into a buffer of its own, as the
kernel copies it into shared memory.  Skips, with the reason, where g++
is missing.
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

from ceph_tpu.osd.pipeline_jax import PoolMapper as JaxPoolMapper  # noqa: E402
from ceph_tpu.osd.types import PgId, PgPool, PoolType  # noqa: E402
from ceph_tpu_torch.core.lntable import ln_tables  # noqa: E402
from ceph_tpu_torch.core.rjenkins import crush_hash32_2  # noqa: E402
from ceph_tpu_torch.crush.types import ITEM_NONE  # noqa: E402
from ceph_tpu_torch.osd import pipeline  # noqa: E402
from ceph_tpu_torch.osd.carry import osdmap_from_reference  # noqa: E402
from ceph_tpu_torch.osd.pipeline import PoolMapper  # noqa: E402
from ceph_tpu_torch.osd.types import PgId as PortPgId  # noqa: E402
from test_torch_pipeline import MAPS, hier_map, osdmap_dict  # noqa: E402

CSRC = ROOT / "ceph_tpu_torch" / "osd" / "csrc"
DATA = ROOT / "tests" / "data" / "pipeline_kernel_cases.json"
MODES = tuple(pipeline.MODES)

SHIM = r"""
#include <string.h>

#include "pipeline.cuh"

extern "C" void pipeline_host(
    const int32_t* headers, const int32_t* records, const int32_t* items,
    const uint32_t* nodes, const int64_t* weight, const int64_t* rh_lh,
    const int64_t* ll, const int32_t* steps, int n_buckets, int positions,
    int max_devices, int max_depth, int weight_len, int n_steps,
    int result_max, int choose_total_tries, int chooseleaf_descend_once,
    int chooseleaf_vary_r, int chooseleaf_stable, int n_staged, int threads,
    const pipeline::Pipe* pipe) {
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
    for (long long lane = 0; lane < pipe->n; lane++)
        pipeline::map_pg(m, rule, *pipe, lane);
    delete[] staged;
}
"""


@pytest.fixture(scope="module")
def body(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel body cannot be built for "
                    "the host")
    out = tmp_path_factory.mktemp("pipeline_host")
    shim = out / "shim.cpp"
    shim.write_text(SHIM)
    lib = out / "libpipeline_host.so"
    subprocess.run(
        [gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-Wall", "-Werror",
         "-D__host__=", "-D__device__=", f"-I{CSRC}", "-o", str(lib),
         str(shim)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.pipeline_host.argtypes = [p] * 8 + [i] * 13 + [p]
    so.pipeline_host.restype = None
    return so


def run_body(so, pm: PoolMapper, ps, mode: str, stage: int = 0) -> tuple:
    """The host-built body over seeds ps of CPU mapper pm, in `mode`, the
    first `stage` records read from the shim's staged copy: the int32
    outputs `pipeline_cuda` gives."""
    ps = torch.as_tensor(np.asarray(ps, np.int64))
    out = pipeline._outputs(ps.numel(), pm.spec.out_width, mode, "cpu")
    rh_lh, ll = ln_tables(torch.device("cpu"))
    args, pipe, _ = pipeline.launch_operands(pm, ps, mode, out, stage, 1,
                                             rh_lh, ll)
    so.pipeline_host(*args, ctypes.addressof(pipe))
    return tuple(t.numpy() for t in out)


# -- the cases ------------------------------------------------------------------

def _random_map(rng, ec: bool):
    """Every overlay at once on a degraded map with affinity: pg_upmap
    entries (some with an out target, some wider than the pool, some
    holding NONE), up to three pg_upmap_items pairs (chained, repeated,
    onto present and out OSDs), pg_temp entries wider and narrower than
    the pool (some empty), primary_temp with and without pg_temp; a pool
    without hashpspool whose pgp_num is not a power of two."""
    size = 4 if ec else 3
    pool = (PgPool(type=PoolType.ERASURE, size=size, pg_num=96, pgp_num=80,
                   crush_rule=1, flags=0) if ec
            else PgPool(pg_num=96, size=size, pgp_num=80, flags=0))
    m = hier_map(rng, pool, n_host=10, n_rack=2)
    if ec:
        m.crush.make_erasure_rule(
            min(m.crush.buckets, key=lambda b: -m.crush.buckets[b].type), 1)
    n_osd = m.max_osd
    for o in range(n_osd):
        if rng.integers(0, 3) == 0:
            m.set_primary_affinity(o, int(rng.choice(
                [0, 1, 0x8000, 0xFFFF, 0x10000, int(rng.integers(0, 0x10000))])))
    for o in rng.choice(n_osd, 6, replace=False):
        m.mark_down(int(o))
    for o in rng.choice(n_osd, 5, replace=False):
        m.mark_out(int(o))

    def osds(k):
        return [int(o) for o in rng.choice(n_osd, k, replace=False)]

    for ps in range(pool.pg_num):
        pg = PgId(0, ps)
        kind = rng.integers(0, 8)
        if kind == 0:
            m.pg_upmap[pg] = osds(int(rng.integers(1, size + 3)))
        elif kind == 1:
            v = osds(size)
            v[int(rng.integers(0, size))] = ITEM_NONE
            m.pg_upmap[pg] = v
        if rng.integers(0, 3) == 0:
            raw, _ = m.pg_to_raw_osds(pg)
            pairs = []
            for _ in range(int(rng.integers(1, 4))):
                frm = (int(rng.choice(raw)) if raw and rng.integers(0, 2)
                       else int(rng.integers(0, n_osd)))
                to = (int(rng.choice(raw)) if raw and rng.integers(0, 4) == 0
                      else int(rng.integers(0, n_osd)))
                pairs.append((frm, to))
            if rng.integers(0, 4) == 0:
                pairs.append((pairs[-1][1], int(rng.integers(0, n_osd))))
            m.pg_upmap_items[pg] = pairs
        if rng.integers(0, 4) == 0:
            m.pg_temp[pg] = osds(int(rng.integers(0, size + 3)))
        if rng.integers(0, 5) == 0:
            m.primary_temp[pg] = int(rng.integers(0, n_osd))
    return m, 0


def _random_replicated(rng):
    return _random_map(rng, ec=False)


def _random_ec(rng):
    return _random_map(rng, ec=True)


BUILDERS = dict(MAPS, random_replicated=_random_replicated,
                random_ec=_random_ec)


def jax_rows(m, pid: int) -> dict:
    """The JAX package's outputs of the three modes on the CPU."""
    n = m.pools[pid].pg_num
    rows = JaxPoolMapper(m, pid).map_all()
    bare = JaxPoolMapper(m, pid, overlays=False)
    return {"rows": [np.asarray(r).tolist() for r in rows],
            "up": np.asarray(bare.map_all_device()).tolist(),
            "raw": bare.raw_rows(np.arange(n)).tolist()}


def _pad(rows: np.ndarray, width: int) -> np.ndarray:
    out = np.full((rows.shape[0], width), ITEM_NONE, np.int32)
    out[:, :rows.shape[1]] = rows
    return out


@functools.cache
def _stored_cases() -> dict:
    return json.loads(DATA.read_text())["cases"]


def stored(name: str) -> dict:
    return _stored_cases()[name]


def port_mappers(name: str):
    """(mapper with overlays, mapper without, pool id) on the CPU."""
    ent = stored(name)
    m = osdmap_from_reference(ent["map"])
    pid = ent["pool"]
    return (PoolMapper(m, pid, device="cpu"),
            PoolMapper(m, pid, device="cpu", overlays=False), pid)


def want_of(name: str, mode: str, width: int) -> tuple:
    ent = stored(name)["jax"]
    if mode == "rows":
        return tuple(np.asarray(r, np.int32) for r in ent["rows"])
    return (_pad(np.asarray(ent[mode], np.int32), width),)


def _check_mode(body, name: str, mode: str, stage_of=lambda T: 0):
    pm, bare, _ = port_mappers(name)
    mp = bare if mode == "up" else pm
    ps = np.arange(mp.spec.pg_num)
    got = run_body(body, mp, ps, mode, stage_of(mp.tables))
    plain = mp.pipeline_plain(torch.from_numpy(ps), mode)
    want = want_of(name, mode, mp.spec.out_width)
    assert len(got) == len(plain) == len(want)
    for g, p, w in zip(got, plain, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, p.numpy())
        np.testing.assert_array_equal(g, w)
    return mp, got


CASE_NAMES = sorted(BUILDERS)


def test_cases_stored():
    """Every case is stored, with out_width past the pool's size in the
    random ones (rows past result_max are NONE-padded)."""
    assert sorted(_stored_cases()) == CASE_NAMES and len(MAPS) == 16
    for name in ("random_replicated", "random_ec"):
        pm, _, pid = port_mappers(name)
        assert pm.spec.out_width > pm.spec.size
        assert all(v is not None for v in vars(pm.ov).values())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CASE_NAMES)
def test_body_equals_jax_package_and_plain(body, name, mode):
    _check_mode(body, name, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["random_replicated", "random_ec",
                                  "everything_at_once"])
def test_body_with_staged_records(body, name, mode):
    """Staging every record in the shim's copy gives the same outputs."""
    _check_mode(body, name, mode,
                stage_of=lambda T: int(T.records.shape[0]))


def test_body_on_shuffled_batches(body):
    """A shuffled batch with repeated seeds (`map_batch`'s form): each
    lane equals its seed's row of the whole pool."""
    pm, _, _ = port_mappers("random_replicated")
    n = pm.spec.pg_num
    whole = run_body(body, pm, np.arange(n), "rows")
    ps = np.random.default_rng(5).integers(0, n, 3 * n)
    got = run_body(body, pm, ps, "rows")
    for g, w in zip(got, whole):
        np.testing.assert_array_equal(g, w[ps])


def test_body_without_overlays_gives_the_up_mode(body):
    """Rows mode of a mapper without overlays: up and acting equal the up
    mode's rows, acting_primary equals up_primary (no pg_temp)."""
    _, bare, _ = port_mappers("primary_affinity")
    ps = np.arange(bare.spec.pg_num)
    up, upp, acting, actp = run_body(body, bare, ps, "rows")
    (only_up,) = run_body(body, bare, ps, "up")
    np.testing.assert_array_equal(up, only_up)
    np.testing.assert_array_equal(acting, up)
    np.testing.assert_array_equal(actp, upp)


def _edge_map(name: str, rng):
    """The stored map `name` with the overlays at their edges, on the
    port's OSDMap: pg_temp entries whose OSDs are all down (an EC pool
    keeps them, NONE-filled; a replicated pool drops them), with and
    without primary_temp; and primary affinities equal to the hash the
    test draws for the PG whose up set they lead (h >= a rejects)."""
    ent = stored(name)
    m = osdmap_from_reference(ent["map"])
    pid = ent["pool"]
    pm = PoolMapper(m, pid, device="cpu")
    down = [o for o in range(m.max_osd) if not m.is_up(o)]
    n = pm.spec.pg_num
    for ps in rng.choice(n, 12, replace=False).tolist():
        m.pg_temp[PortPgId(pid, ps)] = [int(o) for o in rng.choice(down, 2)]
        if ps % 2:
            m.primary_temp[PortPgId(pid, ps)] = int(rng.integers(0, m.max_osd))
    ps = torch.arange(n)
    up = pm.pipeline_plain(ps, "rows")[0]
    pps = pm.placement_seeds(ps)
    tied = set()
    for s in range(n):
        row = [int(o) for o in up[s] if o != ITEM_NONE]
        for o in row[:2]:
            if o not in tied:
                h = int(crush_hash32_2(pps[s:s + 1], torch.tensor([o]))
                        ) >> 16
                m.set_primary_affinity(o, h)
                tied.add(o)
                break
    return m, pid


@pytest.mark.parametrize("name", ["random_replicated", "random_ec"])
def test_body_at_the_overlay_edges(body, name):
    """On `_edge_map`, every mode of the body == the plain chain, and
    every PG's rows == the port's host oracle
    (`OSDMap.pg_to_up_acting_osds`, held to the JAX package's by
    tests/test_torch_osdmap_oracle.py)."""
    m, pid = _edge_map(name, np.random.default_rng(23))
    pm = PoolMapper(m, pid, device="cpu")
    W, n = pm.spec.out_width, pm.spec.pg_num
    ps = np.arange(n)
    for mode in MODES:
        mp = pm if mode != "up" else PoolMapper(m, pid, device="cpu",
                                                overlays=False)
        got = run_body(body, mp, ps, mode)
        for g, p in zip(got, mp.pipeline_plain(torch.from_numpy(ps),
                                               mode)):
            np.testing.assert_array_equal(g, p.numpy())
    up, upp, acting, actp = run_body(body, pm, ps, "rows")
    pad = lambda v: (list(v) + [ITEM_NONE] * W)[:W]  # noqa: E731
    for s in range(n):
        w_up, w_upp, w_act, w_actp = m.pg_to_up_acting_osds(
            PortPgId(pid, s))
        assert list(up[s]) == pad(w_up) and upp[s] == w_upp, s
        assert list(acting[s]) == pad(w_act) and actp[s] == w_actp, s


def test_wrapper_refuses_cpu_tensors():
    """On the CPU the mapper runs the plain chain; the kernel's wrapper
    itself raises for a tensor off the card and books no launch."""
    pm, _, _ = port_mappers("everything_at_once")
    before = pipeline.pipeline_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        pipeline.pipeline_cuda(pm, torch.arange(4), "rows")
    with pytest.raises(ValueError, match="mode"):
        pipeline.pipeline_cuda(pm, torch.arange(4), "all")
    pm.map_all()
    assert pipeline.pipeline_cuda.launches == before


@pytest.mark.parametrize("name", ["random_ec",
                                  "upmap_rejected_full_skips_items"])
def test_stored_rows_are_the_jax_package(name):
    """`ceph_tpu` still gives what the data file holds for these cases."""
    m, pid = BUILDERS[name](np.random.default_rng(0xC3A5))
    assert osdmap_dict(m) == stored(name)["map"]
    assert jax_rows(m, pid) == stored(name)["jax"]


def main() -> None:
    cases = {}
    for name in CASE_NAMES:
        m, pid = BUILDERS[name](np.random.default_rng(0xC3A5))
        cases[name] = {"pool": pid, "map": osdmap_dict(m),
                       "jax": jax_rows(m, pid)}
        print(name, flush=True)
    DATA.write_text(json.dumps({"cases": cases}, separators=(",", ":"))
                    + "\n")


if __name__ == "__main__":
    main()
