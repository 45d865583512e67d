"""The EC strategies (`ceph_tpu_torch.ec.torch_backend.STRATEGIES`) and the
XOR-schedule compiler (`ceph_tpu_torch.ec.xor_schedule`) held against
`ceph_tpu`: the cases of `tests/test_xor_schedule.py` and
`tests/test_ec.py`'s strategy tests, on the port.

Every comparison is exact.  Matrices and data come from numpy seeds and
go through `ceph_tpu.ec.jax_backend.JaxEngine(strategy)` (its `pallas`
strategy in interpret mode) and the port's `TorchEngine(device="cpu",
strategy)`; the corpus digests are tests/data/ec_corpus.json's.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu import obs  # noqa: E402
from ceph_tpu.ec import create_erasure_code as jax_create  # noqa: E402
from ceph_tpu.ec import clay as jax_clay  # noqa: E402,F401 (its counters)
from ceph_tpu.ec import rs as jax_rs  # noqa: E402
from ceph_tpu.ec import jax_backend  # noqa: E402
from ceph_tpu.ec.jax_backend import JaxEngine  # noqa: E402
from ceph_tpu.ec.xor_schedule import build_schedule as jax_schedule  # noqa: E402
from ceph_tpu.ec.xor_schedule import host_apply as jax_host_apply  # noqa: E402
from ceph_tpu_torch.ec import clay, create_erasure_code, matrices, rs  # noqa: E402
from ceph_tpu_torch.ec import torch_backend, xor_schedule  # noqa: E402
from ceph_tpu_torch.ec.gf import GF_MUL_TABLE, gf_matvec_data  # noqa: E402
from ceph_tpu_torch.ec.torch_backend import (  # noqa: E402
    _BIT_TILE,
    STRATEGIES,
    TorchEngine,
    _xtime,
)
from tools import ec_corpus  # noqa: E402

CORPUS = ROOT / "tests" / "data" / "ec_corpus.json"
PRODUCTS = ("xor", "xor_cse", "bitplane", "logexp", "pallas")


@pytest.fixture(autouse=True)
def no_env_strategy(monkeypatch):
    monkeypatch.delenv("CEPH_TPU_EC_STRATEGY", raising=False)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ec_counters() -> dict:
    return dict(obs.perf_dump()["ec"])


def _matrix(rng, m: int, k: int) -> np.ndarray:
    """A random matrix with zero coefficients in it (logexp masks them)."""
    M = rng.integers(0, 256, (m, k)).astype(np.uint8)
    M[rng.random((m, k)) < 0.25] = 0
    return M


# -- the strategies against the JAX engine ------------------------------------

@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("m,k,L", [(4, 8, 4096), (3, 5, 1237), (2, 7, 8191)])
def test_matmul_equals_jax(strategy, m, k, L):
    """Single stripes, ragged L among them: the JAX engine's bytes."""
    rng = np.random.default_rng(1000 * m + k + L)
    M = _matrix(rng, m, k)
    data = rng.integers(0, 256, (k, L)).astype(np.uint8)
    want = np.asarray(JaxEngine(strategy).matmul(M, data))
    eng = TorchEngine("cpu", strategy)
    got = eng.matmul(M, data)
    assert isinstance(got, np.ndarray)
    assert np.array_equal(got, want)
    assert np.array_equal(want, gf_matvec_data(M, data))
    t = eng.matmul(M, torch.from_numpy(data))  # a tensor stays a tensor
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), want)


@pytest.mark.parametrize("strategy", PRODUCTS)
def test_one_column_equals_jax(strategy):
    """L = 1.  (`auto` is left out: the JAX autotune rounds a 7-byte
    sample's GB/s to 0 and refuses every candidate.)"""
    rng = np.random.default_rng(71)
    M = _matrix(rng, 2, 7)
    data = rng.integers(0, 256, (7, 1)).astype(np.uint8)
    want = np.asarray(JaxEngine(strategy).matmul(M, data))
    assert np.array_equal(TorchEngine("cpu", strategy).matmul(M, data), want)


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("N,L", [(3, 1024), (2, 1531)])
def test_matmul_batch_equals_jax(strategy, N, L):
    rng = np.random.default_rng(7 * N + L)
    M = _matrix(rng, 4, 6)
    data = rng.integers(0, 256, (N, 6, L)).astype(np.uint8)
    want = np.asarray(JaxEngine(strategy).matmul_batch(M, data))
    got = TorchEngine("cpu", strategy).matmul_batch(M, data)
    assert np.array_equal(got, want)
    per = np.stack([gf_matvec_data(M, d) for d in data])
    assert np.array_equal(want, per)


@pytest.mark.parametrize("N,L", [(1, _BIT_TILE + 1237), (3, 45000),
                                 (2, _BIT_TILE // 2)])
def test_bitplane_tiles_past_tile(N, L):
    """L (and the folded N * L) past _BIT_TILE: the tiled product, with a
    ragged last tile, equals the JAX engine's at its default tile; the
    last case fills exactly one tile."""
    assert _BIT_TILE == jax_backend._BIT_TILE
    rng = np.random.default_rng(N + L)
    M = _matrix(rng, 3, 4)
    data = rng.integers(0, 256, (N, 4, L)).astype(np.uint8)
    want = np.asarray(JaxEngine("bitplane").matmul_batch(M, data))
    eng = TorchEngine("cpu", "bitplane")
    assert np.array_equal(eng.matmul_batch(M, data), want)
    assert np.array_equal(eng.matmul(M, data[0]), want[0])


def test_xtime_is_the_gf_doubling():
    x = torch.arange(256, dtype=torch.uint8)
    want = GF_MUL_TABLE[2]
    assert np.array_equal(_xtime(x).numpy(), want)
    assert np.array_equal(_xtime(x.flip(0)[::2]).numpy(), want[::-1][::2])


# -- the schedule compiler ----------------------------------------------------

def _fields(s) -> tuple:
    return (s.shape, s.key, s.terms, s.ops, s.outs, s.max_power)


@pytest.mark.parametrize("k,m", [(4, 2), (8, 4), (6, 3)])
def test_schedule_equals_jax(k, m):
    M = matrices.vandermonde_rs(k, m)
    sched = xor_schedule.build_schedule(M)
    assert _fields(sched) == _fields(jax_schedule(M))
    assert sched.stats() == jax_schedule(M).stats()


def test_schedule_rs84_cse():
    """Paar's dedup on the RS(8,4) profile: 106 XORs to 63."""
    s = xor_schedule.build_schedule(matrices.vandermonde_rs(8, 4)).stats()
    assert (s["xors_naive"], s["xors_cse"]) == (106, 63)
    assert s["temps"] > 0


def test_random_schedules_equal_jax_and_host_apply():
    rng = np.random.default_rng(5)
    for _ in range(8):
        m, k = int(rng.integers(1, 5)), int(rng.integers(1, 7))
        M = rng.integers(0, 256, (m, k)).astype(np.uint8)
        data = rng.integers(0, 256, (k, 257)).astype(np.uint8)
        sched = xor_schedule.build_schedule(M)
        assert _fields(sched) == _fields(jax_schedule(M)), M
        got = xor_schedule.host_apply(sched, data)
        assert np.array_equal(got, jax_host_apply(jax_schedule(M), data))
        assert np.array_equal(got, gf_matvec_data(M, data))


def test_bit_terms():
    """Term (8i+j) in output r <=> bit j of M[r,i]."""
    terms = xor_schedule.bit_terms(np.array([[1, 2], [3, 255]], np.uint8))
    assert terms[0] == [0, 9]
    assert terms[1][:2] == [0, 1]
    assert [t - 8 for t in terms[1][2:]] == list(range(8))


def test_host_apply_checks_its_input():
    sched = xor_schedule.build_schedule(matrices.vandermonde_rs(4, 2))
    with pytest.raises(ValueError):
        xor_schedule.host_apply(sched, np.zeros((3, 8), np.uint8))


def test_schedule_cached_per_matrix():
    M = matrices.vandermonde_rs(5, 2)
    before = dict(xor_schedule.COUNTERS)
    s1 = xor_schedule.build_schedule(M)
    s2 = xor_schedule.build_schedule(M.copy())
    assert s1 is s2  # keyed on content, not identity
    assert xor_schedule.COUNTERS["xor_schedule_cache_hits"] > \
        before["xor_schedule_cache_hits"]


# -- strategy resolution -------------------------------------------------------

def test_env_override(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_EC_STRATEGY", "bitplane")
    assert TorchEngine("cpu").strategy == "bitplane"
    monkeypatch.setenv("CEPH_TPU_EC_STRATEGY", "logexp")
    assert TorchEngine("cpu", "xor").strategy == "logexp"  # a force
    code = create_erasure_code(
        {"plugin": "jax", "k": "3", "m": "2", "strategy": "xor"},
        device="cpu")
    assert code.engine.strategy == "logexp"
    monkeypatch.setenv("CEPH_TPU_EC_STRATEGY", "warp-drive")
    with pytest.raises(ValueError, match="warp-drive"):
        TorchEngine("cpu")
    monkeypatch.delenv("CEPH_TPU_EC_STRATEGY")
    assert TorchEngine("cpu", "xor").strategy == "xor"


def test_default_is_the_kernel_path():
    """No strategy named: `pallas`, the plain version on a CPU tensor
    (the JAX package's CPU default is `xor`)."""
    eng = TorchEngine("cpu")
    assert eng.strategy == "pallas" == torch_backend.DEFAULT_STRATEGY
    assert set(STRATEGIES) == {
        "xor", "xor_cse", "bitplane", "logexp", "pallas", "auto"}


def test_unknown_strategy_raises_with_the_list():
    with pytest.raises(ValueError, match="pick one of"):
        TorchEngine("cpu", "nope")


def test_auto_resolves_and_caches():
    M = matrices.vandermonde_rs(3, 2)
    data = np.random.default_rng(9).integers(0, 256, (3, 4096)).astype(
        np.uint8)
    want = gf_matvec_data(M, data)
    key = ("cpu", xor_schedule.matrix_key(M))
    torch_backend._AUTOTUNE.pop(key, None)
    before = torch_backend.COUNTERS["autotunes"]
    e1 = TorchEngine("cpu", "auto")
    assert np.array_equal(e1.matmul(M, data), want)
    picked = e1._resolved_strategy
    assert picked in ("xor", "xor_cse", "bitplane", "logexp")
    assert torch_backend.COUNTERS["autotunes"] == before + 1
    rec = torch_backend._AUTOTUNE[key]
    assert rec["strategy"] == picked and e1.autotune[key[1]] is rec
    assert set(rec["measured_gbps"]) == {"xor", "xor_cse", "bitplane",
                                         "logexp"}
    assert rec["measured_gbps"][picked] > 0
    assert rec["sample_bytes"] == 3 * 4096
    e2 = TorchEngine("cpu", "auto")  # a second engine: no new tune
    assert np.array_equal(e2.matmul_batch(M, data[None])[0], want)
    assert torch_backend.COUNTERS["autotunes"] == before + 1


def test_auto_candidate_that_raises_raises(monkeypatch):
    """Where the JAX autotune records a failing candidate and goes on,
    the port raises."""
    M = matrices.vandermonde_rs(2, 2)
    torch_backend._AUTOTUNE.pop(("cpu", xor_schedule.matrix_key(M)), None)

    def broken(*a):
        raise RuntimeError("candidate down")

    monkeypatch.setattr(torch_backend, "matmul_logexp", broken)
    with pytest.raises(RuntimeError, match="candidate down"):
        TorchEngine("cpu", "auto").matmul(M, np.zeros((2, 64), np.uint8))
    assert ("cpu", xor_schedule.matrix_key(M)) not in torch_backend._AUTOTUNE


def test_prepare_builds_once():
    """parse() prepares the encode matrix: its schedule is built there,
    once, and the stripes' calls are cache hits."""
    k, m = 7, 2
    M = matrices.vandermonde_rs(k, m)
    xor_schedule._SCHEDULES.pop(xor_schedule.matrix_key(M), None)
    before = dict(xor_schedule.COUNTERS)
    code = create_erasure_code({"plugin": "jax", "k": str(k), "m": str(m),
                                "strategy": "xor_cse"}, device="cpu")
    mid = dict(xor_schedule.COUNTERS)
    assert mid["xor_schedules_built"] == before["xor_schedules_built"] + 1
    data = np.random.default_rng(3).integers(0, 256, (k, 512)).astype(
        np.uint8)
    code.encode_chunks(data)
    code.encode_chunks(data)
    after = dict(xor_schedule.COUNTERS)
    assert after["xor_schedules_built"] == mid["xor_schedules_built"]
    assert after["xor_schedule_cache_hits"] >= \
        mid["xor_schedule_cache_hits"] + 2
    eng = TorchEngine("cpu", "auto")
    eng.prepare(M)  # auto: schedule, bit-matrix and logexp rows
    assert (xor_schedule.matrix_key(M), torch.device("cpu")) in eng._bitmats
    assert xor_schedule.matrix_key(M) in eng._logexp


# -- every strategy through every plugin: the frozen corpus -------------------

ENTRIES = {e["name"]: e for e in json.loads(CORPUS.read_text())["entries"]}


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_corpus_digests_under_every_strategy(name, strategy):
    entry = ENTRIES[name]
    prof = dict(entry["profile"], strategy=strategy)
    code = create_erasure_code(prof, device="cpu")
    engines = ([layer.code.engine for layer in code.layers]
               if hasattr(code, "layers") else [code.engine])
    assert all(e.strategy == strategy for e in engines)  # lrc: each layer
    L = entry["chunk_bytes"]
    data = ec_corpus._data_for(name, code.k, L)
    enc = _np(code.encode_chunks(data))
    assert ec_corpus._stripe_digest(enc) == entry["digest"]
    n = entry["n_chunks"]
    for case in entry["decode"]:
        erased = case["erased"]
        avail = {i: enc[i] for i in range(n) if i not in erased}
        dec = code.decode_chunks(set(erased), avail, L)
        assert ec_corpus._rebuilt_digest(dec, erased) == case["digest"], \
            (name, strategy, erased)


# -- counters, decode plans, batches --------------------------------------------

def _delta(after: dict, before: dict, keys) -> dict:
    return {k: after[k] - before[k] for k in keys}


def test_rs_counters_equal_jax(monkeypatch):
    """The `ec` counters of ec.rs move as the JAX group's do: the first
    decode of a pattern builds its plan, the repeat hits, a second code
    with the same generator shares it."""
    keys = ("bytes_encoded", "bytes_decoded", "decode_plan_hits",
            "decode_plan_misses")
    prof = {"plugin": "jax", "k": "4", "m": "2", "strategy": "xor"}
    rng = np.random.default_rng(21)
    data = rng.integers(0, 256, (4, 1024)).astype(np.uint8)
    batch = rng.integers(0, 256, (3, 4, 1024)).astype(np.uint8)

    def drive(make):
        c1, c2 = make(), make()
        enc = np.asarray(c1.encode_chunks(data))
        avail = {i: enc[i] for i in range(6) if i not in (1, 4)}
        for c in (c1, c1, c2):
            dec = c.decode_chunks({1, 4}, dict(avail), 1024)
            for i in (1, 4):
                assert np.array_equal(np.asarray(dec[i]), enc[i])
        benc = np.asarray(c1.encode_batch(batch))
        c1.encode_parity(data)
        bdec = c2.decode_batch({0, 5}, {i: benc[:, i] for i in (1, 2, 3, 4)},
                               1024)
        assert np.array_equal(np.asarray(bdec[0]), batch[:, 0])

    # both packages start with no plan, and their caches are given back
    # as they were (other tests count on what the process has planned)
    monkeypatch.setattr(jax_rs, "_DECODE_PLANS", {})
    monkeypatch.setattr(rs, "_DECODE_PLANS", {})
    before = _ec_counters()
    drive(lambda: jax_create(dict(prof)))
    want = _delta(_ec_counters(), before, keys)
    before = dict(rs.COUNTERS)
    drive(lambda: create_erasure_code(dict(prof), device="cpu"))
    got = _delta(rs.COUNTERS, before, keys)
    assert got == want
    assert got["decode_plan_misses"] == got["decode_plan_hits"] == 2
    assert got["bytes_encoded"] > 0 and got["bytes_decoded"] > 0


def test_clay_repair_counters_equal_jax():
    keys = ("bytes_encoded", "repair_bytes", "repair_plan_hits",
            "repair_plan_misses")
    prof = {"plugin": "clay", "k": "4", "m": "2", "d": "5"}
    sub = 8
    data = np.random.default_rng(4).integers(0, 256, (4, 64 * sub)).astype(
        np.uint8)

    def drive(code):
        enc = np.asarray(code.encode_chunks(data))
        need = code.minimum_to_repair({2}, set(range(6)) - {2})
        helpers = {}
        for j, runs in need.items():
            arr = enc[j].reshape(sub, -1)
            planes = [z for ind, cnt in runs for z in range(ind, ind + cnt)]
            helpers[j] = np.ascontiguousarray(arr[planes]).reshape(-1)
        for _ in range(2):
            out = code.repair({2}, dict(helpers), 64 * sub)
            assert np.array_equal(np.asarray(out[2]), enc[2])

    before = _ec_counters()
    drive(jax_create(dict(prof)))
    after = _ec_counters()
    want = _delta(after, before, keys)
    frac = (after["repair_read_fraction"]["sum"]
            - before["repair_read_fraction"]["sum"])
    before = json.loads(json.dumps(clay.COUNTERS))
    drive(create_erasure_code(dict(prof), device="cpu"))
    got = _delta(clay.COUNTERS, before, keys)
    assert got == want
    assert got["repair_plan_misses"] == 1 and got["repair_plan_hits"] == 1
    rf = clay.COUNTERS["repair_read_fraction"]
    assert rf["avgcount"] - before["repair_read_fraction"]["avgcount"] == 2
    assert rf["sum"] - before["repair_read_fraction"]["sum"] == \
        pytest.approx(frac, abs=0)


@pytest.mark.parametrize("strategy", PRODUCTS)
def test_encode_decode_batch_match_per_stripe(strategy):
    code = create_erasure_code(
        {"plugin": "jax", "k": "4", "m": "2", "strategy": strategy},
        device="cpu")
    batch = np.random.default_rng(2).integers(0, 256, (3, 4, 2048)).astype(
        np.uint8)
    enc = np.asarray(code.encode_batch(batch))
    want = np.stack([np.asarray(code.encode_chunks(s)) for s in batch])
    assert np.array_equal(enc, want)
    out = code.decode_batch({0, 5}, {i: enc[:, i] for i in (1, 2, 3, 4)},
                            2048)
    for i in (0, 5):
        assert np.array_equal(np.asarray(out[i]), enc[:, i])
