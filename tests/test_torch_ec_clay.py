"""The port's Clay code (`ceph_tpu_torch.ec.clay`) held against
`ceph_tpu.ec.clay`, byte for byte.

The JAX side runs its device engine (`backend=jax, strategy=pallas`, the
Pallas kernel in interpret mode), which Clay reaches in its batched
repair.  The port runs on the CPU (`device="cpu"`) with both of its
engines: numpy, and torch, whose products on a CPU tensor are the
kernel's plain PyTorch version.  Inputs are numpy arrays and CPU tensors.

`python tests/test_torch_ec_clay.py` rewrites tests/data/clay_config4.json:
the JAX package's encode digests of BASELINE config 4, Clay(8,4,11), at a
4 MiB stripe and at bench.py's bench_clay size, which chip_smoke.py's
clay_repair phase reproduces on the card.
"""

import functools
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu.ec import create_erasure_code as jax_create  # noqa: E402
from ceph_tpu.ec.interface import (  # noqa: E402
    ErasureCodeProfileError as JaxProfileError,
)
from ceph_tpu_torch.ec import ErasureCodeProfileError  # noqa: E402
from ceph_tpu_torch.ec import clay, create_erasure_code  # noqa: E402
from tools import ec_corpus  # noqa: E402
from ceph_tpu_torch.ec.carry import clay_from_reference  # noqa: E402
from test_clay import CONFIGS  # noqa: E402

CORPUS = ROOT / "tests" / "data" / "ec_corpus.json"
CONFIG4 = ROOT / "tests" / "data" / "clay_config4.json"
BATCHED = [(4, 2, 5), (4, 3, 6), (8, 4, 11)]  # d = k+m-1: no aloof node
ALOOF = [(4, 3, 5), (8, 4, 10)]  # d = k+m-2: one helper left out
BACKENDS = ("numpy", "torch")


def _prof(k, m, d, **kw):
    return {"plugin": "clay", "k": str(k), "m": str(m), "d": str(d), **kw}


@functools.cache
def jax_code(k, m, d):
    return jax_create(_prof(k, m, d, backend="jax", strategy="pallas"))


def port_code(k, m, d, backend):
    return create_erasure_code(_prof(k, m, d, backend=backend), device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _as(x, kind):
    """numpy input, or the same bytes as a CPU tensor."""
    return torch.from_numpy(np.array(x, np.uint8)) if kind == "tensor" else x


def _assert_same(got: dict, want: dict, kind: str):
    assert sorted(got) == sorted(want)
    for i in want:
        assert isinstance(got[i], torch.Tensor) == (kind == "tensor"), i
        assert np.array_equal(_np(got[i]), _np(want[i])), i


@functools.cache
def jax_stripe(k, m, d):
    """(data rows, JAX encoded stripe, chunk size) of a seeded object."""
    code = jax_code(k, m, d)
    cs = code.get_chunk_size(3511)
    data = np.random.default_rng(k * 100 + d).integers(
        0, 256, (k, cs), dtype=np.uint8)
    return data, np.asarray(code.encode_chunks(data)), cs


def repair_helpers(code, enc, lost: int, kind: str) -> dict:
    """The helpers' repair sub-chunks only, as minimum_to_repair names
    them (bench.py::bench_clay's construction)."""
    need = code.minimum_to_repair({lost}, set(range(len(enc))) - {lost})
    out = {}
    for h, runs in need.items():
        arr = _np(enc[h]).reshape(code.sub_chunk_no, -1)
        planes = [z for ind, cnt in runs for z in range(ind, ind + cnt)]
        out[h] = _as(np.ascontiguousarray(arr[planes]).reshape(-1), kind)
    return out


# -- geometry and profiles ----------------------------------------------------

@pytest.mark.parametrize("k,m,d", CONFIGS)
def test_geometry_equal(k, m, d):
    j, p = jax_code(k, m, d), port_code(k, m, d, "numpy")
    for attr in ("q", "t", "nu", "sub_chunk_no", "k", "m", "d"):
        assert getattr(p, attr) == getattr(j, attr), attr
    assert p.get_sub_chunk_count() == j.get_sub_chunk_count()
    assert p.get_alignment() == j.get_alignment()
    assert p.get_chunk_count() == j.get_chunk_count()
    for size in (1, 3511, 4 << 20, 12345678):
        assert p.get_chunk_size(size) == j.get_chunk_size(size)
    assert np.array_equal(p.mds_C, j.mds_C)
    assert np.array_equal(p.pft.C, j.pft.C)


@pytest.mark.parametrize("profile", [
    _prof(4, 2, 7), _prof(4, 2, 3), {"plugin": "clay", "d": "x"},
    _prof(4, 2, 5, technique="liberation"), _prof(200, 60, 259),
])
def test_bad_profile_raises_as_jax(profile):
    with pytest.raises(JaxProfileError):
        jax_create(dict(profile))
    with pytest.raises(ErasureCodeProfileError):
        create_erasure_code(dict(profile), device="cpu")


@pytest.mark.parametrize("technique", ["cauchy_orig", "cauchy_good",
                                       "cauchy"])
def test_techniques_equal(technique):
    prof = _prof(4, 2, 5, technique=technique)
    j = jax_create(dict(prof))
    p = create_erasure_code(dict(prof), device="cpu")
    assert np.array_equal(p.mds_C, j.mds_C)
    data = np.random.default_rng(3).integers(0, 256, (4, 2 * 4 * 32 * 8),
                                             dtype=np.uint8)
    assert np.array_equal(p.encode_chunks(data), j.encode_chunks(data))


# -- encode and decode --------------------------------------------------------

@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("k,m,d", CONFIGS)
def test_encode_equal(k, m, d, kind):
    data, want, cs = jax_stripe(k, m, d)
    for backend in BACKENDS:
        got = port_code(k, m, d, backend).encode_chunks(_as(data, kind))
        assert isinstance(got, torch.Tensor) == (kind == "tensor")
        assert got.shape == (k + m, cs)
        assert np.array_equal(_np(got), want), backend


def decode_patterns(k, m, d):
    """Up to 40 erasure patterns of 1..m lost chunks, chosen as
    tests/test_clay.py chooses them."""
    n = k + m
    pats = [p for e in range(1, m + 1)
            for p in itertools.combinations(range(n), e)]
    if len(pats) > 40:
        rng = np.random.default_rng(n * d)
        pats = [pats[int(j)] for j in rng.choice(len(pats), 40,
                                                 replace=False)]
    return pats


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("k,m,d", CONFIGS)
def test_decode_equal(k, m, d, kind):
    data, enc, cs = jax_stripe(k, m, d)
    j = jax_code(k, m, d)
    p = port_code(k, m, d, "torch" if kind == "tensor" else "numpy")
    n = k + m
    for lost in decode_patterns(k, m, d):
        have = {i: enc[i] for i in range(n) if i not in lost}
        want = j.decode(set(range(n)), dict(have), cs)
        got = p.decode(set(range(n)), {i: _as(c, kind)
                                       for i, c in have.items()}, cs)
        _assert_same(got, want, kind)
        for i in lost:
            assert np.array_equal(_np(got[i]), enc[i]), (lost, i)


# -- repair -------------------------------------------------------------------

@pytest.mark.parametrize("k,m,d", CONFIGS + ALOOF)
def test_repair_surface_equal(k, m, d):
    j, p = jax_code(k, m, d), port_code(k, m, d, "numpy")
    n = k + m
    for node in range(j.q * j.t):
        assert p.get_repair_subchunks(node) == j.get_repair_subchunks(node)
    for lost in range(n):
        for gone in [()] + [(g,) for g in range(n) if g != lost]:
            avail = set(range(n)) - {lost, *gone}
            assert p.is_repair({lost}, avail) == j.is_repair({lost}, avail)
            if j.is_repair({lost}, avail):
                assert (p.minimum_to_repair({lost}, avail)
                        == j.minimum_to_repair({lost}, avail))
            assert (p.minimum_to_decode({lost}, avail)
                    == j.minimum_to_decode({lost}, avail))
    assert (p.minimum_to_decode({0, 1}, set(range(2, n)))
            == j.minimum_to_decode({0, 1}, set(range(2, n))))
    assert not p.is_repair({0, 1}, set(range(2, n)))


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("lost_kind", ["data", "parity"])
@pytest.mark.parametrize("k,m,d", BATCHED + ALOOF)
def test_repair_equal(k, m, d, lost_kind, kind):
    """Both repair paths: batched for d = k+m-1, the aloof per-plane loop
    for d = k+m-2 (one helper left out)."""
    data, enc, cs = jax_stripe(k, m, d)
    j = jax_code(k, m, d)
    lost = 1 if lost_kind == "data" else k + 1
    helpers = repair_helpers(j, enc, lost, "numpy")
    assert len(helpers) == d
    assert (len(helpers) == k + m - 1) == ((k, m, d) in BATCHED)
    want = j.repair({lost}, dict(helpers), cs)
    assert np.array_equal(want[lost], enc[lost])
    for backend in BACKENDS:
        p = port_code(k, m, d, backend)
        got = p.repair({lost}, {h: _as(v, kind) for h, v in helpers.items()},
                       cs)
        _assert_same(got, want, kind)
        assert bool(p._repair_plans) == ((k, m, d) in BATCHED)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_repair_takes_full_helper_chunks(kind):
    data, enc, cs = jax_stripe(8, 4, 11)
    p = port_code(8, 4, 11, "torch")
    helpers = {h: _as(enc[h], kind) for h in range(12) if h != 3}
    got = p.repair({3}, helpers, cs)
    assert np.array_equal(_np(got[3]), enc[3])
    with pytest.raises(ValueError):
        p.repair({3}, {h: v[:-sc] for h, v in helpers.items()
                       for sc in [cs // 64]}, cs)
    with pytest.raises(ValueError):
        p.repair({3, 4}, helpers, cs)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("k,m,d", [(4, 2, 5), (4, 3, 5)])
def test_decode_routes_to_repair(k, m, d, kind):
    data, enc, cs = jax_stripe(k, m, d)
    p = port_code(k, m, d, "torch")
    helpers = repair_helpers(p, enc, 0, kind)
    calls = []
    p.repair = lambda *a, _r=p.repair: calls.append(1) or _r(*a)
    got = p.decode({0}, helpers, cs)
    assert calls and np.array_equal(_np(got[0]), enc[0])
    assert isinstance(got[0], torch.Tensor) == (kind == "tensor")
    want = jax_code(k, m, d).decode({0}, repair_helpers(p, enc, 0, "numpy"),
                                    cs)
    assert np.array_equal(_np(got[0]), want[0])


def test_repair_plan_is_cached(monkeypatch):
    """The second repair of a node reuses its plan: no recover matrix is
    built, and the plan is the same object (one per lost node)."""
    data, enc, cs = jax_stripe(8, 4, 11)
    p = port_code(8, 4, 11, "torch")
    for lost in (2, 2, 9):
        helpers = repair_helpers(p, enc, lost, "tensor")
        first = p._repair_plans.get(lost)
        built = []
        real = clay.matrices.recover_matrix
        monkeypatch.setattr(clay.matrices, "recover_matrix",
                            lambda *a: built.append(a) or real(*a))
        got = p.repair({lost}, helpers, cs)
        monkeypatch.undo()
        assert np.array_equal(_np(got[lost]), enc[lost])
        if first is None:
            assert built
        else:
            assert not built and p._repair_plans[lost] is first
    assert sorted(p._repair_plans) == [2, 9]
    # the plan's index vectors are int64 (a uint8 index would be a mask)
    plan = p._repair_plans[2]
    cpu = plan["device_index"][torch.device("cpu")]
    assert all(v.dtype == torch.int64 for v in cpu.values())
    assert all(v.dtype == np.int64 for v in plan["index"].values())


def test_no_fallback_off_the_host():
    """A tensor off the host given to the numpy engine raises; it is not
    copied to the host ("meta" stands in for a card here)."""
    p = port_code(4, 2, 5, "numpy")
    meta = torch.empty((4, p.get_chunk_size(4096)), dtype=torch.uint8,
                       device="meta")
    with pytest.raises(ValueError, match="numpy engine runs on the host"):
        p.encode_chunks(meta)


def test_carry_matrices():
    j = jax_code(8, 4, 11)
    p = clay_from_reference(_prof(8, 4, 11, backend="torch"), j.mds_C,
                            j.pft.C, device="cpu")
    assert np.array_equal(p.mds_C, j.mds_C) and p.mds_C is not j.mds_C
    data, enc, cs = jax_stripe(8, 4, 11)
    assert np.array_equal(p.encode_chunks(data), enc)
    with pytest.raises(ValueError):
        clay_from_reference(_prof(8, 4, 11), j.mds_C[:, :3], j.pft.C,
                            device="cpu")
    with pytest.raises(TypeError):
        clay_from_reference(_prof(8, 4, 11), j.mds_C, torch.tensor(j.pft.C),
                            device="cpu")


# -- the corpus and config 4 --------------------------------------------------

@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_corpus_clay(backend, kind):
    entry = next(e for e in json.loads(CORPUS.read_text())["entries"]
                 if e["name"] == "clay_k4m2_d5")
    code = create_erasure_code(dict(entry["profile"], backend=backend),
                               device="cpu")
    L, n = entry["chunk_bytes"], entry["n_chunks"]
    data = ec_corpus._data_for(entry["name"], code.k, L)
    enc = code.encode_chunks(_as(data, kind))
    assert ec_corpus._stripe_digest(enc) == entry["digest"]
    assert len(entry["decode"]) >= 5
    for case in entry["decode"]:
        erased = case["erased"]
        dec = code.decode_chunks(
            set(erased), {i: enc[i] for i in range(n) if i not in erased}, L)
        assert ec_corpus._rebuilt_digest(dec, erased) == case["digest"], \
            erased


def config4_stripes() -> list[dict]:
    """BASELINE config 4's stripes: 4 MiB (512 KiB chunks of 64 sub-chunks
    of 8 KiB) and bench.py::bench_clay's 1 MiB chunks, data rows from
    default_rng(1) as bench_clay draws them."""
    return [{"chunk_bytes": 512 << 10, "seed": 1},
            {"chunk_bytes": 1 << 20, "seed": 1}]


def config4_data(stripe: dict) -> np.ndarray:
    return np.random.default_rng(stripe["seed"]).integers(
        0, 256, size=(8, stripe["chunk_bytes"]), dtype=np.uint8)


def test_config4_is_the_jax_package():
    stored = json.loads(CONFIG4.read_text())
    assert stored["profile"] == _prof(8, 4, 11)
    j = jax_create(dict(stored["profile"]))
    p = create_erasure_code(dict(stored["profile"]), device="cpu")
    for stripe in stored["stripes"]:
        data = config4_data(stripe)
        want = np.asarray(j.encode_chunks(data))
        assert ec_corpus._stripe_digest(want) == stripe["digest"]
        assert np.array_equal(p.encode_chunks(data), want)
    # the 4 MiB stripe on CPU tensors: encode, and a repair of chunk 2
    stripe = stored["stripes"][0]
    t = port_code(8, 4, 11, "torch")
    enc = t.encode_chunks(torch.from_numpy(config4_data(stripe)))
    assert ec_corpus._stripe_digest(enc) == stripe["digest"]
    got = t.repair({2}, repair_helpers(t, enc, 2, "tensor"),
                   stripe["chunk_bytes"])
    assert torch.equal(got[2], enc[2])


def write_data() -> None:
    """Rewrite tests/data/clay_config4.json from the JAX package."""
    prof = _prof(8, 4, 11)
    code = jax_create(dict(prof))
    stripes = []
    for stripe in config4_stripes():
        enc = np.asarray(code.encode_chunks(config4_data(stripe)))
        stripes.append(dict(stripe, digest=ec_corpus._stripe_digest(enc)))
        print(stripe, stripes[-1]["digest"])
    CONFIG4.write_text(json.dumps({
        "about": "the JAX package's encode digests (sha256 over the 12 "
                 "chunks in order) of BASELINE config 4, Clay(k=8, m=4, "
                 "d=11), data rows default_rng(seed).integers(0, 256, (8, "
                 "chunk_bytes), uint8); written by `python "
                 "tests/test_torch_ec_clay.py`",
        "profile": prof, "stripes": stripes}, indent=1) + "\n")


if __name__ == "__main__":
    write_data()
