"""The port's placement numerics (`ceph_tpu_torch.core`) held bit-exact
against `ceph_tpu.core`: the rjenkins hashes, crush_ln over its whole
input domain, stable_mod and the truncating s64 divide.  Tolerance 0:
this is integer arithmetic."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu.core import intmath as jax_intmath  # noqa: E402
from ceph_tpu.core import rjenkins as jax_rjenkins  # noqa: E402
from ceph_tpu.core.lntable import crush_ln_np as jax_crush_ln  # noqa: E402
from ceph_tpu_torch.core import intmath, lntable, rjenkins  # noqa: E402

EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
HASHES = [
    (jax_rjenkins.crush_hash32, rjenkins.crush_hash32),
    (jax_rjenkins.crush_hash32_2, rjenkins.crush_hash32_2),
    (jax_rjenkins.crush_hash32_3, rjenkins.crush_hash32_3),
    (jax_rjenkins.crush_hash32_4, rjenkins.crush_hash32_4),
    (jax_rjenkins.crush_hash32_5, rjenkins.crush_hash32_5),
]


def _args(nargs: int, seed: int) -> list[np.ndarray]:
    """Random u32 lanes, then every combination of the edge values."""
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 1 << 32, (nargs, 4096), dtype=np.uint64)
    grid = np.stack(np.meshgrid(*[EDGES] * nargs)).reshape(nargs, -1)
    return list(np.concatenate([rand, grid], 1).astype(np.uint32))


@pytest.mark.parametrize("nargs", [1, 2, 3, 4, 5])
def test_hashes_equal_jax_package(nargs):
    ref_fn, port_fn = HASHES[nargs - 1]
    args = _args(nargs, seed=nargs)
    want = np.asarray(ref_fn(*args)).astype(np.int64)
    got = port_fn(*[torch.from_numpy(a.astype(np.int64)) for a in args])
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # int32 bit patterns (negative bucket ids) hash as their u32 values
    got32 = port_fn(*[torch.from_numpy(a.view(np.int32)) for a in args])
    np.testing.assert_array_equal(got32.numpy(), want)


def test_hash_scalars_and_jax_backend():
    x, b, r = 0x1234567, -5, 3
    want = int(np.asarray(jax_rjenkins.crush_hash32_3(
        jnp.uint32(x), jnp.uint32(b & 0xFFFFFFFF), jnp.uint32(r), xp=jnp)))
    assert int(rjenkins.crush_hash32_3(x, b, r)) == want


@pytest.mark.parametrize("data", [b"", b"a", b"rbd_data.1234", b"x" * 11,
                                  b"y" * 12, b"object-name-" * 7])
def test_str_hash_equals_jax_package(data):
    assert rjenkins.str_hash_rjenkins(data) == \
        jax_rjenkins.str_hash_rjenkins(data)


def test_crush_ln_whole_domain():
    u = np.arange(1 << 16, dtype=np.uint32)
    want = jax_crush_ln(u).astype(np.int64)
    got = lntable.crush_ln(torch.from_numpy(u.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(lntable.crush_ln_np(u).astype(np.int64),
                                  want)


def test_ln_tables_are_the_reference_tables():
    from ceph_tpu.core.lntable import LL_TBL, RH_LH_TBL

    np.testing.assert_array_equal(lntable.RH_LH_TBL, RH_LH_TBL)
    np.testing.assert_array_equal(lntable.LL_TBL, LL_TBL)


@pytest.mark.parametrize("pg_num", [1, 12, 64, 100, 1000, 4096, 100000])
def test_stable_mod_equals_jax_package(pg_num):
    rng = np.random.default_rng(pg_num)
    x = np.concatenate([rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
                        .astype(np.uint32), EDGES])
    mask = intmath.pg_mask_for(pg_num)
    assert mask == jax_intmath.pg_mask_for(pg_num)
    want = np.asarray(jax_intmath.stable_mod(x, pg_num, mask, xp=jnp))
    got = intmath.stable_mod(torch.from_numpy(x.astype(np.int64)), pg_num,
                             mask)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_div_trunc_s64_negative_numerators():
    rng = np.random.default_rng(7)
    a = -rng.integers(0, 1 << 48, 8192, dtype=np.int64)  # straw2 range
    a[:4] = [0, -1, -(1 << 48), -65535]
    w = rng.integers(1, 1 << 32, 8192, dtype=np.int64)
    w[:4] = [1, 3, 0x10000, 0xFFFFFFFF]
    want = np.asarray(jax_intmath.div_trunc_s64(a, w, xp=jnp))
    got = intmath.div_trunc_s64(torch.from_numpy(a), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), jax_intmath.div_trunc_s64(a, w))
    assert all(intmath.div_trunc_int(int(p), int(q)) == int(g)
               for p, q, g in zip(a[:64], w[:64], got[:64]))


def _magic_test_weights() -> np.ndarray:
    """The weight set of tests/test_core_numerics.py's magic-division
    test: 1..511, powers of two, 2^k +- 1, 1000 random u32 weights."""
    rng = np.random.default_rng(1234)
    return np.concatenate([
        np.arange(1, 512),
        (2 ** np.arange(0, 32, dtype=np.int64)),
        (2 ** np.arange(1, 32, dtype=np.int64)) - 1,
        (2 ** np.arange(1, 32, dtype=np.int64)) + 1,
        rng.integers(1, 2**32, 1000),
    ]).astype(np.int64)


def test_magic_div_consts_equal_jax_package():
    from ceph_tpu.crush.mapper_jax import _magic_div_consts

    from ceph_tpu_torch.crush import soa

    ws = _magic_test_weights()
    words = soa.magic_words(ws.astype(np.uint64))
    for w, word in zip(ws.tolist(), words.tolist()):
        m, l = _magic_div_consts(w)
        assert soa.magic_div_consts(w) == (m, l)
        assert m < 1 << 50 and l <= 32
        assert word == m | l << soa.MAGIC_SHIFT
    assert soa.magic_words(np.zeros(3, np.uint64)).tolist() == [0, 0, 0]


def _packed_cases():
    from test_torch_crush_mapper import CASES

    return sorted(CASES)


@pytest.mark.parametrize("name", _packed_cases())
def test_packed_records_read_back_to_padded_arrays(name):
    """soa.pack_buckets' headers, records and items give back the padded
    CrushArrays fields, every weight-set position included; the buckets
    lie breadth first from the rules' roots, level_ends on level bounds."""
    from test_torch_crush_mapper import port_case

    from ceph_tpu_torch.crush import soa
    from ceph_tpu_torch.crush.types import RuleOp

    A, prog, _, _ = port_case(name)
    pk = soa.pack_buckets(A)
    P = A.positions
    assert pk.records.dtype.itemsize == 16
    assert pk.headers.dtype.itemsize == 32
    np.testing.assert_array_equal(pk.headers["size"], A.size)
    np.testing.assert_array_equal(pk.headers["type"], A.btype)
    np.testing.assert_array_equal(pk.headers["alg"], A.alg)
    assert len(pk.records) == P * int(A.size.sum())
    for s in range(A.n_buckets):
        off, n = int(pk.headers[s]["offset"]), int(A.size[s])
        np.testing.assert_array_equal(pk.items[off:off + n], A.items[s, :n])
        for p in range(P):
            rec = pk.records[P * off + p * n: P * off + (p + 1) * n]
            np.testing.assert_array_equal(rec["arg_id"], A.arg_ids[s, :n])
            np.testing.assert_array_equal(rec["weight"],
                                          A.pos_weights[p, s, :n])
            np.testing.assert_array_equal(
                rec["magic"], soa.magic_words(A.pos_weights[p, s, :n]))
    # breadth first: the rule's root in the first level (with the other
    # rules' roots), level_ends on bucket bounds
    root = -1 - next(int(a1) for op, a1, _ in prog.steps
                     if op == RuleOp.TAKE)
    assert P * int(pk.headers[root]["offset"]) < pk.level_ends[0]
    starts = {P * int(pk.headers[s]["offset"])
              for s in range(A.n_buckets) if A.size[s]}
    assert set(pk.level_ends[:-1]) <= starts
    assert pk.level_ends[-1] == len(pk.records)
    assert list(pk.level_ends) == sorted(pk.level_ends)
