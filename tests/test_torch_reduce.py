"""The port's row reductions (`ceph_tpu_torch/core/reduce.py`) against
the JAX package's (`ceph_tpu/core/reduce.py`) on the same rows: rows of
OSD ids with ITEM_NONE pads, -1 markers and ids past the OSD count, as
the mapping paths produce them."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu.core import reduce as jax_reduce  # noqa: E402
from ceph_tpu.crush.types import ITEM_NONE  # noqa: E402
from ceph_tpu_torch.core import reduce  # noqa: E402

N_OSD = 37


def rows(seed: int, n: int = 500, w: int = 4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    r = rng.integers(-1, N_OSD + 5, (n, w)).astype(np.int32)
    r[rng.random((n, w)) < 0.2] = ITEM_NONE
    return r


def mask(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed + 100).random(shape) < 0.7


def same(got: torch.Tensor, want) -> None:
    want = np.array(want)
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("masked", [False, True])
def test_osd_histogram(seed, masked):
    r = rows(seed)
    m = mask(seed, r.shape) if masked else None
    for dt, jdt in ((torch.int32, jnp.int32), (torch.int64, jnp.int64)):
        same(reduce.osd_histogram(torch.from_numpy(r), N_OSD,
                                  None if m is None else torch.from_numpy(m),
                                  dtype=dt),
             jax_reduce.osd_histogram(jnp.asarray(r), N_OSD,
                                      None if m is None else jnp.asarray(m),
                                      dtype=jdt))


@pytest.mark.parametrize("masked", [False, True])
def test_weighted_osd_histogram(masked):
    r = rows(2)
    wt = np.random.default_rng(3).integers(0, 1 << 40, len(r)).astype(
        np.float64)
    m = mask(2, r.shape) if masked else None
    same(reduce.weighted_osd_histogram(
        torch.from_numpy(r), torch.from_numpy(wt), N_OSD,
        None if m is None else torch.from_numpy(m)),
        jax_reduce.weighted_osd_histogram(
            jnp.asarray(r), jnp.asarray(wt), N_OSD,
            None if m is None else jnp.asarray(m)))


@pytest.mark.parametrize("masked", [False, True])
def test_result_sizes_and_size_histogram(masked):
    r = rows(4)
    m = mask(4, r.shape) if masked else None
    tm = None if m is None else torch.from_numpy(m)
    jm = None if m is None else jnp.asarray(m)
    same(reduce.result_sizes(torch.from_numpy(r), tm),
         jax_reduce.result_sizes(jnp.asarray(r), jm))
    for max_size in (2, 4):  # clipped, and not
        same(reduce.size_histogram(torch.from_numpy(r), max_size, tm),
             jax_reduce.size_histogram(jnp.asarray(r), max_size, jm))


def test_value_histogram():
    v = np.random.default_rng(5).integers(-2, 12, (300, 3)).astype(np.int32)
    m = mask(5, v.shape)
    for mv in (4, 20):
        same(reduce.value_histogram(torch.from_numpy(v), mv),
             jax_reduce.value_histogram(jnp.asarray(v), mv))
        same(reduce.value_histogram(torch.from_numpy(v), mv,
                                    torch.from_numpy(m)),
             jax_reduce.value_histogram(jnp.asarray(v), mv, jnp.asarray(m)))


def test_row_compares():
    before, after = rows(6, w=3), rows(7, w=3)
    after[::3] = before[::3]  # some rows unchanged
    after[1::3] = before[1::3][:, ::-1]  # some only reordered
    tb, ta = torch.from_numpy(before), torch.from_numpy(after)
    jb, ja = jnp.asarray(before), jnp.asarray(after)
    same(reduce.duplicate_rows(ta), jax_reduce.duplicate_rows(ja))
    same(reduce.moved_in_lanes(tb, ta), jax_reduce.moved_in_lanes(jb, ja))
    same(reduce.changed_rows(tb, ta), jax_reduce.changed_rows(jb, ja))
    m = mask(6, after.shape)
    same(reduce.misplaced_lanes(tb, ta), jax_reduce.misplaced_lanes(jb, ja))
    same(reduce.misplaced_lanes(tb, ta, torch.from_numpy(m)),
         jax_reduce.misplaced_lanes(jb, ja, jnp.asarray(m)))
    assert bool(reduce.duplicate_rows(ta).any())
    assert not bool(reduce.changed_rows(tb, ta)[::3].any())


def test_valid_lanes():
    r = rows(8)
    same(reduce.valid_lanes(torch.from_numpy(r)),
         jax_reduce.valid_lanes(jnp.asarray(r)))
