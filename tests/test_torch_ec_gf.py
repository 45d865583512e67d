"""The port's GF(2^8) field, code matrices and GF matmul module
(`ceph_tpu_torch.ec.{gf,matrices,torch_backend}`) held against `ceph_tpu`.

Every comparison is byte-exact (np.array_equal on uint8): GF math is
exact integer math.  The Pallas kernel runs in interpret mode, as
tests/test_ec.py runs it on the CPU; the port's side runs the kernel's
plain PyTorch version (a CPU tensor never reaches the CUDA kernel).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ceph_tpu.ec import gf as jgf  # noqa: E402
from ceph_tpu.ec import matrices as jmat  # noqa: E402
from ceph_tpu.ec.jax_backend import JaxEngine, gf_matmul_pallas  # noqa: E402
from ceph_tpu_torch.ec import gf as tgf  # noqa: E402
from ceph_tpu_torch.ec import matrices as tmat  # noqa: E402
from ceph_tpu_torch.ec.torch_backend import (  # noqa: E402
    TorchEngine,
    gf_matmul_cuda,
    gf_matmul_plain,
    product_tables,
)
from tools.ec_corpus import decode_patterns  # noqa: E402

TECHNIQUES = ("vandermonde_rs", "cauchy_orig", "cauchy_good",
              "isa_rs_vandermonde", "isa_cauchy")
KM = ((4, 2), (7, 3), (8, 4))
GENERATORS = [(t, k, m) for t in TECHNIQUES for k, m in KM] + [
    ("rs_r6", 6, 2)
]


def _coding(mod, technique, k, m):
    if technique == "rs_r6":
        return mod.rs_r6(k)
    return getattr(mod, technique)(k, m)


# -- field -------------------------------------------------------------------

def test_field_tables_equal():
    assert np.array_equal(tgf.GF_EXP, jgf.GF_EXP)
    assert np.array_equal(tgf.GF_LOG, jgf.GF_LOG)
    assert np.array_equal(tgf.GF_MUL_TABLE, jgf.GF_MUL_TABLE)


def test_scalar_ops_equal():
    for a in range(256):
        for n in (0, 1, 2, 7, 254, 255, 300):
            assert tgf.gf_pow(a, n) == jgf.gf_pow(a, n)
        if a:
            assert tgf.gf_inv(a) == jgf.gf_inv(a)
            for b in (1, 2, 3, 0x53, 0xFF):
                assert tgf.gf_div(a, b) == jgf.gf_div(a, b)
    with pytest.raises(ZeroDivisionError):
        tgf.gf_inv(0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matrix_ops_equal(seed):
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 256, (5, 7)).astype(np.uint8)
    B = rng.integers(0, 256, (7, 3)).astype(np.uint8)
    assert np.array_equal(tgf.gf_matmul(A, B), jgf.gf_matmul(A, B))
    assert np.array_equal(tgf.gf_mul(A, 7), jgf.gf_mul(A, 7))
    data = rng.integers(0, 256, (7, 333)).astype(np.uint8)
    assert np.array_equal(
        tgf.gf_matvec_data(A, data), jgf.gf_matvec_data(A, data)
    )
    assert np.array_equal(
        tgf.matrix_to_bitmatrix(A), jgf.matrix_to_bitmatrix(A)
    )
    G = jmat.generator(jmat.vandermonde_rs(4, 3))[[0, 2, 4, 6]]
    assert np.array_equal(
        tgf.gf_invert_matrix(G), jgf.gf_invert_matrix(G)
    )


def test_device_tables_cpu():
    t = tgf.gf_device_tables("cpu")
    assert t is tgf.gf_device_tables(torch.device("cpu"))  # cached
    assert np.array_equal(t["mul"].numpy(), jgf.GF_MUL_TABLE)
    assert np.array_equal(t["exp"].numpy(), jgf.GF_EXP)
    assert t["log"].dtype == torch.int64 and int(t["log"][0]) == 0
    assert np.array_equal(t["log"].numpy()[1:], jgf.GF_LOG[1:])


# -- code matrices ------------------------------------------------------------

@pytest.mark.parametrize("technique,k,m", GENERATORS)
def test_generator_equal(technique, k, m):
    C = _coding(tmat, technique, k, m)
    assert C.dtype == np.uint8
    assert np.array_equal(C, _coding(jmat, technique, k, m))
    assert np.array_equal(tmat.generator(C), jmat.generator(C))


@pytest.mark.parametrize("technique,k,m", GENERATORS)
def test_recover_matrix_equal(technique, k, m):
    C = _coding(jmat, technique, k, m)
    n = k + m
    for erased in decode_patterns(n, m):
        present = [i for i in range(n) if i not in erased][:k]
        assert np.array_equal(
            tmat.recover_matrix(C, present, erased),
            jmat.recover_matrix(C, present, erased),
        ), erased


# -- the kernel's module: plain version vs the Pallas kernel ------------------

@pytest.mark.parametrize("k,m,L", [(8, 4, 8192), (7, 3, 4096), (4, 2, 12288)])
def test_plain_equals_pallas(k, m, L):
    rng = np.random.default_rng(11 + k)
    M = rng.integers(0, 256, (m, k)).astype(np.uint8)
    data = rng.integers(0, 256, (k, L)).astype(np.uint8)
    B = jnp.asarray(jgf.matrix_to_bitmatrix(M).astype(np.int8))
    want = np.asarray(gf_matmul_pallas(B, jnp.asarray(data), m))
    got = gf_matmul_plain(M, torch.from_numpy(data))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


def test_plain_equals_engine_pallas_ragged():
    rng = np.random.default_rng(12)
    M = rng.integers(0, 256, (4, 8)).astype(np.uint8)
    data = rng.integers(0, 256, (8, 5000)).astype(np.uint8)
    want = JaxEngine(strategy="pallas").matmul(M, data)
    assert np.array_equal(
        gf_matmul_plain(M, torch.from_numpy(data)).numpy(), want
    )
    eng = TorchEngine("cpu")
    out = eng.matmul(M, data)  # numpy in -> numpy out
    assert isinstance(out, np.ndarray) and np.array_equal(out, want)


def test_plain_equals_engine_pallas_batch():
    rng = np.random.default_rng(13)
    M = rng.integers(0, 256, (4, 8)).astype(np.uint8)
    data = rng.integers(0, 256, (4, 8, 4096)).astype(np.uint8)
    want = JaxEngine(strategy="pallas").matmul_batch(M, data)
    got = TorchEngine("cpu").matmul_batch(M, torch.from_numpy(data))
    assert isinstance(got, torch.Tensor)  # tensors stay tensors
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_plain_indexes_with_long_not_mask():
    """A uint8 index tensor would be a boolean mask in torch; the plain
    version must index by value."""
    M = np.array([[2, 3]], np.uint8)
    data = torch.tensor([[0, 1, 255], [1, 0, 2]], dtype=torch.uint8)
    want = jgf.gf_matvec_data(M, data.numpy())
    assert np.array_equal(gf_matmul_plain(M, data).numpy(), want)


@pytest.mark.parametrize("R,S", [(1, 8), (4, 8), (5, 3), (32, 64)])
def test_product_tables_layout(R, S):
    """The kernel reads word [g][s][x]; byte j is mul(M[4g+j, s], x)."""
    rng = np.random.default_rng(R * 100 + S)
    M = rng.integers(0, 256, (R, S)).astype(np.uint8)
    words = product_tables(M).view("<u4")[..., 0]  # [G, S, 256]
    G = -(-R // 4)
    assert words.shape == (G, S, 256)
    for r in range(4 * G):
        byte = (words[r // 4] >> np.uint32(8 * (r % 4))) & np.uint32(0xFF)
        want = jgf.GF_MUL_TABLE[M[r]] if r < R else np.zeros((S, 256))
        assert np.array_equal(byte, want), r


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the CUDA wrapper raises: only the engine chooses
    the plain version, by where the tensor lives."""
    M = np.ones((4, 8), np.uint8)
    tables = torch.from_numpy(product_tables(M).reshape(-1))
    data = torch.zeros((1, 8, 64), dtype=torch.uint8)
    before = gf_matmul_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        gf_matmul_cuda(tables, data, 4)
    assert gf_matmul_cuda.launches == before


def test_engine_checks_inputs():
    eng = TorchEngine("cpu")
    M = np.ones((2, 4), np.uint8)
    with pytest.raises(TypeError):
        eng.matmul(M, torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        eng.matmul(M, torch.zeros((3, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        eng.matmul_batch(M, torch.zeros((4, 8), dtype=torch.uint8))
