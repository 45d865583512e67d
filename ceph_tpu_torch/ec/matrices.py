"""Code-matrix constructions for the RS-family techniques.

Port of `ceph_tpu/ec/matrices.py` (host numpy; the port keeps its own
copy).  The constructions follow the published algorithms (Plank's
jerasure papers, the isa-l docs): jerasure's reed_sol_van / reed_sol_r6_op
/ cauchy_orig / cauchy_good and isa's Vandermonde / Cauchy.

All matrices are the m×k *coding* block C of the systematic generator
[I_k; C]: parity = C · data.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ec.gf import (
    GF_MUL_TABLE,
    gf_div,
    gf_inv,
    gf_invert_matrix,
    gf_matmul,
    gf_pow,
    matrix_to_bitmatrix,
)


def vandermonde_rs(k: int, m: int) -> np.ndarray:
    """jerasure reed_sol_van construction: (m+k)×k Vandermonde rows
    [1, i, i², …] column-reduced to systematic form, then column-scaled so
    the first parity row is all ones; returns the bottom m rows."""
    rows = m + k
    if rows > 256:
        raise ValueError("k+m must be <= 256 for w=8")
    V = np.zeros((rows, k), np.uint8)
    for i in range(rows):
        V[i, 0] = 1
        for j in range(1, k):
            V[i, j] = GF_MUL_TABLE[V[i, j - 1], i]

    # column-reduce the top k×k block to identity (elementary column ops
    # over the full column preserve the code)
    for i in range(k):
        if V[i, i] == 0:
            for j in range(i + 1, k):
                if V[i, j]:
                    V[:, [i, j]] = V[:, [j, i]]
                    break
            else:
                raise np.linalg.LinAlgError("vandermonde reduction failed")
        if V[i, i] != 1:
            V[:, i] = GF_MUL_TABLE[V[:, i], gf_inv(V[i, i])]
        for j in range(k):
            if j != i and V[i, j]:
                V[:, j] ^= GF_MUL_TABLE[V[i, j], V[:, i]]

    # scale the parity part of each column so parity row 0 is all ones
    # (valid: equivalent to a bijective per-symbol data transform)
    for j in range(k):
        c = V[k, j]
        if c == 0:
            raise np.linalg.LinAlgError("zero in first parity row")
        if c != 1:
            V[k:, j] = GF_MUL_TABLE[V[k:, j], gf_inv(c)]
    return V[k:].copy()


def rs_r6(k: int) -> np.ndarray:
    """reed_sol_r6_op (RAID-6, m=2): P row all ones, Q row = powers of 2."""
    C = np.zeros((2, k), np.uint8)
    C[0] = 1
    for j in range(k):
        C[1, j] = gf_pow(2, j)
    return C


def cauchy_orig(k: int, m: int) -> np.ndarray:
    """cauchy_original_coding_matrix: C[i,j] = 1/(i ⊕ (m+j))."""
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for w=8")
    C = np.zeros((m, k), np.uint8)
    for i in range(m):
        for j in range(k):
            C[i, j] = gf_inv(i ^ (m + j))
    return C


def _ones_in_bitrow(row: np.ndarray) -> int:
    """Total set bits of a row's bitmatrix expansion: the XOR cost metric
    cauchy_good minimizes."""
    return int(matrix_to_bitmatrix(row[None, :]).sum())


def cauchy_good(k: int, m: int) -> np.ndarray:
    """cauchy_good: cauchy_orig improved for XOR count: scale each column
    so row 0 is all ones, then scale each later row by the divisor among its
    elements that minimizes the bitmatrix ones count."""
    C = cauchy_orig(k, m)
    for j in range(k):
        if C[0, j] != 1:
            C[:, j] = GF_MUL_TABLE[C[:, j], gf_inv(C[0, j])]
    for i in range(1, m):
        best = None
        best_row = None
        for d in C[i]:
            if d in (0, 1):
                continue
            cand = np.array(
                [gf_div(int(v), int(d)) for v in C[i]], np.uint8
            )
            ones = _ones_in_bitrow(cand)
            if best is None or ones < best:
                best, best_row = ones, cand
        if best_row is not None and best < _ones_in_bitrow(C[i]):
            C[i] = best_row
    return C


def isa_rs_vandermonde(k: int, m: int) -> np.ndarray:
    """isa-l gf_gen_rs_matrix coding block: row i = [g^0, g^i, g^2i, …]
    with g=2 (non-reduced Vandermonde; isa-l documents it as unsafe for
    m>2 at some k)."""
    C = np.zeros((m, k), np.uint8)
    for i in range(m):
        for j in range(k):
            C[i, j] = gf_pow(2, i * j)
    return C


def isa_cauchy(k: int, m: int) -> np.ndarray:
    """isa-l gf_gen_cauchy1_matrix coding block: C[i,j] = 1/((k+i) ⊕ j)."""
    C = np.zeros((m, k), np.uint8)
    for i in range(m):
        for j in range(k):
            C[i, j] = gf_inv((k + i) ^ j)
    return C


def generator(C: np.ndarray) -> np.ndarray:
    """Full systematic generator [I_k; C]."""
    k = C.shape[1]
    return np.concatenate([np.eye(k, dtype=np.uint8), C], axis=0)


def is_mds(C: np.ndarray) -> bool:
    """Every k×k submatrix of [I;C] invertible (every choice of k chunks
    decodes), checked directly: each of the C(k+m, k) row choices
    inverted (the sizes here are small)."""
    from itertools import combinations

    m, k = C.shape
    G = generator(C)
    for rows in combinations(range(k + m), k):
        try:
            gf_invert_matrix(G[list(rows)])
        except np.linalg.LinAlgError:
            return False
    return True


def decode_matrix(C: np.ndarray, present_rows: list[int]) -> np.ndarray:
    """Inverse of the generator restricted to `present_rows` (chunk indices
    into [0,k+m)); multiplying it by the surviving chunks reconstructs the
    data chunks: jerasure_matrix_decode's core step."""
    k = C.shape[1]
    G = generator(C)
    return gf_invert_matrix(G[present_rows[:k]])


# recover_matrix is pure in (C, present, want) and sits on every decode;
# the cache keeps each pattern's Gauss–Jordan inversion to one per process.
_RECOVER_CACHE: dict[tuple, np.ndarray] = {}


def recover_matrix(
    C: np.ndarray, present: list[int], want: list[int]
) -> np.ndarray:
    """Rows that rebuild the `want` chunks (data or parity ids) directly
    from the first k `present` chunks: R = G[want] · inv(G[present]).
    Cached per (matrix content, present, want)."""
    C = np.asarray(C, np.uint8)
    key = (C.shape, C.tobytes(), tuple(present), tuple(want))
    R = _RECOVER_CACHE.get(key)
    if R is None:
        inv = decode_matrix(C, present)
        G = generator(C)
        R = gf_matmul(G[list(want)], inv)
        _RECOVER_CACHE[key] = R
    return R.copy()
