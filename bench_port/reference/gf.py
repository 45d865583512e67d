"""Reed-Solomon over GF(2^8) in plain numpy and torch, without the program.

The field is jerasure's w = 8 (x^8 + x^4 + x^3 + x^2 + 1, 0x11D,
generator 2).  `reed_sol_van` is jerasure's published construction
(reed_sol.c: `reed_sol_vandermonde_coding_matrix`, through
`reed_sol_big_vandermonde_distribution_matrix` and
`reed_sol_extended_vandermonde_matrix`), written from that algorithm.

The checks judge a program's chunks without its coding matrix:
`infer_code` reads the one linear code that a stripe's data and parity
chunks can come from, `off_columns` counts the stripe columns of a
batch whose bytes do not follow that code, and `unrecoverable_sets`
counts the sets of k surviving chunks that cannot give back the data.
`encode` / `apply` compute a product one coefficient at a time by table
lookups; `recover` rebuilds chunks from any k survivors by inverting
their rows of the generator [I; C].
"""

from __future__ import annotations

import numpy as np
import torch

PRIM_POLY = 0x11D


def _tables():
    exp = np.zeros(512, np.int64)
    log = np.zeros(256, np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM_POLY
    exp[255:510] = exp[:255]
    a = np.arange(256)
    nz = (a[:, None] != 0) & (a[None, :] != 0)
    mul = np.where(nz, exp[(log[a][:, None] + log[a][None, :]) % 255], 0)
    return exp, log, mul.astype(np.uint8)


GF_EXP, GF_LOG, MUL = _tables()


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    return int(GF_EXP[255 - GF_LOG[a]])


def extended_vandermonde(rows: int, cols: int) -> np.ndarray:
    """jerasure's extended Vandermonde matrix: row 0 is (1, 0, ..., 0),
    the last row (0, ..., 0, 1), row i between them (1, i, i^2, ...)."""
    V = np.zeros((rows, cols), np.uint8)
    V[0, 0] = 1
    V[rows - 1, cols - 1] = 1
    for i in range(1, rows - 1):
        x = 1
        for j in range(cols):
            V[i, j] = x
            x = int(MUL[x, i])
    return V


def reed_sol_van(k: int, m: int) -> np.ndarray:
    """The m x k coding block C of the systematic generator [I_k; C], as
    jerasure's reed_sol_vandermonde_coding_matrix(k, m, 8) builds it:
    column operations bring the extended Vandermonde matrix's top k rows
    to the identity, each coding column is scaled so that coding row 0
    is all ones, and each later coding row so that its first entry is 1."""
    rows = k + m
    d = extended_vandermonde(rows, k)
    for i in range(1, k):
        j = next((j for j in range(i, rows) if d[j, i]), None)
        if j is None:
            raise np.linalg.LinAlgError("no pivot for column %d" % i)
        if j != i:
            d[[i, j]] = d[[j, i]]
        if d[i, i] != 1:
            d[:, i] = MUL[inv(int(d[i, i])), d[:, i]]
        for j in range(k):
            e = int(d[i, j])
            if j != i and e:
                d[:, j] ^= MUL[e, d[:, i]]
    for j in range(k):
        e = int(d[k, j])
        if e != 1:
            d[k:, j] = MUL[inv(e), d[k:, j]]
    for i in range(k + 1, rows):
        e = int(d[i, 0])
        if e != 1:
            d[i] = MUL[d[i], inv(e)]
    return d[k:].copy()


def matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """(n, k) . (k, m) over the field, both uint8."""
    out = np.zeros((A.shape[0], B.shape[1]), np.uint8)
    for j in range(A.shape[1]):
        out ^= MUL[A[:, j][:, None], B[j][None, :]]
    return out


def invert(M: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over the field."""
    n = M.shape[0]
    aug = np.concatenate([M.astype(np.uint8), np.eye(n, dtype=np.uint8)], 1)
    for col in range(n):
        piv = col + int(np.argmax(aug[col:, col] != 0))
        if aug[piv, col] == 0:
            raise np.linalg.LinAlgError("singular matrix")
        aug[[col, piv]] = aug[[piv, col]]
        aug[col] = MUL[aug[col], inv(int(aug[col, col]))]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= MUL[aug[r, col], aug[col]]
    return aug[:, n:]


def recover(C: np.ndarray, use: list[int], want: list[int]) -> np.ndarray:
    """Rows R with chunks[want] = R . chunks[use], for k survivors `use`."""
    k = C.shape[1]
    G = np.concatenate([np.eye(k, dtype=np.uint8), C])
    return matmul(G[want], invert(G[use]))


def apply(M: np.ndarray, data: torch.Tensor, block: int = 256) -> torch.Tensor:
    """M . data for data u8 [N, S, L] on any device -> u8 [N, R, L],
    a block of stripes at a time."""
    mul = torch.from_numpy(MUL).to(data.device)
    N, _, L = data.shape
    out = torch.zeros((N, M.shape[0], L), dtype=torch.uint8,
                      device=data.device)
    for n0 in range(0, N, block):
        d = data[n0:n0 + block].long()
        for i in range(M.shape[0]):
            acc = out[n0:n0 + block, i]
            for j in range(M.shape[1]):
                if M[i, j]:
                    acc ^= mul[int(M[i, j])][d[:, j]]
    return out


def _independent_columns(D: np.ndarray) -> list[int]:
    """Indices of k columns of the k x L matrix D that are linearly
    independent over the field, the first found in order."""
    k = D.shape[0]
    basis: list[tuple[int, np.ndarray]] = []  # (pivot row, reduced column)
    picked = []
    for c in range(D.shape[1]):
        v = D[:, c].copy()
        for piv, b in basis:
            if v[piv]:
                v ^= MUL[int(v[piv]), b]
        nz = np.flatnonzero(v)
        if len(nz):
            piv = int(nz[0])
            v = MUL[inv(int(v[piv])), v]
            basis.append((piv, v))
            picked.append(c)
            if len(picked) == k:
                return picked
    raise np.linalg.LinAlgError("the stripe's data chunks span less than k")


def infer_code(data: torch.Tensor, parity: torch.Tensor) -> np.ndarray:
    """The m x k matrix C with parity = C . data for one stripe: data u8
    [k, L], parity u8 [m, L].  Read from k independent byte columns; the
    other columns are for `off_columns` to judge."""
    D = data.cpu().numpy()
    P = parity.cpu().numpy()
    cols = _independent_columns(D)
    return matmul(P[:, cols], invert(D[:, cols]))


def off_columns(C: np.ndarray, data: torch.Tensor, out: torch.Tensor,
                parity: torch.Tensor | None = None) -> int:
    """Stripe columns (a stripe's k + m bytes at one offset) of out u8
    [N, k + m, L] with a byte that differs from the systematic code
    [I; C] applied to data u8 [N, k, L] (parity: C . data, if already
    computed)."""
    k = C.shape[1]
    if parity is None:
        parity = apply(C, data)
    off = (out[:, :k] != data).any(1) | (out[:, k:] != parity).any(1)
    return int(off.sum())


def unrecoverable_sets(C: np.ndarray) -> int:
    """Of the sets of k surviving chunks of [I; C], how many cannot give
    back the data (their k rows are singular): 0 for an MDS code."""
    import itertools

    m, k = C.shape
    G = np.concatenate([np.eye(k, dtype=np.uint8), C])
    bad = 0
    for use in itertools.combinations(range(k + m), k):
        try:
            invert(G[list(use)])
        except np.linalg.LinAlgError:
            bad += 1
    return bad
