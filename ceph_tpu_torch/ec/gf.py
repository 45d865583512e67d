"""GF(2^8) arithmetic — the field under every Reed–Solomon code here.

Port of `ceph_tpu/ec/gf.py`.  Field: GF(2^8) with the primitive
polynomial x^8+x^4+x^3+x^2+1 (0x11D), generator α=2, as jerasure's w=8
default and isa-l use.

Host side (numpy): log/antilog tables, scalar ops, matrix multiply and
invert, for code construction and the small decode-matrix inversions.
Device side: `gf_device_tables` (tables as torch tensors, once per
device) and `ec.torch_backend` (the GF matrix product on the card).
"""

from __future__ import annotations

import numpy as np
import torch

PRIM_POLY = 0x11D
FIELD = 256


def _build_tables():
    exp = np.zeros(512, np.uint8)  # doubled so exp[log a + log b] works
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM_POLY
    exp[255:510] = exp[:255]
    log[0] = 512  # sentinel: exp[>=510] unused; callers mask zero operands
    return exp, log


GF_EXP, GF_LOG = _build_tables()

# full 256x256 multiplication table (64 KiB) for vectorized host ops
_a = np.arange(256)
_nz = (_a[:, None] != 0) & (_a[None, :] != 0)
GF_MUL_TABLE = np.where(
    _nz,
    GF_EXP[(GF_LOG[_a][:, None] + GF_LOG[_a][None, :]) % 255],
    0,
).astype(np.uint8)
del _a, _nz


def gf_mul(a, b):
    """Element-wise GF(2^8) product (numpy, any broadcastable shapes)."""
    a = np.asarray(a, np.uint8)
    b = np.asarray(b, np.uint8)
    return GF_MUL_TABLE[a, b]


def gf_inv(a):
    a = int(a)
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    return int(GF_EXP[255 - GF_LOG[a]])


def gf_div(a, b):
    a, b = int(a), int(b)
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by 0")
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] - GF_LOG[b]) % 255])


def gf_pow(a, n):
    a, n = int(a), int(n)
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] * n) % 255])


def gf_matmul(A, B):
    """GF(2^8) matrix product: (n,k)·(k,m) uint8 -> (n,m) uint8.
    XOR-accumulate of table products; fine for the small code matrices."""
    A = np.asarray(A, np.uint8)
    B = np.asarray(B, np.uint8)
    prod = GF_MUL_TABLE[A[:, :, None], B[None, :, :]]  # (n,k,m)
    out = np.zeros((A.shape[0], B.shape[1]), np.uint8)
    for j in range(A.shape[1]):
        out ^= prod[:, j, :]
    return out


def gf_matvec_data(M, data):
    """(m,k) code matrix × (k,L) data bytes -> (m,L) parity bytes (host)."""
    M = np.asarray(M, np.uint8)
    data = np.asarray(data, np.uint8)
    out = np.zeros((M.shape[0], data.shape[1]), np.uint8)
    for j in range(M.shape[1]):
        out ^= GF_MUL_TABLE[M[:, j][:, None], data[j][None, :]]
    return out


def gf_invert_matrix(M):
    """Gauss–Jordan inversion over GF(2^8).  Raises on singular input.
    (The decode-matrix inversion of jerasure_matrix_decode: tiny k×k, it
    stays on the host.)"""
    M = np.array(M, np.uint8)
    n = M.shape[0]
    if M.shape != (n, n):
        raise ValueError(f"square matrix expected, got {M.shape}")
    aug = np.concatenate([M, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = col + int(np.argmax(aug[col:, col] != 0))
        if aug[piv, col] == 0:
            raise np.linalg.LinAlgError("singular GF(2^8) matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        inv = gf_inv(aug[col, col])
        aug[col] = GF_MUL_TABLE[aug[col], inv]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= GF_MUL_TABLE[aug[r, col], aug[col]]
    return aug[:, n:]


# -- device-resident table cache --------------------------------------------

_DEV_TABLES: dict[torch.device, dict] = {}


def gf_device_tables(device) -> dict:
    """GF(2^8) tables as tensors on `device`, uploaded once per device and
    shared by every engine in the process.  Keys: `exp` u8[512], `log`
    int64[256] (log[0] = 0 sentinel; callers mask zero operands), `mul`
    u8[256, 256]."""
    device = torch.device(device)
    t = _DEV_TABLES.get(device)
    if t is None:
        log = np.where(np.arange(256) == 0, 0, GF_LOG).astype(np.int64)
        t = {
            "exp": torch.from_numpy(GF_EXP.copy()).to(device),
            "log": torch.from_numpy(log).to(device),
            "mul": torch.from_numpy(GF_MUL_TABLE.copy()).to(device),
        }
        _DEV_TABLES[device] = t
    return t


# -- bit-plane (GF(2)) representation ---------------------------------------
# Multiplication by a constant c is GF(2)-linear on the 8 bits of the input
# byte, so any GF(2^8) code matrix expands to a bit-matrix over GF(2), as
# jerasure's bitmatrix techniques do.  cauchy_good scores rows by it.

def gf_bitmatrix(c: int) -> np.ndarray:
    """8×8 GF(2) matrix of y = c·x: column j = bits of c·2^j."""
    cols = [int(GF_MUL_TABLE[c, 1 << j]) for j in range(8)]
    out = np.zeros((8, 8), np.uint8)
    for j, v in enumerate(cols):
        for i in range(8):
            out[i, j] = (v >> i) & 1
    return out


def matrix_to_bitmatrix(M: np.ndarray, w: int = 8) -> np.ndarray:
    """(m,k) GF(2^8) matrix -> (8m, 8k) GF(2) matrix (jerasure
    jerasure_matrix_to_bitmatrix semantics for w=8)."""
    if w != 8:
        raise ValueError(f"w={w}: only w=8 is supported")
    M = np.asarray(M, np.uint8)
    m, k = M.shape
    out = np.zeros((8 * m, 8 * k), np.uint8)
    for i in range(m):
        for j in range(k):
            out[8 * i : 8 * i + 8, 8 * j : 8 * j + 8] = gf_bitmatrix(
                int(M[i, j])
            )
    return out
