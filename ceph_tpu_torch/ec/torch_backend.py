"""Device engine for GF(2^8) chunk math: the Hopper kernel, its plain
version, and the engine the RS codes call.

Port of `ceph_tpu/ec/jax_backend.py`.  Where the JAX engine lowers the
product parity = M·data through one of several XLA/Pallas strategies,
the port has one: `gf_matmul_cuda`, a CUDA kernel written for sm_90a
(`ec/csrc/gf_matmul.cu`, in place of `gf_matmul_pallas`).  Beside it,
`gf_matmul_plain` computes the same function in torch table lookups.

`TorchEngine` dispatches on where the tensor lives: a CPU tensor goes to
the plain version, a CUDA tensor to the kernel (or the call raises).
There is no fallback from one to the other.  The kernel takes an M of at
most MAX_ROWS x MAX_COLS; a larger M runs as one launch per block of that
size (`gf_matmul_tiled`), the partial products of a row block XORed
together (GF addition is XOR), so every profile the JAX package encodes
runs on the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ceph_tpu_torch import build
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec.gf import GF_MUL_TABLE, gf_device_tables
from ceph_tpu_torch.ec.interface import _to_tensor

MAX_ROWS = 32  # the kernel's limits on M's shape (gf_matmul.cu)
MAX_COLS = 64
_ROWS_PER_GROUP = 4  # output rows packed in one table word
_BLOCKS_PER_SM = 8


def matrix_key(M: np.ndarray) -> tuple:
    """Structural identity of a code matrix (shape + content bytes)."""
    M = np.asarray(M, np.uint8)
    return (M.shape, M.tobytes())


def product_tables(M: np.ndarray) -> np.ndarray:
    """The kernel's tables of M u8[R, S]: u8[G, S, 256, 4] with
    [g, s, x, j] = mul(M[4g + j, s], x) (0 for rows past R), G = ceil(R/4).
    The kernel reads them as little-endian uint32 words [G][S][256]."""
    M = np.asarray(M, np.uint8)
    R, S = M.shape
    G = -(-R // _ROWS_PER_GROUP)
    padded = np.zeros((G * _ROWS_PER_GROUP, S), np.uint8)
    padded[:R] = M
    prod = GF_MUL_TABLE[padded]  # [4G, S, 256]
    return np.ascontiguousarray(
        prod.reshape(G, _ROWS_PER_GROUP, S, 256).transpose(0, 2, 3, 1)
    )


def gf_matmul_plain(M, data: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device:
    out[..., r, l] = XOR over s of mul(M[r, s], data[..., s, l]).

    M: u8[R, S] (numpy); data: u8[..., S, L] -> u8[..., R, L].
    Indices are cast to int64 first: a uint8 index tensor would be read
    as a boolean mask."""
    mul = gf_device_tables(data.device)["mul"].reshape(-1)
    rows = torch.as_tensor(np.asarray(M, np.uint8)).to(data.device).long()
    R, S = rows.shape
    if data.shape[-2] != S:
        raise ValueError(f"data {tuple(data.shape)} does not match M {R}x{S}")
    base = rows * 256  # [R, S]: offset of each coefficient's table row
    out = torch.zeros(
        (*data.shape[:-2], R, data.shape[-1]),
        dtype=torch.uint8, device=data.device,
    )
    for s in range(S):
        idx = base[:, s, None] + data[..., s, None, :].long()  # [..., R, L]
        out ^= mul[idx]
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ec/csrc/gf_matmul.cu")
    lib.gf_matmul_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.gf_matmul_launch.restype = ctypes.c_int
    lib.gf_matmul_error_string.argtypes = [ctypes.c_int]
    lib.gf_matmul_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _max_blocks(device: torch.device) -> int:
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count * _BLOCKS_PER_SM


def gf_matmul_cuda(
    tables: torch.Tensor, data: torch.Tensor, rows: int
) -> torch.Tensor:
    """Launch the kernel: data u8[N, S, L] on the card -> u8[N, rows, L].

    `tables` is `product_tables(M)` as a u8 tensor on the same card.  The
    kernel runs on the current stream, unsynchronised.  Non-contiguous
    views are copied to contiguous memory first; unaligned ones run (the
    kernel falls back to byte loads).  `gf_matmul_cuda.launches` counts
    the launches."""
    if data.device.type != "cuda" or tables.device != data.device:
        raise ValueError(
            f"gf_matmul_cuda: data on {data.device}, tables on "
            f"{tables.device}; both must be on one CUDA device"
        )
    if data.dtype != torch.uint8 or tables.dtype != torch.uint8:
        raise TypeError("gf_matmul_cuda: uint8 tensors expected")
    if data.dim() != 3:
        raise ValueError(f"gf_matmul_cuda: data [N, S, L] expected, got "
                         f"{tuple(data.shape)}")
    N, S, L = data.shape
    if not (1 <= rows <= MAX_ROWS and 1 <= S <= MAX_COLS):
        raise ValueError(
            f"gf_matmul_cuda: {rows}x{S} matrix outside the kernel's "
            f"limits (R <= {MAX_ROWS}, S <= {MAX_COLS})"
        )
    groups = -(-rows // _ROWS_PER_GROUP)
    if tables.numel() != groups * S * 256 * 4 or not tables.is_contiguous():
        raise ValueError("gf_matmul_cuda: tables do not match the matrix")
    data = data.contiguous()
    out = torch.empty((N, rows, L), dtype=torch.uint8, device=data.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(data.device):
        rc = lib.gf_matmul_launch(
            tables.data_ptr(), data.data_ptr(), out.data_ptr(), N, rows, S,
            L, _max_blocks(data.device),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        msg = lib.gf_matmul_error_string(rc).decode()
        raise RuntimeError(f"gf_matmul kernel launch failed: {msg}")
    gf_matmul_cuda.launches += 1
    return out


gf_matmul_cuda.launches = 0


def matrix_blocks(M: np.ndarray):
    """M's blocks of at most MAX_ROWS x MAX_COLS, row block by row block:
    [(r0, [(c0, M[r0:r0 + MAX_ROWS, c0:c0 + MAX_COLS]), ...]), ...]."""
    R, S = M.shape
    return [(r0, [(c0, np.ascontiguousarray(M[r0:r0 + MAX_ROWS,
                                               c0:c0 + MAX_COLS]))
                  for c0 in range(0, S, MAX_COLS)])
            for r0 in range(0, R, MAX_ROWS)]


def gf_matmul_tiled(M: np.ndarray, data: torch.Tensor, product):
    """M u8[R, S] x data u8[N, S, L] -> u8[N, R, L] through `product(Mb,
    db)`, which computes one block Mb (at most MAX_ROWS x MAX_COLS) times
    db u8[N, cols, L].  An M inside the limits is one product call; a
    larger one is one call per block: a row block's partial products are
    XORed (exact: GF addition is XOR), the row blocks concatenated."""
    R, S = M.shape
    if R <= MAX_ROWS and S <= MAX_COLS:
        return product(M, data)
    parts = []
    for _, cols in matrix_blocks(M):
        acc = None
        for c0, Mb in cols:
            p = product(Mb, data[:, c0:c0 + Mb.shape[1]])
            acc = p if acc is None else acc.bitwise_xor_(p)
        parts.append(acc)
    return torch.cat(parts, dim=1)


class TorchEngine:
    """Device GF matmul engine: M u8[R,S] × data u8[S,L] -> u8[R,L].

    Per-matrix kernel tables are built on the host and uploaded once per
    (matrix, device), then reused by every call with that matrix (encode,
    each repeated decode pattern).  Tensors in stay on their device;
    numpy in runs on the engine's device and comes back as numpy.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._tables: dict[tuple, torch.Tensor] = {}

    def _tables_for(self, M: np.ndarray, device: torch.device):
        key = (matrix_key(M), device)
        t = self._tables.get(key)
        if t is None:
            t = torch.from_numpy(product_tables(M).reshape(-1)).to(device)
            self._tables[key] = t
        return t

    def prepare(self, M: np.ndarray) -> None:
        """Profile-registration hook: upload M's tables (each block's, for
        an M past the kernel's limits) before any stripe arrives (called
        at parse() time and for each new decode plan)."""
        if self.device.type == "cuda":
            for _, cols in matrix_blocks(np.asarray(M, np.uint8)):
                for _, Mb in cols:
                    self._tables_for(Mb, self.device)

    def _run(self, M: np.ndarray, d: torch.Tensor) -> torch.Tensor:
        if d.dtype != torch.uint8:
            raise TypeError(f"uint8 data expected, got {d.dtype}")
        if d.shape[-2] != M.shape[1]:
            raise ValueError(
                f"data {tuple(d.shape)} does not match M {M.shape}"
            )
        if d.device.type == "cpu":
            return gf_matmul_plain(M, d)
        if d.device.type == "cuda":
            return gf_matmul_tiled(M, d, lambda Mb, db: gf_matmul_cuda(
                self._tables_for(Mb, d.device), db, Mb.shape[0]))
        raise ValueError(f"unsupported device {d.device}")

    def matmul(self, M: np.ndarray, data):
        """u8[S, L] -> u8[R, L]."""
        M = np.asarray(M, np.uint8)
        if isinstance(data, torch.Tensor):
            return self._run(M, data[None])[0]
        out = self._run(M, _to_tensor(data, self.device)[None])[0]
        return out.cpu().numpy()

    def matmul_batch(self, M: np.ndarray, data):
        """u8[N, S, L] -> u8[N, R, L]: one launch for the whole batch."""
        M = np.asarray(M, np.uint8)
        if np.ndim(data) != 3:
            raise ValueError(f"[N, S, L] expected, got {np.shape(data)}")
        if isinstance(data, torch.Tensor):
            return self._run(M, data)
        return self._run(M, _to_tensor(data, self.device)).cpu().numpy()
