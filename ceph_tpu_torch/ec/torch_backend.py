"""Device engine for GF(2^8) chunk math: the strategies, the Hopper
kernel and its plain version, and the engine the codes call.

Port of `ceph_tpu/ec/jax_backend.py`.  Every strategy computes the same
product parity = M·data, byte for byte; they differ in how it runs
(`STRATEGIES` is the one list of names, the JAX package's):

- `pallas`: `gf_matmul_cuda`, a CUDA kernel written for sm_90a
  (`ec/csrc/gf_matmul.cu`, in place of `gf_matmul_pallas`) on a CUDA
  tensor, and on a CPU tensor its plain version `gf_matmul_plain`, torch
  table lookups.  The kernel takes an M of at most MAX_ROWS x MAX_COLS;
  a larger M runs as one launch per block of that size
  (`gf_matmul_tiled`), the partial products of a row block XORed
  together (GF addition is XOR).  This is the engine's default.
- `bitplane`, `logexp`, `xor`, `xor_cse`: the JAX package's XLA
  programs `_matmul_bitplane`, `_matmul_logexp` and `xor_schedule_fn`
  (over `ec/xor_schedule.py`), written as torch ops: no hand kernel, the
  same ops on either device.  `bitplane`'s product is one
  `torch.matmul` of 0/1 values, exact in the float type it runs in.
- `auto`: the fastest candidate on a sample of the first stripe,
  measured once per (device type, matrix) and kept in `_AUTOTUNE`.

`TorchEngine` dispatches on where the tensor lives, never moving it:
there is no fallback from one device or strategy to another, and a
candidate that raises in `auto` raises out of the call.
"""

from __future__ import annotations

import ctypes
import functools
import os
import time

import numpy as np
import torch

from ceph_tpu_torch import build
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec.gf import (
    GF_LOG,
    GF_MUL_TABLE,
    gf_device_tables,
    matrix_to_bitmatrix,
)
from ceph_tpu_torch.ec.interface import _to_tensor
from ceph_tpu_torch.ec.xor_schedule import (
    XorSchedule,
    build_schedule,
    matrix_key,
)

MAX_ROWS = 32  # the kernel's limits on M's shape (gf_matmul.cu)
MAX_COLS = 64
_ROWS_PER_GROUP = 4  # output rows packed in one table word
_BLOCKS_PER_SM = 8
# byte-axis tile of the bitplane strategy: its 8x bit expansion stays
# O(_BIT_TILE) in memory (the JAX package's default tile)
_BIT_TILE = 1 << 17
# bytes of the byte axis `auto` measures each candidate on
_AUTOTUNE_COLUMNS = 1 << 16

#: name -> how it computes parity = M·data.  The one list of strategy
#: names (the JAX package's); the engine and the CEPH_TPU_EC_STRATEGY
#: override validate against it.
STRATEGIES = {
    "xor": (
        "XOR schedule over virtual byte rows 2^j·data[i], naive term "
        "form (ec/xor_schedule.py): torch ops, one per doubling and XOR."
    ),
    "xor_cse": (
        "Same schedule, CSE form: the temps of Paar's dedup "
        "materialized, fewer XORs."
    ),
    "bitplane": (
        "GF(2) bit-matrix times the data's eight bit planes as one "
        "torch.matmul in a float type that sums 0/1 exactly, mod 2; "
        "byte axis tiled to _BIT_TILE columns."
    ),
    "logexp": (
        "exp[log M + log data] gathers through the device tables, zero "
        "bytes masked, XOR-reduced over k."
    ),
    "pallas": (
        "The hand kernel gf_matmul_cuda (ec/csrc/gf_matmul.cu) on a CUDA "
        "tensor, tiled past 32 x 64; its plain version on a CPU tensor. "
        "The default."
    ),
    "auto": (
        "Measured pick among the device type's candidates on a sample "
        "of the first stripe, cached per matrix in _AUTOTUNE."
    ),
}
# the strategy of an engine that names none (the JAX package's CPU
# default is `xor`; the port's is the kernel's plain version)
DEFAULT_STRATEGY = "pallas"

# the JAX package's `ec` counter of the strategies
COUNTERS: dict[str, int] = {"autotunes": 0}

# measured autotune results: (device type, matrix key) -> record
_AUTOTUNE: dict[tuple, dict] = {}


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


def _bit_dtype(device: torch.device, cols: int) -> torch.dtype:
    """A float type whose matrix product of 0/1 values over `cols`
    bit rows is exact: every partial sum is an integer <= cols.  On the
    card float16 (integers up to 2^11 exact, tensor cores) while cols <=
    2^11, float32 (up to 2^24) otherwise and on the CPU."""
    if device.type == "cuda" and cols <= 1 << 11:
        return torch.float16
    return torch.float32


def bit_matrix(M: np.ndarray, device) -> torch.Tensor:
    """M's GF(2) bit-matrix [8R, 8S] as 0/1 floats on `device`."""
    device = torch.device(device)
    B = matrix_to_bitmatrix(np.asarray(M, np.uint8))
    return torch.from_numpy(B.astype(np.float32)).to(
        device, _bit_dtype(device, B.shape[1]))


def matmul_bitplane(Bbits: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The `bitplane` product (`_matmul_bitplane` of the JAX package):
    Bbits [8R, 8S] 0/1 floats (`bit_matrix`), data u8[..., S, L] ->
    u8[..., R, L].  Row 8s+j of the unpacked operand is bit j of
    data[s]; bit i of output row r is the parity of row 8r+i of the
    product."""
    *lead, S, L = data.shape
    R = Bbits.shape[0] // 8
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = ((data.unsqueeze(-2) >> shifts[:, None]) & 1).reshape(
        *lead, 8 * S, L).to(Bbits.dtype)
    acc = torch.matmul(Bbits, bits)  # [..., 8R, L], integers <= 8S
    acc = (acc.to(torch.int32) & 1).to(torch.uint8).reshape(*lead, R, 8, L)
    return (acc << shifts[:, None]).sum(-2, dtype=torch.uint8)


def matmul_logexp(rows: tuple, data: torch.Tensor) -> torch.Tensor:
    """The `logexp` product (`_matmul_logexp`): M as a tuple of rows of
    ints, data u8[..., S, L] -> u8[..., R, L], through the device
    tables (`gf_device_tables`; log[0] is a sentinel, so zero bytes are
    masked)."""
    tables = gf_device_tables(data.device)
    exp = tables["exp"]
    logd = tables["log"][data.long()]  # [..., S, L]
    nz = data != 0
    out = []
    for row in rows:
        acc = torch.zeros_like(data[..., 0, :])
        for j, c in enumerate(row):
            if c == 0:
                continue
            prod = exp[int(GF_LOG[c]) + logd[..., j, :]]
            acc = acc ^ torch.where(nz[..., j, :], prod, 0)
        out.append(acc)
    return torch.stack(out, dim=-2)


def _xtime(x: torch.Tensor) -> torch.Tensor:
    """GF(2^8)/0x11D doubling of u8 bytes, branch-free: the arithmetic
    shift of the bytes read as int8 spreads bit 7 into the 0x1D mask
    (torch shifts uint8 logically)."""
    mask = (x.view(torch.int8) >> 7).view(torch.uint8) & 0x1D
    return (x << 1) ^ mask


def xor_schedule_fn(sched: XorSchedule, use_cse: bool):
    """The executor of an XOR schedule (`xor_schedule_fn` of the JAX
    package): data u8[..., S, L] -> u8[..., R, L], a leading batch axis
    broadcast through every op."""
    m, k = sched.shape

    def fn(data: torch.Tensor) -> torch.Tensor:
        vals = {}
        for i in range(k):
            v = data[..., i, :]
            vals[8 * i] = v
            for j in range(1, sched.max_power[i] + 1):
                v = _xtime(v)
                vals[8 * i + j] = v
        if use_cse:
            for tid, a, b in sched.ops:
                vals[tid] = vals[a] ^ vals[b]
        outs = []
        for term in (sched.outs if use_cse else sched.terms):
            acc = None
            for t in term:
                acc = vals[t] if acc is None else acc ^ vals[t]
            outs.append(acc if acc is not None
                        else torch.zeros_like(data[..., 0, :]))
        return torch.stack(outs, dim=-2)

    return fn


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TorchEngine:
    """Device GF matmul engine: M u8[R,S] × data u8[S,L] -> u8[R,L].

    Per-matrix constants (kernel tables, bit-matrices, XOR schedules,
    logexp rows) are built once per (matrix, device) and reused by every
    call with that matrix (encode, each repeated decode pattern).
    Tensors in stay on their device; numpy in runs on the engine's
    device and comes back as numpy.

    Strategy (see STRATEGIES): the env var CEPH_TPU_EC_STRATEGY forces
    it, even over a strategy the caller or profile named; then the
    `strategy` argument; then DEFAULT_STRATEGY, the kernel on the card
    and its plain version on the CPU.  An unknown name raises ValueError.
    """

    def __init__(self, device=None, strategy: str | None = None):
        self.device = resolve_device(device)
        env = os.environ.get("CEPH_TPU_EC_STRATEGY")
        if env:
            strategy = env
        if strategy is None:
            strategy = DEFAULT_STRATEGY
        if strategy not in STRATEGIES:
            raise ValueError(
                f"unknown EC strategy {strategy!r}; "
                f"pick one of {sorted(STRATEGIES)}"
            )
        self.strategy = strategy
        self._resolved_strategy = strategy  # the last call's, for "auto"
        self.autotune: dict[tuple, dict] = {}  # matrix key -> record
        self._tables: dict[tuple, torch.Tensor] = {}
        self._bitmats: dict[tuple, torch.Tensor] = {}
        self._logexp: dict[tuple, tuple] = {}

    def _tables_for(self, M: np.ndarray, device: torch.device):
        key = (matrix_key(M), device)
        t = self._tables.get(key)
        if t is None:
            t = torch.from_numpy(product_tables(M).reshape(-1)).to(device)
            self._tables[key] = t
        return t

    def _bitmat(self, M: np.ndarray, device: torch.device):
        key = (matrix_key(M), device)
        B = self._bitmats.get(key)
        if B is None:
            B = bit_matrix(M, device)
            self._bitmats[key] = B
        return B

    def _logexp_rows(self, M: np.ndarray) -> tuple:
        key = matrix_key(M)
        rows = self._logexp.get(key)
        if rows is None:
            rows = tuple(tuple(int(c) for c in r) for r in M)
            self._logexp[key] = rows
        return rows

    def prepare(self, M: np.ndarray) -> None:
        """Profile-registration hook: build the matrix's constants for
        the engine's strategy (the XOR schedule, the bit-matrix, the
        logexp rows; the kernel's tables, each block's past its limits,
        on the card) once, before any stripe arrives.  Called at parse()
        time and for each new decode plan."""
        M = np.asarray(M, np.uint8)
        s = self.strategy
        if s in ("xor", "xor_cse", "auto"):
            build_schedule(M)
        if s in ("bitplane", "auto"):
            self._bitmat(M, self.device)
        if s in ("logexp", "auto"):
            self._logexp_rows(M)
        if s in ("pallas", "auto") and self.device.type == "cuda":
            for _, cols in matrix_blocks(M):
                for _, Mb in cols:
                    self._tables_for(Mb, self.device)

    # -- strategy resolution / autotune ---------------------------------
    @staticmethod
    def _candidates(device: torch.device) -> tuple[str, ...]:
        if device.type == "cpu":
            return ("xor", "xor_cse", "bitplane", "logexp")
        return ("pallas", "bitplane", "xor", "logexp")

    def _resolve(self, M: np.ndarray, d: torch.Tensor) -> str:
        """The concrete strategy for this matrix (autotunes on 'auto')."""
        if self.strategy != "auto":
            return self.strategy
        key = (d.device.type, matrix_key(M))
        rec = _AUTOTUNE.get(key)
        if rec is None:
            rec = self._run_autotune(M, d)
            _AUTOTUNE[key] = rec
        self.autotune[key[1]] = rec
        return rec["strategy"]

    def _run_autotune(self, M: np.ndarray, d: torch.Tensor) -> dict:
        """Time each candidate (a warm call, then one timed call,
        synchronised) on the first stripe's first min(L, 2^16) columns
        and pick the fastest.  A candidate that raises raises here: on
        the card that is a kernel fault, not a slow candidate."""
        sample = d[:1, :, :_AUTOTUNE_COLUMNS]
        nbytes = sample.numel()
        measured: dict[str, float] = {}
        for s in self._candidates(d.device):
            self._dispatch(s, M, sample)
            _synchronize(d.device)
            t0 = time.perf_counter()
            self._dispatch(s, M, sample)
            _synchronize(d.device)
            dt = time.perf_counter() - t0
            measured[s] = round(nbytes / max(dt, 1e-9) / 1e9, 3)
        best = max(measured, key=lambda s: measured[s])
        COUNTERS["autotunes"] += 1
        return {"strategy": best, "measured_gbps": measured,
                "sample_bytes": nbytes}

    # -- dispatch ----------------------------------------------------------
    def _bitplane(self, M: np.ndarray, d: torch.Tensor) -> torch.Tensor:
        """d u8[N, S, L]: one batched product while the batch's bit
        expansion stays under _BIT_TILE bytes of byte axis; past it the
        stripes fold into the byte axis (they are independent) and run
        in tiles of _BIT_TILE columns, so peak memory is O(_BIT_TILE)."""
        N, S, L = d.shape
        R = M.shape[0]
        B = self._bitmat(M, d.device)
        if N * L <= _BIT_TILE:
            return matmul_bitplane(B, d)
        flat = d[0] if N == 1 else d.transpose(0, 1).reshape(S, N * L)
        out = torch.empty((R, N * L), dtype=torch.uint8, device=d.device)
        for c0 in range(0, N * L, _BIT_TILE):
            out[:, c0:c0 + _BIT_TILE] = matmul_bitplane(
                B, flat[:, c0:c0 + _BIT_TILE])
        return out.reshape(R, N, L).transpose(0, 1).contiguous()

    def _dispatch(self, strategy: str, M: np.ndarray,
                  d: torch.Tensor) -> torch.Tensor:
        """parity of d u8[N, S, L] -> u8[N, R, L] by `strategy`."""
        if strategy == "pallas":
            if d.device.type == "cpu":
                return gf_matmul_plain(M, d)
            return gf_matmul_tiled(M, d, lambda Mb, db: gf_matmul_cuda(
                self._tables_for(Mb, d.device), db, Mb.shape[0]))
        if strategy == "bitplane":
            return self._bitplane(M, d)
        if strategy == "logexp":
            return matmul_logexp(self._logexp_rows(M), d)
        if strategy in ("xor", "xor_cse"):
            return xor_schedule_fn(build_schedule(M),
                                   strategy == "xor_cse")(d)
        raise ValueError(f"no product for strategy {strategy!r}")

    def _run(self, M: np.ndarray, d: torch.Tensor) -> torch.Tensor:
        if d.dtype != torch.uint8:
            raise TypeError(f"uint8 data expected, got {d.dtype}")
        if d.shape[-2] != M.shape[1]:
            raise ValueError(
                f"data {tuple(d.shape)} does not match M {M.shape}"
            )
        if d.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {d.device}")
        self._resolved_strategy = self._resolve(M, d)
        return self._dispatch(self._resolved_strategy, M, d)

    def matmul(self, M: np.ndarray, data):
        """u8[S, L] -> u8[R, L]."""
        M = np.asarray(M, np.uint8)
        if isinstance(data, torch.Tensor):
            return self._run(M, data[None])[0]
        out = self._run(M, _to_tensor(data, self.device)[None])[0]
        return out.cpu().numpy()

    def matmul_batch(self, M: np.ndarray, data):
        """u8[N, S, L] -> u8[N, R, L]: one product for the whole batch
        (one kernel launch with `pallas` inside the kernel's limits)."""
        M = np.asarray(M, np.uint8)
        if np.ndim(data) != 3:
            raise ValueError(f"[N, S, L] expected, got {np.shape(data)}")
        if isinstance(data, torch.Tensor):
            return self._run(M, data)
        return self._run(M, _to_tensor(data, self.device)).cpu().numpy()
