"""Device engine for GF(2^8) chunk math: the strategies, the Hopper
kernel and its plain version, and the engine the codes call.

Port of `ceph_tpu/ec/jax_backend.py`.  Every strategy computes the same
product parity = M·data, byte for byte; they differ in how it runs
(`STRATEGIES` is the one list of names, the JAX package's):

- `pallas`: `gf_matmul_cuda`, a CUDA kernel written for sm_90a
  (`ec/csrc/gf_matmul.cu`, in place of `gf_matmul_pallas`) on a CUDA
  tensor, and on a CPU tensor its plain version `gf_matmul_plain`, torch
  table lookups.  One launch computes any M of up to KERNEL_COLS columns,
  and one launch runs a whole list of products (`ProductList`,
  `gf_grouped_cuda`; plain version `gf_grouped_plain`), which Clay's
  layered plans use.  This is the engine's default.
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
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ceph_tpu_torch import build, obs
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
from ceph_tpu_torch.utils import knobs
from ceph_tpu_torch.utils.perf_counters import counters_attr

# the block shape of `matrix_blocks`: `gf_matmul_tiled` runs a wide M as
# products of such blocks, the reference of the kernel's one-launch product
MAX_ROWS = 32
MAX_COLS = 64
KERNEL_COLS = 256  # input rows of one product (gf_matmul.cuh kMaxCols)
BASE1 = 1 << 62  # a row offset from a list's second buffer (kBase1)
_ROWS_PER_GROUP = 4  # output rows packed in one table word
_CHUNK = 4096  # bytes of a row per work item (kChunk)
_FIELDS = 11  # columns of a product's descriptor row (kFields)
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
        "tensor, one launch per product or list of products; its plain "
        "version on a CPU tensor.  The default."
    ),
    "auto": (
        "Measured pick among the device type's candidates on a sample "
        "of the first stripe, cached per matrix in _AUTOTUNE."
    ),
}
# the strategy of an engine that names none (the JAX package's CPU
# default is `xor`; the port's is the kernel's plain version)
DEFAULT_STRATEGY = "pallas"

_L = obs.logger_for("ec")
_L.add_u64("autotunes", "measured strategy autotunes (one per matrix)")


# the kernel's launches, enqueue times and first-call build
def _gf_work(work: tuple[int, int]) -> tuple[int, int]:
    """(bytes, operations) of one launch: its list's, reckoned when the
    list was packed (`_pack`): inputs, tables and outputs each moved once,
    and its GF(2^8) multiply-accumulates."""
    return work


_GF_ACCT = obs.LaunchAccount(_L, "gf_matmul", "ec/csrc/gf_matmul.cu",
                             span="ec.gf_matmul", work=_gf_work)
__getattr__ = counters_attr("ec", __name__, ("autotunes",))

# measured autotune results: (device type, matrix key) -> record
_AUTOTUNE: dict[tuple, dict] = {}


def product_tables(M: np.ndarray) -> np.ndarray:
    """The kernel's tables of M u8[R, S]: u8[G, S, 256, 4] with
    [g, s, x, j] = mul(M[4g + j, s], x) (0 for rows past R), G = ceil(R/4).
    The kernel reads them as little-endian uint32 words [G][S][256], of
    which it stages words x < 16 and x = 16 v in shared memory (its nibble
    tables, gf_matmul.cuh)."""
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


class Product(NamedTuple):
    """One product of a launch's list: M u8[R, S] times its S input rows
    into its R output rows, each row `length` bytes.  A row is a byte
    offset from the first of the launch's two buffers, or with BASE1 set
    from the second."""
    M: np.ndarray
    ins: tuple
    outs: tuple
    length: int


def _pack(entries, table_bytes: int):
    """The kernel's descriptor of a list: entries (R, S, table word index,
    ins, outs, N, L, in_stride, out_stride) -> (desc int64 [P, _FIELDS],
    rows int64, items, widest S, (bytes, operations)).  Columns as
    gf_matmul.cuh's Field enum; `table_bytes`, the tables' bytes the
    launch reads, count in its bytes.  A `ProductList`'s products are one
    stripe each (N = 1); gf_matmul_cuda's one product has N stripes, its
    rows in_stride and out_stride bytes on from one stripe to the next."""
    desc, rows = [], []
    items = max_cols = nbytes = ops = 0
    for R, S, tab, ins, outs, N, L, in_stride, out_stride in entries:
        chunks = -(-L // _CHUNK)
        aligned = all(v % 16 == 0 for v in (L, in_stride, out_stride,
                                            *(int(r) & (BASE1 - 1)
                                              for r in (*ins, *outs))))
        desc.append((items, R, S, N, L, in_stride, out_stride, len(rows),
                     tab, chunks, int(aligned)))
        rows.extend(ins)
        rows.extend(outs)
        items += -(-R // _ROWS_PER_GROUP) * N * chunks
        max_cols = max(max_cols, S)
        nbytes += N * (S + R) * L
        ops += N * R * S * L
    if items >= 1 << 31:
        raise ValueError(f"a list of {items} items of {_CHUNK} bytes: the "
                         f"kernel walks fewer than 2^31 in one launch")
    return (np.asarray(desc, np.int64).reshape(-1, _FIELDS),
            np.asarray(rows, np.int64), items, max_cols,
            (nbytes + table_bytes, ops))


def _row_spans(p: Product, rows):
    """(buffer, start, end) of each row."""
    for row in rows:
        start = int(row) & (BASE1 - 1)
        yield int(row) >> 62, start, start + p.length


def _hazard(products: list[Product]) -> str | None:
    """Where a product of the list touches bytes that it or another
    product writes, or None: the kernel runs a list's products at once,
    in no order."""
    spans = []  # (buffer, start, end, writes, product)
    for i, p in enumerate(products):
        spans += [(*s, False, i) for s in _row_spans(p, p.ins)]
        spans += [(*s, True, i) for s in _row_spans(p, p.outs)]
    spans.sort()
    ends = {}  # buffer -> (end of any span so far, of any write so far)
    for buf, start, end, writes, i in spans:
        any_end, write_end = ends.get(buf, (0, 0))
        if start < write_end or (writes and start < any_end):
            return f"product {i} at byte {start} of buffer {buf}"
        ends[buf] = (max(any_end, end), max(write_end, end) if writes
                     else write_end)
    return None


class ProductList:
    """One launch's list of products (`Product`), packed once: its
    descriptor, row offsets and tables (one copy per distinct M), and
    their copies on each device they were used on (`on`).  The products
    must be free of hazards (no bytes read or written by one product are
    written by another), which is checked here: on the card they run at
    once, in no order.  A caller that runs the same list again (Clay's
    plans) keeps it; each run passes only the buffers."""

    def __init__(self, products):
        self.products = [p for p in products if p.length]
        where = _hazard(self.products)
        if where is not None:
            raise ValueError(f"ProductList: a hazard: {where}")
        words, tables, entries = {}, [], []
        size = 0
        for p in self.products:
            M = np.asarray(p.M, np.uint8)
            R, S = M.shape
            if not (R >= 1 and 1 <= S <= KERNEL_COLS and len(p.ins) == S
                    and len(p.outs) == R and p.length > 0):
                raise ValueError(f"ProductList: a product of M {M.shape}, "
                                 f"{len(p.ins)} inputs, {len(p.outs)} "
                                 f"outputs of {p.length} bytes")
            key = matrix_key(M)
            if key not in words:
                words[key] = size
                tables.append(product_tables(M).view("<u4").reshape(-1))
                size += tables[-1].size
            entries.append((R, S, words[key], p.ins, p.outs, 1, p.length,
                            0, 0))
        self.tables = (np.concatenate(tables) if tables
                       else np.zeros(1, np.uint32))
        # the table words the kernel reads: 32 per (group, input row)
        read = sum(-(-R // 4) * S * 128 for R, S, *_ in entries)
        (self.desc, self.rows, self.items, self.max_cols,
         self.work) = _pack(entries, read)
        # bytes of each buffer the list reaches into, and whether it
        # reaches into the second at all
        self.extent = [0, 0]
        for p in self.products:
            for buf, _, end in _row_spans(p, (*p.ins, *p.outs)):
                self.extent[buf] = max(self.extent[buf], end)
        self._on: dict[torch.device, tuple] = {}

    def on(self, device: torch.device) -> tuple:
        """(desc, rows, tables) on `device`, uploaded at its first use."""
        got = self._on.get(device)
        if got is None:
            got = self._on[device] = tuple(
                torch.from_numpy(a).to(device)
                for a in (self.desc, self.rows, self.tables))
        return got


def _buffers(plist: ProductList, b0: torch.Tensor, b1):
    """The list's two buffers as flat u8 tensors, checked: on one device,
    contiguous, long enough, and not overlapping when both are used."""
    b1 = b0 if b1 is None else b1
    for b in (b0, b1):
        if b.dtype != torch.uint8 or not b.is_contiguous():
            raise TypeError("gf grouped: contiguous uint8 buffers expected")
    if b1.device != b0.device:
        raise ValueError(f"gf grouped: buffers on {b0.device} and "
                         f"{b1.device}")
    b0, b1 = b0.reshape(-1), b1.reshape(-1)
    if b0.numel() < plist.extent[0] or b1.numel() < plist.extent[1]:
        raise ValueError(f"gf grouped: buffers of {b0.numel()} and "
                         f"{b1.numel()} bytes, the list reaches "
                         f"{plist.extent}")
    if plist.extent[1] and b0.numel() and b1.numel():
        p0, p1 = b0.data_ptr(), b1.data_ptr()
        if p0 < p1 + b1.numel() and p1 < p0 + b0.numel():
            raise ValueError("gf grouped: the two buffers overlap")
    return b0, b1


def _row_view(b0, b1, row: int, length: int):
    """Row `row` of buffer b0 or b1 (BASE1), `length` bytes."""
    start = int(row) & (BASE1 - 1)
    return (b1 if int(row) & BASE1 else b0)[start:start + length]


def _inputs(p: Product, b0, b1) -> torch.Tensor:
    """A product's input rows as u8[1, S, L]."""
    return torch.stack([_row_view(b0, b1, row, p.length)
                        for row in p.ins])[None]


def gf_grouped_plain(plist: ProductList, b0: torch.Tensor, b1=None,
                     product=gf_matmul_plain) -> None:
    """The plain version of a grouped launch, on any device: every
    product of the list computed by `product(M, X)` (X u8[1, S, L] -> u8[1,
    R, L]) from the buffers as they are, then every result written into
    its rows, in list order.  A list whose products depend on one another
    gives other bytes here than in order, as on the card."""
    b0, b1 = _buffers(plist, b0, b1)
    results = [product(p.M, _inputs(p, b0, b1)) for p in plist.products]
    for p, Y in zip(plist.products, results):
        for r, row in enumerate(p.outs):
            _row_view(b0, b1, row, p.length).copy_(Y[0, r])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _GF_ACCT.load(lambda: build.load("ec/csrc/gf_matmul.cu"))
    p = ctypes.c_void_p
    lib.gf_matmul_launch.argtypes = [
        p, p, p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, p, p,
        ctypes.c_int, p,
    ]
    lib.gf_matmul_launch.restype = ctypes.c_int
    lib.gf_matmul_prepare.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.gf_matmul_prepare.restype = ctypes.c_int
    lib.gf_matmul_error_string.argtypes = [ctypes.c_int]
    lib.gf_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().gf_matmul_error_string(rc).decode()
        raise RuntimeError(f"gf_matmul kernel {what} failed: {msg}")


@functools.cache
def _blocks(device: torch.device, max_cols: int) -> int:
    """The blocks that fit on all the SMs of `device` at once, for a list
    whose widest product has `max_cols` inputs."""
    per_sm, sms = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        _check(_lib().gf_matmul_prepare(max_cols, ctypes.byref(per_sm),
                                        ctypes.byref(sms)), "prepare")
    if per_sm.value < 1:
        raise RuntimeError(f"gf_matmul kernel: no block of {max_cols} "
                           f"input rows fits on an SM of {device}")
    return per_sm.value * sms.value


def _grid(device: torch.device, max_cols: int, items: int) -> int:
    """The persistent grid of a list of `items` items: the blocks that
    fit, or, where the items take more than one round of those, the
    fewest blocks that take them in the same number of rounds, so that
    every block takes as many items as the next (at (a), 512 items in 256
    blocks of 2, not 396 blocks of which 116 take a second item alone)."""
    rounds = max(1, -(-items // _blocks(device, max_cols)))
    return max(1, -(-items // rounds))


def _launch(desc, rows, tables, n_products: int, items: int,
            max_cols: int, b0: torch.Tensor, b1: torch.Tensor,
            work: tuple[int, int]) -> None:
    lib = _lib()
    with torch.cuda.device(b0.device):
        rc = _GF_ACCT.launch(
            lib.gf_matmul_launch, desc.data_ptr(), rows.data_ptr(),
            tables.data_ptr(), n_products, items, max_cols, b0.data_ptr(),
            b1.data_ptr(), _grid(b0.device, max_cols, items),
            torch.cuda.current_stream().cuda_stream, shape=work)
    _check(rc, "launch")


def _single_desc(rows: int, S: int, N: int, L: int):
    """The descriptor of gf_matmul_cuda's one product: input row s at s *
    L of the data, output row r at r * L of the output (the second
    buffer), stripes S * L and rows * L apart -> (desc, row offsets,
    items, work)."""
    desc, offs, items, _, work = _pack(
        [(rows, S, 0, [s * L for s in range(S)],
          [BASE1 | r * L for r in range(rows)], N, L, S * L, rows * L)],
        -(-rows // 4) * S * 128)
    return desc, offs, items, work


@functools.lru_cache(maxsize=256)
def _single(device: torch.device, rows: int, S: int, N: int, L: int):
    """`_single_desc` on `device`."""
    desc, offs, items, work = _single_desc(rows, S, N, L)
    return (torch.from_numpy(desc).to(device),
            torch.from_numpy(offs).to(device), items, work)


def gf_matmul_cuda(
    tables: torch.Tensor, data: torch.Tensor, rows: int
) -> torch.Tensor:
    """Launch the kernel on one product: data u8[N, S, L] on the card ->
    u8[N, rows, L], for any rows and S <= KERNEL_COLS (a list of one).

    `tables` is `product_tables(M)` as a u8 tensor on the same card.  The
    kernel runs on the current stream, unsynchronised.  Non-contiguous
    views are copied to contiguous memory first; unaligned ones run (the
    kernel loads their rows byte by byte).  `gf_matmul_cuda.launches`
    counts the launches of the kernel, this wrapper's and
    `gf_grouped_cuda`'s: it is the kernel's count in the kernel registry
    (`obs.executables`), which each launch books with its bytes and
    operations."""
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
    if not (rows >= 1 and 1 <= S <= KERNEL_COLS):
        raise ValueError(
            f"gf_matmul_cuda: {rows}x{S} matrix outside the kernel's "
            f"limits (S <= {KERNEL_COLS})"
        )
    groups = -(-rows // _ROWS_PER_GROUP)
    if tables.numel() != groups * S * 256 * 4 or not tables.is_contiguous():
        raise ValueError("gf_matmul_cuda: tables do not match the matrix")
    data = data.contiguous()
    out = torch.empty((N, rows, L), dtype=torch.uint8, device=data.device)
    if out.numel() == 0:
        return out
    desc, offs, items, work = _single(data.device, rows, S, N, L)
    _launch(desc, offs, tables, 1, items, S, data, out, work)
    return out


gf_matmul_cuda = _GF_ACCT.entry(gf_matmul_cuda)


def gf_grouped_cuda(plist: ProductList, b0: torch.Tensor,
                    b1: torch.Tensor | None = None) -> None:
    """Launch the kernel once on a list of products (`ProductList`), in
    place on the buffers b0 and b1 (contiguous u8 on one card; b1 only
    where the list uses it), on the current stream, unsynchronised.  The
    list's descriptor and tables go to the card at its first launch
    there.  Counted with gf_matmul_cuda's launches."""
    if b0.device.type != "cuda":
        raise ValueError(f"gf_grouped_cuda: buffers on {b0.device}; they "
                         f"must be on a CUDA device")
    b0, b1 = _buffers(plist, b0, b1)
    if plist.items == 0:
        return
    desc, rows, tables = plist.on(b0.device)
    _launch(desc, rows, tables, len(plist.products), plist.items,
            plist.max_cols, b0, b1, plist.work)


gf_grouped_cuda = _GF_ACCT.entry(gf_grouped_cuda)


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
    db u8[N, cols, L]: the blocks' products XORed on the host (exact: GF
    addition is XOR), the row blocks concatenated.  The reference a wide
    product in one launch is held to; an M inside the block is one
    product call."""
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
        env = knobs.get("CEPH_TPU_EC_STRATEGY")
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
        self._list_pick: str | None = None  # the running list's strategy
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
        logexp rows; the kernel's tables on the card) once, before any stripe arrives.  Called at parse()
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
            self._tables_for(M, self.device)

    # -- strategy resolution / autotune ---------------------------------
    @staticmethod
    def _candidates(device: torch.device) -> tuple[str, ...]:
        if device.type == "cpu":
            return ("xor", "xor_cse", "bitplane", "logexp")
        return ("pallas", "bitplane", "xor", "logexp")

    def _resolve(self, M: np.ndarray, d: torch.Tensor) -> str:
        """The concrete strategy for this matrix (autotunes on 'auto'),
        or the one of the list being run (`matmul_grouped`)."""
        if self.strategy != "auto":
            return self.strategy
        if self._list_pick is not None:
            return self._list_pick
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
        _L.inc("autotunes")
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
            return gf_matmul_cuda(self._tables_for(M, d.device), d,
                                  M.shape[0])
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
        with obs.span("ec.gf_dispatch", rows=int(M.shape[0]),
                      stripes=int(d.shape[0]),
                      strategy=self._resolved_strategy):
            return self._dispatch(self._resolved_strategy, M, d)

    def matmul(self, M: np.ndarray, data):
        """u8[S, L] -> u8[R, L].  Numpy in is uploaded to the engine's
        device and its result copied back (`ec.gf_fetch_seconds`)."""
        M = np.asarray(M, np.uint8)
        with obs.span("ec.gf_matmul", rows=int(M.shape[0]),
                      bytes=math.prod(np.shape(data))):
            if isinstance(data, torch.Tensor):
                return self._run(M, data[None])[0]
            out = self._run(M, _to_tensor(data, self.device)[None])[0]
        return obs.timed_fetch(_L, "gf", out)

    def matmul_batch(self, M: np.ndarray, data):
        """u8[N, S, L] -> u8[N, R, L]: one product for the whole batch
        (one kernel launch with `pallas` inside the kernel's limits)."""
        M = np.asarray(M, np.uint8)
        if np.ndim(data) != 3:
            raise ValueError(f"[N, S, L] expected, got {np.shape(data)}")
        with obs.span("ec.gf_matmul_batch", rows=int(M.shape[0]),
                      stripes=int(np.shape(data)[0]),
                      bytes=math.prod(np.shape(data))):
            if isinstance(data, torch.Tensor):
                return self._run(M, data)
            out = self._run(M, _to_tensor(data, self.device))
        return obs.timed_fetch(_L, "gf_batch", out)

    def matmul_grouped(self, plist: ProductList, base0: torch.Tensor,
                       base1: torch.Tensor | None = None) -> None:
        """Run a list of products (`ProductList`) in place on the buffers
        base0 and base1 (contiguous u8 tensors, which stay on their
        device), under one strategy (`list_strategy`).  With `pallas` on
        the card it is one kernel launch (`gf_grouped_cuda`); otherwise
        `gf_grouped_plain`, each product one call of this engine's product
        under that strategy (`_run`: the kernel's plain version on the
        CPU, the strategy's own product elsewhere)."""
        strategy = self.list_strategy(plist, base0, base1)
        if strategy == "pallas" and base0.device.type == "cuda":
            self._resolved_strategy = strategy
            with obs.span("ec.gf_dispatch", products=len(plist.products),
                          strategy=strategy):
                gf_grouped_cuda(plist, base0, base1)
            return
        self._list_pick = strategy
        try:
            gf_grouped_plain(plist, base0, base1, product=self._run)
        finally:
            self._list_pick = None

    def list_strategy(self, plist: ProductList, base0: torch.Tensor,
                      base1: torch.Tensor | None = None) -> str:
        """The one strategy a list of products runs under: the engine's,
        or under `auto` the one its largest product (most bytes times
        coefficients) resolves to, autotuned once per matrix on that
        product's rows.  So a list `auto` gives the kernel is one launch,
        as under `pallas`."""
        if self.strategy != "auto" or not plist.products:
            return self.strategy
        p = max(plist.products, key=lambda p: p.M.size * p.length)
        b0, b1 = _buffers(plist, base0, base1)
        return self._resolve(np.asarray(p.M, np.uint8), _inputs(p, b0, b1))
