"""The GF(2^8) product kernel's body and work-list walk
(`ec/csrc/gf_matmul.cuh`), built for the host with g++ (`__host__` /
`__device__` defined empty), held byte-exact against the grouped plain
version (`torch_backend.gf_grouped_plain`), the plain product
(`gf_matmul_plain`) and the JAX package's `gf_matmul_pallas` (interpreted,
as the JAX tests run it on the CPU, through `JaxEngine(strategy="pallas")`,
which pads a ragged row).

nvcc builds the same file into the kernel on the card, as
`tests/test_torch_crush_kernel_host.py` does for the rule kernel's body.
Here a shim walks a list's items as a grid of `grid` blocks walks them
(block b takes items b, b + grid, ..., found as the kernel's walk finds
them; a block stages its tables when its matrix or group of rows
changes), and each of a block's 256 lanes loads
its 16 bytes of a slab's rows into a tile, as the ring does on the card.
Every list is one `ProductList`: its descriptor, row offsets and tables
are what the kernel gets.  Inputs come from numpy with a seed.  Skips,
with the reason, where g++ is missing.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu.ec.jax_backend import JaxEngine  # noqa: E402
from ceph_tpu_torch.ec import torch_backend as tb  # noqa: E402
from ceph_tpu_torch.ec.torch_backend import (  # noqa: E402
    BASE1,
    Product,
    ProductList,
)

CSRC = ROOT / "ceph_tpu_torch" / "ec" / "csrc"

SHIM = r"""
#include <string.h>

#include "gf_matmul.cuh"

using namespace gf;

extern "C" void gf_matmul_host(const int64_t* desc, const int64_t* rows,
                               const uint32_t* tables, int n_products,
                               long long total, uint8_t* b0, uint8_t* b1,
                               int grid) {
    // a block's shared memory: its tables, a stage of the ring, an output
    // tile; and its lanes' accumulators
    alignas(16) static uint8_t tab[kMaxCols * kTabBytes];
    alignas(16) static uint8_t tile[kStage];
    alignas(16) static uint8_t out_tile[kGroup * kChunk];
    static uint32_t acc[kThreads][kVec];
    for (int block = 0; block < grid; ++block) {
        int64_t staged = -1;
        Walk w;
        walk_start(w, desc, rows, n_products, total, block, grid);
        for (; w.valid; walk_step(w, desc, rows, n_products, total, grid)) {
            if (table_start(w) != staged) {
                stage_tables(reinterpret_cast<uint32_t*>(tab), tables, w,
                             0, 1);
                staged = table_start(w);
            }
            const int S = static_cast<int>(w.d[kCols]);
            const int n = chunk_bytes(w);
            memset(acc, 0, sizeof acc);
            for (int s0 = 0; s0 < S; s0 += kSlab) {
                const int m = S - s0 < kSlab ? S - s0 : kSlab;
                // the bulk copy of each row, then the lanes' rest
                for (int r = 0; r < m; ++r) {
                    const uint8_t* src = in_row(w, b0, b1, s0 + r);
                    const int bulk = bulk_bytes(src, n);
                    memcpy(tile + r * kChunk, src, bulk);
                    for (int lo = 0; lo < n; lo += kVec) {
                        if (lo + kVec <= bulk) continue;
                        uint32_t v[4];
                        load16(src + lo, n - lo < kVec ? n - lo : kVec, v);
                        memcpy(tile + r * kChunk + lo, v, kVec);
                    }
                }
                for (int lane = 0; lane < kThreads; ++lane)
                    lane_slab(tab, s0, m, tile + lane * kVec, acc[lane]);
            }
            // the output rows: into the tile where a bulk copy takes them
            const int r0 = static_cast<int>(w.g) * kGroup;
            const int left = static_cast<int>(w.d[kRows]) - r0;
            const int rows_out = left < kGroup ? left : kGroup;
            for (int j = 0; j < rows_out; ++j) {
                uint8_t* o = out_row(w, b0, b1, r0 + j);
                const int bulk = bulk_bytes(o, n);
                for (int lo = 0, lane = 0; lo < n; lo += kVec, ++lane) {
                    if (lo + kVec <= bulk) {
                        uint32_t v[4];
                        lane_row(acc[lane], j, v);
                        memcpy(out_tile + j * kChunk + lo, v, kVec);
                    } else {
                        lane_store(acc[lane], j, o + lo,
                                   n - lo < kVec ? n - lo : kVec);
                    }
                }
                memcpy(o, out_tile + j * kChunk, bulk);
            }
        }
    }
}

// the product of each item the walk of a grid `grid` blocks wide visits
extern "C" void gf_walk_products(const int64_t* desc, const int64_t* rows,
                                 int n_products, long long total, int grid,
                                 int* out) {
    for (int block = 0; block < grid; ++block) {
        Walk w;
        walk_start(w, desc, rows, n_products, total, block, grid);
        for (; w.valid; walk_step(w, desc, rows, n_products, total, grid))
            out[w.item] = w.p;
    }
}

extern "C" int gf_find_product(const int64_t* desc, int n_products,
                               long long item) {
    return find_product(desc, n_products, item);
}
"""


@pytest.fixture(scope="module")
def body(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel body cannot be built for "
                    "the host")
    out = tmp_path_factory.mktemp("gf_matmul_host")
    shim = out / "shim.cpp"
    shim.write_text(SHIM)
    lib = out / "libgf_matmul_host.so"
    subprocess.run(
        [gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-D__host__=",
         "-D__device__=", f"-I{CSRC}", "-o", str(lib), str(shim)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    so = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    so.gf_matmul_host.argtypes = [p, p, p, ctypes.c_int, ctypes.c_longlong,
                                  p, p, ctypes.c_int]
    so.gf_matmul_host.restype = None
    so.gf_find_product.argtypes = [p, ctypes.c_int, ctypes.c_longlong]
    so.gf_find_product.restype = ctypes.c_int
    so.gf_walk_products.argtypes = [p, p, ctypes.c_int, ctypes.c_longlong,
                                    ctypes.c_int, p]
    so.gf_walk_products.restype = None
    return so


def run_body(so, plist: ProductList, b0: np.ndarray, b1: np.ndarray,
             grid: int = 1) -> None:
    """The host-built body over the list, in place on b0 and b1."""
    assert b0.size >= plist.extent[0] and b1.size >= plist.extent[1]
    run_packed(so, plist.desc, plist.rows, plist.tables,
               len(plist.products), plist.items, b0, b1, grid)


def run_packed(so, desc, rows, tables, n_products: int, items: int,
               b0: np.ndarray, b1: np.ndarray, grid: int) -> None:
    so.gf_matmul_host(desc.ctypes.data, rows.ctypes.data, tables.ctypes.data,
                      n_products, items, b0.ctypes.data, b1.ctypes.data,
                      grid)


def run_plain(plist: ProductList, b0: np.ndarray, b1: np.ndarray):
    """The grouped plain version on copies: (b0, b1) after the list."""
    t0, t1 = torch.from_numpy(b0.copy()), torch.from_numpy(b1.copy())
    tb.gf_grouped_plain(plist, t0, t1)
    return t0.numpy(), t1.numpy()


def rows_of(buf: np.ndarray, rows, length: int) -> np.ndarray:
    return np.stack([buf[r:r + length] for r in rows])


def random_list(rng, shapes, b0_size: int, b1_size: int):
    """Products of the given (R, S, L): inputs at random, unaligned
    places of b0 (they may overlap: reads only), outputs at disjoint,
    unaligned places of b1 (each row 8 bytes past the last)."""
    products, out_at = [], 5
    for R, S, L in shapes:
        M = rng.integers(0, 256, (R, S), np.uint8)
        ins = tuple(int(v) for v in rng.integers(0, b0_size - L, S))
        outs = []
        for _ in range(R):
            outs.append(BASE1 | out_at)
            out_at += L + 8
        assert out_at <= b1_size
        products.append(Product(M, ins, tuple(outs), L))
    return products


def buffers(rng, b0_size: int, b1_size: int):
    return (rng.integers(0, 256, b0_size, np.uint8),
            rng.integers(0, 256, b1_size, np.uint8))


SHAPES = {
    # ragged L, unaligned rows, R not a multiple of 4
    "ragged_unaligned": [(5, 3, 5000), (3, 8, 4097), (1, 2, 17)],
    "s1_and_s64": [(4, 1, 4096), (2, 64, 8193), (7, 64, 300)],
    "wide": [(33, 3, 2000), (4, 70, 4100), (2, 256, 513)],
    "mixed": [(4, 8, 8192), (1, 2, 8192), (2, 2, 8192), (4, 8, 1),
              (6, 5, 12345), (1, 1, 4096), (32, 64, 700)],
}


@pytest.mark.parametrize("grid", [1, 3])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_body_equals_grouped_plain(body, case, grid):
    rng = np.random.default_rng([7, len(case), grid])
    b0, b1 = buffers(rng, 40_000, 200_000)
    plist = ProductList(random_list(rng, SHAPES[case], b0.size, b1.size))
    want0, want1 = run_plain(plist, b0, b1)
    run_body(body, plist, b0, b1, grid)
    assert np.array_equal(b0, want0)  # inputs untouched
    assert np.array_equal(b1, want1)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_body_equals_the_products_and_jax(body, case):
    """Every product's output rows == gf_matmul_plain of its input rows;
    the first two products' also == the JAX package's Pallas kernel."""
    rng = np.random.default_rng([8, len(case)])
    b0, b1 = buffers(rng, 40_000, 200_000)
    plist = ProductList(random_list(rng, SHAPES[case], b0.size, b1.size))
    before = b0.copy()
    run_body(body, plist, b0, b1)
    jax = JaxEngine(strategy="pallas")
    for i, p in enumerate(plist.products):
        X = rows_of(before, p.ins, p.length)
        got = rows_of(b1, [r & (BASE1 - 1) for r in p.outs], p.length)
        want = tb.gf_matmul_plain(p.M, torch.from_numpy(X)).numpy()
        assert np.array_equal(got, want), i
        if i < 2:
            assert np.array_equal(got, np.asarray(jax.matmul(p.M, X))), i


def test_body_overwrites_the_output_rows(body):
    """A product's output rows are written over, whatever they held, and
    only those bytes: run again over other stale bytes, the list gives
    the same rows, and the bytes between them keep theirs."""
    rng = np.random.default_rng(9)
    b0, b1 = buffers(rng, 40_000, 60_000)
    products = random_list(rng, [(5, 70, 4099), (3, 2, 8192)], b0.size,
                           b1.size)
    plist = ProductList(products)
    start = b1.copy()
    run_body(body, plist, b0, b1)
    written = np.zeros(b1.size, bool)
    for p in products:
        X = torch.from_numpy(rows_of(b0, p.ins, p.length))
        outs = [r & (BASE1 - 1) for r in p.outs]
        want = tb.gf_matmul_plain(p.M, X).numpy()
        assert np.array_equal(rows_of(b1, outs, p.length), want)
        for o in outs:
            written[o:o + p.length] = True
    assert np.array_equal(b1[~written], start[~written])
    first = b1.copy()
    b1[written] = rng.integers(0, 256, int(written.sum()), np.uint8)
    run_body(body, plist, b0, b1, grid=2)
    assert np.array_equal(b1, first)


@pytest.mark.parametrize("grid", [1, 5])
def test_body_products_sharing_matrices(body, grid):
    """Products of three matrices (as Clay's pair transforms share a
    few), each block keeping the tables of its last matrix and group while
    the next item uses them: == the grouped plain version."""
    rng = np.random.default_rng([12, grid])
    b0, b1 = buffers(rng, 40_000, 400_000)
    shapes = [(1 + i % 2, 2, 8192) for i in range(12)] + [(6, 9, 5000)] * 4
    products = random_list(rng, shapes, b0.size, b1.size)
    shared = {(1, 2): rng.integers(0, 256, (1, 2), np.uint8),
              (2, 2): rng.integers(0, 256, (2, 2), np.uint8),
              (6, 9): rng.integers(0, 256, (6, 9), np.uint8)}
    products = [p._replace(M=shared[np.asarray(p.M).shape])
                for p in products]
    plist = ProductList(products)
    assert plist.tables.size == (2 + 2 + 2 * 9) * 256
    want0, want1 = run_plain(plist, b0, b1)
    run_body(body, plist, b0, b1, grid)
    assert np.array_equal(b0, want0) and np.array_equal(b1, want1)


def test_body_batched_stripes(body):
    """N stripes of a product, rows `stride` apart: one launch of the
    single-product case (gf_matmul_cuda's descriptor, `_single_desc`) ==
    the JAX package's batched product."""
    rng = np.random.default_rng(10)
    N, S, R, L = 6, 8, 4, 4096 + 40
    data = rng.integers(0, 256, (N, S, L), np.uint8)
    M = rng.integers(0, 256, (R, S), np.uint8)
    desc, rows, items, _ = tb._single_desc(R, S, N, L)
    tables = tb.product_tables(M).view("<u4").reshape(-1)
    out = np.zeros(N * R * L, np.uint8)
    run_packed(body, desc, rows, tables, 1, items, data.reshape(-1), out,
               grid=5)
    want = JaxEngine(strategy="pallas").matmul_batch(M, data)
    assert np.array_equal(out.reshape(N, R, L), np.asarray(want))


@pytest.mark.parametrize("grid", [1, 3, 7, 264])
def test_the_walk_visits_each_item_once(body, grid):
    """Items map to the product whose items hold them, empty products
    (L = 0) dropped; a grid of `grid` blocks, each stepping by the grid's
    width through the products' (group, stripe, chunk) digits, visits
    every item once, in its product."""
    rng = np.random.default_rng(11)
    shapes = [(5, 3, 9000), (1, 1, 1), (2, 2, 0), (9, 2, 4096),
              (4, 4, 20000), (13, 1, 70000)]
    products = random_list(rng, shapes, 300_000, 2_000_000)
    plist = ProductList(products)
    assert len(plist.products) == 5
    # the same list packed with product 3 in 5 stripes, rows interleaved
    # (gf_matmul_cuda's kind of product)
    stripes = [1, 1, 5, 1, 1]
    entries = [(np.asarray(p.M).shape[0], np.asarray(p.M).shape[1], 0,
                p.ins, p.outs, n, p.length, 4096 * (n > 1),
                4096 * 9 * (n > 1))
               for p, n in zip(plist.products, stripes)]
    desc, rows, items, _, _ = tb._pack(entries, 0)
    want = []
    for i, (p, n) in enumerate(zip(plist.products, stripes)):
        R = np.asarray(p.M).shape[0]
        want += [i] * (-(-R // 4) * n * -(-p.length // 4096))
    assert items == len(want) == plist.items + 3 * 4  # 3 groups, 4 more
    got = [body.gf_find_product(desc.ctypes.data, len(entries), i)
           for i in range(items)]
    assert got == want
    walked = np.full(items, -1, np.int32)
    body.gf_walk_products(desc.ctypes.data, rows.ctypes.data, len(entries),
                          items, grid, walked.ctypes.data)
    assert walked.tolist() == want
