// The per-lane body and the work-list walk of the GF(2^8) product kernel
// (gf_matmul.cu), written once as __host__ __device__ code.
//
// nvcc builds it into the kernel; a C++ compiler builds the same file for
// the host with the two qualifiers defined empty (-D__host__=
// -D__device__=), which is how the CPU tests hold it against the JAX
// package.  The two builds differ only in how rows move: on the card bulk
// copies (TMA) bring each slab of input rows into the block's ring in
// shared memory and take each group of output rows back out of it
// (gf_matmul.cu), and the lanes move only what a bulk copy cannot (rows
// not 16-byte aligned, a row's last bytes past a multiple of 16); on the
// host the caller moves all of it with load16 and lane_store.
//
// A launch runs a list of products.  Product p computes, for each stripe
// n < N and column l < L,
//
//   out_row[r] (n, l) = XOR over s < S of mul(M[r, s], in_row[s] (n, l))
//
// Its rows are byte offsets from one of two base pointers (bit 62 picks
// the second), each stripe n a further n * stride bytes on.  A wide M is
// one product: its input rows are walked in slabs (up to kMaxCols of
// them), its output rows in groups of four, so no product accumulates
// into rows another writes.
// Its descriptor is one row of kFields int64 (the Field enum) in the list's
// descriptor array, its row offsets (S inputs, then R outputs) a run of
// the row array, its tables the product_tables(M) words
// [ceil(R / 4)][S][256] at a word index of the table array
// (ceph_tpu_torch/ec/torch_backend.py builds all three).
//
// Work list: an item is (product, group of 4 output rows, stripe, 4 KiB
// column chunk), numbered group-major within a product and product after
// product; kWork holds the first item of each product (a prefix sum), so
// find_product is a binary search, taken only when a walk enters a
// product (Walk).  A block takes items blockIdx.x,
// blockIdx.x + gridDim.x, ...; its 256 lanes take 16 bytes of the chunk
// each and walk the product's S input rows in slabs of kSlab rows.
//
// Lookups: mul(c, x) = mul(c, x & 15) ^ mul(c, x & 0xf0) (GF addition is
// XOR), so per (group, input row) the block keeps 32 words in shared
// memory: lo[v] = the four products of the group's rows with v, hi[v] the
// same with v << 4, packed one row per byte.  Both tables of an input row
// sit in one 256-byte block (lo at bytes 0-63, hi at 64-127): one word
// each of the 32 banks, so whatever nibbles a warp's lanes hold, a lookup
// into lo (banks 0-15) or hi (16-31) touches each bank once or
// broadcasts.  Per data byte: two lookups, two byte permutes that form
// the two shared addresses (the nibble times four in the low byte, the
// block's offset in the others), one three-way XOR; per four bytes two
// shifts and two masks.

#pragma once

#include <stdint.h>

#define GF_HD __host__ __device__ inline

namespace gf {

constexpr int kThreads = 256;             // lanes of a block
constexpr int kVec = 16;                  // bytes of L owned by a lane
constexpr int kChunk = kThreads * kVec;   // bytes of L per item
constexpr int kGroup = 4;                 // output rows per table word
constexpr int kSlab = 4;                  // input rows per ring stage
constexpr int kRing = 2;                  // ring stages
constexpr int kStage = kSlab * kChunk;    // bytes of one stage
constexpr int kRingBytes = kRing * kStage;
constexpr int kOutBufs = 2;               // output tiles
constexpr int kOutBytes = kOutBufs * kGroup * kChunk;
constexpr int kMaxCols = 256;             // S of one product
constexpr int kTabBytes = 256;            // shared bytes per input row
constexpr int kTableWords = 256;          // global words per input row
constexpr int64_t kBase1 = int64_t(1) << 62;

// the columns of a product's descriptor row
enum Field {
  kWork,        // its first item
  kRows,        // R, output rows
  kCols,        // S, input rows
  kStripes,     // N
  kLength,      // L, bytes per row
  kInStride,    // bytes from one stripe's input rows to the next's
  kOutStride,   // the same for its output rows
  kRowIndex,    // its first row offset in the row array
  kTableIndex,  // its first table word in the table array
  kChunks,      // ceil(L / kChunk)
  kAligned,     // 1: every row, stride and L a multiple of 16
  kFields
};

// A block's walk over the work list: the item it is at, as (product,
// group, stripe, chunk).  It steps by the grid's width, and within a
// product it does so without dividing: the step is the width's digits in
// the product's (group, stripe, chunk) mixed radix, added with carries.
// Only an item past its product's last finds the product anew.
struct Walk {
  const int64_t* d;     // the product's descriptor row
  const int64_t* rows;  // its S input row offsets, then its R output
  uint32_t item, end;   // the item, and the product's last plus one
  uint32_t g, n, c;     // its group, stripe and chunk
  uint32_t N, chunks;
  uint32_t step_g, step_n, step_c;
  int p;
  bool valid;
};

GF_HD uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, y, s);
#else
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<uint32_t>((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff)
         << (8 * i);
  return r;
#endif
}

// the product that holds `item`: the last whose first item is <= item
GF_HD int find_product(const int64_t* desc, int n_products, uint32_t item) {
  int lo = 0, hi = n_products - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (static_cast<uint32_t>(desc[static_cast<int64_t>(mid) * kFields +
                                   kWork]) <= item)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// The walk at `item` (< total) for a grid `grid` blocks wide.  A list
// has fewer than 2^31 items (the wrapper checks), so 32-bit division
// does.
GF_HD void walk_to(Walk& w, const int64_t* desc, const int64_t* rows,
                   int n_products, uint32_t item, uint32_t grid) {
  w.p = find_product(desc, n_products, item);
  w.d = desc + static_cast<int64_t>(w.p) * kFields;
  w.rows = rows + w.d[kRowIndex];
  w.chunks = static_cast<uint32_t>(w.d[kChunks]);
  w.N = static_cast<uint32_t>(w.d[kStripes]);
  const uint32_t per_group = w.N * w.chunks;
  const uint32_t first = static_cast<uint32_t>(w.d[kWork]);
  const uint32_t R = static_cast<uint32_t>(w.d[kRows]);
  w.end = first + (R + kGroup - 1) / kGroup * per_group;
  uint32_t rem = item - first;
  w.g = rem / per_group;
  rem -= w.g * per_group;
  w.n = rem / w.chunks;
  w.c = rem - w.n * w.chunks;
  w.step_g = grid / per_group;
  rem = grid - w.step_g * per_group;
  w.step_n = rem / w.chunks;
  w.step_c = rem - w.step_n * w.chunks;
  w.item = item;
  w.valid = true;
}

GF_HD void walk_start(Walk& w, const int64_t* desc, const int64_t* rows,
                      int n_products, uint32_t total, uint32_t block,
                      uint32_t grid) {
  w.valid = block < total;
  if (w.valid) walk_to(w, desc, rows, n_products, block, grid);
}

GF_HD void walk_step(Walk& w, const int64_t* desc, const int64_t* rows,
                     int n_products, uint32_t total, uint32_t grid) {
  const uint32_t item = w.item + grid;
  if (item >= total) {
    w.valid = false;
  } else if (item >= w.end) {
    walk_to(w, desc, rows, n_products, item, grid);
  } else {
    w.item = item;
    w.c += w.step_c;
    if (w.c >= w.chunks) {
      w.c -= w.chunks;
      ++w.n;
    }
    w.n += w.step_n;
    if (w.n >= w.N) {
      w.n -= w.N;
      ++w.g;
    }
    w.g += w.step_g;
  }
}

GF_HD int64_t walk_l0(const Walk& w) {
  return static_cast<int64_t>(w.c) * kChunk;
}

GF_HD uint8_t* row_address(uint8_t* b0, uint8_t* b1, int64_t row) {
  return ((row & kBase1) ? b1 : b0) + (row & (kBase1 - 1));
}

// where the item's input row s (output row r) starts, at its chunk
GF_HD const uint8_t* in_row(const Walk& w, uint8_t* b0, uint8_t* b1,
                            int s) {
  return row_address(b0, b1, w.rows[s]) + w.n * w.d[kInStride] +
         walk_l0(w);
}

GF_HD uint8_t* out_row(const Walk& w, uint8_t* b0, uint8_t* b1, int r) {
  return row_address(b0, b1, w.rows[w.d[kCols] + r]) +
         w.n * w.d[kOutStride] + walk_l0(w);
}

// the bytes of the lane's 16 that lie inside the row (0 past its end)
GF_HD int lane_bytes(const Walk& w, int lane) {
  const int64_t left = w.d[kLength] - walk_l0(w) -
                       static_cast<int64_t>(lane) * kVec;
  return left <= 0 ? 0 : (left < kVec ? static_cast<int>(left) : kVec);
}

// 16 bytes at p (nb of them valid) as four little-endian words; the
// bytes past nb read as 0, whose products are 0
GF_HD void load16(const uint8_t* p, int nb, uint32_t w[4]) {
#ifdef __CUDA_ARCH__
  if (nb == kVec && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
    return;
  }
#endif
  w[0] = w[1] = w[2] = w[3] = 0;
  for (int i = 0; i < nb; ++i)
    w[i >> 2] |= static_cast<uint32_t>(p[i]) << (8 * (i & 3));
}

GF_HD void store16(uint8_t* p, int nb, const uint32_t w[4]) {
#ifdef __CUDA_ARCH__
  if (nb == kVec && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#endif
  for (int i = 0; i < nb; ++i)
    p[i] = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
}

// Where the tables of the walk's product and group start in the table
// array.  Products of one matrix share its tables (the wrapper packs each
// distinct M once), so a block whose next item has the same start keeps
// the tables it staged.
GF_HD int64_t table_start(const Walk& w) {
  return w.d[kTableIndex] + static_cast<int64_t>(w.g) * w.d[kCols] *
                                kTableWords;
}

// The tables of the walk's product and group into `tab` (shared memory
// on the card), lanes `lane`, `lane + lanes`, ... of the block each
// copying words: input row s at word 64 s, lo[v] = word v of its 256,
// hi[v] = word v << 4.
GF_HD void stage_tables(uint32_t* tab, const uint32_t* tables,
                        const Walk& w, int lane, int lanes) {
  const int S = static_cast<int>(w.d[kCols]);
  const uint32_t* src = tables + table_start(w);
  for (int i = lane; i < S * 32; i += lanes) {
    const int s = i >> 5, v = i & 31;
    tab[s * (kTabBytes / 4) + v] =
        src[s * kTableWords + (v < 16 ? v : (v - 16) << 4)];
  }
}

// Where a lane reads the staged tables.  On the card, the shared address
// of the block's tables (their first byte at a multiple of 256: the
// kernel checks), so that a byte permute forms a lookup's whole address
// and ld.shared reads it; on the host, the buffer holding them.
#ifdef __CUDA_ARCH__
using TabRef = uint32_t;

GF_HD uint32_t row_tables(TabRef tab, int s) {
  return tab + static_cast<uint32_t>(s * kTabBytes);
}

GF_HD uint32_t table_word(TabRef, uint32_t address) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(address));
  return v;
}

GF_HD uint32_t mask_or(uint32_t x, uint32_t mask, uint32_t bits) {
  uint32_t v;  // (x & mask) | bits in one instruction
  asm("lop3.b32 %0, %1, %2, %3, 0xea;" : "=r"(v) : "r"(x), "r"(mask),
      "r"(bits));
  return v;
}
#else
using TabRef = const uint8_t*;

GF_HD uint32_t row_tables(TabRef, int s) {
  return static_cast<uint32_t>(s * kTabBytes);
}

GF_HD uint32_t table_word(TabRef tab, uint32_t offset) {
  return *reinterpret_cast<const uint32_t*>(tab + offset);
}

GF_HD uint32_t mask_or(uint32_t x, uint32_t mask, uint32_t bits) {
  return (x & mask) | bits;
}
#endif

// XOR the products of `rows` input rows s0, s0 + 1, ... into acc: `tile`
// holds the lane's 16 bytes of row s0 + r at tile + r * kChunk.  acc[b]:
// byte j is the group's output row j at column l0 + 16 lane + b.
GF_HD void lane_slab(TabRef tab, int s0, int rows, const uint8_t* tile,
                     uint32_t acc[kVec]) {
  for (int r = 0; r < rows; ++r) {
    uint32_t x[4];
#ifdef __CUDA_ARCH__
    const uint4 v = *reinterpret_cast<const uint4*>(tile + r * kChunk);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
#else
    const uint32_t* v = reinterpret_cast<const uint32_t*>(tile + r * kChunk);
    for (int q = 0; q < 4; ++q) x[q] = v[q];
#endif
    const uint32_t base = row_tables(tab, s0 + r);
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int q = 0; q < 4; ++q) {
      // each byte's nibble times four: a word offset in lo (bytes 0-63)
      // and in hi (bytes 64-127)
      const uint32_t lo = (x[q] << 2) & 0x3c3c3c3cu;
      const uint32_t hi = mask_or(x[q] >> 2, 0x3c3c3c3cu, 0x40404040u);
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int j = 0; j < 4; ++j) {
        // byte j of lo / hi in the low byte, the row's block above it
        const uint32_t sel = 0x7650u | j;
        acc[4 * q + j] ^= table_word(tab, byte_perm(lo, base, sel)) ^
                          table_word(tab, byte_perm(hi, base, sel));
      }
    }
  }
}

// The bytes of a row's chunk (n of them at p) that a bulk copy moves: a
// multiple of 16 from a 16-byte aligned start, none from another; the
// lanes that own the rest move it themselves.
GF_HD int bulk_bytes(const uint8_t* p, int n) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 ? n & ~15 : 0;
}

// the bytes of a row in the walk's chunk
GF_HD int chunk_bytes(const Walk& w) {
  const int64_t left = w.d[kLength] - walk_l0(w);
  return left < kChunk ? static_cast<int>(left) : kChunk;
}

// The lane's 16 bytes of the group's output row j from acc.
GF_HD void lane_row(const uint32_t acc[kVec], int j, uint32_t w[4]) {
  // byte j of acc[4q .. 4q + 3] -> bytes 0..3 of word q
  const uint32_t pick = static_cast<uint32_t>(j | ((j + 4) << 4));
  for (int q = 0; q < 4; ++q) {
    const uint32_t lo = byte_perm(acc[4 * q], acc[4 * q + 1], pick);
    const uint32_t hi = byte_perm(acc[4 * q + 2], acc[4 * q + 3], pick);
    w[q] = byte_perm(lo, hi, 0x5410);
  }
}

// The same, written over the row's nb bytes at o.
GF_HD void lane_store(const uint32_t acc[kVec], int j, uint8_t* o, int nb) {
  uint32_t w[4];
  lane_row(acc, j, w);
  store16(o, nb, w);
}

}  // namespace gf
