// GF(2^8) matrix products for Hopper (sm_90a): one launch runs a list of
// products (gf_matmul.cuh says what a product is and how the work list
// is walked).
//
//   out[n, r, l] = XOR over s of mul(M[r, s], in[n, s, l])
//
// Replaces ceph_tpu/ec/jax_backend.py::gf_matmul_pallas.  That kernel is
// shaped by the TPU's matrix unit: it unpacks every byte into 8 bit rows,
// multiplies them by the GF(2) bit-matrix of M in bf16 and packs the sums
// mod 2 back into bytes.  Here the function is computed with nibble
// tables in shared memory.
//
// What bounds it: memory.  A product reads S*L bytes and writes R*L bytes
// per stripe, so the card moves at least N*(S+R)*L bytes of HBM.  Beside
// that, shared memory: per data byte and group of four output rows two
// table lookups, conflict-free (gf_matmul.cuh), so one warp-wide lookup a
// clock per SM; and every row passes through it twice (a bulk copy
// writes it, the lanes read it; the lanes write outputs, a bulk copy
// reads them), at 128 bytes a clock.  The lanes issue about six
// instructions per data byte (two lookups, two byte permutes, one XOR,
// the nibbles).  On the H100 (132 SMs, 1.98 GHz, 3.35 TB/s):
//   (a) RS(8,4) encode of 16 MiB, N*S*L = 16.8 M bytes: lookups 4.0 us,
//       rows through shared memory 1.5 us, against a 7.5 us HBM bound;
//   (b) encode_batch [8192, 8, 4096], 268 M bytes: lookups 64 us, rows
//       through shared memory 24 us, issue 51 us, against 120 us;
//   (c) decode_batch, two rows lost: the same 268 M bytes and lookups,
//       rows 20 us, against 100 us.
// A byte table of 256 words per input row (the design before this one)
// costs one lookup per byte, but the warp's 32 random bytes meet in about
// 3.5 ways on the busiest bank: about 110 us at (b), as long as the HBM
// bound.
//
// What the design does about the bound: rows move by bulk copies (TMA),
// which reach the card's copy rate (a kernel of bulk copies alone, the
// same bytes as (b), ran in the time of torch's copy_ of them on the
// H100), and they move while the lookups run.  A block is 8 consumer
// warps, which only look up, and a producer warp, whose lane 0 moves the
// rows; they hand work over through mbarriers, never a block barrier.
// A persistent grid walks the work list: as many blocks as fit on the
// SMs (three at S <= 44), or where a list's items take more than one
// round of those, the fewest blocks that take them in as many rounds
// (torch_backend._grid), since a block's fixed costs (barriers, tables,
// its first loads, its last store) are paid in series with its items.  Each block keeps a ring of kRing stages of
// [kSlab rows, 4 KiB] in shared memory: the producer fills a stage with
// one bulk copy per row as soon as the consumers have released it, so
// kRing stages are in flight ahead of the lookups.  An item's output rows
// go to one of kOutBufs tiles in shared memory, and the producer takes
// each row out with one bulk copy.  What a bulk copy cannot move (16-byte
// misaligned rows, the last bytes of a row past a multiple of 16) the
// owning lane moves with ordinary loads and stores.  Tables
// are staged when the block's (matrix, group) changes, not once per
// item or product: Clay's lists run hundreds of products of a few
// matrices.  Small products (Clay's pair transforms, 2 x 8 KiB) run by the
// hundred in one launch, so no launch carries only a few blocks of work.
//
// Offsets are 64-bit: N*S*L passes 2^31 at real batch sizes.  A list
// must be free of hazards: no product reads or writes bytes that another
// product of the list writes (ec/torch_backend.py::ProductList checks).
//
// Launch: gf_matmul_launch() on the caller's stream, no synchronisation,
// no allocation; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "gf_matmul.cuh"

namespace {

using namespace gf;

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- the bulk copies and their barriers (PTX, sm_90) ----------------------

// A spin on a barrier gives up, trapping, after this many polls (seconds):
// a protocol fault then fails the launch instead of hanging the card.
constexpr uint32_t kSpinLimit = 1u << 26;  // the producer's (32 ns naps)
constexpr uint32_t kWaitLimit = 1u << 22;  // a consumer's try_waits

__device__ __forceinline__ void barrier_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void barrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   shared_address(bar))
               : "memory");
}

// the one arrival of a stage, expecting `bytes` of bulk copies into it
__device__ __forceinline__ void barrier_expect(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(shared_address(bar)),
               "r"(bytes)
               : "memory");
}

// whether the barrier's phase of this parity has completed (no wait)
__device__ __forceinline__ bool barrier_done(uint64_t* bar,
                                             uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{ .reg .pred p; mbarrier.test_wait.parity.shared::cta.b64 p, [%1], "
      "%2; selp.u32 %0, 1, 0, p; }"
      : "=r"(done)
      : "r"(shared_address(bar)), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar,
                                             uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == kWaitLimit) __trap();
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(shared_address(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(shared_address(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// this thread's shared-memory writes, before a bulk copy touches them
__device__ __forceinline__ void fence_to_bulk() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the consumer warps' own barrier (not the producer's)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

// -- the producer: bulk copies in and out ------------------------------------

// lane 0 of the producer warp: the bulk copies of the walk's slab from s0
// into `slot`, posted on its barrier (bytes no bulk copy moves are moved
// by the consumer lanes that own them)
__device__ __forceinline__ void load_slab(const Walk& w, int s0, uint8_t* b0,
                                          uint8_t* b1, uint8_t* slot,
                                          uint64_t* bar) {
  const int left = static_cast<int>(w.d[kCols]) - s0;
  const int rows = left < kSlab ? left : kSlab;
  const int n = chunk_bytes(w);
  uint32_t bytes = 0;
  for (int r = 0; r < rows; ++r)
    bytes += bulk_bytes(in_row(w, b0, b1, s0 + r), n);
  barrier_expect(bar, bytes);
  for (int r = 0; r < rows; ++r) {
    const uint8_t* src = in_row(w, b0, b1, s0 + r);
    const int bulk = bulk_bytes(src, n);
    if (bulk) bulk_load(slot + r * kChunk, src, bulk, bar);
  }
}

// lane 0 of the producer warp: the bulk copies of the item's output rows
// out of `tile`, as one group, waited on until they have read the tile
__device__ __forceinline__ void store_item(const Walk& w, uint8_t* b0,
                                           uint8_t* b1, const uint8_t* tile) {
  const int n = chunk_bytes(w);
  const int r0 = static_cast<int>(w.g) * kGroup;
  const int left = static_cast<int>(w.d[kRows]) - r0;
  const int rows = left < kGroup ? left : kGroup;
  for (int j = 0; j < rows; ++j) {
    uint8_t* o = out_row(w, b0, b1, r0 + j);
    const int bulk = bulk_bytes(o, n);
    if (bulk) bulk_store(o, tile + j * kChunk, bulk);
  }
  bulk_commit();
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// -- the consumers: lookups ----------------------------------------------------

// the bytes of the lane's 16 of each slab row that no bulk copy brought,
// loaded into the lane's place in `slot`
__device__ __forceinline__ bool load_rest(const Walk& w, int s0,
                                          uint8_t* b0, uint8_t* b1,
                                          uint8_t* slot, int lane) {
  const int n = chunk_bytes(w);
  const int lo = lane * kVec;
  if (lo >= n) return false;
  const int nb = n - lo < kVec ? n - lo : kVec;
  const int left = static_cast<int>(w.d[kCols]) - s0;
  const int rows = left < kSlab ? left : kSlab;
  bool wrote = false;
  for (int r = 0; r < rows; ++r) {
    const uint8_t* src = in_row(w, b0, b1, s0 + r);
    if (lo + kVec <= bulk_bytes(src, n)) continue;
    uint32_t v[4];
    load16(src + lo, nb, v);
    *reinterpret_cast<uint4*>(slot + r * kChunk + lo) =
        make_uint4(v[0], v[1], v[2], v[3]);
    wrote = true;
  }
  return wrote;
}

// The lane's part of the item's output rows: into `tile` for the bulk
// copy of each row, or straight to the row where no bulk copy takes its
// bytes.  Returns whether the lane wrote to the tile.
__device__ __forceinline__ bool finish(const Walk& w, uint8_t* b0,
                                       uint8_t* b1, uint8_t* tile, int lane,
                                       const uint32_t acc[kVec],
                                       bool aligned) {
  const int n = chunk_bytes(w);
  const int lo = lane * kVec;
  if (lo >= n) return false;
  const int nb = n - lo < kVec ? n - lo : kVec;
  const int r0 = static_cast<int>(w.g) * kGroup;
  const int left = static_cast<int>(w.d[kRows]) - r0;
  const int rows = left < kGroup ? left : kGroup;
  bool staged = false;
  for (int j = 0; j < rows; ++j) {
    uint8_t* o = aligned ? nullptr : out_row(w, b0, b1, r0 + j);
    if (aligned || lo + kVec <= bulk_bytes(o, n)) {
      uint32_t v[4];
      lane_row(acc, j, v);
      *reinterpret_cast<uint4*>(tile + j * kChunk + lo) =
          make_uint4(v[0], v[1], v[2], v[3]);
      staged = true;
    } else {
      lane_store(acc, j, o + lo, nb);
    }
  }
  return staged;
}

// the next slab of the walk: the product's next kSlab input rows, or the
// first of its next item
__device__ __forceinline__ void advance(Walk& w, int& s0,
                                        const int64_t* desc,
                                        const int64_t* rows, int n_products,
                                        uint32_t total) {
  s0 += kSlab;
  if (s0 < w.d[kCols]) return;
  s0 = 0;
  walk_step(w, desc, rows, n_products, total, gridDim.x);
}

// Warps 0-7 look up (lane = thread); warp 8 is the producer, whose lane 0
// moves the rows.  Stage q of the block's walk sits in slot q % kRing:
// full[slot] completes when its bulk copies land, empty[slot] when the 8
// consumer warps are done with it.  Item i's output rows sit in tile i %
// kOutBufs: tile_full completes when the consumers have written it,
// tile_empty when its bulk copies have read it.
__global__ void __launch_bounds__(kThreads + 32, 3)
gf_matmul_kernel(const int64_t* __restrict__ desc,
                 const int64_t* __restrict__ rows,
                 const uint32_t* __restrict__ tables, int n_products,
                 uint32_t total, int max_cols, uint8_t* b0, uint8_t* b1) {
  // rows of a product marked kAligned are 16-byte aligned when both bases
  // are: every byte of them moves by bulk copy
  const bool bases_aligned =
      ((reinterpret_cast<uintptr_t>(b0) | reinterpret_cast<uintptr_t>(b1)) &
       15) == 0;
  // the tables (max_cols blocks of kTabBytes), the ring, the output tiles
  extern __shared__ __align__(256) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kRing], empty[kRing];
  __shared__ __align__(8) uint64_t tile_full[kOutBufs], tile_empty[kOutBufs];
  uint8_t* ring = smem + max_cols * kTabBytes;
  uint8_t* tiles = ring + kRingBytes;
  constexpr int kTile = kGroup * kChunk;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      barrier_init(&full[i], 1);
      barrier_init(&empty[i], kThreads / 32);
    }
    for (int i = 0; i < kOutBufs; ++i) {
      barrier_init(&tile_full[i], kThreads / 32);
      barrier_init(&tile_empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kThreads) {  // the producer warp
    if (threadIdx.x != kThreads) return;
    Walk f, out;  // the slabs to load, the items to store
    walk_start(f, desc, rows, n_products, total, blockIdx.x, gridDim.x);
    out = f;
    int fs0 = 0;
    uint32_t q = 0, item = 0, idle = 0;
    while (f.valid || out.valid) {
      bool moved = false;
      const uint32_t slot = q % kRing;
      if (f.valid && (q < kRing ||
                      barrier_done(&empty[slot], (q / kRing - 1) & 1))) {
        load_slab(f, fs0, b0, b1, ring + slot * kStage, &full[slot]);
        advance(f, fs0, desc, rows, n_products, total);
        ++q;
        moved = true;
      }
      const uint32_t t = item % kOutBufs;
      if (out.valid && barrier_done(&tile_full[t], (item / kOutBufs) & 1)) {
        store_item(out, b0, b1, tiles + t * kTile);
        barrier_arrive(&tile_empty[t]);
        walk_step(out, desc, rows, n_products, total, gridDim.x);
        ++item;
        moved = true;
      }
      if (moved) {
        idle = 0;
      } else {
        if (++idle == kSpinLimit) __trap();
        __nanosleep(32);
      }
    }
    return;  // store_item waited for each store to read its tile
  }

  const int lane = threadIdx.x;
#ifdef __CUDA_ARCH__
  const TabRef tab = shared_address(smem);
  if (tab & (kTabBytes - 1)) __trap();  // lane_slab's addresses need it
#else
  const TabRef tab = smem;  // (the host pass parses, never runs, this)
#endif
  Walk c;
  walk_start(c, desc, rows, n_products, total, blockIdx.x, gridDim.x);
  int cs0 = 0;
  int64_t staged_at = -1;  // table_start of the staged tables
  uint32_t item = 0;
  uint32_t acc[kVec];
  for (uint32_t q = 0; c.valid; ++q) {
    if (cs0 == 0) {
      if (table_start(c) != staged_at) {
        consumers_sync();  // every lane is done with the old tables
        stage_tables(reinterpret_cast<uint32_t*>(smem), tables, c, lane,
                     kThreads);
        consumers_sync();
        staged_at = table_start(c);
      }
#pragma unroll
      for (int b = 0; b < kVec; ++b) acc[b] = 0;
    }
    const uint32_t slot = q % kRing;
    uint8_t* stage = ring + slot * kStage;
    barrier_wait(&full[slot], (q / kRing) & 1);
    // bytes of the slab's rows no bulk copy brought: the lane's own
    const bool aligned = bases_aligned && c.d[kAligned];
    if (!aligned && load_rest(c, cs0, b0, b1, stage, lane)) fence_to_bulk();
    const int left = static_cast<int>(c.d[kCols]) - cs0;
    lane_slab(tab, cs0, left < kSlab ? left : kSlab,
              stage + lane * kVec, acc);
    __syncwarp();
    if ((lane & 31) == 0) barrier_arrive(&empty[slot]);
    if (left <= kSlab) {
      const uint32_t t = item % kOutBufs;
      if (item >= kOutBufs)
        barrier_wait(&tile_empty[t], (item / kOutBufs - 1) & 1);
      if (finish(c, b0, b1, tiles + t * kTile, lane, acc, aligned))
        fence_to_bulk();
      __syncwarp();
      if ((lane & 31) == 0) barrier_arrive(&tile_full[t]);
      ++item;
    }
    advance(c, cs0, desc, rows, n_products, total);
  }
}

size_t smem_bytes(int max_cols) {
  return static_cast<size_t>(kRingBytes) + kOutBytes +
         static_cast<size_t>(max_cols) * kTabBytes;
}

}  // namespace

// Once per device, before its first launch: lets the kernel use the
// shared memory of its largest list (kMaxCols input rows), and says how
// many blocks of a list whose widest product has `max_cols` input rows
// fit on an SM, and how many SMs the card has.  Returns a cudaError_t.
extern "C" int gf_matmul_prepare(int max_cols, int* blocks_per_sm,
                                 int* sms) {
  if (max_cols < 1 || max_cols > kMaxCols)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      gf_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxCols)));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gf_matmul_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, gf_matmul_kernel, kThreads + 32,
        smem_bytes(max_cols));
  int device = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return static_cast<int>(e);
}

// desc: int64 [n_products][kFields]; rows: int64 row offsets; tables:
// uint32 words; total: the list's items (the last product's kWork plus
// its items, below 2^31); max_cols: its widest S; b0, b1: the two bases;
// grid: blocks (at most total).  Returns a cudaError_t (0 on success).
extern "C" int gf_matmul_launch(const void* desc, const void* rows,
                                const void* tables, int n_products,
                                long long total, int max_cols, void* b0,
                                void* b1, int grid, void* stream) {
  if (n_products < 1 || total < 0 || total >= (1LL << 31) || max_cols < 1 ||
      max_cols > kMaxCols || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return 0;
  gf_matmul_kernel<<<grid, kThreads + 32, smem_bytes(max_cols),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc), static_cast<const int64_t*>(rows),
      static_cast<const uint32_t*>(tables), n_products,
      static_cast<uint32_t>(total), max_cols,
      static_cast<uint8_t*>(b0), static_cast<uint8_t*>(b1));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gf_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
