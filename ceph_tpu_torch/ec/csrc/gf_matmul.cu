// GF(2^8) matrix product over a batch of stripes, for Hopper (sm_90a).
//
//   out[n, r, l] = XOR over s of mul(M[r, s], data[n, s, l])
//   n < N stripes, r < R <= 32 output rows, s < S <= 64 input rows, l < L.
//
// Replaces ceph_tpu/ec/jax_backend.py::gf_matmul_pallas.  That kernel is
// shaped by the TPU's matrix unit: it unpacks every byte into 8 bit rows,
// multiplies them by the GF(2) bit-matrix of M in bf16 and packs the sums
// mod 2 back into bytes.  Here the function is computed with byte tables.
//
// What bounds it: memory.  Per stripe it reads S*L bytes and writes R*L
// bytes, so the card moves at least N*(S+R)*L bytes of HBM, against R*S
// table products per byte column.  The design reads each data byte once
// and writes each output byte once (for R <= 4: each further group of four
// rows reads the data again), 16 bytes of L per thread, as one uint4 per
// row where the row is 16-byte aligned.
//
// Tables: the host builds, once per matrix, T[g][s][x] = the four products
// mul(M[4g + j, s], x) packed in byte j = 0..3 of a 32-bit word (rows past
// R are zero), and uploads them once.  A block copies the S*256 words of
// its row group (S KiB) into shared memory.  One lookup with the data byte
// x then gives the products for four output rows, so a data byte costs S
// lookups, not R*S.
//
// Grid: x walks the flattened (stripe, 4 KiB column chunk) index with a
// stride of gridDim.x (the wrapper caps it at a few blocks per SM, so the
// table copy is paid once per block, not once per chunk); y is the group
// of four output rows.  Offsets are 64-bit: N*S*L passes 2^31 at real
// batch sizes.
//
// Launch: gf_matmul_launch() on the caller's stream, no synchronisation,
// no allocation; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;                  // bytes of L owned by a thread
constexpr int kChunk = kThreads * kVec;   // bytes of L per block step
constexpr int kRowsPerGroup = 4;          // output rows per table word
constexpr int kMaxRows = 32;
constexpr int kMaxCols = 64;

// 16 bytes at p (nb of them valid) into four little-endian words; the
// bytes past nb read as 0, whose products are 0.
__device__ __forceinline__ void load16(const uint8_t* p, int nb,
                                       uint32_t w[4]) {
  if (nb == kVec && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
    return;
  }
  w[0] = w[1] = w[2] = w[3] = 0;
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    if (i < nb) w[i >> 2] |= static_cast<uint32_t>(p[i]) << (8 * (i & 3));
}

__device__ __forceinline__ void store16(uint8_t* p, int nb,
                                        const uint32_t w[4]) {
  if (nb == kVec && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    if (i < nb) p[i] = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
}

__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const uint32_t* __restrict__ tables,
                 const uint8_t* __restrict__ data,
                 uint8_t* __restrict__ out, int R, int S, int64_t L,
                 int64_t chunks_per_stripe, int64_t total_chunks) {
  extern __shared__ uint32_t tab[];  // [S][256] words of this row group
  const int g = blockIdx.y;
  const uint32_t* src = tables + static_cast<int64_t>(g) * S * 256;
  for (int i = threadIdx.x; i < S * 256; i += kThreads) tab[i] = src[i];
  __syncthreads();
  const int rows = min(kRowsPerGroup, R - kRowsPerGroup * g);

  for (int64_t c = blockIdx.x; c < total_chunks; c += gridDim.x) {
    const int64_t n = c / chunks_per_stripe;
    const int64_t l0 = (c - n * chunks_per_stripe) * kChunk +
                       static_cast<int64_t>(threadIdx.x) * kVec;
    if (l0 >= L) continue;
    const int nb = L - l0 < kVec ? static_cast<int>(L - l0) : kVec;

    // acc[b]: byte j holds output row 4g+j at column l0+b
    uint32_t acc[kVec];
#pragma unroll
    for (int b = 0; b < kVec; ++b) acc[b] = 0;
    const uint8_t* d = data + n * S * L + l0;
    for (int s = 0; s < S; ++s, d += L) {
      uint32_t w[4];
      load16(d, nb, w);
      const uint32_t* t = tab + s * 256;
#pragma unroll
      for (int b = 0; b < kVec; ++b)
        acc[b] ^= t[(w[b >> 2] >> (8 * (b & 3))) & 0xff];
    }

    uint8_t* o = out + (n * R + kRowsPerGroup * g) * L + l0;
    for (int r = 0; r < rows; ++r, o += L) {
      // byte r of acc[4q .. 4q+3] -> bytes 0..3 of word q
      const uint32_t pick = r | ((r + 4) << 4);
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t lo = __byte_perm(acc[4 * q], acc[4 * q + 1], pick);
        const uint32_t hi = __byte_perm(acc[4 * q + 2], acc[4 * q + 3], pick);
        w[q] = __byte_perm(lo, hi, 0x5410);
      }
      store16(o, nb, w);
    }
  }
}

}  // namespace

// tables: uint32 [ceil(R/4)][S][256] from the host (see above); data: u8
// [N][S][L]; out: u8 [N][R][L], not overlapping data.  Returns a
// cudaError_t (0 on success).
extern "C" int gf_matmul_launch(const void* tables, const void* data,
                                void* out, long long n_stripes, int rows,
                                int cols, long long length, int max_blocks,
                                void* stream) {
  if (rows < 1 || rows > kMaxRows || cols < 1 || cols > kMaxCols ||
      n_stripes < 0 || length < 0 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks_per_stripe = (length + kChunk - 1) / kChunk;
  const int64_t total = n_stripes * chunks_per_stripe;
  if (total == 0) return 0;
  const size_t smem = static_cast<size_t>(cols) * 256 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(
      static_cast<unsigned>(total < max_blocks ? total : max_blocks),
      (rows + kRowsPerGroup - 1) / kRowsPerGroup);
  gf_matmul_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tables),
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out), rows,
      cols, length, chunks_per_stripe, total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gf_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
