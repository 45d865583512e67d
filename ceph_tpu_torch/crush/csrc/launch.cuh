// The launch plumbing of the placement kernels, in one place: the rule
// kernel (crush_rule.cu), its diagnostics variant (crush_rule_diag.cu) and
// the pipeline kernel (osd/csrc/pipeline.cu).
//
// - stage(): each block copies the crush_ln tables (16-byte rows, so
//   RH/LH is one load) and the first n_staged records (the top levels,
//   which every lane draws from) into dynamic shared memory once;
// - plan_values(): what a launch is built from (crush_rule_plan's ten
//   values) for one kernel;
// - group_for(): the lanes a launch of n PGs maps each PG with: the
//   largest power of two G <= 32 with n * G <= the one-lane kernel's
//   resident lanes (blocks per SM x threads x SMs);
// - grid_for(): a persistent grid, as many blocks as the card holds at
//   once and never more than the PGs' groups need; a group launch
//   spreads its lanes over the SMs in blocks of at least MIN_GROUP_BLOCK
//   threads.
// Include crush_rule.cuh (with the defines the kernel needs) first.

#pragma once

#include <cuda_runtime.h>

#include "crush_rule.cuh"

namespace crush_launch {

using crush_rule::crush_smem;
using crush_rule::LN_WORDS;

// stage: the RH/LH rows, the LL entries, then records[0, n_staged)
__device__ __forceinline__ void stage(crush_rule::Map& m) {
    const uint4* rh_lh = reinterpret_cast<const uint4*>(m.rh_lh);
    const uint4* ll = reinterpret_cast<const uint4*>(m.ll);
    const uint4* rec = reinterpret_cast<const uint4*>(m.records);
    const int words = LN_WORDS + m.n_staged;
    for (int i = threadIdx.x; i < words; i += blockDim.x)
        crush_smem[i] = i < crush_rule::LN_ROWS ? __ldg(rh_lh + i)
                        : i < LN_WORDS ? __ldg(ll + i - crush_rule::LN_ROWS)
                                       : __ldg(rec + i - LN_WORDS);
    __syncthreads();
    m.staged = reinterpret_cast<const crush_rule::Record*>(crush_smem +
                                                           LN_WORDS);
}

inline size_t smem_bytes(int n_staged) {
    return (size_t)(LN_WORDS + n_staged) * sizeof(uint4);
}

// The smallest block of a group launch: every block stages the same
// crush_ln tables and records, so a block of few threads stages them
// slowly (512 against 256 and 1024 on the card: pipeline_ab.py).
constexpr int MIN_GROUP_BLOCK = 512;

// Kernel k's out[0..9]: registers per thread, local bytes per thread,
// static shared bytes per block, the block size the occupancy calculator
// picks (with only the crush_ln tables staged), resident blocks per SM at
// that size, shared memory per SM, shared memory a block may opt in to,
// shared memory the system reserves per block, SMs, and the bytes of
// shared memory a block holds before any record.
template <class K>
int plan_values(K k, int* out) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, k);
    if (e != cudaSuccess) return e;
    int dev, min_grid, threads, blocks;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaOccupancyMaxPotentialBlockSize(&min_grid, &threads, k,
                                                smem_bytes(0))) !=
        cudaSuccess)
        return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, k, threads, smem_bytes(0))) != cudaSuccess)
        return e;
    int per_sm, optin, reserved, sms;
    cudaDeviceGetAttribute(&per_sm,
                           cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaDeviceGetAttribute(&reserved,
                           cudaDevAttrReservedSharedMemoryPerBlock, dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int vals[10] = {fa.numRegs, (int)fa.localSizeBytes,
                          (int)fa.sharedSizeBytes, threads, blocks, per_sm,
                          optin, reserved, sms, (int)smem_bytes(0)};
    for (int i = 0; i < 10; i++) out[i] = vals[i];
    return (int)cudaGetLastError();
}

// The group of a launch of n PGs at `threads` a block: the largest power
// of two G <= 32 with n * G <= the resident lanes there of k1, the kernel
// of one lane a PG (crush_ln tables staged, as plan_values reckons them).
template <class K>
cudaError_t group_for(K k1, long long n, int threads, int* group) {
    int dev, sms, per_sm;
    cudaError_t e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
        return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, k1, threads, smem_bytes(0))) != cudaSuccess)
        return e;
    const long long resident = (long long)per_sm * threads * sms;
    int g = 1;
    while (g < 32 && n * 2 * g <= resident) g *= 2;
    *group = g;
    return cudaSuccess;
}

// The grid of kernel k for n PGs at `group` lanes a PG and `smem` bytes
// of dynamic shared memory a block: *threads comes in as the one-lane
// kernel's block (a multiple of 32 when group > 1) and goes out as the
// launch's; *blocks as many as fit on the card at once, and never more
// than the PGs' groups need.  Sets k's dynamic shared memory limit.
template <class K>
cudaError_t grid_for(K k, long long n, int group, size_t smem, int* threads,
                     unsigned* blocks) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    int dev, sms, per_sm;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // a group launch spreads its lanes over the SMs: blocks of its lanes
    // an SM, a multiple of 32, at least MIN_GROUP_BLOCK and at most
    // *threads
    if (group > 1) {
        long long block = (n * group + sms - 1) / sms;
        block = (block + 31) / 32 * 32;
        if (block < MIN_GROUP_BLOCK) block = MIN_GROUP_BLOCK;
        if (block < *threads) *threads = (int)block;
    }
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, k, *threads, smem)) != cudaSuccess)
        return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long need = (n * group + *threads - 1) / *threads;
    const long long resident = (long long)per_sm * sms;
    *blocks = (unsigned)(need < resident ? need : resident);
    return cudaSuccess;
}

}  // namespace crush_launch
