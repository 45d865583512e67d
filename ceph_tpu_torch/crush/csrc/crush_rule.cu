// The CRUSH rule kernel for Hopper (sm_90a):
//   out[n, 0:result_max] = crush_do_rule(map, rule, x[n], result_max, weight)
// int32 rows padded with ITEM_NONE, one thread per PG lane.
//
// It replaces the XLA programs of ceph_tpu/crush/mapper_jax.py that the
// JAX package traces for every (map, rule): the straw2 draw
// (_straw2_choose, _straw2_rows, _ln_fn), the descent (_descend_rows,
// _descend_impl), the legacy bucket draws (_straw_choose, _list_choose,
// _tree_choose, _perm_choose, _bucket_choose), the exact choose loops
// (_choose_firstn_one, _leaf_firstn, _choose_indep_one, _leaf_indep),
// _is_out and the interpreter of compile_rule's fn.  None of them was a Pallas kernel.
// The fast candidate window and its loop-kernel rescue are not carried
// over: they exist because XLA needs static shapes, and a per-lane
// interpreter with real loops is exact by itself.
//
// What bounds it: instructions, not bytes.  A lane reads 4 B (its seed)
// and writes 4 * result_max B, while it makes a few hundred straw2 draws
// (at 10k OSDs in 1250 hosts of 8 under 78 racks, about
// 3 x (78 + 16 + 8) per PG), each one hash3, one crush_ln and one
// quotient: at the fewest about 174 instructions (counted in
// chip_smoke.py, DRAW_OPS), most of them hash3's IADD3/LOP3/SHF on the
// integer pipe, which runs at half the issue rate.  What the design does
// about it:
// - no divide: the quotient is a multiply-high by the weight's
//   reciprocal, which the map's records carry (crush_rule.cuh
//   straw2_choose); Hopper has no integer divide instruction;
// - one 16-byte load per draw: the id, weight and reciprocal of an item
//   sit together in a record, buckets laid out breadth first from the
//   rules' roots (crush/soa.py pack_buckets);
// - shared memory: each block copies the crush_ln tables (16-byte rows,
//   so RH/LH is one load) and the first n_staged records (the top levels,
//   which every lane draws from) into dynamic shared memory once; the
//   rest is read through the read-only path.  The wrapper
//   (crush/mapper.py) chooses n_staged so that staging costs no resident
//   block;
// - a persistent grid: as many blocks as the card holds at once, with
//   the block size the occupancy calculator picks from the build's
//   registers, striding over the seeds;
// - work vectors of RMAX_CAP entries in local memory (ptxas reports no
//   spills from them; `-Xptxas=-v`, printed by chip_smoke.py).
// Divergence between lanes that retry is left as it is.
//
// Plain C entry points, bound with ctypes (ceph_tpu_torch/crush/mapper.py).
// The launch runs on the caller's stream, does not synchronise and
// allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>

#include "crush_rule.cuh"

namespace {

using crush_rule::crush_smem;
using crush_rule::LN_WORDS;

__global__ void crush_rule_kernel(crush_rule::Map m, crush_rule::Rule rule,
                                  const uint32_t* __restrict__ xs,
                                  long long n, int32_t* __restrict__ out) {
    // stage: the RH/LH rows, the LL entries, then records[0, n_staged)
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

    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         lane < n; lane += stride)
        crush_rule::map_seed(m, rule, xs[lane], out + lane * rule.result_max);
}

size_t smem_bytes(int n_staged) {
    return (size_t)(LN_WORDS + n_staged) * sizeof(uint4);
}

}  // namespace

extern "C" {

// What a launch is built from, on the current device: out[0..9] =
// registers per thread, local bytes per thread, static shared bytes per
// block, the block size the occupancy
// calculator picks (with only the crush_ln tables staged), resident
// blocks per SM at that size, shared memory per SM, shared memory a block
// may opt in to, shared memory the system reserves per block, SMs, and
// the bytes of shared memory a block holds before any record.
int crush_rule_plan(int* out) {
    const auto k = crush_rule_kernel;
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

// Pointers are device pointers, records and the crush_ln tables 16-byte
// aligned; u32 arrays are passed as their bit patterns.  `threads` lanes a
// block; the grid is as many blocks as fit on the card at once (at
// n_staged records a block), and never more than the seeds need.
int crush_rule_launch(
    const int32_t* headers, const int32_t* records, const int32_t* items,
    const uint32_t* nodes, const uint32_t* weight, const int64_t* rh_lh, const int64_t* ll,
    const int32_t* steps, int n_buckets, int positions, int max_devices,
    int max_depth, int weight_len, int n_steps, int result_max,
    int choose_total_tries, int chooseleaf_descend_once,
    int chooseleaf_vary_r, int chooseleaf_stable, int n_staged, int threads,
    const uint32_t* xs, long long n, int32_t* out, void* stream) {
    if (n <= 0) return cudaSuccess;
    if (result_max < 1 || result_max > crush_rule::RMAX_CAP ||
        n_staged < 0 || threads < 1)
        return cudaErrorInvalidValue;
    const auto k = crush_rule_kernel;
    const size_t smem = smem_bytes(n_staged);
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    int dev, sms, per_sm;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, k, threads, smem)) != cudaSuccess)
        return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long need = (n + threads - 1) / threads;
    const long long resident = (long long)per_sm * sms;
    const unsigned blocks = (unsigned)(need < resident ? need : resident);
    crush_rule::Map m{headers,
                      reinterpret_cast<const crush_rule::Record*>(records),
                      nullptr, items, weight, rh_lh, ll, n_staged,
                      n_buckets, positions, max_devices, max_depth,
                      weight_len, nodes};
    crush_rule::Rule rule{steps, n_steps, result_max, choose_total_tries,
                          chooseleaf_descend_once, chooseleaf_vary_r,
                          chooseleaf_stable};
    k<<<blocks, threads, smem, (cudaStream_t)stream>>>(m, rule, xs, n, out);
    return (int)cudaGetLastError();
}

const char* crush_rule_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
