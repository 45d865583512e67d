// The CRUSH rule kernel's diagnostics variant for Hopper (sm_90a):
//   out[n, 0:result_max] = crush_do_rule(map, rule, x[n], result_max, weight)
// and beside each row the decision planes of one placement seed:
//   tries[n, 0:n_lanes]              retry count of each placement, -1 none
//   steps[n, 0:n_steps_rows, 0:RMAX] work vector after each choose step
//   tally[n, 0:4]                    collisions, out-of-weight rejections,
//                                    skips, bad (row shorter than RMAX)
// one thread per PG lane.
//
// It replaces the instrumented XLA program of ceph_tpu/crush/mapper_jax.py
// (compile_rule(..., with_diag=True) :1529, the diag tallies of
// _choose_firstn_one_fast :1214-1283 and _choose_indep_one_fast
// :1509-1525), which PoolMapper.diagnose, crush/explain.py's diag_batch
// and `crushtool --test --show-choose-tries` run.  The JAX program
// rebuilds the retry counts from its candidate window, so only the lanes
// the window decides are exact; this kernel walks the C interpreter's
// loops (crush_rule.cuh, built with CRUSH_RULE_DIAG) and every lane is
// exact.  The lane layout is the wrapper's plan (`plan`, laid out by
// crush/mapper.py::compile_rule; see crush_rule.cuh Diag).
//
// The rows are the rule kernel's (crush_rule.cu): the same body, the same
// staging of the crush_ln tables and the top records in shared memory, the
// same persistent grid.  crush_rule.cu is left as it is, so the default
// kernel's code does not change with this variant; the staging and grid
// plumbing below is its copy.  What the variant adds is stores: about
// 4 * (n_lanes + n_steps_rows * RMAX + 4) bytes a lane, written by the
// lane that owns them, and a few registers of tallies.
//
// Plain C entry points, bound with ctypes (ceph_tpu_torch/crush/mapper.py).

#include <cuda_runtime.h>

#define CRUSH_RULE_DIAG
#include "crush_rule.cuh"

namespace {

using crush_rule::crush_smem;
using crush_rule::LN_WORDS;

__global__ void crush_rule_diag_kernel(
    crush_rule::Map m, crush_rule::Rule rule, const int32_t* __restrict__ plan,
    int n_lanes, int n_steps_rows, const uint32_t* __restrict__ xs,
    long long n, int32_t* __restrict__ out, int32_t* __restrict__ tries,
    int32_t* __restrict__ steps, int32_t* __restrict__ tally) {
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
    const long long step_words = (long long)n_steps_rows * rule.result_max;
    for (long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         lane < n; lane += stride) {
        crush_rule::Diag d{plan, tries + lane * n_lanes,
                           steps + lane * step_words, {0, 0, 0}};
        crush_rule::map_seed_diag(m, rule, xs[lane],
                                  out + lane * rule.result_max, d, n_lanes,
                                  n_steps_rows, tally + 4 * lane);
    }
}

size_t smem_bytes(int n_staged) {
    return (size_t)(LN_WORDS + n_staged) * sizeof(uint4);
}

}  // namespace

extern "C" {

// crush_rule_plan's ten values (crush_rule.cu) for this kernel.
int crush_rule_diag_plan(int* out) {
    const auto k = crush_rule_diag_kernel;
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

// crush_rule_launch's arguments (crush_rule.cu), then the plan
// ([n_steps, 3] int32, on the device), the planes' widths and the planes:
// tries [n, n_lanes], steps [n, n_steps_rows, result_max], tally [n, 4].
int crush_rule_diag_launch(
    const int32_t* headers, const int32_t* records, const int32_t* items,
    const uint32_t* nodes, const uint32_t* weight, const int64_t* rh_lh,
    const int64_t* ll, const int32_t* steps, int n_buckets, int positions,
    int max_devices, int max_depth, int weight_len, int n_steps,
    int result_max, int choose_total_tries, int chooseleaf_descend_once,
    int chooseleaf_vary_r, int chooseleaf_stable, int n_staged, int threads,
    const uint32_t* xs, long long n, int32_t* out, const int32_t* plan,
    int n_lanes, int n_steps_rows, int32_t* tries, int32_t* step_rows,
    int32_t* tally, void* stream) {
    if (n <= 0) return cudaSuccess;
    if (result_max < 1 || result_max > crush_rule::RMAX_CAP ||
        n_staged < 0 || threads < 1 || n_lanes < 0 || n_steps_rows < 0)
        return cudaErrorInvalidValue;
    const auto k = crush_rule_diag_kernel;
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
    k<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        m, rule, plan, n_lanes, n_steps_rows, xs, n, out, tries, step_rows,
        tally);
    return (int)cudaGetLastError();
}

const char* crush_rule_diag_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
