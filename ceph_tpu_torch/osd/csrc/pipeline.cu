// The placement pipeline kernel for Hopper (sm_90a): every stage of a PG's
// placement in one launch, one thread per PG lane (body: pipeline.cuh):
//   ps -> placement seed -> CRUSH -> _remove_nonexistent_osds -> pg_upmap,
//   pg_upmap_items -> up filter, up_primary -> primary affinity ->
//   pg_temp, primary_temp
// int32 rows [N, width] padded with ITEM_NONE, and int32 primaries.
//
// It replaces ceph_tpu/osd/pipeline_jax.py::compile_pipeline (:221): the
// per-PG function fn (:298) that jax.jit(jax.vmap(fn)) (:699) compiles
// into one XLA program (not a Pallas kernel).  The port's plain version is
// the torch-op chain of ceph_tpu_torch/osd/pipeline.py (PoolMapper._raw,
// _up, _rows) around the rule's plain version, which on the card had run
// as the rule kernel between two chains of int64 torch ops on [N, W].
//
// What bounds it: instructions, as the rule kernel.  A lane reads its seed
// (8 B), a few overlay words and per-OSD entries, and writes 2 x 4 x width
// + 8 B; the rule's draws (a few hundred at 10k OSDs, about 174
// instructions each) dwarf the seed's hash and the at most `width`
// affinity hashes.  What the design does about it:
// - the rule runs as the rule kernel runs it (crush_rule::do_rule, the
//   crush_ln tables and the first n_staged records staged in dynamic
//   shared memory, a persistent grid whose block size the occupancy
//   calculator picks from this build's registers);
// - everything after the rule stays in the lane's registers and local
//   row: no [N, W] intermediate reaches device memory, and the outputs are
//   written once, as int32;
// - what a launch computes is fixed at launch (the mode, the overlays
//   present, affinity on or off), so a lane without an overlay reads none.
// Divergence between lanes that retry is left as it is.
//
// Prediction (written before this kernel's first run on the card; timed
// with pipeline_ab.py against the plain chain in turns, NVIDIA H100 80GB
// HBM3): config 5's map_all_device (10M PGs, 10k OSDs) from 173.8-175.0
// ms to about the rule kernel's 32.6-32.9 ms plus at most 1-2 ms (about
// 280 M mappings/s); the kernel within about 5 % of the rule kernel on
// the same PGs.
//
// Plain C entry points, bound with ctypes (osd/pipeline.py).  The launch
// runs on the caller's stream, does not synchronise and allocates
// nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>

#include "pipeline.cuh"

namespace {

using crush_rule::crush_smem;
using crush_rule::LN_WORDS;

__global__ void pipeline_kernel(crush_rule::Map m, crush_rule::Rule rule,
                                pipeline::Pipe p) {
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
         lane < p.n; lane += stride)
        pipeline::map_pg(m, rule, p, lane);
}

size_t smem_bytes(int n_staged) {
    return (size_t)(LN_WORDS + n_staged) * sizeof(uint4);
}

}  // namespace

extern "C" {

// crush_rule_plan's ten values for this kernel: registers per thread,
// local bytes per thread, static shared bytes per block, the occupancy
// calculator's block size (crush_ln tables staged), resident blocks per SM
// at that size, shared memory per SM, shared memory a block may opt in
// to, shared memory the system reserves per block, SMs, and the bytes of
// shared memory a block holds before any record.
int pipeline_plan(int* out) {
    const auto k = pipeline_kernel;
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

// The rule's arguments are crush_rule_launch's (the reweights as the
// mapper's int64 vector); `pipe` is a host pointer to the pool's operands,
// whose pointers are device pointers.  `threads` lanes a block; the grid
// is as many blocks as fit on the card at once (at n_staged records a
// block), and never more than the seeds need.
int pipeline_launch(
    const int32_t* headers, const int32_t* records, const int32_t* items,
    const uint32_t* nodes, const int64_t* weight, const int64_t* rh_lh,
    const int64_t* ll, const int32_t* steps, int n_buckets, int positions,
    int max_devices, int max_depth, int weight_len, int n_steps,
    int result_max, int choose_total_tries, int chooseleaf_descend_once,
    int chooseleaf_vary_r, int chooseleaf_stable, int n_staged, int threads,
    const pipeline::Pipe* pipe, void* stream) {
    const pipeline::Pipe p = *pipe;
    if (p.n <= 0) return cudaSuccess;
    if (result_max < 1 || result_max > crush_rule::RMAX_CAP ||
        p.width < result_max || p.width > pipeline::WMAX || n_staged < 0 ||
        threads < 1 || p.mode < pipeline::MODE_ROWS ||
        p.mode > pipeline::MODE_RAW)
        return cudaErrorInvalidValue;
    const auto k = pipeline_kernel;
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
    const long long need = (p.n + threads - 1) / threads;
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
    k<<<blocks, threads, smem, (cudaStream_t)stream>>>(m, rule, p);
    return (int)cudaGetLastError();
}

const char* pipeline_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
