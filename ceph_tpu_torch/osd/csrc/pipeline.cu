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
//   present, affinity on or off), so a lane without an overlay reads none;
// - a launch smaller than the card maps each PG with a group of G lanes
//   (pipeline_kernel<G>).  A lane's serial descent is the whole
//   critical path of such a launch: at config 5 a PG makes about 306
//   straw2 draws (3 replicas of a root of 78 racks, a rack of 16 hosts, a
//   host of 8 OSDs), each about 174 dependent instructions, and an 8192-PG
//   launch fills 8 of the 132 SMs.  G is the largest power of two up to
//   32 with n * G <= the G = 1 kernel's resident lanes (blocks per SM x
//   threads x SMs, pipeline_plan): 1 at config 5 and config 2, 4 at a
//   fleet member's 32 768 PGs, 16 at serving's 8192-lane sub-block, 32 at
//   a micro-batch of 64.  The grid-stride loop counts PGs; every lane of
//   a group runs the seed and the rule's control flow and the straw2
//   draws are split over the group (crush_rule.cuh straw2_group: a
//   strided partial per lane, a butterfly of shuffles); the group's first
//   lane runs the stages after the rule.  Such a launch spreads its lanes over
//   the SMs in blocks of at least MIN_GROUP_BLOCK threads.  G = 1 is one
//   PG a thread and the serial straw2 loop (straw2_choose).
// Divergence between groups (and, at G = 1, lanes) that retry is left as
// it is.
//
// Prediction (written before this kernel's first run on the card; timed
// with pipeline_ab.py against the plain chain in turns, NVIDIA H100 80GB
// HBM3): config 5's map_all_device (10M PGs, 10k OSDs) from 173.8-175.0
// ms to about the rule kernel's 32.6-32.9 ms plus at most 1-2 ms (about
// 280 M mappings/s); the kernel within about 5 % of the rule kernel on
// the same PGs.
//
// Prediction for the groups (written before their first run on the card;
// pipeline_ab.py, the parent tree and this one in turns, NVIDIA H100 80GB
// HBM3), from the bucket sizes and about 174 instructions a draw: at
// G = 16 a replica's 102 draws become 5 + 1 + 1 strided rounds and three
// 4-step butterflies, so serving's 8192-lane sub-block of config 5 from
// 0.642 ms to about 0.06-0.12 ms (map_batch from 0.99 ms to about 0.4-0.5
// ms of host wall); a 64-lane batch (G = 32) from about 0.6 ms to under
// 0.06 ms; a fleet member's 32 768-PG pool (G = 4, a root of 8 racks,
// racks of 16 hosts, hosts of 8) about 3x shorter; config 5 and config 2
// (G = 1) within 1 % of the parent.
//
// Plain C entry points, bound with ctypes (osd/pipeline.py).  The launch
// runs on the caller's stream, does not synchronise and allocates
// nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>

#include "pipeline.cuh"
#include "../../crush/csrc/launch.cuh"

namespace {

// One PG a group of G aligned lanes (blockDim.x a multiple of 32 when
// G > 1); G = 1 is one PG a thread.  The bound gives every G 64
// registers and one block of 1024 threads an SM: with 1024 alone ptxas
// takes 32 registers at G > 1 and spills.
template <int G>
__global__ void __launch_bounds__(1024, 1)
    pipeline_kernel(crush_rule::Map m, crush_rule::Rule rule,
                    pipeline::Pipe p) {
    crush_launch::stage(m);
    const int per_block = blockDim.x / G;
    const long long stride = (long long)gridDim.x * per_block;
    for (long long pg = (long long)blockIdx.x * per_block + threadIdx.x / G;
         pg < p.n; pg += stride)
        pipeline::map_pg<G>(m, rule, p, pg);
}

using Kernel = void (*)(crush_rule::Map, crush_rule::Rule, pipeline::Pipe);

Kernel kernel_of(int group) {
    switch (group) {
    case 1: return pipeline_kernel<1>;
    case 2: return pipeline_kernel<2>;
    case 4: return pipeline_kernel<4>;
    case 8: return pipeline_kernel<8>;
    case 16: return pipeline_kernel<16>;
    case 32: return pipeline_kernel<32>;
    default: return nullptr;
    }
}

}  // namespace

extern "C" {

// crush_rule_plan's ten values for the kernel of group G (1: one PG a
// thread; 2 to 32, a power of two): registers per thread, local bytes per
// thread, static shared bytes per block, the occupancy calculator's block
// size (crush_ln tables staged), resident blocks per SM at that size,
// shared memory per SM, shared memory a block may opt in to, shared
// memory the system reserves per block, SMs, and the bytes of shared
// memory a block holds before any record.
int pipeline_plan(int group, int* out) {
    const Kernel k = kernel_of(group);
    if (!k) return cudaErrorInvalidValue;
    return crush_launch::plan_values(k, out);
}

// The group a launch of n PGs at `threads` a block runs with, into *group.
int pipeline_group(long long n, int threads, int* group) {
    if (n < 0 || threads < 1) return cudaErrorInvalidValue;
    return (int)crush_launch::group_for(pipeline_kernel<1>, n, threads,
                                        group);
}

// The rule's arguments are crush_rule_launch's (the reweights as the
// mapper's int64 vector); `pipe` is a host pointer to the pool's operands,
// whose pointers are device pointers.  The group is pipeline_group's.
// `threads` lanes a block (a multiple of 32), fewer in a group launch
// that spreads over the SMs; the grid is as many blocks as fit on the
// card at once (at n_staged records a block), and never more than the
// PGs' groups need.
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
    int group;
    cudaError_t e =
        crush_launch::group_for(pipeline_kernel<1>, p.n, threads, &group);
    if (e != cudaSuccess) return e;
    if (group > 1 && threads % 32) return cudaErrorInvalidValue;
    const Kernel k = kernel_of(group);
    const size_t smem = crush_launch::smem_bytes(n_staged);
    unsigned blocks;
    if ((e = crush_launch::grid_for(k, p.n, group, smem, &threads,
                                    &blocks)) != cudaSuccess)
        return e;
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
