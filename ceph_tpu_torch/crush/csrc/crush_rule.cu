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
//   (the staging and the grid are launch.cuh's, shared with the
//   diagnostics variant and the pipeline kernel)
// - work vectors of RMAX_CAP entries in local memory (ptxas reports no
//   spills from them; `-Xptxas=-v`, printed by chip_smoke.py).
// Divergence between lanes that retry is left as it is.
//
// Plain C entry points, bound with ctypes (ceph_tpu_torch/crush/mapper.py).
// The launch runs on the caller's stream, does not synchronise and
// allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>

#include "crush_rule.cuh"
#include "launch.cuh"

namespace {

__global__ void crush_rule_kernel(crush_rule::Map m, crush_rule::Rule rule,
                                  const uint32_t* __restrict__ xs,
                                  long long n, int32_t* __restrict__ out) {
    crush_launch::stage(m);
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         lane < n; lane += stride)
        crush_rule::map_seed(m, rule, xs[lane], out + lane * rule.result_max);
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
    return crush_launch::plan_values(crush_rule_kernel, out);
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
    unsigned blocks;
    const cudaError_t e = crush_launch::grid_for(
        k, n, 1, crush_launch::smem_bytes(n_staged), &threads, &blocks);
    if (e != cudaSuccess) return e;
    crush_rule::Map m{headers,
                      reinterpret_cast<const crush_rule::Record*>(records),
                      nullptr, items, weight, rh_lh, ll, n_staged,
                      n_buckets, positions, max_devices, max_depth,
                      weight_len, nodes};
    crush_rule::Rule rule{steps, n_steps, result_max, choose_total_tries,
                          chooseleaf_descend_once, chooseleaf_vary_r,
                          chooseleaf_stable};
    k<<<blocks, threads, crush_launch::smem_bytes(n_staged),
        (cudaStream_t)stream>>>(m, rule, xs, n, out);
    return (int)cudaGetLastError();
}

const char* crush_rule_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
