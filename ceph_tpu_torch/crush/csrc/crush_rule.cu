// The CRUSH rule kernel for Hopper (sm_90a):
//   out[n, 0:result_max] = crush_do_rule(map, rule, x[n], result_max, weight)
// int32 rows padded with ITEM_NONE, one thread per PG lane.
//
// It replaces the XLA programs of ceph_tpu/crush/mapper_jax.py that the
// JAX package traces for every (map, rule): the straw2 draw
// (_straw2_choose, _straw2_rows, _ln_fn), the descent (_descend_rows,
// _descend_impl), the exact choose loops (_choose_firstn_one,
// _leaf_firstn, _choose_indep_one, _leaf_indep), _is_out and the
// interpreter of compile_rule's fn.  None of them was a Pallas kernel.
// The fast candidate window and its loop-kernel rescue are not carried
// over: they exist because XLA needs static shapes, and a per-lane
// interpreter with real loops is exact by itself.
//
// What bounds it: instruction issue, not bytes.  A lane reads 4 B (its
// seed) and writes 4 * result_max B, while it makes a few hundred straw2
// draws (at 10k OSDs in 1250 hosts of 8 under 78 racks, about
// 3 x (78 + 16 + 8) per PG), each one hash3, one crush_ln and one 64-bit
// divide: at the fewest about 174 instructions (counted in chip_smoke.py,
// DRAW_OPS).  The design keeps all of that on chip: the crush_ln tables
// (4 KB) are copied into shared memory once per block, a lane draws only
// the items of the buckets it visits, and its work vectors live in
// registers and local memory, never in HBM.  The bucket rows are read
// from global memory through L1.  Divergence between lanes that retry
// and the 64-bit divide are left as they are.
//
// Plain C entry points, bound with ctypes (ceph_tpu_torch/crush/mapper.py).
// The launch runs on the caller's stream, does not synchronise and
// allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>

#include "crush_rule.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void crush_rule_kernel(crush_rule::Map m, crush_rule::Rule rule,
                                  const uint32_t* __restrict__ xs,
                                  long long n, int32_t* __restrict__ out) {
    __shared__ int64_t s_rh_lh[258];
    __shared__ int64_t s_ll[256];
    for (int i = threadIdx.x; i < 258; i += blockDim.x)
        s_rh_lh[i] = m.rh_lh[i];
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s_ll[i] = m.ll[i];
    __syncthreads();
    m.rh_lh = s_rh_lh;
    m.ll = s_ll;

    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    int32_t res[crush_rule::RMAX_CAP];
    const int got = crush_rule::do_rule(m, rule, xs[lane], res);
    int32_t* row = out + lane * rule.result_max;
    for (int j = 0; j < rule.result_max; j++)
        row[j] = j < got ? res[j] : crush_rule::ITEM_NONE;
}

}  // namespace

extern "C" {

// Pointers are device pointers; u32 arrays are passed as their bit
// patterns.  n <= 2^31 * THREADS lanes.
int crush_rule_launch(
    const int32_t* btype, const int32_t* size, const int32_t* items,
    const uint32_t* pos_weights, const int32_t* arg_ids,
    const uint32_t* weight, const int64_t* rh_lh, const int64_t* ll,
    const int32_t* steps, int n_buckets, int max_size, int positions,
    int max_devices, int max_depth, int weight_len, int n_steps,
    int result_max, int choose_total_tries, int chooseleaf_descend_once,
    int chooseleaf_vary_r, int chooseleaf_stable, const uint32_t* xs,
    long long n, int32_t* out, void* stream) {
    if (n <= 0) return cudaSuccess;
    if (result_max < 1 || result_max > crush_rule::RMAX_CAP)
        return cudaErrorInvalidValue;
    crush_rule::Map m{btype, size, items, pos_weights, arg_ids, weight,
                      rh_lh, ll, n_buckets, max_size, positions,
                      max_devices, max_depth, weight_len};
    crush_rule::Rule rule{steps, n_steps, result_max, choose_total_tries,
                          chooseleaf_descend_once, chooseleaf_vary_r,
                          chooseleaf_stable};
    const long long blocks = (n + THREADS - 1) / THREADS;
    crush_rule_kernel<<<(unsigned)blocks, THREADS, 0,
                        (cudaStream_t)stream>>>(m, rule, xs, n, out);
    return (int)cudaGetLastError();
}

const char* crush_rule_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
