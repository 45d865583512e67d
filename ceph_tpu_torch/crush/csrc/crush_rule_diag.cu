// The CRUSH rule kernel's diagnostics variant for Hopper (sm_90a): the
// rule walk of crush_rule.cuh, built with CRUSH_RULE_DIAG, over a batch of
// seeds, in one of two modes fixed at launch:
//   planes   out[n, 0:result_max] = crush_do_rule(map, rule, x[n], ...)
//            and beside each row the decision planes of its seed:
//              tries[n, 0:n_lanes]              retry count of each
//                                               placement, -1 none
//              steps[n, 0:n_steps_rows, 0:RMAX] work vector after each
//                                               choose step
//              tally[n, 0:4]                    collisions, out-of-weight
//                                               rejections, skips, bad
//                                               (row shorter than RMAX)
//   summary  no rows and no planes: summary[0:bound+1] the histogram of
//            every tries lane's value in [0, bound] (the rest dropped),
//            summary[bound+1:bound+6] the sums of coll, rej, skip, bad
//            and the retry lanes left at -1 (exhausted); uint64, added to
//            a zeroed buffer.
// A seed is x[i] as given, or the placement seed of a PG computed in its
// lane (osd/csrc/placement_seed.cuh: ceph_stable_mod, then hash32_2 with
// the pool id) from ps[i], or from first + i where no ps is given.
//
// It replaces the instrumented XLA program of ceph_tpu/crush/mapper_jax.py
// (compile_rule(..., with_diag=True) :1529, the diag tallies of
// _choose_firstn_one_fast :1214-1283 and _choose_indep_one_fast
// :1509-1525), and the reduction of its planes in
// ceph_tpu/osd/pipeline_jax.py::PoolMapper.diagnose (:781-850), which
// computes the seed inside its program (compile_pipeline(...,
// with_diag=True) :232).  The JAX program rebuilds the retry counts from
// its candidate window, so only the lanes the window decides are exact;
// this kernel walks the C interpreter's loops and every lane is exact.
// The lane layout is the wrapper's plan (`plan`, laid out by
// crush/mapper.py::compile_rule; see crush_rule.cuh Diag).
//
// What bounds it: the rule's draws, as the rule kernel (instructions; a
// few hundred straw2 draws a PG at config 5).  What the design does:
// - summary mode writes nothing a seed: each PG hands each tries lane to
//   the sink once, with its final value (crush_rule.cuh Summary).  The
//   tallies, the bad flag, the exhausted retry lanes and the histogram's
//   first four bins (nearly every booking) go to counters of the lane's
//   own in shared memory: no atomic, and no register held across the
//   walk (in registers they made the walk spill 116 B at G = 1; with
//   every bin a shared 64-bit atomic add, bin 0 taken by a whole warp
//   at once, config 5 ran 3.3 % above the pipeline kernel, diag_ab.py).
//   The higher bins are the block's uint64 counters after the staged
//   records, one shared atomic a booking.  At the end each lane's counts
//   are summed over the warp by shuffles, over the block in shared
//   memory, and each of the bound + 6 counters is added to the output
//   with one 64-bit atomic a block.  Integer sums: exact in any order.
//   diagnose() makes one launch and reads bound + 6 integers a block of
//   up to 2^24 PGs, where it had written and reduced 13 int32 a PG;
// - planes mode writes the planes as the variant always did (the rows,
//   -1 / ITEM_NONE filled, then the walk's values);
// - the staging and the persistent grid are launch.cuh's, shared with the
//   rule and pipeline kernels;
// - a launch smaller than the card maps each PG with a group of G lanes
//   (diag_kernel<G, MODE>), G by the pipeline's rule (launch.cuh
//   group_for, on this kernel's one-lane instance): every lane of a group
//   runs the seed and the walk on the same values, the straw2 draws split
//   over the group (crush_rule.cuh straw2_group), so their tallies and
//   lanes agree; the first lane alone books and stores (the sink's
//   `store`), and no lane leaves the walk early, so the shuffles always
//   find their group whole.
// Divergence between groups that retry is left as it is.
//
// Prediction (written before this kernel's first run on the card;
// diag_ab.py, the parent tree and this one in turns, NVIDIA H100 80GB
// HBM3): config 5's diagnose() (10M PGs) from about 54 ms of entry to
// near the pipeline kernel's 32.8 ms; the summary kernel within about 1 %
// of the pipeline kernel on the same PGs; the 512-seed sample's launch
// from about the one-lane time to under 0.05 ms; --show-choose-tries on
// 2^20 seeds without its plane writes and reductions; planes mode at
// config 5 within 1 % of the parent.
//
// Plain C entry points, bound with ctypes (ceph_tpu_torch/crush/mapper.py).
// The launch runs on the caller's stream, does not synchronise and
// allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>

#define CRUSH_RULE_DIAG
#include "crush_rule.cuh"
#include "launch.cuh"
#include "../../osd/csrc/placement_seed.cuh"

namespace crush_diag {

enum { MODE_PLANES = 0, MODE_SUMMARY = 1 };
constexpr int SUMS = crush_rule::N_SUMS;  // coll, rej, skip, bad, exhausted

// One launch's operands (ctypes mirrors this layout: crush/mapper.py,
// _DiagArgs).  Pointers are device pointers.
struct DiagArgs {
    const uint32_t* xs;  // [n] seeds as given, or null: placement seeds
    const int64_t* ps;   // [n] PG seeds (u32 values), or null: first + i
    long long first, n;
    uint32_t pool_id, pgp_num, pgp_mask;
    int32_t hashpspool;
    const int32_t* plan;  // [n_steps, 3]
    int32_t n_lanes, n_steps_rows, n_retry, bound, mode;
    int32_t* out;    // planes: [n, result_max]
    int32_t* tries;  // planes: [n, n_lanes]
    int32_t* steps;  // planes: [n, n_steps_rows, result_max]
    int32_t* tally;  // planes: [n, 4]
    unsigned long long* summary;  // summary: [bound + 1 + SUMS], zeroed
};

}  // namespace crush_diag

namespace {

using crush_diag::DiagArgs;
using crush_diag::MODE_PLANES;
using crush_diag::MODE_SUMMARY;
using crush_diag::SUMS;
using crush_rule::crush_smem;
using crush_rule::LN_WORDS;

__device__ __forceinline__ uint32_t seed_at(const DiagArgs& a, long long i) {
    if (a.xs) return __ldg(a.xs + i);
    const uint32_t ps = a.ps ? (uint32_t)__ldg(a.ps + i)
                             : (uint32_t)(a.first + i);
    return placement::placement_seed(ps, a.pgp_num, a.pgp_mask,
                                     a.hashpspool, a.pool_id);
}

// Summary mode's dynamic shared memory after the staged records: the
// histogram's uint64 counters (16-byte aligned), then each lane's
// N_COUNTS uint32 counters (crush_rule.cuh Summary), counter k of lane t
// at [k * threads + t].
__host__ __device__ inline size_t hist_bytes(int bound) {
    return ((size_t)(bound + 1) * 8 + 15) / 16 * 16;
}

inline size_t summary_bytes(int mode, int bound, int threads) {
    return mode == MODE_SUMMARY
               ? hist_bytes(bound) +
                     (size_t)crush_rule::N_COUNTS * 4 * threads
               : 0;
}

// One PG a group of G aligned lanes (blockDim.x a multiple of 32);
// G = 1 is one PG a thread.  The bound, as the pipeline kernel's, gives
// every instance 64 registers and one block of 1024 threads an SM.
template <int G, int MODE>
__global__ void __launch_bounds__(1024, 1)
    diag_kernel(crush_rule::Map m, crush_rule::Rule rule, DiagArgs a) {
    __shared__ unsigned long long sums[SUMS];
    unsigned long long* hist =
        reinterpret_cast<unsigned long long*>(crush_smem + LN_WORDS +
                                              m.n_staged);
    uint32_t* counts = reinterpret_cast<uint32_t*>(
        reinterpret_cast<char*>(hist) + hist_bytes(a.bound)) + threadIdx.x;
    if (MODE == MODE_SUMMARY) {
        // zeroed before stage()'s barrier
        for (int i = threadIdx.x; i <= a.bound; i += blockDim.x) hist[i] = 0;
        for (int k = 0; k < crush_rule::N_COUNTS; k++)
            counts[k * blockDim.x] = 0;
        if (threadIdx.x < SUMS) sums[threadIdx.x] = 0;
    }
    crush_launch::stage(m);

    const bool store = (threadIdx.x & (G - 1)) == 0;
    const int per_block = blockDim.x / G;
    const long long stride = (long long)gridDim.x * per_block;
    crush_rule::Summary s{a.plan,  hist,      counts, (int)blockDim.x,
                          a.bound, a.n_retry, store};
    for (long long pg = (long long)blockIdx.x * per_block + threadIdx.x / G;
         pg < a.n; pg += stride) {
        const uint32_t x = seed_at(a, pg);
        if constexpr (MODE == MODE_PLANES) {
            const long long step_words =
                (long long)a.n_steps_rows * rule.result_max;
            crush_rule::Diag d{a.plan, a.tries + pg * a.n_lanes,
                               a.steps + pg * step_words, {0, 0, 0}, store};
            crush_rule::map_seed_diag<G>(m, rule, x,
                                         a.out + pg * rule.result_max, d,
                                         a.n_lanes, a.n_steps_rows,
                                         a.tally + 4 * pg);
        } else {
            crush_rule::summarize_seed<G>(m, rule, x, s);
        }
    }
    if constexpr (MODE == MODE_SUMMARY) {
        // the lanes' counts (the store lanes'; the other lanes of a group
        // counted the same): over the warp by shuffles, over the block in
        // shared memory (the sums, and the low bins into the histogram),
        // then one 64-bit atomic a counter a block
        for (int k = 0; k < crush_rule::N_COUNTS; k++) {
            unsigned long long v = store ? counts[k * blockDim.x] : 0;
            for (int o = 16; o > 0; o >>= 1)
                v += __shfl_xor_sync(0xffffffffu, v, o);
            if ((threadIdx.x & 31) == 0 && v)
                atomicAdd(k < SUMS ? sums + k : hist + (k - SUMS), v);
        }
        __syncthreads();
        for (int i = threadIdx.x; i <= a.bound + SUMS; i += blockDim.x) {
            const unsigned long long c =
                i <= a.bound ? hist[i] : sums[i - a.bound - 1];
            if (c) atomicAdd(a.summary + i, c);
        }
    }
}

using Kernel = void (*)(crush_rule::Map, crush_rule::Rule, DiagArgs);

template <int MODE>
Kernel kernel_in(int group) {
    switch (group) {
    case 1: return diag_kernel<1, MODE>;
    case 2: return diag_kernel<2, MODE>;
    case 4: return diag_kernel<4, MODE>;
    case 8: return diag_kernel<8, MODE>;
    case 16: return diag_kernel<16, MODE>;
    case 32: return diag_kernel<32, MODE>;
    default: return nullptr;
    }
}

Kernel kernel_of(int mode, int group) {
    return mode == MODE_PLANES    ? kernel_in<MODE_PLANES>(group)
           : mode == MODE_SUMMARY ? kernel_in<MODE_SUMMARY>(group)
                                  : nullptr;
}

}  // namespace

extern "C" {

// crush_rule_plan's ten values (launch.cuh plan_values) for the kernel of
// `mode` (0 planes, 1 summary) and group G (1, 2, 4, ..., 32).
int crush_rule_diag_plan(int mode, int group, int* out) {
    const Kernel k = kernel_of(mode, group);
    if (!k) return cudaErrorInvalidValue;
    return crush_launch::plan_values(k, out);
}

// The group a launch of n seeds in `mode` at `threads` a block runs with,
// into *group (launch.cuh group_for on the mode's one-lane kernel).
int crush_rule_diag_group(int mode, long long n, int threads, int* group) {
    const Kernel k1 = kernel_of(mode, 1);
    if (!k1 || n < 0 || threads < 1) return cudaErrorInvalidValue;
    return (int)crush_launch::group_for(k1, n, threads, group);
}

// crush_rule_launch's arguments through `threads` (crush_rule.cu; `xs`
// and the rows are in `args`), then a host pointer to the launch's
// DiagArgs.  `threads` lanes a block, a multiple of 32 (fewer in a group
// launch that spreads over the SMs); the grid is as many blocks as fit
// on the card at once (at n_staged records and, in summary mode, the
// histogram a block), and never more than the seeds' groups need.
int crush_rule_diag_launch(
    const int32_t* headers, const int32_t* records, const int32_t* items,
    const uint32_t* nodes, const uint32_t* weight, const int64_t* rh_lh,
    const int64_t* ll, const int32_t* steps, int n_buckets, int positions,
    int max_devices, int max_depth, int weight_len, int n_steps,
    int result_max, int choose_total_tries, int chooseleaf_descend_once,
    int chooseleaf_vary_r, int chooseleaf_stable, int n_staged, int threads,
    const DiagArgs* args, void* stream) {
    const DiagArgs a = *args;
    if (a.n <= 0) return cudaSuccess;
    if (result_max < 1 || result_max > crush_rule::RMAX_CAP ||
        n_staged < 0 || threads < 1 || threads % 32 || a.n_lanes < 0 ||
        a.n_steps_rows < 0 || a.n_retry < 0 || a.n_retry > a.n_lanes ||
        (a.mode == MODE_SUMMARY && (a.bound < 0 || !a.summary)))
        return cudaErrorInvalidValue;
    const Kernel k1 = kernel_of(a.mode, 1);
    if (!k1) return cudaErrorInvalidValue;
    int group;
    cudaError_t e = crush_launch::group_for(k1, a.n, threads, &group);
    if (e != cudaSuccess) return e;
    const Kernel k = kernel_of(a.mode, group);
    // at the one-lane block, which a group launch's never exceeds
    const size_t smem = crush_launch::smem_bytes(n_staged) +
                        summary_bytes(a.mode, a.bound, threads);
    unsigned blocks;
    if ((e = crush_launch::grid_for(k, a.n, group, smem, &threads,
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
    k<<<blocks, threads, smem, (cudaStream_t)stream>>>(m, rule, a);
    return (int)cudaGetLastError();
}

const char* crush_rule_diag_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
