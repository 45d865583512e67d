// The device_loop upmap plan for Hopper (sm_90a): one cooperative launch
// runs a whole plan, every round on the card, and writes one int64 buffer
// that the host reads back once (layout: upmap_loop.cuh, OUT_*).
//
// It replaces ceph_tpu/balancer/upmap.py::_loop_account (:718), the XLA
// program whose lax.while_loop (:867) runs the whole multi-round greedy
// in one dispatch (not a Pallas kernel).  The port's plain version is
// ceph_tpu_torch/balancer/upmap.py::_loop_plan: torch ops with one host
// read per round.
//
// What bounds it: bytes, at scale.  Each round reads every row (int32
// [N, w]), the movable mask and a bit per PG once: at 10M PGs x 3 that is
// 131 MB, 0.039 ms of HBM.  The rest is O(OSDs x candidates) and latency:
// grid barriers, selections over the OSDs, the candidates' order.
// What the design does about it (the schedule: upmap_loop.cuh, run_plan):
// - one launch a plan: a persistent grid (blocks per SM from the
//   occupancy calculator, times the SMs), launched cooperatively (every
//   block resident) so that a grid barrier of its own (DeviceGrid::sync,
//   polls with a sleep between reads) separates the stages and the
//   continue flag stays on the card.  The last block to reach a barrier runs the
//   short serial sections (the resolve, the apply) before it releases
//   the others: two barriers a round when the candidates fit one group;
// - phase (a) is a grid-stride pass over the PGs, PA_U PGs in flight a
//   thread, the next PA_U loaded before these settle their picks (a row's
//   width is a template argument up to 8); the caller's rows are read
//   every round as a stream that L2 evicts first (no copy): the PGs the
//   plan changed are an overlay, skipped by their bit and taken from
//   their overlay rows.  Each block keeps the round's float32 deviations
//   and its own picks in shared memory (up to OD_SMEM_OSDS OSDs): the
//   three gathers of a PG hit shared memory, a PG lowers its block's
//   pick there, and each block takes its picks to the grid's with one
//   atomicMin an OSD at the end (reading or lowering the grid's pick in
//   L2 for every PG set the pace at 10M PGs);
// - the top-B is one selection pass (B <= 32) in block 0 while the other
//   blocks run phase (a).  A selection (DeviceBlock::smallest) reads its
//   elements twice, SEL_U a thread at once: a warp's k-th smallest of the
//   threads' first elements bounds the answer, and the few elements
//   within the bound are gathered and ranked (warp bitonic sorts, binary
//   searches between the warps' lists); a selection of one is a block
//   minimum;
// - a round's candidates are resolved in order, exactly, from shortlists
//   built in parallel: one block per candidate takes its first 2j + 1
//   allowed targets from its pool's first PREFIX (selected by the last
//   block beside phase (a) in plans of PREFIX_PGS PGs an OSD or more), or
//   where those are not kept or do not hold them selects them from every
//   OSD; one warp of the last block walks them in order,
//   lane j keeping which of candidate j's targets and whether its source
//   the earlier ones used;
// - the deviations move only at the OSDs a round moved: the last block
//   updates those, their lanes of the ordered sum and the class counts
//   that decide the next round's overfull set and the exits.
//
// Prediction (written before this design's first run on the card; timed
// with upmap_loop_ab.py against the parent in turns, NVIDIA H100 80GB
// HBM3): config 5's plan (1 round, 10 changes, 16 candidates) from
// 0.503-0.525 ms to at most 0.15 ms (its bound 0.0388 ms a round);
// config 5 with one candidate a round (10 rounds) from 2.39 ms to at most
// 1.0 ms; config 2 from 0.090-0.091 ms to at most 0.04 ms; the fleet
// member's plan (1024 OSDs, 32768 PGs of 3) measured beside its parent.
//
// Plain C entry points, bound with ctypes (balancer/upmap.py).  The
// launch runs on the caller's stream, does not synchronise and allocates
// nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>

#include "upmap_loop.cuh"

namespace {

using upmap_loop::Best;
using upmap_loop::Cand;
using upmap_loop::THREADS;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = THREADS / 32;
constexpr int SEL_U = 4;  // elements a lane of a selection reads at once

__device__ inline Best shfl(Best v, int src) {
    return Best{__shfl_sync(FULL, v.v, src), __shfl_sync(FULL, v.i, src)};
}

// A block of THREADS threads; its reductions and selections go through
// shared memory.
struct DeviceBlock {
    Best* red;        // [WARPS] per-warp partials, then the result
    int* ired;        // [WARPS]
    Best* lists;      // [THREADS] the warps' lists; a group's shortlists
    Best* cands;      // [THREADS] a selection's gathered elements
    Best* sel;        // [32] a selection's result
    Cand* cand;       // [GROUP]
    int32_t* nu;      // [2 * GROUP] the group's used OSDs
    int32_t* stage;   // [2 * W_CAP]
    int* flag;        // the barrier's "last to arrive"
    int* count;       // a selection's gathered elements
    Best* grp;        // = lists
    float* odsm;      // [dv] phase (a)'s deviations (dynamic)
    int32_t* spick;   // [dv] phase (a)'s picks of this block (dynamic), or null

    __host__ __device__ int tid() const {
#ifdef __CUDA_ARCH__
        return threadIdx.x;
#else
        return 0;
#endif
    }
    __host__ __device__ int size() const { return THREADS; }
    __host__ __device__ int warp() const { return tid() >> 5; }
    __host__ __device__ int lane() const { return tid() & 31; }
    __host__ __device__ int lanes() const { return 32; }
    __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
        __syncthreads();
#endif
    }
    __host__ __device__ void warp_sync() const {
#ifdef __CUDA_ARCH__
        __syncwarp();
#endif
    }
    // the block's best element, seen by every thread
    __host__ __device__ Best reduce(Best v, bool hi) const {
#ifdef __CUDA_ARCH__
        const int ln = lane(), w = warp();
        for (int off = 16; off > 0; off >>= 1)
            v = upmap_loop::prefer(v, shfl(v, ln + off < 32 ? ln + off : ln),
                                   hi);
        if (ln == 0) red[w] = v;
        __syncthreads();
        if (w == 0) {
            v = ln < WARPS ? red[ln] : upmap_loop::none(hi);
            for (int off = 16; off > 0; off >>= 1)
                v = upmap_loop::prefer(
                    v, shfl(v, ln + off < 32 ? ln + off : ln), hi);
            if (ln == 0) red[0] = v;
        }
        __syncthreads();
        const Best r = red[0];
        __syncthreads();
        return r;
#else
        (void)hi;
        return v;
#endif
    }
    // the block's sum, seen by every thread
    __host__ __device__ int sum(int v) const {
#ifdef __CUDA_ARCH__
        v = __reduce_add_sync(FULL, v);
        if (lane() == 0) ired[warp()] = v;
        __syncthreads();
        int s = 0;
        for (int w = 0; w < WARPS; w++) s += ired[w];
        __syncthreads();
        return s;
#else
        return v;
#endif
    }
    // This warp's entries x (one a lane) sorted, bitonic, by shuffles.
    __host__ __device__ Best warp_sort(Best x) const {
#ifdef __CUDA_ARCH__
        const int ln = lane();
        for (int size = 2; size <= 32; size <<= 1) {
            for (int j = size >> 1; j > 0; j >>= 1) {
                const Best o = Best{__shfl_xor_sync(FULL, x.v, j),
                                    __shfl_xor_sync(FULL, x.i, j)};
                // an ascending run's lower lane keeps the first of the
                // pair, a descending run's the last
                const bool first = ((ln & size) == 0) == ((ln & j) == 0);
                if (first ? upmap_loop::before(o, x) : upmap_loop::before(x, o))
                    x = o;
            }
        }
#endif
        return x;
    }
    // Among the block's entries x (one a thread, or none; the real ones
    // in the first nw warps), the k (<= 32) first in (v, i) order land in
    // sel at their ranks; returns how many real entries there are.  An
    // entry's rank is its place in its warp's sorted list plus, in each
    // other warp's list, the entries before it (binary searches of fixed
    // steps, independent of each other).
    __host__ __device__ int rank_block(Best x, int k, int nw) const {
#ifdef __CUDA_ARCH__
        const int ln = lane(), w = warp();
        x = warp_sort(x);
        lists[32 * w + ln] = x;
        __syncthreads();
        const bool real = x.i != upmap_loop::NO_INDEX;
        if (ln < k && real) {
            int rank = ln;
            for (int w2 = 0; w2 < nw; w2++) {
                if (w2 == w) continue;
                const Best* l = lists + 32 * w2;
                int at = 0;
#pragma unroll
                for (int h = 16; h > 0; h >>= 1)
                    if (upmap_loop::before(l[at + h - 1], x)) at += h;
                // (the halvings reach 31; the last entry decides 32)
                rank += at + upmap_loop::before(l[at], x);
            }
            if (rank < k) sel[rank] = x;
        }
        return __syncthreads_count(real);
#else
        (void)x, (void)k, (void)nw;
        return 0;
#endif
    }
    // An upper bound of the block's k-th smallest entry (one a thread):
    // the least of the warps' k-th smallest, or none if no warp holds k.
    __host__ __device__ Best bound_k(Best x, int k) const {
#ifdef __CUDA_ARCH__
        x = warp_sort(x);
        const Best kth = Best{__shfl_sync(FULL, x.v, k - 1),
                              __shfl_sync(FULL, x.i, k - 1)};
        if (lane() == 0) red[warp()] = kth;
        __syncthreads();
        Best b = upmap_loop::none(false);
        for (int w = 0; w < WARPS; w++)
            if (upmap_loop::before(red[w], b)) b = red[w];
        __syncthreads();
        return b;
#else
        (void)k;
        return x;
#endif
    }
    // The k (<= 32) first elements d < n that admit(d, fetch(d), v)
    // admits, in (v, d) order, into sel; returns how many.  A bound of
    // the k-th smallest (bound_k of the threads' first elements: k
    // threads each hold one no later) leaves few elements within it;
    // those are gathered in shared memory and ranked.  Should more than
    // THREADS be within it, the k-th of those gathered bounds it anew,
    // and they are gathered again.  Each thread fetches SEL_U elements
    // before it decides on the first.
    template <class Fetch, class Admit>
    __host__ __device__ int smallest(int k, int n, Fetch fetch,
                                     Admit admit) const {
#ifdef __CUDA_ARCH__
        const int t = tid();
        const Best no = upmap_loop::none(false);
        Best m = no;
        for (int d0 = t; d0 < n; d0 += THREADS * SEL_U) {
            decltype(fetch(0)) f[SEL_U];
#pragma unroll
            for (int q = 0; q < SEL_U; q++)
                if (d0 + q * THREADS < n) f[q] = fetch(d0 + q * THREADS);
#pragma unroll
            for (int q = 0; q < SEL_U; q++) {
                const int d = d0 + q * THREADS;
                Best c{0.0, d};
                if (d < n && admit(d, f[q], c.v) && upmap_loop::before(c, m))
                    m = c;
            }
        }
        if (k == 1) {  // the first: the block's least
            m = reduce(m, false);
            if (t == 0) sel[0] = m;
            __syncthreads();
            return m.i != upmap_loop::NO_INDEX;
        }
        Best bound = bound_k(m, k);
        for (;;) {
            if (t == 0) *count = 0;
            __syncthreads();
            for (int d0 = t; d0 < n; d0 += THREADS * SEL_U) {
                decltype(fetch(0)) f[SEL_U];
#pragma unroll
                for (int q = 0; q < SEL_U; q++)
                    if (d0 + q * THREADS < n) f[q] = fetch(d0 + q * THREADS);
#pragma unroll
                for (int q = 0; q < SEL_U; q++) {
                    const int d = d0 + q * THREADS;
                    Best c{0.0, d};
                    if (d < n && admit(d, f[q], c.v) &&
                        !upmap_loop::before(bound, c)) {
                        const int at = atomicAdd(count, 1);
                        if (at < THREADS) cands[at] = c;
                    }
                }
            }
            __syncthreads();
            const int mc = *count;
            const int got = rank_block(t < mc ? cands[t] : no, k,
                                       mc < THREADS ? (mc + 31) / 32 : WARPS);
            if (mc <= THREADS) return got < k ? got : k;
            bound = sel[k - 1];
        }
#else
        (void)k, (void)n, (void)fetch, (void)admit;
        return 0;
#endif
    }
    // The first k entries of list[0..n) whose OSD pred admits, in order,
    // into sel; returns how many.  Warp 0 takes the list 32 entries at a
    // time, a ballot placing those admitted after the ones before.
    template <class Pred>
    __host__ __device__ int first_of(int k, int n, const Best* list,
                                     Pred pred) const {
#ifdef __CUDA_ARCH__
        if (warp() == 0) {
            int c = 0;
            for (int base = 0; base < n && c < k; base += 32) {
                const int l = base + lane();
                Best e{0.0, -1};
                bool ok = false;
                if (l < n) {
                    e = Best{__ldcg(&list[l].v), __ldcg(&list[l].i)};
                    ok = pred(e.i);
                }
                const unsigned m = __ballot_sync(FULL, ok);
                const int at = c + __popc(m & ((1u << lane()) - 1u));
                if (ok && at < k) sel[at] = e;
                c += __popc(m);
            }
            if (lane() == 0) *count = c < k ? c : k;
        }
        __syncthreads();
        const int got = *count;
        __syncthreads();
        return got;
#else
        (void)k, (void)n, (void)list, (void)pred;
        return 0;
#endif
    }
    // The uses of a group's candidates as each later one sees them, one
    // candidate a lane of warp 0: lane j keeps candidate j's shortlist in
    // registers, the positions of it used and whether its source is.
    struct Group {
        int32_t e[upmap_loop::LIST];
        int32_t frm;
        uint32_t taken_;
        bool src_;

        __host__ __device__ Group(const DeviceBlock& b, int gn)
            : taken_(0), src_(false) {
            const int j = b.lane();
#pragma unroll
            for (int l = 0; l < upmap_loop::LIST; l++)
                e[l] = j < gn ? b.grp[j * upmap_loop::LIST + l].i : -1;
            frm = j < gn ? b.cand[j].frm : -1;
        }
        __host__ __device__ uint32_t taken(int i) const {
#ifdef __CUDA_ARCH__
            return __shfl_sync(FULL, taken_, i);
#else
            (void)i;
            return taken_;
#endif
        }
        __host__ __device__ bool src_used(int i) const {
#ifdef __CUDA_ARCH__
            return __shfl_sync(FULL, (int)src_, i) != 0;
#else
            (void)i;
            return src_;
#endif
        }
        // candidate i used OSD x and, when y >= 0, OSD y
        __host__ __device__ void use(int i, int32_t x, int32_t y) {
#ifdef __CUDA_ARCH__
            if ((int)(threadIdx.x & 31) <= i) return;
            uint32_t m = 0;
#pragma unroll
            for (int l = 0; l < upmap_loop::LIST; l++)
                m |= (uint32_t)(e[l] == x || e[l] == y) << l;
            taken_ |= m;
            src_ |= frm == x || frm == y;
#else
            (void)i, (void)x, (void)y;
#endif
        }
    };
    __host__ __device__ Group group(int gn) const { return Group(*this, gn); }
    // a pick only falls: with the block's own picks in shared memory, a
    // PG lowers its block's pick, and flush_picks takes the block's picks
    // to the grid's at the end of its phase (a); else a PG no lower than
    // the grid's pick so far (read from L2, which holds this round's
    // reset) needs no atomic
    __host__ __device__ void pick_min(int32_t* a, int32_t d, int32_t g) const {
#ifdef __CUDA_ARCH__
        if (spick) {
            if (g < spick[d]) atomicMin(spick + d, g);
        } else if (g < __ldcg(a + d)) {
            atomicMin(a + d, g);
        }
#else
        (void)a, (void)d, (void)g;
#endif
    }
    __host__ __device__ void flush_picks(const upmap_loop::Plan& p,
                                         int32_t* a) const {
#ifdef __CUDA_ARCH__
        if (!spick) return;
        __syncthreads();
        for (int d = tid(); d < p.dv; d += THREADS) {
            const int32_t g = spick[d];
            if (g < p.npg) atomicMin(a + d, g);
        }
#else
        (void)p, (void)a;
#endif
    }
    // pick_min of PG g0 + u * stride at OSD dom[u] (none where dom[u] is
    // dv)
    template <int U>
    __host__ __device__ void pick_min_n(int32_t* pick, const int32_t* dom,
                                        int dv, int64_t g0,
                                        int64_t stride) const {
#ifdef __CUDA_ARCH__
#pragma unroll
        for (int u = 0; u < U; u++)
            if (dom[u] < dv) pick_min(pick, dom[u], (int32_t)(g0 + u * stride));
#else
        (void)pick, (void)dom, (void)dv, (void)g0, (void)stride;
#endif
    }
    __host__ __device__ static void add(int32_t* a, int32_t v) {
#ifdef __CUDA_ARCH__
        atomicAdd(a, v);
#endif
    }
    __host__ __device__ static void set_bit(uint32_t* a, uint32_t m) {
#ifdef __CUDA_ARCH__
        atomicOr(a, m);
#endif
    }
    // phase (a) gathers three deviations a PG at random OSDs, and would
    // take the pick of the PG's dominant member in L2 (ten million reads
    // or atomics at 10M PGs): the deviations and the block's own picks go
    // to shared memory
    __host__ __device__ const float* stage_od(const upmap_loop::Plan& p,
                                              const float* od) {
#ifdef __CUDA_ARCH__
        if (!p.od_smem) return od;
        spick = reinterpret_cast<int32_t*>(odsm + p.dv);
        for (int d = tid(); d < p.dv; d += THREADS) {
            odsm[d] = __ldcg(od + d);
            spick[d] = (int32_t)p.npg;
        }
        __syncthreads();
        return odsm;
#else
        (void)p;
        return od;
#endif
    }
};

// The grid: this block, and the barrier (the launch is cooperative:
// every block is resident).  Each block's thread 0 arrives on bar[0]; the
// last to arrive runs `last` with its block, clears bar[0] and starts the
// next generation in bar[1]; the others poll bar[1], sleeping 64 ns
// between reads.  The fences make each block's writes before the barrier, and
// the last block's section, visible after it.
struct DeviceGrid {
    DeviceBlock b;
    unsigned* bar;

    template <class F>
    __host__ __device__ void each(F f) {
#ifdef __CUDA_ARCH__
        f(b, (int)blockIdx.x, (int)gridDim.x);
#else
        (void)f;
#endif
    }
    template <class F>
    __host__ __device__ void sync(F last) {
#ifdef __CUDA_ARCH__
        volatile unsigned* gen = bar + 1;
        unsigned g = 0;
        __syncthreads();
        if (threadIdx.x == 0) {
            g = *gen;
            __threadfence();
            const bool l = atomicAdd(bar, 1u) == gridDim.x - 1;
            if (l) __threadfence();
            *b.flag = l;
        }
        __syncthreads();
        if (*b.flag) {
            last(b);
            __syncthreads();
            if (threadIdx.x == 0) {
                atomicExch(bar, 0u);
                __threadfence();
                atomicAdd(bar + 1, 1u);
            }
        } else if (threadIdx.x == 0) {
            while (*gen == g) __nanosleep(64);
        }
        if (threadIdx.x == 0) __threadfence();
        __syncthreads();
#else
        (void)last;
#endif
    }
};

__global__ void __launch_bounds__(THREADS)
    upmap_loop_kernel(upmap_loop::Plan p) {
    __shared__ Best red[WARPS];
    __shared__ int ired[WARPS];
    __shared__ Best lists[THREADS];
    __shared__ Best cands[THREADS];
    __shared__ Best sel[32];
    __shared__ Cand cand[upmap_loop::GROUP];
    __shared__ int32_t nu[2 * upmap_loop::GROUP];
    __shared__ int32_t stage[2 * upmap_loop::W_CAP];
    __shared__ int flag, count;
    extern __shared__ float odsm[];
    DeviceGrid grid{DeviceBlock{red, ired, lists, cands, sel, cand, nu,
                                stage, &flag, &count, lists, odsm, nullptr},
                    p.st->bar};
    upmap_loop::run_plan(grid, p);
}

// Dynamic shared memory of a launch over dv OSDs (phase (a)'s deviations
// and picks where they fit), and the kernel allowed it on the current
// device.
cudaError_t dynamic_smem(int dv, int* bytes) {
    *bytes = dv <= upmap_loop::OD_SMEM_OSDS ? 8 * dv : 0;
    return *bytes ? cudaFuncSetAttribute(
                        upmap_loop_kernel,
                        cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes)
                  : cudaSuccess;
}

}  // namespace

extern "C" {

// What a launch over dv OSDs is built from, on the current device:
// out[0..7] = registers per thread, local bytes per thread, static shared
// bytes per block, threads per block, resident blocks per SM at that
// size, SMs, whether the device takes cooperative launches, and the
// dynamic shared bytes per block.
int upmap_loop_plan(int* out, int dv) {
    const auto k = upmap_loop_kernel;
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, k);
    if (e != cudaSuccess) return e;
    int dev, blocks, sms, coop, smem;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = dynamic_smem(dv, &smem)) != cudaSuccess) return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                           THREADS, smem)) !=
        cudaSuccess)
        return e;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    const int vals[8] = {fa.numRegs, (int)fa.localSizeBytes,
                         (int)fa.sharedSizeBytes, THREADS, blocks, sms,
                         coop, smem};
    for (int i = 0; i < 8; i++) out[i] = vals[i];
    return (int)cudaGetLastError();
}

// Bytes of scratch the launch needs (device memory, 8-byte aligned, no
// initial contents: the launch zeroes what must start at zero).
long long upmap_loop_scratch_bytes(int dv, int nbatch, long long npg, int w,
                                   int ncap) {
    return (long long)upmap_loop::scratch_bytes(dv, nbatch, npg, w, ncap);
}

// Pointers are device pointers; bool arrays are one byte an element.
// out (out_len int64) and the scratch are written; the caller's rows
// never.  `blocks` is the grid (at most what the card holds at once:
// upmap_loop_plan(dv)'s blocks per SM x SMs).
int upmap_loop_launch(const int32_t* rows_in, const int32_t* pidx,
                      const uint8_t* movable, const int32_t* dom_tbl,
                      const uint8_t* tgt_ok, const double* target,
                      const double* inw, const int64_t* counts,
                      long long npg, int w, int dv, int npool, int nbatch,
                      int ncap, double max_dev, long long budget,
                      int64_t* out, void* scratch, int blocks,
                      void* stream) {
    if (npg < 0 || npg > 0x7ffffffeLL || w < 1 ||
        w > upmap_loop::W_CAP || dv < 1 || npool < 1 || nbatch < 1 ||
        nbatch > dv || ncap < 1 || budget > ncap || blocks < 1)
        return cudaErrorInvalidValue;
    upmap_loop::Plan p{};
    p.rows_in = rows_in;
    p.pidx = pidx;
    p.movable = movable;
    p.dom_tbl = dom_tbl;
    p.tgt_ok = tgt_ok;
    p.target = target;
    p.inw = inw;
    p.counts_in = counts;
    p.npg = npg;
    p.w = w;
    p.dv = dv;
    p.npool = npool;
    p.nbatch = nbatch;
    p.ncap = ncap;
    p.max_dev = max_dev;
    p.budget = budget;
    p.out = out;
    upmap_loop::bind_scratch(p, scratch);
    int smem;
    cudaError_t e = dynamic_smem(dv, &smem);
    if (e != cudaSuccess) return e;
    p.od_smem = smem > 0;
    // the state (its counts and the barrier's words) starts at zero
    e = cudaMemsetAsync(p.st, 0, sizeof(upmap_loop::State),
                        (cudaStream_t)stream);
    if (e != cudaSuccess) return e;
    void* args[] = {&p};
    e = cudaLaunchCooperativeKernel((const void*)upmap_loop_kernel,
                                    dim3(blocks), dim3(THREADS), args, smem,
                                    (cudaStream_t)stream);
    if (e != cudaSuccess) return e;
    return (int)cudaGetLastError();
}

const char* upmap_loop_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
