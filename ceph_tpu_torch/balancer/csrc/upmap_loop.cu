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
// [N, w]) and the movable mask once, and the first round writes the
// plan's copy of the rows; the per-OSD work is O(OSDs x candidates) in
// one block.  At 10M PGs x 3 that is 130 MB a round, 0.039 ms of HBM.
// What the design does about it:
// - one launch a plan: a persistent grid (blocks per SM from the
//   occupancy calculator, times the SMs), launched cooperatively (every
//   block resident) so that a grid-wide barrier (grid_sync) separates
//   phase (a) from phase (b) and (b) from the next round's (a); the
//   continue flag stays on the card.  The waiting blocks poll the barrier
//   with a sleep between reads: cooperative_groups' grid sync, whose
//   polls do not sleep, left phase (b) 0.10 ms slower at 10M PGs
//   (upmap_loop_ab.py on an H100);
// - phase (a) is a grid-stride pass over the PGs, one thread a PG,
//   coalesced row loads past L1; the per-OSD float32 deviations it
//   gathers (40 KB at 10k OSDs) stay in L1; each OSD's lowest picking PG
//   is an atomicMin, issued only by a PG below the pick read so far (most
//   PGs of 10M have an overfull member, and 10k addresses taking an
//   atomic from each would set the pace);
// - phase (b) runs in block 0 while the grid waits: B passes of a block
//   arg-max give the top-B in XLA's order, then each candidate's target
//   is one block arg-min over the OSDs, its loads issued together.
// Left for later: staging rows in shared memory, splitting phase (b) over
// warps, overlapping (b) with the next round's (a).
//
// Plain C entry points, bound with ctypes (balancer/upmap.py).  The
// launch runs on the caller's stream, does not synchronise and allocates
// nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>

#include "upmap_loop.cuh"

namespace {

using upmap_loop::Best;
using upmap_loop::THREADS;

// Phase (b)'s block: THREADS threads; reductions through shared memory.
struct DeviceBlock {
    Best* red;  // [THREADS / 32] per-warp partials, then the result

    __host__ __device__ int tid() const {
#ifdef __CUDA_ARCH__
        return threadIdx.x;
#else
        return 0;
#endif
    }
    __host__ __device__ int size() const { return THREADS; }
    __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
        __syncthreads();
#endif
    }
    __host__ __device__ bool any(bool v) const {
#ifdef __CUDA_ARCH__
        return __syncthreads_or(v) != 0;
#else
        return v;
#endif
    }
    // the block's best element, seen by every thread
    __host__ __device__ Best reduce(Best v, bool hi) const {
#ifdef __CUDA_ARCH__
        const unsigned full = 0xffffffffu;
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        for (int off = 16; off > 0; off >>= 1) {
            Best o{__shfl_down_sync(full, v.v, off),
                   __shfl_down_sync(full, v.i, off)};
            v = upmap_loop::prefer(v, o, hi);
        }
        if (lane == 0) red[warp] = v;
        __syncthreads();
        if (warp == 0) {
            v = lane < THREADS / 32 ? red[lane] : upmap_loop::none(hi);
            for (int off = 16; off > 0; off >>= 1) {
                Best o{__shfl_down_sync(full, v.v, off),
                       __shfl_down_sync(full, v.i, off)};
                v = upmap_loop::prefer(v, o, hi);
            }
            if (lane == 0) red[0] = v;
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
};

// The grid's barrier (the launch is cooperative: every block is resident).
// Each block's thread 0 arrives on bar[0]; the last to arrive clears it
// and starts the next generation in bar[1]; the others poll bar[1],
// sleeping between reads, so that while block 0 runs phase (b) the
// waiting blocks' polls do not crowd its loads out of L2.  The fences
// make each block's writes before the barrier visible after it.
__device__ void grid_sync(unsigned* bar) {
    __syncthreads();
    if (threadIdx.x == 0) {
        volatile unsigned* gen = bar + 1;
        const unsigned g = *gen;
        __threadfence();
        if (atomicAdd(bar, 1u) == gridDim.x - 1) {
            atomicExch(bar, 0u);
            __threadfence();
            atomicAdd(bar + 1, 1u);
        } else {
            while (*gen == g) __nanosleep(256);
        }
        __threadfence();
    }
    __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
    upmap_loop_kernel(upmap_loop::Plan p, unsigned* bar) {
    __shared__ Best red[THREADS / 32];
    DeviceBlock b{red};
    const bool lead = blockIdx.x == 0;
    if (lead) upmap_loop::start_plan(b, p);
    grid_sync(bar);
    const long long stride = (long long)gridDim.x * THREADS;
    for (int round = 0;; round++) {
        // phase (a): the first round reads the caller's rows and writes
        // the plan's copy; later rounds read the copy
        const int32_t* src = round == 0 ? p.rows_in : p.rows;
        int32_t* copy = round == 0 ? p.rows : nullptr;
        for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
             g < p.npg; g += stride) {
            const int32_t d = upmap_loop::dominant(p, g, src, copy);
            // a pick only falls: a PG no lower than the OSD's pick so far
            // (read from L2, which holds this round's reset) needs no
            // atomic
            if (d < p.dv && (int32_t)g < __ldcg(p.pick + d))
                atomicMin(p.pick + d, (int32_t)g);
        }
        grid_sync(bar);
        // phase (b)
        if (lead) upmap_loop::plan_round_b(b, p);
        grid_sync(bar);
        if (!__ldcg(&p.st->cont)) break;
    }
    if (lead) upmap_loop::finish_plan(b, p);
}

}  // namespace

extern "C" {

// What a launch is built from, on the current device: out[0..6] =
// registers per thread, local bytes per thread, static shared bytes per
// block, threads per block, resident blocks per SM at that size, SMs, and
// whether the device takes cooperative launches.
int upmap_loop_plan(int* out) {
    const auto k = upmap_loop_kernel;
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, k);
    if (e != cudaSuccess) return e;
    int dev, blocks, sms, coop;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                           THREADS, 0)) !=
        cudaSuccess)
        return e;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    const int vals[7] = {fa.numRegs, (int)fa.localSizeBytes,
                         (int)fa.sharedSizeBytes, THREADS, blocks, sms,
                         coop};
    for (int i = 0; i < 7; i++) out[i] = vals[i];
    return (int)cudaGetLastError();
}

// Bytes of scratch the launch needs (device memory, 8-byte aligned, no
// initial contents): the plan's, then the grid barrier's two words.
long long upmap_loop_scratch_bytes(int dv, int nbatch) {
    return (long long)upmap_loop::scratch_bytes(dv, nbatch) + 8;
}

// Pointers are device pointers; bool arrays are one byte an element.
// rows (the plan's copy, [npg, w] int32) and out (out_len int64) are
// written; the caller's rows_in never.  `blocks` is the grid (at most
// what the card holds at once: upmap_loop_plan's blocks per SM x SMs).
int upmap_loop_launch(const int32_t* rows_in, const int32_t* pidx,
                      const uint8_t* movable, const int32_t* dom_tbl,
                      const uint8_t* tgt_ok, const double* target,
                      const double* inw, const int64_t* counts,
                      long long npg, int w, int dv, int npool, int nbatch,
                      int ncap, double max_dev, long long budget,
                      int32_t* rows, int64_t* out, void* scratch,
                      int blocks, void* stream) {
    if (npg < 0 || npg > 0x7ffffffeLL || w < 1 ||
        w > upmap_loop::W_CAP || dv < 1 || npool < 1 || nbatch < 1 ||
        nbatch > dv || ncap < 1 || blocks < 1)
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
    p.rows = rows;
    p.out = out;
    upmap_loop::bind_scratch(p, scratch);
    // the barrier's two words, after the plan's scratch
    unsigned* bar = reinterpret_cast<unsigned*>(
        static_cast<char*>(scratch) +
        upmap_loop::scratch_bytes(dv, nbatch));
    cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned),
                                    (cudaStream_t)stream);
    if (e != cudaSuccess) return e;
    void* args[] = {&p, &bar};
    e = cudaLaunchCooperativeKernel((const void*)upmap_loop_kernel,
                                    dim3(blocks), dim3(THREADS), args, 0,
                                    (cudaStream_t)stream);
    if (e != cudaSuccess) return e;
    return (int)cudaGetLastError();
}

const char* upmap_loop_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
