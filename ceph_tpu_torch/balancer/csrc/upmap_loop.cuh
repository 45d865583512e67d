// The device_loop upmap plan (balancer/upmap.py::_loop_plan), written
// once as __host__ __device__ code: the body of the one-launch plan
// kernel (upmap_loop.cu), its schedule included (run_plan).
//
// nvcc builds it into the kernel; a C++ compiler builds the same file for
// the host with the two qualifiers defined empty (-D__host__=
// -D__device__=), where HostGrid runs the same schedule one block after
// another with a block of one thread.  That is how the CPU tests hold it
// against the plain version and the JAX package
// (tests/test_torch_upmap_kernel_host.py).
//
// A plan runs rounds until a round accepts nothing, stops improving the
// sum of squares, reaches max_dev or spends the budget.  The schedule is
// stages over the whole grid, each ended by a grid barrier whose last
// block to arrive may run a short section before it releases the others:
//  start   every OSD's deviation (grid-stride), the ordered sum's lanes
//          spread over the blocks; last block: the sum and the state.
//  (a)     block 0: the round's top-B overfull OSDs (top_b); the last
//          block, in plans of many PGs an OSD: each pool's first PREFIX
//          allowed targets (prefixes); the others: a grid-stride pass over
//          the PGs (phase_a): each PG's
//          worst overfull member, the first maximum of the float32
//          deviations in row order; each OSD keeps the lowest PG index
//          that picks it (an integer minimum: exact in any order).
//  (b)     the candidates in groups of GROUP.  Each block takes one
//          candidate of the group (shortlist): its PG, slot and the first
//          2j + 1 allowed targets of candidate j in (deviation, index)
//          order, filtered by everything but the group's own uses (from
//          its pool's prefix where that holds them, else from every OSD).  Last
//          block: one warp resolves the group in candidate order
//          (resolve); after the last group the block applies the round
//          and updates the deviations of the OSDs it moved (apply_round).
// Why 2j + 1 targets are enough: within a round, candidate j of a group
// depends on the earlier ones only through the OSDs they used, and before
// j they used at most 2j (each its target, an accepted one its source).
// The sequential answer is the first allowed OSD not used; among the
// first 2j + 1 allowed at least one is not used, and the first such one
// is that answer.
//
// The plan never copies the rows: the PGs it changes are an overlay (a
// bit per PG, and the changed rows by overlay slot); phase (a) skips them
// in its pass and takes them from the overlay.
//
// What a `Blk` gives the stages: tid() and size() of the block, sync(),
// reduce(Best, hi) and sum(int) over the block, smallest(k, n, fetch,
// admit) (the k first admitted elements in (value, index) order, into
// sel; fetch(d) loads what admit(d, fetched, v) decides on), first_of(k,
// n, list, pred) (the first k of a list that pred admits, into sel), a stage
// area of 2 * W_CAP ints, warp()/lane()/lanes(), warp_sync(), group(gn)
// over warp 0 (the resolve: the group's uses as each candidate sees
// them, from the shortlists in grp and the candidates in cand), the
// atomics pick_min (one PG), pick_min_n (a thread's PGs in flight), add
// and set_bit, and stage_od and flush_picks (phase (a)'s deviations and
// picks where its gathers and minima are fastest).  Every reduction is
// a maximum, a minimum, an integer count or a selection of distinct
// keys, which the order of the threads cannot change; the one float sum
// (the sum of squares, whose comparison is the float-tie guard) is taken
// in a fixed order that does not depend on the grid or the block
// (lane_sq, halve), with multiplies and adds that nvcc may not fuse.

#pragma once

#include <math.h>
#include <stdint.h>

#define UL_HD __host__ __device__

#ifdef __CUDA_ARCH__
// a float64 product and sum rounded one at a time (nvcc fuses a * b + c
// into one fma otherwise, which rounds once and changes the sum's bits)
#define UL_MUL(a, b) __dmul_rn((a), (b))
#define UL_ADD(a, b) __dadd_rn((a), (b))
#define UL_UNROLL _Pragma("unroll")
#else
#define UL_MUL(a, b) ((a) * (b))
#define UL_ADD(a, b) ((a) + (b))
#define UL_UNROLL
#endif

namespace upmap_loop {

// loads of what another block may have written in this launch: past L1
#ifdef __CUDA_ARCH__
template <class T>
__device__ inline T ldcg(const T* p) {
    return __ldcg(p);
}
template <>
__device__ inline int64_t ldcg(const int64_t* p) {
    return (int64_t)__ldcg(reinterpret_cast<const long long*>(p));
}
// loads of the operands, which nothing writes in a launch: the read-only
// path
template <class T>
__device__ inline T ldg(const T* p) {
    return __ldg(p);
}
// phase (a)'s stream of rows and flags, read once a round: evicted first,
// so that the per-OSD arrays the other stages read stay in L2
template <class T>
__device__ inline T ldcs(const T* p) {
    return __ldcs(p);
}
#else
template <class T>
inline T ldcg(const T* p) {
    return *p;
}
template <class T>
inline T ldg(const T* p) {
    return *p;
}
template <class T>
inline T ldcs(const T* p) {
    return *p;
}
#endif

constexpr int32_t ITEM_NONE = 0x7fffffff;
constexpr int32_t DOM_NONE = 0x7fffffff;  // dom_tbl: not in the rule
constexpr int32_t NO_INDEX = 0x7fffffff;  // Best: no element
constexpr int THREADS = 512;  // a block; the lanes of ordered_sum
constexpr int W_CAP = 32;     // widest row a plan takes
constexpr int GROUP = 16;     // candidates resolved together
constexpr int LIST = 2 * GROUP;  // a shortlist's room (2j + 1 < LIST)
constexpr int TOPK = 32;      // top-B entries one selection pass takes
constexpr int PA_U = 4;       // PGs a thread of phase (a) holds in flight
constexpr int PREFIX = 64;    // a pool's first allowed targets, kept a round
constexpr int PREFIX_POOLS = 4;  // plans over more pools keep none
constexpr int PREFIX_PGS = 512;  // PGs an OSD from which plans keep them
// phase (a) keeps each block's own picks and the float32 deviations in
// shared memory up to this many OSDs
constexpr int OD_SMEM_OSDS = 24576;
static_assert(GROUP * LIST == THREADS, "a group's lists fill one block");

// The int64 output buffer, read back once: a header, then the accepted
// changes in order, their final rows and the final counts.
enum { OUT_NCHG = 0, OUT_NREJ = 1, OUT_ROUNDS = 2, OUT_HEAD = 4 };

inline int64_t out_len(int ncap, int w, int dv) {
    return OUT_HEAD + (int64_t)ncap * (4 + w) + dv;
}

// which float32 deviations phase (a) reads: none is overfull, the strict
// set (dev > max_dev), or the more_overfull takeover (dev > 0)
enum { MODE_NONE = 0, MODE_HI = 1, MODE_POS = 2 };

// The plan's running state (global memory, zeroed by the launch; written
// in the barriers' last-block sections).
struct State {
    unsigned bar[2];  // the grid barrier: arrivals, generation
    double sum_sq;    // the last round's sum of squared deviations
    int64_t n_chg;    // accepted changes so far
    int64_t n_rej;    // candidates whose move would not improve
    int64_t rounds;
    int32_t cont;     // run another round
    int32_t mode;     // MODE_*: the round's overfull set
    int32_t n_hi;     // OSDs with dev > max_dev
    int32_t n_lo;     // OSDs with dev < -max_dev
    int32_t n_top;    // the round's candidates (top-B overfull OSDs)
    int32_t n_acc;    // the round's accepts so far
    int32_t rej;      // the round's rejects so far
    int32_t n_used;   // entries of ulist this round
    int32_t n_ov;     // overlay rows
    int32_t n_prefix;                // pools with a target prefix this round
    int32_t prefix_n[PREFIX_POOLS];  // their lengths (< PREFIX: every target)
};

// A candidate of the group being resolved: its source OSD's deviation,
// PG, slot and OSD, and its shortlist's length (-1: skipped).
struct Cand {
    double vfrm;
    int32_t pg, slot, frm, n;
};

// An element of a selection: its value and index.  hi: the largest
// value wins, else the smallest; equal values go to the lower index (the
// first extremum, as argmax / argmin and XLA's top_k order them).
struct Best {
    double v;
    int32_t i;
};

UL_HD inline bool before(Best a, Best b) {
    return a.v < b.v || (a.v == b.v && a.i < b.i);
}

UL_HD inline Best prefer(Best a, Best b, bool hi) {
    if (hi ? a.v > b.v : a.v < b.v) return a;
    if (a.v == b.v && a.i < b.i) return a;
    return b;
}

UL_HD inline Best none(bool hi) {
    return Best{hi ? -(double)INFINITY : (double)INFINITY, NO_INDEX};
}

// What a selection loads of an OSD before it decides (every element's
// loads of a thread's turn are issued before the first decision): an
// overfull candidate's deviation, a target's deviation, domain and flags.
struct OverF {
    double dev;
    bool over;
};
struct TargetF {
    double udev;
    int32_t dom;
    bool ok;
};

struct Plan {
    // operands, read only
    const int32_t* rows_in;   // [npg, w]
    const int32_t* pidx;      // [npg] the PG's pool position
    const uint8_t* movable;   // [npg] bool
    const int32_t* dom_tbl;   // [npool, dv]
    const uint8_t* tgt_ok;    // [npool, dv] bool
    const double* target;     // [dv]
    const double* inw;        // [dv]
    const int64_t* counts_in; // [dv]
    int64_t npg;
    int w, dv, npool, nbatch, ncap;
    double max_dev;
    int64_t budget;
    int od_smem;              // phase (a) stages its picks and deviations in shared memory
    int64_t* out;             // out_len int64
    // scratch (bind_scratch)
    State* st;
    double* dev;      // [dv] the round's deviations
    double* udev;     // [dv] dev where a target may go (inw > 0, dev < 0), else inf
    double* part;     // [THREADS] the ordered sum's lanes
    double* tmp;      // [THREADS] their halving
    Best* list;       // [GROUP * LIST] the group's shortlists
    Best* prefix;     // [PREFIX_POOLS * PREFIX] the pools' first targets
    Cand* cand;       // [GROUP]
    float* odev;      // [2, dv] MODE_HI's, MODE_POS's float32 deviations (-inf: not over)
    int32_t* pick;    // [2, dv] by round parity: lowest PG whose dominant member is the OSD
    int32_t* topi;    // [nbatch] the top-B
    int32_t* acc;     // [5 * nbatch] the round's accepts: pg, slot, to, frm, overlay slot
    int32_t* ulist;   // [2 * nbatch] the round's used OSDs, in order
    uint32_t* bits;   // [ceil(npg / 32)] changed PGs
    int32_t* ov_pg;   // [ncap] the overlay's PGs
    int32_t* cslot;   // [ncap] each change's overlay slot
    int32_t* ov_rows; // [ncap, w] the overlay's rows
    uint8_t* used;    // [dv] OSDs an earlier group of the round used
};

inline size_t align8(size_t n) { return (n + 7) & ~(size_t)7; }

UL_HD inline int64_t bit_words(int64_t npg) { return (npg + 31) / 32; }

// Bytes of scratch a plan needs.  Its first sizeof(State) bytes must be
// zero at the launch.
inline size_t scratch_bytes(int dv, int nbatch, int64_t npg, int w,
                            int ncap) {
    const size_t d = (size_t)dv, b = (size_t)nbatch, c = (size_t)ncap;
    return align8(sizeof(State)) + 2 * align8(8 * d) +
           2 * 8 * (size_t)THREADS + align8(sizeof(Best) * GROUP * LIST) +
           align8(sizeof(Best) * PREFIX_POOLS * PREFIX) +
           align8(sizeof(Cand) * GROUP) + align8(8 * d) + align8(8 * d) +
           align8(4 * b) + align8(20 * b) + align8(8 * b) +
           align8(4 * (size_t)bit_words(npg)) + 2 * align8(4 * c) +
           align8(4 * c * (size_t)w) + align8(d);
}

inline char* take(char*& at, size_t n) {
    char* here = at;
    at += align8(n);
    return here;
}

// Points the plan's scratch arrays into `scratch` (scratch_bytes of it,
// 8-byte aligned), after the plan's sizes are set.
inline void bind_scratch(Plan& p, void* scratch) {
    char* s = static_cast<char*>(scratch);
    const size_t d = (size_t)p.dv, b = (size_t)p.nbatch, c = (size_t)p.ncap;
    p.st = reinterpret_cast<State*>(take(s, sizeof(State)));
    p.dev = reinterpret_cast<double*>(take(s, 8 * d));
    p.udev = reinterpret_cast<double*>(take(s, 8 * d));
    p.part = reinterpret_cast<double*>(take(s, 8 * (size_t)THREADS));
    p.tmp = reinterpret_cast<double*>(take(s, 8 * (size_t)THREADS));
    p.list = reinterpret_cast<Best*>(take(s, sizeof(Best) * GROUP * LIST));
    p.prefix = reinterpret_cast<Best*>(
        take(s, sizeof(Best) * PREFIX_POOLS * PREFIX));
    p.cand = reinterpret_cast<Cand*>(take(s, sizeof(Cand) * GROUP));
    p.odev = reinterpret_cast<float*>(take(s, 8 * d));
    p.pick = reinterpret_cast<int32_t*>(take(s, 8 * d));
    p.topi = reinterpret_cast<int32_t*>(take(s, 4 * b));
    p.acc = reinterpret_cast<int32_t*>(take(s, 20 * b));
    p.ulist = reinterpret_cast<int32_t*>(take(s, 8 * b));
    p.bits = reinterpret_cast<uint32_t*>(
        take(s, 4 * (size_t)bit_words(p.npg)));
    p.ov_pg = reinterpret_cast<int32_t*>(take(s, 4 * c));
    p.cslot = reinterpret_cast<int32_t*>(take(s, 4 * c));
    p.ov_rows = reinterpret_cast<int32_t*>(take(s, 4 * c * (size_t)p.w));
    p.used = reinterpret_cast<uint8_t*>(take(s, d));
}

UL_HD inline double dev_of(const Plan& p, int d, int64_t c) {
    return p.inw[d] > 0.0 ? (double)c - p.target[d] : 0.0;
}

UL_HD inline int64_t* out_counts(const Plan& p) {
    return p.out + OUT_HEAD + (int64_t)p.ncap * (4 + p.w);
}

// bit 1: dev > max_dev; bit 2: dev < -max_dev
UL_HD inline int class_of(const Plan& p, double v) {
    return (v > p.max_dev ? 1 : 0) | (v < -p.max_dev ? 2 : 0);
}

UL_HD inline int mode_of(int n_hi, int n_lo) {
    return n_hi > 0 ? MODE_HI : (n_lo > 0 ? MODE_POS : MODE_NONE);
}

// OSD d's deviations at count c, in every form a stage reads; returns
// its class_of.
UL_HD inline int set_dev(const Plan& p, int d, int64_t c) {
    const double v = dev_of(p, d, c);
    const bool w = p.inw[d] > 0.0;
    p.dev[d] = v;
    p.udev[d] = (w && v < 0.0) ? v : (double)INFINITY;
    p.odev[d] = (w && v > p.max_dev) ? (float)v : -INFINITY;
    p.odev[p.dv + d] = (w && v > 0.0) ? (float)v : -INFINITY;
    return class_of(p, v);
}

// the lowest set bit's position (x != 0)
UL_HD inline int first_bit(uint32_t x) {
#ifdef __CUDA_ARCH__
    return __ffs(x) - 1;
#else
    return __builtin_ctz(x);
#endif
}

UL_HD inline bool changed(const Plan& p, int64_t g) {
    return (ldcg(p.bits + (g >> 5)) >> (g & 31)) & 1u;
}

// Lane l of the sum of x(d)^2 over d < n: d = l, l + THREADS, ... in turn
// (sixteen values loaded at once, added in that order).
template <class X>
UL_HD double lane_sq(int l, int n, X x) {
    double s = 0.0;
    int d = l;
    for (; d + 15 * THREADS < n; d += 16 * THREADS) {
        double v[16];
        UL_UNROLL
        for (int q = 0; q < 16; q++) v[q] = x(d + q * THREADS);
        UL_UNROLL
        for (int q = 0; q < 16; q++) s = UL_ADD(s, UL_MUL(v[q], v[q]));
    }
    for (; d < n; d += THREADS) {
        const double v = x(d);
        s = UL_ADD(s, UL_MUL(v, v));
    }
    return s;
}

// The lanes t[0..THREADS) added pairwise, halving, in place: the block
// takes the levels down to 32 lanes, one warp the rest.
template <class Blk>
UL_HD double halve(Blk& b, double* t) {
    int h = THREADS / 2;
    for (; h >= 32; h >>= 1) {
        for (int l = b.tid(); l < h; l += b.size())
            t[l] = UL_ADD(t[l], t[l + h]);
        b.sync();
    }
    if (b.warp() == 0) {
        for (; h > 0; h >>= 1) {
            for (int l = b.lane(); l < h; l += b.lanes())
                t[l] = UL_ADD(t[l], t[l + h]);
            b.warp_sync();
        }
    }
    b.sync();
    const double s = t[0];
    b.sync();
    return s;
}

// sum over d < dv of x[d] * x[d], in one order whatever the grid and the
// block: lane l < THREADS adds d = l, l + THREADS, ... in turn, then the
// lanes are added pairwise, halving.
template <class Blk>
UL_HD double ordered_sum(Blk& b, const Plan& p, const double* x) {
    for (int l = b.tid(); l < THREADS; l += b.size())
        p.part[l] = lane_sq(l, p.dv, [&](int d) { return x[d]; });
    b.sync();
    return halve(b, p.part);
}

// The sum of squares of the lanes the plan keeps (part), halved in tmp.
template <class Blk>
UL_HD double sum_sq_of_lanes(Blk& b, const Plan& p) {
    for (int l = b.tid(); l < THREADS; l += b.size())
        p.tmp[l] = ldcg(p.part + l);
    b.sync();
    return halve(b, p.tmp);
}

// -- start --------------------------------------------------------------------

// Block blk of nblk: its share of the counts, the deviations, the resets
// and the ordered sum's lanes (lane l in block l % nblk).
template <class Blk>
UL_HD void start_grid(Blk& b, const Plan& p, int blk, int nblk) {
    const int64_t t0 = (int64_t)blk * b.size() + b.tid();
    const int64_t stride = (int64_t)nblk * b.size();
    int64_t* counts = out_counts(p);
    int hi = 0, lo = 0;
    for (int64_t d = t0; d < p.dv; d += stride) {
        counts[d] = p.counts_in[d];
        const int c = set_dev(p, (int)d, p.counts_in[d]);
        hi += c & 1;
        lo += c >> 1;
        p.pick[d] = p.pick[p.dv + d] = (int32_t)p.npg;
        p.used[d] = 0;
    }
    for (int64_t i = t0; i < bit_words(p.npg); i += stride) p.bits[i] = 0;
    for (int l = blk + nblk * b.tid(); l < THREADS; l += nblk * b.size())
        p.part[l] = lane_sq(l, p.dv, [&](int d) {
            return dev_of(p, d, p.counts_in[d]);
        });
    hi = b.sum(hi);
    lo = b.sum(lo);
    if (b.tid() == 0) {
        if (hi) b.add(&p.st->n_hi, hi);
        if (lo) b.add(&p.st->n_lo, lo);
    }
}

// Last block: the first sum of squares and the state.
template <class Blk>
UL_HD void start_last(Blk& b, const Plan& p) {
    const double ss = sum_sq_of_lanes(b, p);
    if (b.tid() == 0) {
        State* st = p.st;
        st->sum_sq = ss;
        st->cont = 1;
        st->mode = mode_of(ldcg(&st->n_hi), ldcg(&st->n_lo));
    }
    b.sync();
}

// -- phase (a) ----------------------------------------------------------------

// The top-B overfull OSDs, largest deviation first, equal deviations
// lowest index first (XLA's top_k order), in passes of TOPK: each pass
// takes the first after the last one's last pick in that order.
template <class Blk>
UL_HD void top_b(Blk& b, const Plan& p) {
    const int mode = ldcg(&p.st->mode);
    int n = 0;
    if (mode != MODE_NONE) {
        const float* od = p.odev + (mode == MODE_POS ? p.dv : 0);
        Best last{-(double)INFINITY, -1};  // in the order of -dev
        while (n < p.nbatch) {
            const int k = p.nbatch - n < TOPK ? p.nbatch - n : TOPK;
            const int got = b.smallest(
                k, p.dv,
                [&](int d) {
                    return OverF{ldcg(p.dev + d), ldcg(od + d) > -INFINITY};
                },
                [&](int d, const OverF& f, double& v) {
                    v = -f.dev;
                    return f.over &&
                           (v > last.v || (v == last.v && d > last.i));
                });
            for (int i = b.tid(); i < got; i += b.size())
                p.topi[n + i] = b.sel[i].i;
            n += got;
            if (got < k) break;
            last = b.sel[got - 1];
            b.sync();
        }
    }
    if (b.tid() == 0) p.st->n_top = n;
}

// The pools that keep a prefix of targets: one block selects them beside
// phase (a), which hides that only where phase (a) is long (PREFIX_PGS
// PGs an OSD or more), and only a round of several candidates gains.
UL_HD inline int prefix_pools(const Plan& p) {
    return p.nbatch > 1 && p.npool <= PREFIX_POOLS &&
                   p.npg >= (int64_t)PREFIX_PGS * p.dv
               ? p.npool
               : 0;
}

// The first PREFIX targets each of np pools allows, in (deviation, index)
// order (inw > 0, dev < 0 and the pool's tgt_ok), in passes of TOPK: a
// candidate's shortlist filters its pool's prefix before it would scan
// every OSD.
template <class Blk>
UL_HD void prefixes(Blk& b, const Plan& p, int np) {
    for (int q = 0; q < np; q++) {
        const uint8_t* ok = p.tgt_ok + (int64_t)q * p.dv;
        int n = 0;
        Best last{-(double)INFINITY, -1};
        while (n < PREFIX) {
            const int k = PREFIX - n < TOPK ? PREFIX - n : TOPK;
            const int got = b.smallest(
                k, p.dv,
                [&](int d) {
                    return TargetF{ldcg(p.udev + d), 0, ldg(ok + d) != 0};
                },
                [&](int d, const TargetF& f, double& v) {
                    v = f.udev;
                    return (v < (double)INFINITY) & f.ok &&
                           (v > last.v || (v == last.v && d > last.i));
                });
            for (int i = b.tid(); i < got; i += b.size())
                p.prefix[q * PREFIX + n + i] = b.sel[i];
            n += got;
            if (got < k) break;
            last = b.sel[got - 1];
            b.sync();
        }
        if (b.tid() == 0) p.st->prefix_n[q] = n;
        b.sync();
    }
    if (b.tid() == 0) p.st->n_prefix = np;
}

// PG g's dominant overfull member: the first maximum of the float32
// deviations od of the row's members, or dv when it has none or may not
// move.
UL_HD inline int32_t dominant(const Plan& p, const int32_t* row, int64_t g,
                              const float* od) {
    float best = -INFINITY;
    int32_t osd = 0;
    for (int s = 0; s < p.w; s++) {
        const int32_t r = ldcg(row + s);
        const float v = (r >= 0 && r < p.dv) ? od[r] : -INFINITY;
        if (v > best) {
            best = v;
            osd = r;
        }
    }
    if (!(best > -INFINITY) || !p.movable[g]) return p.dv;
    return osd;
}

// PA_U PGs of one thread in flight: their rows, change-bit words and
// movable flags, loaded at once (a PG past the end reads as changed).
template <int W>
struct PaBatch {
    int32_t r[PA_U][W];
    uint32_t word[PA_U];
    bool mv[PA_U];

    UL_HD void load(const Plan& p, int64_t g0, int64_t stride) {
        UL_UNROLL
        for (int u = 0; u < PA_U; u++) {
            const int64_t g = g0 + u * stride;
            const bool live = g < p.npg;
            word[u] = live ? ldcg(p.bits + (g >> 5)) : ~0u;
            mv[u] = live && ldcs(p.movable + g);
            UL_UNROLL
            for (int s = 0; s < W; s++)
                r[u][s] = live ? ldcs(p.rows_in + g * W + s) : -1;
        }
    }
    // each PG's dominant overfull member, dv if none or it may not move
    // (or it changed: its overlay row counts instead)
    UL_HD void dominants(const Plan& p, int64_t g0, int64_t stride,
                         const float* od, int32_t* dom) const {
        UL_UNROLL
        for (int u = 0; u < PA_U; u++) {
            const int64_t g = g0 + u * stride;
            float best = -INFINITY;
            int32_t osd = 0;
            UL_UNROLL
            for (int s = 0; s < W; s++) {
                const int32_t x = r[u][s];
                const float v = (x >= 0 && x < p.dv) ? od[x] : -INFINITY;
                if (v > best) {
                    best = v;
                    osd = x;
                }
            }
            const bool none = ((word[u] >> (g & 31)) & 1u) ||
                              !(best > -INFINITY) || !mv[u];
            dom[u] = none ? p.dv : osd;
        }
    }
};

// Phase (a) over the caller's rows, W slots a row: each thread holds PA_U
// PGs in flight, and loads its next PA_U before it settles the picks of
// these (so the picks' reads overlap the rows' loads).
template <int W, class Blk>
UL_HD void phase_a_rows(Blk& b, const Plan& p, int64_t t0, int64_t stride,
                        int32_t* pick, const float* od) {
    const int64_t step = PA_U * stride;
    PaBatch<W> cur, next;
    cur.load(p, t0, stride);
    for (int64_t g0 = t0; g0 < p.npg; g0 += step) {
        int32_t dom[PA_U];
        cur.dominants(p, g0, stride, od, dom);
        next.load(p, g0 + step, stride);
        b.template pick_min_n<PA_U>(pick, dom, p.dv, g0, stride);
        cur = next;
    }
}

// Block blk's share of phase (a): the caller's rows of the PGs the plan
// has not changed, then the overlay's rows.
template <class Blk>
UL_HD void phase_a(Blk& b, const Plan& p, int blk, int nblk) {
    const State* st = p.st;
    const int mode = ldcg(&st->mode);
    if (mode == MODE_NONE) return;  // no member is overfull: no pick
    // the round's float32 deviations (and the block's own picks) in
    // shared memory where they fit
    const float* od =
        b.stage_od(p, p.odev + (mode == MODE_POS ? p.dv : 0));
    int32_t* pick = p.pick + (ldcg(&st->rounds) & 1) * (int64_t)p.dv;
    const int64_t t0 = (int64_t)blk * b.size() + b.tid();
    const int64_t stride = (int64_t)nblk * b.size();
    // a row's width as a template argument up to 8; wider rows one PG at
    // a time
    switch (p.w) {
        case 1: phase_a_rows<1>(b, p, t0, stride, pick, od); break;
        case 2: phase_a_rows<2>(b, p, t0, stride, pick, od); break;
        case 3: phase_a_rows<3>(b, p, t0, stride, pick, od); break;
        case 4: phase_a_rows<4>(b, p, t0, stride, pick, od); break;
        case 5: phase_a_rows<5>(b, p, t0, stride, pick, od); break;
        case 6: phase_a_rows<6>(b, p, t0, stride, pick, od); break;
        case 7: phase_a_rows<7>(b, p, t0, stride, pick, od); break;
        case 8: phase_a_rows<8>(b, p, t0, stride, pick, od); break;
        default:
            for (int64_t g = t0; g < p.npg; g += stride) {
                if (changed(p, g)) continue;
                const int32_t d = dominant(p, p.rows_in + g * p.w, g, od);
                if (d < p.dv) b.pick_min(pick, d, (int32_t)g);
            }
    }
    const int n_ov = ldcg(&st->n_ov);
    for (int64_t s = t0; s < n_ov; s += stride) {
        const int32_t g = ldcg(p.ov_pg + s);
        const int32_t d = dominant(p, p.ov_rows + s * p.w, g, od);
        if (d < p.dv) b.pick_min(pick, d, g);
    }
    b.flush_picks(p, pick);
}

// -- phase (b) ----------------------------------------------------------------

// The overlay slot of changed PG pg (the whole block searches).
template <class Blk>
UL_HD int find_ov(Blk& b, const Plan& p, int32_t pg) {
    const int n_ov = ldcg(&p.st->n_ov);
    Best m = none(false);
    for (int s = b.tid(); s < n_ov; s += b.size())
        if (ldcg(p.ov_pg + s) == pg) m = Best{(double)s, s};
    return b.reduce(m, false).i;
}

// Candidate k, j-th of its group, in one block: its PG (the round's pick
// of its OSD), slot and the first 2j + 1 allowed targets, filtered by the
// OSDs earlier groups used.
template <class Blk>
UL_HD void shortlist(Blk& b, const Plan& p, int k, int j,
                     const int32_t* pick, bool later_group) {
    const int tid = b.tid(), nt = b.size(), W = p.w, DV = p.dv;
    const int32_t frm = ldcg(p.topi + k);
    const int32_t pg = ldcg(pick + frm);
    int slot = -1, n = -1;
    if (pg < p.npg) {
        // what the PG's pick leads to, loaded together
        const bool used = ldcg(p.used + frm);
        const bool chg = changed(p, pg);
        int32_t pp = ldg(p.pidx + pg);
        int32_t* mem = b.stage;           // the row's members, -1 if none
        int32_t* mdom = b.stage + W_CAP;  // the other members' domains
        for (int s = tid; s < W; s += nt) {
            const int32_t r = ldg(p.rows_in + (int64_t)pg * W + s);
            mem[s] = (r >= 0 && r < DV) ? r : -1;
        }
        if (!used && chg) {
            const int32_t* row = p.ov_rows + (int64_t)find_ov(b, p, pg) * W;
            for (int s = tid; s < W; s += nt) {
                const int32_t r = ldcg(row + s);
                mem[s] = (r >= 0 && r < DV) ? r : -1;
            }
        }
        b.sync();
        for (int s = 0; s < W && !used; s++) {
            if (mem[s] == frm) {
                slot = s;
                break;
            }
        }
        if (slot >= 0) {
            pp = pp < 0 ? 0 : (pp >= p.npool ? p.npool - 1 : pp);
            const int32_t* dtbl = p.dom_tbl + (int64_t)pp * DV;
            const uint8_t* ok = p.tgt_ok + (int64_t)pp * DV;
            // the failure domains of the other members: the target may
            // not share one
            for (int s = tid; s < W; s += nt)
                mdom[s] = (mem[s] >= 0 && s != slot) ? ldg(dtbl + mem[s])
                                                     : DOM_NONE;
            b.sync();
            // the pool's prefix, filtered in order, where it holds the
            // answer: the first 2j + 1 that pass, or every target it has
            const int K = 2 * j + 1;
            if (pp < ldcg(&p.st->n_prefix)) {
                const int pn = ldcg(p.st->prefix_n + pp);
                const int c = b.first_of(K, pn, p.prefix + pp * PREFIX,
                                         [&](int32_t d) {
                    bool a = !(later_group && ldcg(p.used + d));
                    const int32_t dd = ldg(dtbl + d);
                    for (int s = 0; s < W; s++)
                        a &= (mem[s] != d) & (mdom[s] != dd);
                    return a;
                });
                if (c == K || pn < PREFIX) n = c;
            }
            if (n < 0) n = b.smallest(
                K, DV,
                [&](int d) {
                    return TargetF{
                        ldcg(p.udev + d), ldg(dtbl + d),
                        ldg(ok + d) != 0 && !(later_group && ldcg(p.used + d))};
                },
                [&](int d, const TargetF& f, double& v) {
                    v = f.udev;
                    bool a = (v < (double)INFINITY) & f.ok;
                    for (int s = 0; s < W; s++)
                        a &= (mem[s] != d) & (mdom[s] != f.dom);
                    return a;
                });
            for (int i = tid; i < n; i += nt) p.list[j * LIST + i] = b.sel[i];
        }
    }
    if (tid == 0) {
        Cand* c = p.cand + j;
        c->vfrm = ldcg(p.dev + frm);
        c->pg = pg;
        c->slot = slot;
        c->frm = frm;
        c->n = n;
    }
    b.sync();  // the stage and sel serve the block's next candidate
}

// Block blk's share of group g0's shortlists; with the first group, the
// reset of the next round's picks.
template <class Blk>
UL_HD void shortlists(Blk& b, const Plan& p, int blk, int nblk, int g0) {
    const int64_t r = ldcg(&p.st->rounds);
    const int32_t* pick = p.pick + (r & 1) * (int64_t)p.dv;
    if (g0 == 0) {
        int32_t* next = p.pick + ((r + 1) & 1) * (int64_t)p.dv;
        for (int64_t d = (int64_t)blk * b.size() + b.tid(); d < p.dv;
             d += (int64_t)nblk * b.size())
            next[d] = (int32_t)p.npg;
    }
    const int n_top = ldcg(&p.st->n_top);
    const int gn = n_top - g0 < GROUP ? n_top - g0 : GROUP;
    for (int j = blk; j < gn; j += nblk)
        shortlist(b, p, g0 + j, j, pick, g0 > 0);
}

// After the last group: the round's moves applied (rows into the
// overlay, counts, change records), the moved OSDs' deviations and their
// lanes of the sum, the exits and the next round's state.  Whole block.
template <class Blk>
UL_HD void apply_round(Blk& b, const Plan& p) {
    State* st = p.st;
    const int tid = b.tid(), nt = b.size(), W = p.w;
    const int n_acc = ldcg(&st->n_acc), nu = ldcg(&st->n_used);
    const int n_ov0 = ldcg(&st->n_ov);
    const int64_t n_chg = ldcg(&st->n_chg), rnd = ldcg(&st->rounds) + 1;
    int32_t* acc = p.acc;  // pg, slot, to, frm, overlay slot
    // each accepted PG's overlay slot: the one it has (one pair of
    // accept and slot a thread), or a new one
    for (int i = tid; i < n_acc; i += nt) acc[5 * i + 4] = -1;
    b.sync();
    for (int e = tid; e < n_acc * n_ov0; e += nt) {
        const int i = e / n_ov0, t = e % n_ov0;
        if (ldcg(p.ov_pg + t) == ldcg(acc + 5 * i)) acc[5 * i + 4] = t;
    }
    b.sync();
    if (tid == 0) {
        int n_ov = n_ov0;
        for (int i = 0; i < n_acc; i++)
            if (acc[5 * i + 4] < 0) acc[5 * i + 4] = n_ov++;
        st->n_ov = n_ov;
    }
    b.sync();
    // a round's PGs are distinct (one dominant member each) and its OSDs
    // disjoint, so the moves commute; each accept's two OSDs take their
    // new counts and deviations, and the class counts they change
    int64_t* counts = out_counts(p);
    int64_t* cpg = p.out + OUT_HEAD;
    int dhi = 0, dlo = 0;
    for (int i = tid; i < n_acc; i += nt) {
        const int32_t* a = acc + 5 * i;
        const int32_t pg = ldcg(a), sl = ldcg(a + 1), to = ldcg(a + 2);
        const int32_t frm = ldcg(a + 3), s = a[4];
        const int64_t c_frm = ldcg(counts + frm) - 1;
        const int64_t c_to = ldcg(counts + to) + 1;
        const int k_frm = class_of(p, ldcg(p.dev + frm));
        const int k_to = class_of(p, ldcg(p.dev + to));
        int32_t* row = p.ov_rows + (int64_t)s * W;
        if (s >= n_ov0) {  // the PG's first change: its row and its bit
            for (int t = 0; t < W; t++) row[t] = p.rows_in[(int64_t)pg * W + t];
            p.ov_pg[s] = pg;
            b.set_bit(p.bits + (pg >> 5), 1u << (pg & 31));
        }
        row[sl] = to;
        counts[frm] = c_frm;
        counts[to] = c_to;
        const int n_frm = set_dev(p, frm, c_frm), n_to = set_dev(p, to, c_to);
        dhi += (n_frm & 1) + (n_to & 1) - (k_frm & 1) - (k_to & 1);
        dlo += (n_frm >> 1) + (n_to >> 1) - (k_frm >> 1) - (k_to >> 1);
        const int64_t pos = n_chg + i;
        if (pos < p.ncap) {
            cpg[pos] = pg;
            cpg[p.ncap + pos] = frm;
            cpg[2 * p.ncap + pos] = to;
            cpg[3 * p.ncap + pos] = rnd;
            p.cslot[pos] = s;
        }
    }
    dhi = b.sum(dhi);
    dlo = b.sum(dlo);
    // their lanes of the sum of squares, summed again in order (two OSDs
    // of one lane write the same value)
    for (int e = tid; e < 2 * n_acc; e += nt) {
        const int l = ldcg(acc + 5 * (e >> 1) + 2 + (e & 1)) % THREADS;
        p.part[l] = lane_sq(l, p.dv, [&](int d) { return ldcg(p.dev + d); });
    }
    b.sync();
    const double ss2 = sum_sq_of_lanes(b, p);
    if (tid == 0) {
        const int n_hi = ldcg(&st->n_hi) + dhi, n_lo = ldcg(&st->n_lo) + dlo;
        const int64_t n_chg2 = n_chg + n_acc;
        // max |dev| > max_dev: always when max_dev < 0, else some OSD
        // lies beyond it on one side
        const bool far = p.max_dev < 0.0 || n_hi + n_lo > 0;
        // the sequential loop's exits: nothing accepted, the float-tie
        // guard (never loop on a non-improvement), max_dev reached, the
        // round or change budget spent
        st->cont = n_acc > 0 && ss2 < st->sum_sq && far && rnd < p.budget &&
                   n_chg2 < p.budget;
        st->sum_sq = ss2;
        st->n_chg = n_chg2;
        st->n_rej += ldcg(&st->rej);
        st->rounds = rnd;
        st->n_hi = n_hi;
        st->n_lo = n_lo;
        st->mode = mode_of(n_hi, n_lo);
        st->n_acc = 0;
        st->rej = 0;
        st->n_used = 0;
    }
    // the earlier groups' marks
    for (int e = tid; e < nu; e += nt) p.used[ldcg(p.ulist + e)] = 0;
    b.sync();
}

// Last block, after group g0's shortlists: one warp takes the group's
// candidates in order, each skipped where the sequential loop skips it
// (a source an earlier candidate of the group used; no target left),
// each target the first of its shortlist not used; then the next group's
// filter, or after the last group the round's apply.  The group's uses
// are kept as each later candidate sees them (b.group): the shortlist
// positions they take and whether they take its source.
template <class Blk>
UL_HD void resolve(Blk& b, const Plan& p, int g0) {
    State* st = p.st;
    const int n_top = ldcg(&st->n_top);
    const int gn = n_top - g0 < GROUP ? n_top - g0 : GROUP;
    const int nu0 = ldcg(&st->n_used);
    for (int e = b.tid(); e < gn * LIST; e += b.size())
        b.grp[e] = Best{ldcg(&p.list[e].v), ldcg(&p.list[e].i)};
    for (int j = b.tid(); j < gn; j += b.size())
        b.cand[j] = Cand{ldcg(&p.cand[j].vfrm), ldcg(&p.cand[j].pg),
                         ldcg(&p.cand[j].slot), ldcg(&p.cand[j].frm),
                         ldcg(&p.cand[j].n)};
    b.sync();
    if (b.warp() == 0) {
        const int64_t n_chg = ldcg(&st->n_chg);
        int n_acc = ldcg(&st->n_acc), rej = ldcg(&st->rej), nn = 0;
        auto uses = b.group(gn);
        for (int i = 0; i < gn; i++) {
            const Cand c = b.cand[i];
            if (c.n < 0 || uses.src_used(i)) continue;
            const uint32_t avail = ~uses.taken(i) & ((1u << c.n) - 1u);
            if (!avail) continue;  // no allowed target is left
            const Best t = b.grp[i * LIST + first_bit(avail)];
            // the separable objective: moving one PG frm -> to
            const double delta = UL_ADD(UL_MUL(2.0, t.v - c.vfrm), 2.0);
            const bool accept = delta < 0.0 && n_chg + n_acc < p.budget;
            rej += delta >= 0.0;
            if (b.lane() == 0) {
                if (accept) {
                    int32_t* a = p.acc + 5 * n_acc;
                    a[0] = c.pg;
                    a[1] = c.slot;
                    a[2] = t.i;
                    a[3] = c.frm;
                    b.nu[nn] = c.frm;
                }
                // a target is used up whether or not the move is accepted
                b.nu[nn + accept] = t.i;
            }
            nn += 1 + accept;
            n_acc += accept;
            uses.use(i, t.i, accept ? c.frm : -1);
            b.warp_sync();
        }
    for (int e = b.lane(); e < nn; e += b.lanes())
            p.ulist[nu0 + e] = b.nu[e];
        if (b.lane() == 0) {
            st->n_acc = n_acc;
            st->rej = rej;
            st->n_used = nu0 + nn;
        }
    }
    b.sync();
    if (g0 + GROUP < n_top) {
        // the next group's shortlists leave out this group's uses
        const int nu = ldcg(&st->n_used);
        for (int e = nu0 + b.tid(); e < nu; e += b.size())
            p.used[ldcg(p.ulist + e)] = 1;
        b.sync();
    } else {
        apply_round(b, p);
    }
}

// -- the end ------------------------------------------------------------------

// After the last round: the final rows of the changes, from the overlay,
// and the header.
template <class Blk>
UL_HD void finish_plan(Blk& b, const Plan& p, int blk, int nblk) {
    const int64_t n_chg = ldcg(&p.st->n_chg);
    int64_t* crows = p.out + OUT_HEAD + 4 * (int64_t)p.ncap;
    for (int64_t e = (int64_t)blk * b.size() + b.tid(); e < n_chg * p.w;
         e += (int64_t)nblk * b.size()) {
        const int64_t i = e / p.w, s = e % p.w;
        crows[e] = ldcg(p.ov_rows + (int64_t)ldcg(p.cslot + i) * p.w + s);
    }
    if (blk == 0 && b.tid() == 0) {
        p.out[OUT_NCHG] = n_chg;
        p.out[OUT_NREJ] = ldcg(&p.st->n_rej);
        p.out[OUT_ROUNDS] = ldcg(&p.st->rounds);
    }
}

// The whole plan.  grid.each(f) runs f(block, blk, nblk) as each block of
// the grid; grid.sync(f) is the grid barrier, f(block) run by the last
// block to arrive before any block passes it.
template <class Grid>
UL_HD void run_plan(Grid& grid, const Plan& p) {
    grid.each([&](auto& b, int blk, int nblk) { start_grid(b, p, blk, nblk); });
    grid.sync([&](auto& b) { start_last(b, p); });
    for (;;) {
        // block 0 takes the top-B, the last block the pools' target
        // prefixes where kept, the other blocks phase (a) (a block alone
        // takes all three, and of two the last takes phase (a) too)
        const int np = prefix_pools(p);
        grid.each([&](auto& b, int blk, int nblk) {
            if (blk == 0) top_b(b, p);
            if (np && blk == nblk - 1) prefixes(b, p, np);
            const int first = nblk > 1 ? 1 : 0;
            const int last = np && nblk > 2 ? nblk - 2 : nblk - 1;
            if (blk >= first && blk <= last)
                phase_a(b, p, blk - first, last - first + 1);
        });
        grid.sync([](auto&) {});
        const int n_top = ldcg(&p.st->n_top);
        for (int g0 = 0; g0 == 0 || g0 < n_top; g0 += GROUP) {
            grid.each([&](auto& b, int blk, int nblk) {
                shortlists(b, p, blk, nblk, g0);
            });
            grid.sync([&](auto& b) { resolve(b, p, g0); });
        }
        if (!ldcg(&p.st->cont)) break;
    }
    grid.each([&](auto& b, int blk, int nblk) { finish_plan(b, p, blk, nblk); });
}

#ifndef __CUDACC__
// The host's block: one thread, which is also warp 0's one lane.
struct HostBlock {
    Best sel[LIST > TOPK ? LIST : TOPK];
    Best grp[GROUP * LIST];
    Cand cand[GROUP];
    int32_t nu[2 * GROUP];
    int32_t stage[2 * W_CAP];

    int tid() const { return 0; }
    int size() const { return 1; }
    int warp() const { return 0; }
    int lane() const { return 0; }
    int lanes() const { return 1; }
    void sync() const {}
    void warp_sync() const {}
    Best reduce(Best v, bool) const { return v; }
    int sum(int v) const { return v; }
    // the k first admitted elements d < n in (value, index) order
    template <class Fetch, class Admit>
    int smallest(int k, int n, Fetch fetch, Admit admit) {
        int got = 0;
        for (int d = 0; d < n; d++) {
            Best c{0.0, d};
            if (!admit(d, fetch(d), c.v)) continue;
            if (got == k && !before(c, sel[k - 1])) continue;
            int at = got < k ? got++ : k - 1;
            for (; at > 0 && before(c, sel[at - 1]); at--) sel[at] = sel[at - 1];
            sel[at] = c;
        }
        return got;
    }
    // the first k entries of list[0..n) whose OSD pred admits, in order,
    // into sel
    template <class Pred>
    int first_of(int k, int n, const Best* list, Pred pred) {
        int c = 0;
        for (int l = 0; l < n && c < k; l++)
            if (pred(list[l].i)) sel[c++] = list[l];
        return c;
    }
    // The uses of a group's candidates as each later one sees them.
    struct Group {
        const HostBlock& b;
        int gn;
        uint32_t taken_[GROUP] = {};  // candidate j's positions used
        uint32_t src_ = 0;            // bit j: candidate j's source used
        uint32_t taken(int i) const { return taken_[i]; }
        bool src_used(int i) const { return (src_ >> i) & 1u; }
        // candidate i used OSD x and, when y >= 0, OSD y
        void use(int i, int32_t x, int32_t y) {
            for (int j = i + 1; j < gn; j++) {
                for (int l = 0; l < LIST; l++) {
                    const int32_t e = b.grp[j * LIST + l].i;
                    taken_[j] |= (uint32_t)(e == x || e == y) << l;
                }
                const int32_t f = b.cand[j].frm;
                src_ |= (uint32_t)(f == x || f == y) << j;
            }
        }
    };
    Group group(int gn) const { return Group{*this, gn}; }
    static void pick_min(int32_t* pick, int32_t d, int32_t g) {
        if (g < pick[d]) pick[d] = g;
    }
    // pick_min of PG g0 + u * stride at OSD dom[u] (none where dom[u] is dv)
    template <int U>
    static void pick_min_n(int32_t* pick, const int32_t* dom, int dv,
                           int64_t g0, int64_t stride) {
        for (int u = 0; u < U; u++)
            if (dom[u] < dv) pick_min(pick, dom[u], (int32_t)(g0 + u * stride));
    }
    static void add(int32_t* a, int32_t v) { *a += v; }
    static void set_bit(uint32_t* a, uint32_t m) { *a |= m; }
    static const float* stage_od(const Plan&, const float* od) { return od; }
    static void flush_picks(const Plan&, int32_t*) {}
};

// The host's grid: nblk blocks run one after another, a stage at a time.
struct HostGrid {
    HostBlock b;
    int nblk;
    template <class F>
    void each(F f) {
        for (int blk = 0; blk < nblk; blk++) f(b, blk, nblk);
    }
    template <class F>
    void sync(F last) {
        last(b);
    }
};
#endif

}  // namespace upmap_loop
