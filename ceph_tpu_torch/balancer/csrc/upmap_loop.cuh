// The device_loop upmap plan (balancer/upmap.py::_loop_plan), written
// once as __host__ __device__ code: the body of the one-launch plan
// kernel (upmap_loop.cu).
//
// nvcc builds it into the kernel; a C++ compiler builds the same file for
// the host with the two qualifiers defined empty (-D__host__=
// -D__device__=), which is how the CPU tests hold it against the plain
// version and the JAX package (tests/test_torch_upmap_kernel_host.py).
//
// A plan runs rounds until a round accepts nothing, stops improving the
// sum of squares, reaches max_dev or spends the budget.  A round is two
// phases:
//  (a) over every PG (dominant(): a grid-stride loop on the card, a plain
//      loop on the host): the PG's worst overfull member, the first
//      maximum of the float32 deviations in row order; each OSD keeps the
//      lowest PG index that picks it (an integer minimum: exact in any
//      order);
//  (b) in one block (plan_round_b()): the top-B overfull OSDs, each
//      candidate's target (the first minimum of the allowed deviations),
//      the accepts, the apply, the next round's deviations and the
//      continue flag.
// What `Blk` gives phase (b): tid() and size() of the block, sync(),
// any(pred) and reduce(Best, hi) over the block, each result seen by
// every thread.  Every reduction but one is a maximum, a minimum or an
// "any", which the order of the threads cannot change; the one float sum
// (the sum of squares, whose comparison is the float-tie guard) is taken
// in a fixed order that does not depend on the block's size
// (ordered_sum), with multiplies and adds that nvcc may not fuse.
//
// The XLA program's `mode="drop"` scatters are branches here; the plan
// writes its own copy of the rows (Plan::rows), never the caller's.

#pragma once

#include <math.h>
#include <stdint.h>

#define UL_HD __host__ __device__

#ifdef __CUDA_ARCH__
// loads of what another block may have written in this launch: past L1
#define UL_LDCG(p) __ldcg(p)
// a float64 product and sum rounded one at a time (nvcc fuses a * b + c
// into one fma otherwise, which rounds once and changes the sum's bits)
#define UL_MUL(a, b) __dmul_rn((a), (b))
#define UL_ADD(a, b) __dadd_rn((a), (b))
#define UL_UNROLL4 _Pragma("unroll 4")
#else
#define UL_LDCG(p) (*(p))
#define UL_MUL(a, b) ((a) * (b))
#define UL_ADD(a, b) ((a) + (b))
#define UL_UNROLL4
#endif

namespace upmap_loop {

constexpr int32_t ITEM_NONE = 0x7fffffff;
constexpr int32_t DOM_NONE = 0x7fffffff;  // dom_tbl: not in the rule
constexpr int32_t NO_INDEX = 0x7fffffff;  // Best: no element
constexpr int THREADS = 512;  // a block; the lanes of ordered_sum
constexpr int W_CAP = 32;     // widest row a plan takes

// The int64 output buffer, read back once: a header, then the accepted
// changes in order, their final rows and the final counts.
enum { OUT_NCHG = 0, OUT_NREJ = 1, OUT_ROUNDS = 2, OUT_HEAD = 4 };

inline int64_t out_len(int ncap, int w, int dv) {
    return OUT_HEAD + (int64_t)ncap * (4 + w) + dv;
}

// The plan's running state (global memory; written by block 0's thread 0
// between syncs).
struct State {
    double sum_sq;   // the last round's sum of squared deviations
    int64_t n_chg;   // accepted changes so far
    int64_t n_rej;   // candidates whose move would not improve
    int64_t rounds;
    int32_t cont;    // run another round
    int32_t pad;
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
    // the plan's copy of the rows, and the output (out_len int64)
    int32_t* rows;
    int64_t* out;
    // scratch (bind_scratch)
    State* st;
    double* dev;      // [dv] the round's deviations
    double* part;     // [THREADS] ordered_sum's lanes
    double* topv;     // [nbatch]
    float* odev;      // [dv] over ? (float)dev : -inf
    int32_t* pick;    // [dv] lowest PG whose dominant member is the OSD
    int32_t* topi;    // [nbatch]
    int32_t* acc;     // [4 * nbatch] the round's accepts: pg, slot, to, frm
    uint8_t* over;    // [dv]
    uint8_t* used;    // [dv]
};

inline size_t align8(size_t n) { return (n + 7) & ~(size_t)7; }

// Bytes of scratch a plan over dv OSDs with nbatch candidates needs.
inline size_t scratch_bytes(int dv, int nbatch) {
    return align8(sizeof(State)) + align8(8 * (size_t)dv) +
           8 * (size_t)THREADS + align8(8 * (size_t)nbatch) +
           align8(4 * (size_t)dv) + align8(4 * (size_t)dv) +
           align8(4 * (size_t)nbatch) + align8(16 * (size_t)nbatch) +
           align8((size_t)dv) + align8((size_t)dv);
}

inline char* take(char*& at, size_t n) {
    char* here = at;
    at += align8(n);
    return here;
}

// Points the plan's scratch arrays into `scratch` (scratch_bytes of it,
// 8-byte aligned), after p.dv and p.nbatch are set.
inline void bind_scratch(Plan& p, void* scratch) {
    char* s = static_cast<char*>(scratch);
    p.st = reinterpret_cast<State*>(take(s, sizeof(State)));
    p.dev = reinterpret_cast<double*>(take(s, 8 * (size_t)p.dv));
    p.part = reinterpret_cast<double*>(take(s, 8 * (size_t)THREADS));
    p.topv = reinterpret_cast<double*>(take(s, 8 * (size_t)p.nbatch));
    p.odev = reinterpret_cast<float*>(take(s, 4 * (size_t)p.dv));
    p.pick = reinterpret_cast<int32_t*>(take(s, 4 * (size_t)p.dv));
    p.topi = reinterpret_cast<int32_t*>(take(s, 4 * (size_t)p.nbatch));
    p.acc = reinterpret_cast<int32_t*>(take(s, 16 * (size_t)p.nbatch));
    p.over = reinterpret_cast<uint8_t*>(take(s, (size_t)p.dv));
    p.used = reinterpret_cast<uint8_t*>(take(s, (size_t)p.dv));
}

// An element of an arg-reduction: its value and index.  hi: the largest
// value wins, else the smallest; equal values go to the lower index (the
// first extremum, as argmax / argmin and XLA's top_k order them).
struct Best {
    double v;
    int32_t i;
};

UL_HD inline Best prefer(Best a, Best b, bool hi) {
    if (hi ? a.v > b.v : a.v < b.v) return a;
    if (a.v == b.v && a.i < b.i) return a;
    return b;
}

UL_HD inline Best none(bool hi) {
    return Best{hi ? -(double)INFINITY : (double)INFINITY, NO_INDEX};
}

UL_HD inline bool is_finite(double x) {
    return x > -(double)INFINITY && x < (double)INFINITY;
}

UL_HD inline double dev_of(const Plan& p, int d, int64_t c) {
    return p.inw[d] > 0.0 ? (double)c - p.target[d] : 0.0;
}

UL_HD inline int64_t* out_counts(const Plan& p) {
    return p.out + OUT_HEAD + (int64_t)p.ncap * (4 + p.w);
}

// sum over d < dv of x[d] * x[d], in one order whatever the block: lane
// l < THREADS adds d = l, l + THREADS, ... in turn, then the lanes are
// added pairwise, halving.
template <class Blk>
UL_HD double ordered_sum(Blk& b, const Plan& p, const double* x) {
    for (int l = b.tid(); l < THREADS; l += b.size()) {
        double s = 0.0;
        for (int d = l; d < p.dv; d += THREADS)
            s = UL_ADD(s, UL_MUL(x[d], x[d]));
        p.part[l] = s;
    }
    b.sync();
    for (int h = THREADS / 2; h > 0; h >>= 1) {
        for (int l = b.tid(); l < h; l += b.size())
            p.part[l] = UL_ADD(p.part[l], p.part[l + h]);
        b.sync();
    }
    const double s = p.part[0];
    b.sync();
    return s;
}

// The deviations of the counts in out_counts, and what the next round's
// phase (a) reads: the overfull set (the strict set, or the
// more_overfull takeover when only underfull remain), the float32
// deviations of its members, and cleared picks and used flags.  Returns
// the sum of squares and, in *mx, the largest absolute deviation.
template <class Blk>
UL_HD double deviations(Blk& b, const Plan& p, double* mx) {
    const int64_t* counts = out_counts(p);
    bool over_any = false, under_any = false;
    Best m = none(true);
    for (int d = b.tid(); d < p.dv; d += b.size()) {
        const double v = dev_of(p, d, counts[d]);
        p.dev[d] = v;
        over_any |= v > p.max_dev;
        under_any |= v < -p.max_dev;
        m = prefer(m, Best{fabs(v), 0}, true);
    }
    const bool has_over = b.any(over_any);
    const bool has_under = b.any(under_any);
    *mx = b.reduce(m, true).v;
    const double ss = ordered_sum(b, p, p.dev);
    for (int d = b.tid(); d < p.dv; d += b.size()) {
        const double v = p.dev[d];
        const bool o = (has_over ? v > p.max_dev : (v > 0.0 && has_under)) &&
                       p.inw[d] > 0.0;
        p.over[d] = o;
        p.odev[d] = o ? (float)v : -INFINITY;
        p.pick[d] = (int32_t)p.npg;
        p.used[d] = 0;
    }
    b.sync();
    return ss;
}

// Before the first round: the counts copied into the output, the first
// deviations and the state.
template <class Blk>
UL_HD void start_plan(Blk& b, const Plan& p) {
    int64_t* counts = out_counts(p);
    for (int d = b.tid(); d < p.dv; d += b.size()) counts[d] = p.counts_in[d];
    b.sync();
    double mx;
    const double ss = deviations(b, p, &mx);
    if (b.tid() == 0) {
        p.st->sum_sq = ss;
        p.st->n_chg = 0;
        p.st->n_rej = 0;
        p.st->rounds = 0;
        p.st->cont = 1;
    }
    b.sync();
}

// Phase (a) for PG g: its dominant overfull member (the first maximum of
// the float32 deviations of its overfull members), or dv when it has
// none or may not move.  Reads the row from src and, when copy is not
// null, writes it there too (the first round makes the plan's copy).
UL_HD inline int32_t dominant(const Plan& p, int64_t g, const int32_t* src,
                              int32_t* copy) {
    float best = -INFINITY;
    int32_t osd = 0;
    const int64_t at = g * p.w;
    for (int s = 0; s < p.w; s++) {
        const int32_t r = UL_LDCG(src + at + s);
        if (copy) copy[at + s] = r;
        const float v = (r >= 0 && r < p.dv) ? p.odev[r] : -INFINITY;
        if (v > best) {
            best = v;
            osd = r;
        }
    }
    if (!(best > -INFINITY) || !p.movable[g]) return p.dv;
    return osd;
}

// Phase (b), in one block: the round's candidates, the apply, the next
// round's deviations and the continue flag.
template <class Blk>
UL_HD void plan_round_b(Blk& b, const Plan& p) {
    const int tid = b.tid(), nt = b.size();
    const int B = p.nbatch, W = p.w, DV = p.dv;
    const int64_t n_chg = p.st->n_chg;

    // the top-B overfull OSDs, largest deviation first, equal deviations
    // lowest index first: pass k takes the largest after pass k-1's pick
    // in that order
    double pv = (double)INFINITY;
    int32_t pi = -1;
    for (int k = 0; k < B; k++) {
        Best best = none(true);
        UL_UNROLL4
        for (int d = tid; d < DV; d += nt) {
            const double v = p.over[d] ? p.dev[d] : -(double)INFINITY;
            if (v < pv || (v == pv && d > pi))
                best = prefer(best, Best{v, d}, true);
        }
        best = b.reduce(best, true);
        if (tid == 0) {
            p.topv[k] = best.v;
            p.topi[k] = best.i;
        }
        pv = best.v;
        pi = best.i;
    }
    b.sync();

    // the candidates in order; every thread takes the same branches
    int n_acc = 0, rej = 0;
    for (int k = 0; k < B; k++) {
        const int32_t frm = p.topi[k];
        const int32_t pg = UL_LDCG(p.pick + frm);
        if (!is_finite(p.topv[k]) || p.used[frm] || pg >= p.npg) continue;
        const int32_t* row = p.rows + (int64_t)pg * W;
        int32_t member[W_CAP];
        int slot = -1;
        for (int s = 0; s < W; s++) {
            const int32_t r = UL_LDCG(row + s);
            member[s] = (r >= 0 && r < DV) ? r : -1;
            if (slot < 0 && member[s] == frm) slot = s;
        }
        if (slot < 0) continue;  // frm is not a member of the row
        int32_t pp = p.pidx[pg];
        pp = pp < 0 ? 0 : (pp >= p.npool ? p.npool - 1 : pp);
        const int32_t* dtbl = p.dom_tbl + (int64_t)pp * DV;
        const uint8_t* ok = p.tgt_ok + (int64_t)pp * DV;
        // the failure domains of the other members: the target may not
        // share one
        int32_t mdom[W_CAP];
        for (int s = 0; s < W; s++)
            mdom[s] = (member[s] >= 0 && s != slot) ? dtbl[member[s]]
                                                     : DOM_NONE;
        Best t = none(false);
        // every load of an OSD issued at once (no short-circuit between
        // them), four OSDs a thread in flight
        UL_UNROLL4
        for (int d = tid; d < DV; d += nt) {
            const double v = p.dev[d];
            const int32_t dd = dtbl[d];
            bool allowed = (p.inw[d] > 0.0) & (v < 0.0) & (ok[d] != 0) &
                           (p.used[d] == 0);
            for (int s = 0; s < W; s++)
                allowed &= (member[s] != d) & (mdom[s] != dd);
            if (allowed) t = prefer(t, Best{v, d}, false);
        }
        t = b.reduce(t, false);
        if (t.i == NO_INDEX) continue;  // no allowed target
        const int32_t to = t.i;
        // the separable objective: moving one PG frm -> to
        const double delta =
            UL_ADD(UL_MUL(2.0, p.dev[to] - p.dev[frm]), 2.0);
        const bool accept = delta < 0.0 && n_chg + n_acc < p.budget;
        rej += delta >= 0.0;
        b.sync();  // every thread has read used[] for this candidate
        if (tid == 0) {
            if (accept) {
                int32_t* a = p.acc + 4 * n_acc;
                a[0] = pg;
                a[1] = slot;
                a[2] = to;
                a[3] = frm;
                p.used[frm] = 1;
            }
            // a target is used up whether or not the move is accepted
            p.used[to] = 1;
        }
        n_acc += accept;
        b.sync();
    }

    // apply: a round's PGs are distinct (one dominant member each) and
    // its OSDs disjoint, so the moves commute
    int64_t* counts = out_counts(p);
    int64_t* cpg = p.out + OUT_HEAD;
    const int64_t rnd = p.st->rounds + 1;
    for (int i = tid; i < n_acc; i += nt) {
        const int32_t* a = p.acc + 4 * i;
        p.rows[(int64_t)a[0] * W + a[1]] = a[2];
        counts[a[3]] -= 1;
        counts[a[2]] += 1;
        const int64_t pos = n_chg + i;
        if (pos < p.ncap) {
            cpg[pos] = a[0];
            cpg[p.ncap + pos] = a[3];
            cpg[2 * p.ncap + pos] = a[2];
            cpg[3 * p.ncap + pos] = rnd;
        }
    }
    b.sync();

    double mx2;
    const double ss2 = deviations(b, p, &mx2);
    if (tid == 0) {
        const int64_t n_chg2 = n_chg + n_acc;
        // the sequential loop's exits: nothing accepted, the float-tie
        // guard (never loop on a non-improvement), max_dev reached, the
        // round or change budget spent
        p.st->cont = n_acc > 0 && ss2 < p.st->sum_sq && mx2 > p.max_dev &&
                     rnd < p.budget && n_chg2 < p.budget;
        p.st->sum_sq = ss2;
        p.st->n_chg = n_chg2;
        p.st->n_rej += rej;
        p.st->rounds = rnd;
    }
    b.sync();
}

// After the last round: the header and the final rows of the changed PGs.
template <class Blk>
UL_HD void finish_plan(Blk& b, const Plan& p) {
    const int64_t n_chg = p.st->n_chg;
    const int64_t* cpg = p.out + OUT_HEAD;
    int64_t* crows = p.out + OUT_HEAD + 4 * (int64_t)p.ncap;
    for (int64_t e = b.tid(); e < n_chg * p.w; e += b.size()) {
        const int64_t i = e / p.w, s = e % p.w;
        crows[e] = UL_LDCG(p.rows + cpg[i] * p.w + s);
    }
    if (b.tid() == 0) {
        p.out[OUT_NCHG] = n_chg;
        p.out[OUT_NREJ] = p.st->n_rej;
        p.out[OUT_ROUNDS] = p.st->rounds;
    }
    b.sync();
}

}  // namespace upmap_loop
