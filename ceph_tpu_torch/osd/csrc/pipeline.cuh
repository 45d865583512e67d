// One placement group through the whole placement pipeline: the per-lane
// body of the pipeline kernel (pipeline.cu), written once as
// __host__ __device__ code, as crush_rule.cuh is.
//
// nvcc builds it into the kernel; a C++ compiler builds the same file for
// the host with the two qualifiers defined empty (-D__host__=
// -D__device__=), which is how the CPU tests hold it against the JAX
// package (tests/test_torch_pipeline_kernel_host.py).
//
// The stages are those of ceph_tpu/osd/pipeline_jax.py::compile_pipeline's
// fn (:298) and of its plain version in the port,
// ceph_tpu_torch/osd/pipeline.py (PoolMapper._raw, _up, _rows), run in
// the lane's own row (reference src/osd/OSDMap.cc:2412-2715):
//   1. the placement seed: ceph_stable_mod, then hash32_2 with the pool id
//      (or the plain sum without hashpspool);
//   2. CRUSH: crush_rule::do_rule, the rule kernel's body as it is;
//      then _remove_nonexistent_osds: compacted (replicated) or NONE in
//      place (EC);
//   3. pg_upmap, whose out target aborts _apply_upmap (pg_upmap_items is
//      skipped too), then the pg_upmap_items pairs in order, each seeing
//      the writes of the pairs before it;
//   4. raw -> up: the up filter, and up_primary;
//   5. primary affinity (hash32_2(pps, osd) >> 16 against the affinity,
//      unsigned), the chosen primary moved to the front where the pool
//      shifts;
//   then pg_temp and primary_temp into acting and acting_primary.
// Every per-OSD load checks 0 <= v < max_osd first: the vectors may be
// longer than max_osd, and a NONE or an id past it is never a valid OSD.
//
// map_pg is a template on G, the lanes that map one PG together
// (crush_rule.cuh: the straw2 draws split over the group).  Every lane of
// a group runs the seed and the rule's whole control flow, so a group
// never diverges within itself where it shuffles; its first lane alone
// runs the stages after the rule, which shuffle nothing, and stores the
// rows and the primaries.

#pragma once

#include <stdint.h>

#define CRUSH_WEIGHT_T int64_t
#include "../../crush/csrc/crush_rule.cuh"
#include "placement_seed.cuh"

namespace pipeline {

using crush_rule::ITEM_NONE;
using crush_rule::RMAX_CAP;

constexpr int WMAX = RMAX_CAP;  // the widest row a lane holds
constexpr uint32_t DEFAULT_AFFINITY = 0x10000;  // osd/osdmap.py
constexpr uint32_t MAX_AFFINITY = 0x10000;

// What a launch writes (fixed at launch): all four planes (map_batch,
// map_all, map_all_tensors, the mesh blocks), `up` only (map_all_device),
// or the raw rows before the overlays (raw_rows).
enum { MODE_ROWS = 0, MODE_UP = 1, MODE_RAW = 2 };

// The pool's operands.  Seeds and the per-OSD vectors are the mapper's
// tensors as they are (int64 seeds and u32 values in int64, bool
// vectors); the overlays are int32 copies made once per mapper, indexed
// by the seed; a null overlay is absent.  ctypes mirrors this layout
// (osd/pipeline.py, _Pipe).
struct Pipe {
    const int64_t* ps;            // [n] placement seeds (u32 values)
    long long n;
    const uint8_t* exists;        // [dv] bool
    const uint8_t* up;            // [dv] bool: exists and up
    const int64_t* weight;        // [dv] OSD reweights (u32 values)
    const int64_t* affinity;      // [dv] primary affinity (u32 values)
    const int32_t* upmap_full;    // [pg_num, wu], NONE-padded, or null
    const int32_t* upmap_len;     // [pg_num], 0: no entry
    const int32_t* upmap_pairs;   // [pg_num, n_pairs, 2], or null
    const int32_t* temp;          // [pg_num, wt], NONE-padded, or null
    const int32_t* temp_len;      // [pg_num], -1: no entry
    const int32_t* primary_temp;  // [pg_num], -1: none; or null
    int32_t* up_out;              // [n, width]: up (or raw) rows
    int32_t* up_primary_out;      // [n]
    int32_t* acting_out;          // [n, width]
    int32_t* acting_primary_out;  // [n]
    uint32_t pool_id, pgp_num, pgp_mask;
    int32_t hashpspool, can_shift, has_rule, with_affinity, mode;
    int32_t max_osd, width, wu, n_pairs, wt;
};

template <typename T>
CRUSH_HD inline T load(const T* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

// a valid OSDMap id whose entry of `tbl` is set (exists() / is_up())
CRUSH_HD inline bool osd_ok(const Pipe& p, int32_t v, const uint8_t* tbl) {
    return v >= 0 && v < p.max_osd && load(tbl + v) != 0;
}

// the upmap reject guard: a valid id whose reweight is 0
// (reference src/osd/OSDMap.cc:2472, 2496)
CRUSH_HD inline bool marked_out(const Pipe& p, int32_t v) {
    return v >= 0 && v < p.max_osd && load(p.weight + v) == 0;
}

// the pool's placement seed of ps (placement_seed.cuh)
CRUSH_HD inline uint32_t placement_seed(const Pipe& p, uint32_t ps) {
    return placement::placement_seed(ps, p.pgp_num, p.pgp_mask,
                                     p.hashpspool, p.pool_id);
}

// row[0, w) with the entries osd_ok(., tbl) kept in order, NONE after
// (the erase loops of reference src/osd/OSDMap.cc:2416-2427, 2516-2522)
CRUSH_HD inline void compact(const Pipe& p, int32_t* row, int w,
                             const uint8_t* tbl) {
    int k = 0;
    for (int i = 0; i < w; i++)
        if (osd_ok(p, row[i], tbl)) row[k++] = row[i];
    for (; k < w; k++) row[k] = ITEM_NONE;
}

// _pick_primary (reference src/osd/OSDMap.cc:2455-2463)
CRUSH_HD inline int32_t first_not_none(const int32_t* row, int w) {
    for (int i = 0; i < w; i++)
        if (row[i] != ITEM_NONE) return row[i];
    return -1;
}

// Stage 3 (reference src/osd/OSDMap.cc:2465-2509) on the raw row of seed s.
CRUSH_HD inline void apply_upmap(const Pipe& p, long long s, int32_t* row) {
    const int w = p.width;
    bool aborted = false;
    if (p.upmap_full) {
        const int rl = load(p.upmap_len + s);
        const int32_t* full = p.upmap_full + s * p.wu;
        bool bad = false;
        for (int j = 0; j < p.wu && j < rl; j++)
            bad |= marked_out(p, load(full + j));
        // an out target aborts the whole _apply_upmap (the early return
        // at reference src/osd/OSDMap.cc:2474)
        aborted = rl > 0 && bad;
        if (rl > 0 && !bad)
            for (int i = 0; i < w; i++)
                row[i] = i < rl && i < p.wu ? load(full + i) : ITEM_NONE;
    }
    if (!p.upmap_pairs || aborted) return;
    const int32_t* pairs = p.upmap_pairs + s * p.n_pairs * 2;
    for (int j = 0; j < p.n_pairs; j++) {
        const int32_t from = load(pairs + 2 * j);
        const int32_t to = load(pairs + 2 * j + 1);
        if (from == ITEM_NONE || marked_out(p, to)) continue;
        bool present = false;
        for (int i = 0; i < w; i++) present |= row[i] == to;
        if (present) continue;
        for (int i = 0; i < w; i++)
            if (row[i] == from) {
                row[i] = to;
                break;
            }
    }
}

// Stage 5 (reference src/osd/OSDMap.cc:2537-2590): returns up_primary.
CRUSH_HD inline int32_t apply_affinity(const Pipe& p, uint32_t pps,
                                       int32_t* row, int32_t primary) {
    const int w = p.width;
    bool gate = false;  // some OSD of the row has a non-default affinity
    for (int i = 0; i < w; i++)
        gate |= row[i] != ITEM_NONE &&
                (uint32_t)load(p.affinity + row[i]) != DEFAULT_AFFINITY;
    if (!gate) return primary;
    int pos = -1, first = -1;
    for (int i = 0; i < w; i++) {
        const int32_t v = row[i];
        if (v == ITEM_NONE) continue;
        if (first < 0) first = i;
        const uint32_t a = (uint32_t)load(p.affinity + v);
        if (a < MAX_AFFINITY &&
            (crush_rule::hash2(pps, (uint32_t)v) >> 16) >= a)
            continue;
        pos = i;
        break;
    }
    if (pos < 0) pos = first;
    const int32_t chosen = row[pos];
    if (p.can_shift) {
        for (int i = pos; i > 0; i--) row[i] = row[i - 1];
        row[0] = chosen;
    }
    return chosen;
}

// pg_temp / primary_temp (reference src/osd/OSDMap.cc:2592-2627) for seed
// s of lane `lane`, whose up row and up_primary are given.
CRUSH_HD inline void apply_temp(const Pipe& p, long long s, long long lane,
                                const int32_t* up, int32_t up_primary) {
    const int w = p.width;
    const int32_t pt = p.primary_temp ? load(p.primary_temp + s) : -1;
    int32_t* acting = p.acting_out + lane * w;
    int32_t acting_primary = pt >= 0 ? pt : up_primary;
    bool use_temp = false;
    if (p.temp) {
        const int tlen = load(p.temp_len + s);
        const int32_t* trow = p.temp + s * p.wt;
        int alive = 0;
        int32_t first = -1;
        for (int i = 0; i < w && i < p.wt && i < tlen; i++) {
            const int32_t v = load(trow + i);
            if (osd_ok(p, v, p.up)) {
                alive++;
                if (first < 0) first = v;
            }
        }
        // an EC pool keeps positions: its count is the entry's length
        const int t_n = p.can_shift ? alive : (tlen > 0 ? tlen : 0);
        use_temp = tlen >= 0 && t_n > 0;
        if (use_temp) {
            acting_primary = pt >= 0 ? pt : first;
            int k = 0;
            for (int i = 0; i < w; i++) {
                const int32_t v = i < p.wt && i < tlen ? load(trow + i)
                                                       : ITEM_NONE;
                const bool ok = i < tlen && osd_ok(p, v, p.up);
                if (p.can_shift) {
                    if (ok) acting[k++] = v;
                } else {
                    acting[i] = ok ? v : ITEM_NONE;
                }
            }
            if (p.can_shift)
                for (; k < w; k++) acting[k] = ITEM_NONE;
        }
    }
    if (!use_temp)
        for (int i = 0; i < w; i++) acting[i] = up[i];
    p.acting_primary_out[lane] = acting_primary;
}

// Whether this lane runs the stages after the rule and stores its group's
// outputs: the group's first lane on the card (a group is G aligned lanes
// of a warp), the one thread that runs the group on the host.
template <int G>
CRUSH_HD inline bool group_lead() {
#ifdef __CUDA_ARCH__
    return G == 1 || (threadIdx.x & (G - 1)) == 0;
#else
    return true;
#endif
}

// The whole pipeline for lane `lane` of the launch (the PG of a group of
// G lanes).
template <int G = 1>
CRUSH_HD inline void map_pg(const crush_rule::Map& m,
                            const crush_rule::Rule& rule, const Pipe& p,
                            long long lane) {
    const int w = p.width;
    const long long s = load(p.ps + lane);
    const uint32_t pps = placement_seed(p, (uint32_t)s);

    // stage 2 and _remove_nonexistent_osds (reference OSDMap.cc:2412)
    int32_t row[WMAX];
    const int got =
        p.has_rule ? crush_rule::do_rule<G>(m, rule, pps, row) : 0;
    // no shuffle follows the rule: the group's other lanes are done
    if (!group_lead<G>()) return;
    for (int i = got; i < w; i++) row[i] = ITEM_NONE;
    if (p.can_shift) {
        compact(p, row, w, p.exists);
    } else {
        for (int i = 0; i < w; i++)
            if (row[i] != ITEM_NONE && !osd_ok(p, row[i], p.exists))
                row[i] = ITEM_NONE;
    }

    if (p.mode != MODE_RAW) {
        apply_upmap(p, s, row);
        // stage 4 (reference OSDMap.cc:2512-2535)
        if (p.can_shift) {
            compact(p, row, w, p.up);
        } else {
            for (int i = 0; i < w; i++)
                if (!osd_ok(p, row[i], p.up)) row[i] = ITEM_NONE;
        }
        int32_t up_primary = first_not_none(row, w);
        if (p.with_affinity)
            up_primary = apply_affinity(p, pps, row, up_primary);
        if (p.mode == MODE_ROWS) {
            p.up_primary_out[lane] = up_primary;
            apply_temp(p, s, lane, row, up_primary);
        }
    }
    int32_t* out = p.up_out + lane * w;
    for (int i = 0; i < w; i++) out[i] = row[i];
}

}  // namespace pipeline
