// crush_do_rule for one placement seed: the per-lane body of the CRUSH
// rule kernel (crush_rule.cu), written once as __host__ __device__ code.
//
// nvcc builds it into the kernel; a C++ compiler builds the same file for
// the host with the two qualifiers defined empty
// (-D__host__= -D__device__=), which is how the CPU tests hold it against
// the JAX package.  The control flow is the C interpreter's
// (reference src/crush/mapper.c, as ceph_tpu/native/crush.cpp follows it:
// straw2_choose :221, choose_firstn :287, choose_indep :387, do_rule
// :481), read over the packed bucket records of
// ceph_tpu_torch/crush/soa.py::pack_buckets: no containers, no heap, no
// recursion.  Retries are loops bounded by the tunables; chooseleaf's
// inner pick is a second function (leaf_firstn / leaf_indep).
//
// Where the two builds differ, it is only in where a load comes from.  On
// the card the crush_ln tables and the staged prefix of the records sit
// in the block's dynamic shared memory (crush_smem, filled by the
// kernel, which points Map::staged at its records), the rest is read
// through the read-only path; on the host they are the buffers the Map
// points at (Map::staged a copy of the prefix).
//
// Scope: every bucket algorithm (straw2, and the legacy straw, list, tree
// and uniform draws, bucket_choose), no legacy local retries (the
// wrapper's plan pass, crush/mapper.py::compile_rule, refuses those maps
// before a launch).
//
// The diagnostics variant (crush_rule_diag.cu) defines CRUSH_RULE_DIAG
// before it includes this file: the same walk, which also books each
// placement's retry count, the collision, out-of-weight and skip tallies
// of the draws it makes, and the work vector after each choose step (see
// Diag).  What it adds is written with DIAG() and DIAG_ARGS(), which
// expand to nothing in the rule kernel's build, so that build compiles
// exactly the code it compiled before the variant existed.

#pragma once

#include <stdint.h>

#define CRUSH_HD __host__ __device__

#ifdef CRUSH_RULE_DIAG
#define DIAG(...) __VA_ARGS__
#define DIAG_ARGS(...) , __VA_ARGS__
#else
#define DIAG(...)
#define DIAG_ARGS(...)
#endif

namespace crush_rule {

constexpr int32_t ITEM_NONE = 0x7fffffff;
constexpr int32_t ITEM_UNDEF = 0x7ffffffe;
constexpr int RMAX_CAP = 32;  // longest result row a lane can hold

// rule step opcodes (reference src/crush/crush.h:52-70)
enum {
    OP_TAKE = 1, OP_CHOOSE_FIRSTN = 2, OP_CHOOSE_INDEP = 3, OP_EMIT = 4,
    OP_CHOOSELEAF_FIRSTN = 6, OP_CHOOSELEAF_INDEP = 7,
    OP_SET_CHOOSE_TRIES = 8, OP_SET_CHOOSELEAF_TRIES = 9,
    OP_SET_CHOOSELEAF_VARY_R = 12, OP_SET_CHOOSELEAF_STABLE = 13,
};

// outcome of one descent (the status codes of mapper_jax._descend_impl)
enum { FOUND = 1, SKIP = 2, EMPTY = 3 };

// bucket algorithms (reference src/crush/crush.h crush_algorithm)
enum { ALG_UNIFORM = 1, ALG_LIST = 2, ALG_TREE = 3, ALG_STRAW = 4,
       ALG_STRAW2 = 5 };

// One draw's inputs (soa.py RECORD).  straw2: the id it hashes, its weight
// and the weight's reciprocal, magic = m | l << 56 (soa.py
// magic_div_consts; 0 where the weight is 0).  The legacy algorithms
// ignore choose_args: arg_id is the bucket's own item, weight its own
// weight, magic straw's straw or list's sum_weights entry.
struct alignas(16) Record {
    int32_t arg_id;
    uint32_t weight;
    uint64_t magic;
};

// The first 16 bytes of a bucket slot's 32-byte header (soa.py HEADER):
// items[offset, offset + size); the records of weight-set position p at
// positions * offset + p * size.  A tree's node weights are
// nodes[spare, spare + num_nodes), from the header's second 16 bytes.
struct Bucket {
    int32_t offset, size, type, alg;
};

constexpr int HEADER_WORDS = 8;
// the crush_ln tables in 16-byte words: RH/LH (129 rows of one pair),
// then LL (256 entries, two a word)
constexpr int LN_ROWS = 129, LL_WORDS = 128, LN_WORDS = LN_ROWS + LL_WORDS;

// The map, packed.  Slot b holds bucket id -1-b.  u32 fields are read as
// their bit patterns.
struct Map {
    const int32_t* headers;  // [n_buckets, HEADER_WORDS]
    const Record* records;   // [R]
    const Record* staged;    // a copy of records[0, n_staged): shared memory
                             // on the card
    const int32_t* items;    // [sum of sizes]
    const uint32_t* weight;  // [weight_len] OSD reweights (16.16)
    const int64_t* rh_lh;    // [258] crush_ln tables
    const int64_t* ll;       // [256]
    int32_t n_staged, n_buckets, positions, max_devices, max_depth;
    int32_t weight_len;
    const uint32_t* nodes;   // the tree buckets' node weights
};

struct Rule {
    const int32_t* steps;  // [n_steps, 3]: op, arg1, arg2
    int32_t n_steps, result_max;
    int32_t choose_total_tries, chooseleaf_descend_once;
    int32_t chooseleaf_vary_r, chooseleaf_stable;
};

#ifdef CRUSH_RULE_DIAG
// The diagnostics of one lane (the planes of mapper_jax.compile_rule's
// with_diag, with mapper_ref's values).  plan[3 * s .. 3 * s + 2] is rule
// step s's first tries lane, its lanes per source bucket and its row of
// `steps` (-1: not a choose step the lane can reach); the wrapper's plan
// pass, crush/mapper.py::compile_rule, lays them out:
// - choose firstn: one lane per rep, the retry count (ftotal) of its
//   placement; chooseleaf firstn a second block of numrep lanes, the
//   leaf recursion's count (reference src/crush/mapper.c:640-643 books
//   both);
// - choose indep: one lane, the call's rounds (mapper.c:843); chooseleaf
//   indep also one lane per (rep, round) for the leaf call of that round,
//   which books its own rounds;
// -1 where no placement (or call) was made.  coll, rej and skip count the
// firstn draws that collided, were out of weight or ended in a skip_rep;
// the indep loops leave them alone, as the JAX package does.
struct Tally {
    int32_t coll, rej, skip;
};

struct Diag {
    const int32_t* plan;  // [n_steps, 3]
    int32_t* tries;       // [diag_lanes], -1 filled
    int32_t* steps;       // [diag_steps, result_max], ITEM_NONE filled
    Tally tally;
};
#endif

#ifdef __CUDACC__
// [LN_WORDS] crush_ln tables, then [n_staged] records (crush_rule.cu)
extern __shared__ uint4 crush_smem[];
#endif

// -- loads ----------------------------------------------------------------

CRUSH_HD inline Bucket bucket(const Map& m, int slot) {
#ifdef __CUDA_ARCH__
    const int4 h = __ldg(
        reinterpret_cast<const int4*>(m.headers + HEADER_WORDS * slot));
    return {h.x, h.y, h.z, h.w};
#else
    const int32_t* h = m.headers + HEADER_WORDS * slot;
    return {h[0], h[1], h[2], h[3]};
#endif
}

// a tree bucket's node weights: (offset into m.nodes, num_nodes)
CRUSH_HD inline void tree_header(const Map& m, int slot, int& off, int& nn) {
    const int32_t* h = m.headers + HEADER_WORDS * slot + 4;
#ifdef __CUDA_ARCH__
    off = __ldg(h);
    nn = __ldg(h + 1);
#else
    off = h[0];
    nn = h[1];
#endif
}

CRUSH_HD inline uint32_t node_at(const Map& m, int i) {
#ifdef __CUDA_ARCH__
    return __ldg(m.nodes + i);
#else
    return m.nodes[i];
#endif
}

CRUSH_HD inline Record record(const Map& m, int i) {
    if (i < m.n_staged) return m.staged[i];
#ifdef __CUDA_ARCH__
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(m.records) + i);
    return {(int32_t)v.x, v.y, (uint64_t)v.z | (uint64_t)v.w << 32};
#else
    return m.records[i];
#endif
}

CRUSH_HD inline int32_t item_at(const Map& m, int i) {
#ifdef __CUDA_ARCH__
    return __ldg(m.items + i);
#else
    return m.items[i];
#endif
}

// row k of the RH/LH table: (RH, LH), one 16-byte load on the card
CRUSH_HD inline void ln_row(const Map& m, int k, uint64_t& rh,
                            uint64_t& lh) {
#ifdef __CUDA_ARCH__
    const ulonglong2 v = reinterpret_cast<const ulonglong2*>(crush_smem)[k];
    rh = v.x;
    lh = v.y;
#else
    rh = (uint64_t)m.rh_lh[2 * k];
    lh = (uint64_t)m.rh_lh[2 * k + 1];
#endif
}

CRUSH_HD inline uint64_t ln_ll(const Map& m, int j) {
#ifdef __CUDA_ARCH__
    return reinterpret_cast<const unsigned long long*>(
        crush_smem + LN_ROWS)[j];
#else
    return (uint64_t)m.ll[j];
#endif
}

// the high 64 bits of a 64 x 64-bit product
CRUSH_HD inline uint64_t mulhi64(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
    return __umul64hi(a, b);
#else
    return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// floor(log2(v)) for v >= 1
CRUSH_HD inline int log2_floor(uint32_t v) {
#ifdef __CUDA_ARCH__
    return 31 - __clz(v);
#else
    return 31 - __builtin_clz(v);
#endif
}

// the number of trailing zero bits of v >= 1
CRUSH_HD inline int ctz(uint32_t v) {
#ifdef __CUDA_ARCH__
    return __ffs(v) - 1;
#else
    return __builtin_ctz(v);
#endif
}

// -- rjenkins (reference src/crush/hash.c) ---------------------------------

CRUSH_HD inline void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
    a -= b; a -= c; a ^= c >> 13;
    b -= c; b -= a; b ^= a << 8;
    c -= a; c -= b; c ^= b >> 13;
    a -= b; a -= c; a ^= c >> 12;
    b -= c; b -= a; b ^= a << 16;
    c -= a; c -= b; c ^= b >> 5;
    a -= b; a -= c; a ^= c >> 3;
    b -= c; b -= a; b ^= a << 10;
    c -= a; c -= b; c ^= b >> 15;
}

constexpr uint32_t HASH_SEED = 1315423911u;

CRUSH_HD inline uint32_t hash2(uint32_t a, uint32_t b) {
    uint32_t h = HASH_SEED ^ a ^ b, x = 231232, y = 1232;
    mix(a, b, h);
    mix(x, a, h);
    mix(b, y, h);
    return h;
}

CRUSH_HD inline uint32_t hash3(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t h = HASH_SEED ^ a ^ b ^ c, x = 231232, y = 1232;
    mix(a, b, h);
    mix(c, x, h);
    mix(y, a, h);
    mix(b, x, h);
    mix(y, c, h);
    return h;
}

CRUSH_HD inline uint32_t hash4(uint32_t a, uint32_t b, uint32_t c,
                               uint32_t d) {
    uint32_t h = HASH_SEED ^ a ^ b ^ c ^ d, x = 231232, y = 1232;
    mix(a, b, h);
    mix(c, d, h);
    mix(a, x, h);
    mix(y, b, h);
    mix(c, x, h);
    mix(y, d, h);
    return h;
}

// -- crush_ln: 2^44 * log2(xin + 1) (reference src/crush/mapper.c:247) ----

// xin <= 0xffff, so x = xin + 1 fits 32 bits: the reference's u64
// normalisation (x < 0x8000: shift up to [0x8000, 0x10000), iexpon =
// floor(log2 x)) is done in 32 bits and without a branch, iexpon being
// min(floor(log2 x), 15).
CRUSH_HD inline int64_t crush_ln(const Map& m, uint32_t xin) {
    uint32_t x = xin + 1;
    const int fl = log2_floor(x);
    const int iexpon = fl < 15 ? fl : 15;
    x <<= 15 - iexpon;
    const int k = (int)(x >> 8) - 128;  // RH/LH row, in [0, 128]
    uint64_t rh, lh;
    ln_row(m, k, rh, lh);
    const uint64_t xl64 = ((uint64_t)x * rh) >> 48;  // u64 wraparound, as in C
    const uint64_t ll = ln_ll(m, (int)(xl64 & 0xff));
    return (int64_t)(((uint64_t)iexpon << 44) +
                     ((lh + ll) >> (48 - 12 - 32)));
}

// -- the straw2 draw (reference src/crush/mapper.c:334-384) ---------------
// draw_i = (crush_ln(hash3(x, id_i, r) & 0xffff) - 2^48) / w_i, truncated
// toward zero (S64_MIN where w_i = 0); the first maximum wins.  The
// numerator is -n with 0 <= n = 2^48 - crush_ln <= 2^48, so draw_i is
// -floor(n / w_i), and floor(n / w_i) = floor(n * m_i / 2^(49 + l_i)) with
// the record's reciprocal: the high half of (n << 15) * m_i, shifted
// right by l_i.  The draw is kept as q_i = -draw_i (UINT64_MAX where
// w_i = 0), and the first minimum of q wins.

// floor((2^48 - ln) / w) for 0 <= ln <= 2^48, from w's magic word
CRUSH_HD inline uint64_t straw2_quotient(int64_t ln, uint64_t magic) {
    const uint64_t n = 0x1000000000000ULL - (uint64_t)ln;
    return mulhi64(n << 15, magic & 0x00ffffffffffffffULL) >> (magic >> 56);
}

CRUSH_HD inline int32_t straw2_choose(const Map& m, const Bucket& b,
                                      uint32_t x, int32_t r, int position) {
    const int pos = position < m.positions - 1 ? position : m.positions - 1;
    const int base = m.positions * b.offset + pos * b.size;
    int high = 0;
    uint64_t high_q = UINT64_MAX;
    for (int i = 0; i < b.size; i++) {
        const Record rec = record(m, base + i);
        uint64_t q = UINT64_MAX;
        if (rec.weight) {
            const uint32_t u =
                hash3(x, (uint32_t)rec.arg_id, (uint32_t)r) & 0xffff;
            q = straw2_quotient(crush_ln(m, u), rec.magic);
        }
        const bool better = q < high_q;
        high = better ? i : high;
        high_q = better ? q : high_q;
    }
    return item_at(m, b.offset + high);
}

// -- the legacy draws ------------------------------------------------------
// They ignore choose_args and the position (reference src/crush/mapper.c
// crush_bucket_choose passes a weight set to straw2 only), so they read
// the records of position 0, which hold the bucket's own items and
// weights.

// straw (reference src/crush/mapper.c:227-245): the largest
// (hash3(x, item, r) & 0xffff) * straw wins, the first on a tie.
CRUSH_HD inline int32_t straw_choose(const Map& m, const Bucket& b,
                                     uint32_t x, int32_t r) {
    const int base = m.positions * b.offset;
    int high = 0;
    uint64_t high_draw = 0;
    for (int i = 0; i < b.size; i++) {
        const Record rec = record(m, base + i);
        const uint64_t draw =
            (uint64_t)(hash3(x, (uint32_t)rec.arg_id, (uint32_t)r) & 0xffff) *
            rec.magic;
        const bool better = i == 0 || draw > high_draw;
        high = better ? i : high;
        high_draw = better ? draw : high_draw;
    }
    return item_at(m, b.offset + high);
}

// list (reference src/crush/mapper.c:141-164): from the tail, the first
// item whose scaled hash falls under its weight; else the head.
CRUSH_HD inline int32_t list_choose(const Map& m, const Bucket& b,
                                    int32_t id, uint32_t x, int32_t r) {
    const int base = m.positions * b.offset;
    for (int i = b.size - 1; i >= 0; i--) {
        const Record rec = record(m, base + i);
        const uint64_t w =
            ((uint64_t)(hash4(x, (uint32_t)rec.arg_id, (uint32_t)r,
                              (uint32_t)id) & 0xffff) * rec.magic) >> 16;
        if (w < rec.weight) return rec.arg_id;
    }
    return item_at(m, b.offset);
}

// tree (reference src/crush/mapper.c:195-222): down the node-weight heap
// from the root, num_nodes >> 1, to an odd (leaf) node.
CRUSH_HD inline int32_t tree_choose(const Map& m, const Bucket& b,
                                    int32_t id, uint32_t x, int32_t r) {
    int off, nn;
    tree_header(m, -1 - id, off, nn);
    uint32_t n = (uint32_t)nn >> 1;
    while (n && !(n & 1)) {
        const uint64_t t =
            ((uint64_t)hash4(x, n, (uint32_t)r, (uint32_t)id) *
             node_at(m, off + n)) >> 32;
        const uint32_t half = 1u << (ctz(n) - 1);
        n = t < node_at(m, off + n - half) ? n - half : n + half;
    }
    return item_at(m, b.offset + (n >> 1));
}

// uniform (reference src/crush/mapper.c:73-131): items[perm[r % size]],
// perm the Fisher-Yates shuffle seeded by x whose step p swaps positions
// p and p + hash3(x, id, p) % (size - p) (p < size - 1).  perm[pr] is
// final after step pr, so only steps 0..pr matter, and they are traced
// backward from pr: the position whose starting value step pr brings to
// pr, then each earlier step that swapped it in.  One hash per step, and
// no permutation in memory, whatever the bucket's size.  (The C keeps the
// permutation between calls of one crush_do_rule; the item it returns is
// the same.)
CRUSH_HD inline int32_t uniform_choose(const Map& m, const Bucket& b,
                                       int32_t id, uint32_t x, int32_t r) {
    const uint32_t size = (uint32_t)b.size;
    const uint32_t pr = (uint32_t)r % size;
    uint32_t q = pr;
    if (pr + 1 < size) q += hash3(x, (uint32_t)id, pr) % (size - pr);
    for (uint32_t p = pr; p-- > 0;)
        if (p + hash3(x, (uint32_t)id, p) % (size - p) == q) q = p;
    return item_at(m, b.offset + (int)q);
}

// crush_bucket_choose (reference src/crush/mapper.c:387-418) for bucket
// `id` with header b
CRUSH_HD inline int32_t bucket_choose(const Map& m, const Bucket& b,
                                      int32_t id, uint32_t x, int32_t r,
                                      int position) {
    switch (b.alg) {
    case ALG_STRAW2: return straw2_choose(m, b, x, r, position);
    case ALG_STRAW: return straw_choose(m, b, x, r);
    case ALG_LIST: return list_choose(m, b, id, x, r);
    case ALG_TREE: return tree_choose(m, b, id, x, r);
    case ALG_UNIFORM: return uniform_choose(m, b, id, x, r);
    default: return item_at(m, b.offset);
    }
}

// reference src/crush/mapper.c:424-438
CRUSH_HD inline bool is_out(const Map& m, int32_t item, uint32_t x) {
    if (item >= m.weight_len) return true;
    uint32_t w = m.weight[item];
    if (w >= 0x10000) return false;
    if (w == 0) return true;
    return (hash2(x, (uint32_t)item) & 0xffff) >= w;
}

// Walk from bucket `start` with one r until an item of `type` emerges
// (the retry_bucket descent of reference src/crush/mapper.c:507-555 /
// 710-771).  FOUND sets *item; SKIP is C's skip_rep (an out-of-range or
// dangling item, a device of the wrong type, or a walk deeper than the
// map); EMPTY is an empty bucket on the way.  Each level reads one
// header: the one that gave the child's type is the next level's.
// An indep descent (numrep > 0) draws from a uniform bucket whose size
// numrep divides with r_uniform in place of r (reference
// src/crush/mapper.c:716-721); *r_last gets the r of the last draw.
CRUSH_HD inline int descend(const Map& m, int32_t start, uint32_t x,
                            int32_t r, int position, int type,
                            int32_t* item, int numrep = 0,
                            int32_t r_uniform = 0, int32_t* r_last = nullptr) {
    int32_t id = start;
    Bucket b = bucket(m, -1 - id);
    for (int level = 0; level <= m.max_depth; level++) {
        if (b.size == 0) return EMPTY;
        const int32_t rb = numrep > 0 && b.alg == ALG_UNIFORM &&
                                   b.size % numrep == 0
                               ? r_uniform : r;
        if (r_last) *r_last = rb;
        const int32_t it = bucket_choose(m, b, id, x, rb, position);
        if (it >= m.max_devices) return SKIP;
        if (it >= 0) {
            if (type != 0) return SKIP;
            *item = it;
            return FOUND;
        }
        if (-1 - it >= m.n_buckets) return SKIP;
        id = it;
        b = bucket(m, -1 - id);
        if (b.type == type) {
            *item = it;
            return FOUND;
        }
    }
    return SKIP;
}

// chooseleaf firstn's inner pick (reference src/crush/mapper.c:573-588):
// one device under `bucket`, colliding against out2[0, outpos).  DIAG:
// *tries_at gets the retry count of the pick.
CRUSH_HD inline bool leaf_firstn(const Map& m, int32_t bucket, uint32_t x,
                                 int32_t r0, int outpos, const int32_t* out2,
                                 int tries, int32_t* leaf
                                 DIAG_ARGS(Tally* t, int* tries_at)) {
    for (int ftotal = 0;;) {
        int32_t item;
        const int st = descend(m, bucket, x, r0 + ftotal, outpos, 0, &item);
        DIAG(if (st == SKIP) t->skip++;)
        if (st == SKIP) return false;
        if (st == FOUND) {
            bool collide = false;
            for (int i = 0; i < outpos; i++)
                if (out2[i] == item) { collide = true; break; }
            if (!collide && !is_out(m, item, x)) {
                *leaf = item;
                DIAG(*tries_at = ftotal;)
                return true;
            }
            DIAG(if (collide) t->coll++; else t->rej++;)
        }
        if (++ftotal >= tries) return false;
    }
}

// crush_choose_firstn from outpos 0 (reference src/crush/mapper.c:460-648;
// no local retries).  Returns the number of items placed in out[]; out2[]
// holds the chooseleaf leaves beside them.  DIAG: lanes are this source's
// tries lanes (numrep, then numrep more for chooseleaf's leaves).
CRUSH_HD inline int choose_firstn(const Map& m, int32_t bucket, uint32_t x,
                                  int numrep, int type, int32_t* out,
                                  int32_t* out2, int count, int tries,
                                  int recurse_tries, bool leafy, int vary_r,
                                  int stable
                                  DIAG_ARGS(Tally* t, int32_t* lanes)) {
    int outpos = 0;
    for (int rep = 0; rep < numrep && count > 0; rep++) {
        for (int ftotal = 0;;) {
            const int32_t r = rep + ftotal;
            int32_t item;
            const int st = descend(m, bucket, x, r, outpos, type, &item);
            DIAG(if (st == SKIP) t->skip++;)
            if (st == SKIP) break;
            bool fail = true;
            int32_t leaf = item;
            if (st == FOUND) {
                bool collide = false;
                for (int i = 0; i < outpos; i++)
                    if (out[i] == item) { collide = true; break; }
                bool reject = false;
                if (!collide && leafy && item < 0) {
                    const int32_t sub_r = vary_r ? (r >> (vary_r - 1)) : 0;
                    DIAG(int leaf_tries = -1;)
                    reject = !leaf_firstn(m, item, x,
                                          (stable ? 0 : outpos) + sub_r,
                                          outpos, out2, recurse_tries, &leaf
                                          DIAG_ARGS(t, &leaf_tries));
                    // a leaf found is a placement: the outer item is a
                    // bucket, so no is_out check follows
                    DIAG(lanes[numrep + rep] = leaf_tries;)
                }
                if (!collide && !reject && type == 0)
                    reject = is_out(m, item, x);
                DIAG(if (collide) t->coll++;
                     else if (reject && type == 0) t->rej++;)
                fail = collide || reject;
            }
            if (!fail) {
                out[outpos] = item;
                out2[outpos] = leaf;
                outpos++;
                count--;
                DIAG(lanes[rep] = ftotal;)
                break;
            }
            if (++ftotal >= tries) break;
        }
    }
    return outpos;
}

// chooseleaf indep's inner pick (reference src/crush/mapper.c:784-798):
// one device under `bucket` for slot `rep`; ITEM_NONE if none.  DIAG:
// *rounds gets the rounds the inner crush_choose_indep call ran.
CRUSH_HD inline int32_t leaf_indep(const Map& m, int32_t bucket, uint32_t x,
                                   int rep, int32_t parent_r, int numrep,
                                   int tries DIAG_ARGS(int* rounds)) {
    DIAG(*rounds = tries;)
    for (int ftotal = 0; ftotal < tries; ftotal++) {
        int32_t item;
        const int st = descend(m, bucket, x, rep + parent_r + numrep * ftotal,
                               rep, 0, &item, numrep,
                               rep + parent_r + (numrep + 1) * ftotal);
        DIAG(if (st == SKIP || (st == FOUND && !is_out(m, item, x)))
                 *rounds = ftotal + 1;)
        if (st == SKIP) return ITEM_NONE;
        if (st == FOUND && !is_out(m, item, x)) return item;
    }
    return ITEM_NONE;
}

// crush_choose_indep from outpos 0 (reference src/crush/mapper.c:655-843):
// breadth-first over `left` positional slots, ITEM_NONE where none.
// DIAG: lanes are this source's tries lanes (the rounds, then the leaf
// calls by rep and round).
CRUSH_HD inline void choose_indep(const Map& m, int32_t bucket, uint32_t x,
                                  int left, int numrep, int type,
                                  int32_t* out, int32_t* out2, int tries,
                                  int recurse_tries, bool leafy
                                  DIAG_ARGS(int32_t* lanes)) {
    const int endpos = left;
    DIAG(lanes[0] = 0;)
    for (int rep = 0; rep < endpos; rep++) out[rep] = out2[rep] = ITEM_UNDEF;
    for (int ftotal = 0; left > 0 && ftotal < tries; ftotal++) {
        DIAG(lanes[0]++;)
        for (int rep = 0; rep < endpos; rep++) {
            if (out[rep] != ITEM_UNDEF) continue;
            int32_t item, r;
            const int st = descend(m, bucket, x, rep + numrep * ftotal, 0,
                                   type, &item, numrep,
                                   rep + (numrep + 1) * ftotal, &r);
            if (st == EMPTY) continue;
            if (st == SKIP) {
                out[rep] = out2[rep] = ITEM_NONE;
                left--;
                continue;
            }
            bool collide = false;
            for (int i = 0; i < endpos; i++)
                if (out[i] == item) { collide = true; break; }
            if (collide) continue;
            if (leafy) {
                // a device is written to out2 before its is_out check
                // (reference src/crush/mapper.c:799-801)
                DIAG(int32_t* at = lanes + 1 + rep * tries + ftotal;)
                out2[rep] = item < 0 ? leaf_indep(m, item, x, rep, r, numrep,
                                                  recurse_tries
                                                  DIAG_ARGS(at))
                                     : item;
                if (out2[rep] == ITEM_NONE) continue;
            }
            if (type == 0 && is_out(m, item, x)) continue;
            out[rep] = item;
            left--;
        }
    }
    for (int rep = 0; rep < endpos; rep++) {
        if (out[rep] == ITEM_UNDEF) out[rep] = ITEM_NONE;
        if (out2[rep] == ITEM_UNDEF) out2[rep] = ITEM_NONE;
    }
}

// crush_do_rule (reference src/crush/mapper.c:900-1105).  Writes up to
// rule.result_max (<= RMAX_CAP) items to result; returns how many.
// DIAG: books into *d.
CRUSH_HD inline int do_rule(const Map& m, const Rule& rule, uint32_t x,
                            int32_t* result DIAG_ARGS(Diag* d)) {
    const int result_max = rule.result_max;
    int32_t buf_a[RMAX_CAP], buf_b[RMAX_CAP], leaves[RMAX_CAP];
    int32_t* w = buf_a;
    int32_t* o = buf_b;
    int wsize = 0, rlen = 0;
    int choose_tries = rule.choose_total_tries + 1;
    int leaf_tries = 0;
    int vary_r = rule.chooseleaf_vary_r;
    int stable = rule.chooseleaf_stable;

    for (int s = 0; s < rule.n_steps; s++) {
        const int op = rule.steps[3 * s];
        const int arg1 = rule.steps[3 * s + 1];
        const int arg2 = rule.steps[3 * s + 2];
        switch (op) {
        case OP_TAKE:
            if ((arg1 >= 0 && arg1 < m.max_devices) ||
                (arg1 < 0 && -1 - arg1 < m.n_buckets)) {
                w[0] = arg1;
                wsize = 1;
            }
            break;
        case OP_SET_CHOOSE_TRIES:
            if (arg1 > 0) choose_tries = arg1;
            break;
        case OP_SET_CHOOSELEAF_TRIES:
            if (arg1 > 0) leaf_tries = arg1;
            break;
        case OP_SET_CHOOSELEAF_VARY_R:
            if (arg1 >= 0) vary_r = arg1;
            break;
        case OP_SET_CHOOSELEAF_STABLE:
            if (arg1 >= 0) stable = arg1;
            break;
        case OP_CHOOSE_FIRSTN:
        case OP_CHOOSELEAF_FIRSTN:
        case OP_CHOOSE_INDEP:
        case OP_CHOOSELEAF_INDEP: {
            if (wsize == 0) break;
            const bool firstn =
                op == OP_CHOOSE_FIRSTN || op == OP_CHOOSELEAF_FIRSTN;
            const bool leafy =
                op == OP_CHOOSELEAF_FIRSTN || op == OP_CHOOSELEAF_INDEP;
            int osize = 0;
            for (int i = 0; i < wsize; i++) {
                int numrep = arg1;
                if (numrep <= 0) {
                    numrep += result_max;
                    if (numrep <= 0) continue;
                }
                const int32_t src = w[i];
                if (src >= 0 || -1 - src >= m.n_buckets) continue;
                DIAG(int32_t* lanes =
                         d->tries + d->plan[3 * s] + i * d->plan[3 * s + 1];)
                if (firstn) {
                    const int recurse_tries =
                        leaf_tries ? leaf_tries
                                   : (rule.chooseleaf_descend_once
                                          ? 1 : choose_tries);
                    osize += choose_firstn(
                        m, src, x, numrep, arg2, o + osize, leaves + osize,
                        result_max - osize, choose_tries, recurse_tries,
                        leafy, vary_r, stable DIAG_ARGS(&d->tally, lanes));
                } else {
                    const int out_size = numrep < result_max - osize
                                             ? numrep : result_max - osize;
                    choose_indep(m, src, x, out_size, numrep, arg2,
                                 o + osize, leaves + osize, choose_tries,
                                 leaf_tries ? leaf_tries : 1, leafy
                                 DIAG_ARGS(lanes));
                    osize += out_size;
                }
            }
            if (leafy)
                for (int i = 0; i < osize; i++) o[i] = leaves[i];
            int32_t* t = w;
            w = o;
            o = t;
            wsize = osize;
            DIAG(for (int j = 0; j < wsize; j++)
                     d->steps[d->plan[3 * s + 2] * result_max + j] = w[j];)
            break;
        }
        case OP_EMIT:
            for (int i = 0; i < wsize && rlen < result_max; i++)
                result[rlen++] = w[i];
            wsize = 0;
            break;
        default:
            break;
        }
    }
    return rlen;
}

#ifndef CRUSH_RULE_DIAG
// One seed's row: row[0, result_max), padded with ITEM_NONE.
CRUSH_HD inline void map_seed(const Map& m, const Rule& rule, uint32_t x,
                              int32_t* row) {
    int32_t res[RMAX_CAP];
    const int got = do_rule(m, rule, x, res);
    for (int j = 0; j < rule.result_max; j++)
        row[j] = j < got ? res[j] : ITEM_NONE;
}
#else
// map_seed with the diagnostics: d's tries lanes (n_lanes) and steps rows
// (n_steps_rows) are filled here first; tally gets coll, rej, skip and
// bad (1 when the row holds fewer than result_max items).
CRUSH_HD inline void map_seed_diag(const Map& m, const Rule& rule,
                                   uint32_t x, int32_t* row, Diag& d,
                                   int n_lanes, int n_steps_rows,
                                   int32_t* tally) {
    for (int j = 0; j < n_lanes; j++) d.tries[j] = -1;
    for (int j = 0; j < n_steps_rows * rule.result_max; j++)
        d.steps[j] = ITEM_NONE;
    d.tally = {0, 0, 0};
    int32_t res[RMAX_CAP];
    const int got = do_rule(m, rule, x, res, &d);
    int placed = 0;
    for (int j = 0; j < rule.result_max; j++) {
        row[j] = j < got ? res[j] : ITEM_NONE;
        placed += row[j] != ITEM_NONE;
    }
    tally[0] = d.tally.coll;
    tally[1] = d.tally.rej;
    tally[2] = d.tally.skip;
    tally[3] = placed < rule.result_max;
}
#endif

}  // namespace crush_rule
