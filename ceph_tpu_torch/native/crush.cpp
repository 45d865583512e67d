// Native batched CRUSH mapper — the C++ host runtime for the placement
// pipeline.
//
// This is a port of the reference semantics, written against this
// framework's Python semantic oracle (ceph_tpu_torch/crush/mapper_ref.py); it is the
// native-code analogue of the reference's ParallelPGMapper (reference
// src/osd/OSDMapMapping.h:18-140): a thread pool shards the x (PG) axis and
// each worker runs the full rule interpreter per input.  Used by the CLIs
// as the fast host backend and by benchmarks as the multicore CPU baseline.
//
// ctypes ABI (flat arrays only): cm_create / cm_add_bucket / cm_add_rule /
// cm_set_choose_args / cm_finalize / cm_map_batch / cm_destroy, plus
// cm_set_ln_tables to inject the fixed-point log tables (built in Python,
// ceph_tpu_torch/core/lntable.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <map>
#include <thread>
#include <vector>

namespace {

constexpr int ITEM_NONE = 0x7FFFFFFF;
constexpr int ITEM_UNDEF = 0x7FFFFFFE;
constexpr int64_t S64_MIN_V = INT64_MIN;

// ---- rjenkins 32-bit mix (public-domain Jenkins hash) ---------------------
inline void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
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
constexpr uint32_t SEED = 1315423911u;

inline uint32_t h2(uint32_t a, uint32_t b) {
    uint32_t hash = SEED ^ a ^ b, x = 231232, y = 1232;
    mix(a, b, hash);
    mix(x, a, hash);
    mix(b, y, hash);
    return hash;
}
inline uint32_t h3(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t hash = SEED ^ a ^ b ^ c, x = 231232, y = 1232;
    mix(a, b, hash);
    mix(c, x, hash);
    mix(y, a, hash);
    mix(b, x, hash);
    mix(y, c, hash);
    return hash;
}
inline uint32_t h4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
    uint32_t hash = SEED ^ a ^ b ^ c ^ d, x = 231232, y = 1232;
    mix(a, b, hash);
    mix(c, d, hash);
    mix(a, x, hash);
    mix(y, b, hash);
    mix(c, x, hash);
    mix(y, d, hash);
    return hash;
}

// ---- fixed-point log tables (injected from Python) ------------------------
int64_t RH_LH[258];
int64_t LL[256];

inline uint64_t crush_ln(uint32_t xin) {
    uint64_t x = (uint64_t)xin + 1;
    uint64_t iexpon = 15;
    if ((x & 0x18000) == 0) {
        uint32_t masked = (uint32_t)(x & 0x1FFFF);
        int fl = 0;
        uint32_t m = masked;
        for (int s : {16, 8, 4, 2, 1})
            if (m >= (1u << s)) { fl += s; m >>= s; }
        uint64_t bits = 15 - (uint64_t)fl;
        x <<= bits;
        iexpon = 15 - bits;
    }
    int64_t idx1 = (int64_t)((x >> 8) << 1);
    uint64_t RH = (uint64_t)RH_LH[idx1 - 256];
    uint64_t LH = (uint64_t)RH_LH[idx1 + 1 - 256];
    uint64_t xl64 = (x * RH) >> 48;
    uint64_t ll = (uint64_t)LL[xl64 & 0xFF];
    return (iexpon << 44) + ((LH + ll) >> (48 - 12 - 32));
}

// ---- map model ------------------------------------------------------------
struct Bucket {
    int id = 0, alg = 5, type = 0;
    std::vector<int> items, weights;
    std::vector<int> sum_weights;   // LIST
    std::vector<int> node_weights;  // TREE
    std::vector<int> straws;        // STRAW
    int size() const { return (int)items.size(); }
};

struct Rule {
    int ruleset, type, min_size, max_size;
    std::vector<int> ops, a1, a2;
};

struct ChooseArgsEntry {
    std::vector<std::vector<unsigned>> weight_sets;
    std::vector<int> ids;  // empty = use bucket items
};

struct Tunables {
    int choose_local_tries = 0;
    int choose_local_fallback_tries = 0;
    int choose_total_tries = 50;
    int chooseleaf_descend_once = 1;
    int chooseleaf_vary_r = 1;
    int chooseleaf_stable = 1;
};

struct Map {
    Tunables t;
    std::vector<Bucket> buckets;  // index = -1-id; may contain holes
    std::vector<char> present;
    std::vector<Rule> rules;
    std::map<int, ChooseArgsEntry> choose_args;
    int max_devices = 0;

    const Bucket* get(int id) const {
        int idx = -1 - id;
        if (idx < 0 || idx >= (int)buckets.size() || !present[idx])
            return nullptr;
        return &buckets[idx];
    }
};

// per-thread scratch: uniform-bucket permutation memo
struct PermState {
    uint32_t perm_x = 0;
    unsigned perm_n = 0;
    std::vector<int> perm;
};
using Work = std::map<int, PermState>;

// ---- bucket choose functions ---------------------------------------------
int perm_choose(const Bucket& b, PermState& w, uint32_t x, int r) {
    unsigned pr = (unsigned)r % b.size();
    if (w.perm_x != x || w.perm_n == 0) {
        w.perm_x = x;
        if (pr == 0) {
            unsigned s = h3(x, (uint32_t)b.id, 0) % b.size();
            w.perm.assign(b.size(), 0);
            w.perm[0] = (int)s;
            w.perm_n = 0xFFFF;
            return b.items[s];
        }
        w.perm.resize(b.size());
        for (int i = 0; i < b.size(); i++) w.perm[i] = i;
        w.perm_n = 0;
    } else if (w.perm_n == 0xFFFF) {
        int s = w.perm[0];
        for (int i = 0; i < b.size(); i++) w.perm[i] = i;
        w.perm[0] = s;
        w.perm[s] = 0;
        w.perm_n = 1;
    }
    while (w.perm_n <= pr) {
        unsigned p = w.perm_n;
        if ((int)p < b.size() - 1) {
            unsigned i = h3(x, (uint32_t)b.id, p) % (b.size() - p);
            if (i) std::swap(w.perm[p], w.perm[p + i]);
        }
        w.perm_n++;
    }
    return b.items[w.perm[pr]];
}

int list_choose(const Bucket& b, uint32_t x, int r) {
    for (int i = b.size() - 1; i >= 0; i--) {
        uint64_t w = h4(x, (uint32_t)b.items[i], (uint32_t)r,
                        (uint32_t)b.id) & 0xFFFF;
        w = (w * (uint64_t)(uint32_t)b.sum_weights[i]) >> 16;
        if (w < (uint64_t)(uint32_t)b.weights[i]) return b.items[i];
    }
    return b.items[0];
}

int tree_choose(const Bucket& b, uint32_t x, int r) {
    const auto& nw = b.node_weights;
    int n = (int)nw.size() >> 1;
    while (!(n & 1)) {
        uint64_t w = (uint32_t)nw[n];
        uint64_t t =
            ((uint64_t)h4(x, (uint32_t)n, (uint32_t)r, (uint32_t)b.id) * w) >>
            32;
        int h = 0, m = n;
        while ((m & 1) == 0) { h++; m >>= 1; }
        int left = n - (1 << (h - 1));
        n = (t < (uint64_t)(uint32_t)nw[left]) ? left : n + (1 << (h - 1));
    }
    return b.items[n >> 1];
}

int straw_choose(const Bucket& b, uint32_t x, int r) {
    int high = 0;
    uint64_t high_draw = 0;
    for (int i = 0; i < b.size(); i++) {
        uint64_t draw = (uint64_t)(h3(x, (uint32_t)b.items[i], (uint32_t)r) &
                                   0xFFFF) *
                        (uint64_t)(uint32_t)b.straws[i];
        if (i == 0 || draw > high_draw) { high = i; high_draw = draw; }
    }
    return b.items[high];
}

inline int64_t div_trunc(int64_t a, int64_t bdiv) { return a / bdiv; }

int straw2_choose(const Map& m, const Bucket& b, uint32_t x, int r,
                  const std::map<int, ChooseArgsEntry>* camap,
                  int position) {
    const std::vector<unsigned>* aw = nullptr;
    const std::vector<int>* ids = nullptr;
    if (camap) {
        auto it = camap->find(b.id);
        if (it != camap->end()) {
            const ChooseArgsEntry& ca = it->second;
            if (!ca.weight_sets.empty()) {
                size_t pos =
                    std::min((size_t)position, ca.weight_sets.size() - 1);
                aw = &ca.weight_sets[pos];
            }
            if (!ca.ids.empty()) ids = &ca.ids;
        }
    }
    int high = 0;
    int64_t high_draw = 0;
    for (int i = 0; i < b.size(); i++) {
        unsigned wgt = aw ? (*aw)[i] : (unsigned)b.weights[i];
        int64_t draw;
        if (wgt) {
            int id = ids ? (*ids)[i] : b.items[i];
            uint32_t u = h3(x, (uint32_t)id, (uint32_t)r) & 0xFFFF;
            int64_t ln = (int64_t)crush_ln(u) - 0x1000000000000LL;
            draw = div_trunc(ln, (int64_t)wgt);
        } else {
            draw = S64_MIN_V;
        }
        if (i == 0 || draw > high_draw) { high = i; high_draw = draw; }
    }
    return b.items[high];
}

int bucket_choose(const Map& m, Work& work, const Bucket& b, uint32_t x,
                  int r, const std::map<int, ChooseArgsEntry>* ca,
                  int position) {
    switch (b.alg) {
        case 1: return perm_choose(b, work[b.id], x, r);
        case 2: return list_choose(b, x, r);
        case 3: return tree_choose(b, x, r);
        case 4: return straw_choose(b, x, r);
        case 5: return straw2_choose(m, b, x, r, ca, position);
        default: return b.items[0];
    }
}

bool is_out(const Map& m, const unsigned* weight, int wlen, int item,
            uint32_t x) {
    if (item >= wlen) return true;
    unsigned w = weight[item];
    if (w >= 0x10000) return false;
    if (w == 0) return true;
    return (h2(x, (uint32_t)item) & 0xFFFF) >= w;
}

// ---- firstn / indep -------------------------------------------------------
struct Ctx {
    const Map& m;
    Work& work;
    const unsigned* weight;
    int wlen;
    const std::map<int, ChooseArgsEntry>* ca;  // per-bucket lookup
};

int choose_firstn(Ctx& cx, const Bucket& bucket, uint32_t x, int numrep,
                  int type, std::vector<int>& out, int outpos, int out_size,
                  int tries, int recurse_tries, int local_retries,
                  int local_fallback_retries, bool recurse_to_leaf,
                  int vary_r, int stable, std::vector<int>* out2,
                  int parent_r) {
    int count = out_size;
    int rep = stable ? 0 : outpos;
    for (; rep < numrep && count > 0; rep++) {
        int ftotal = 0;
        bool skip_rep = false;
        int item = 0;
        bool retry_descent = true;
        while (retry_descent) {
            retry_descent = false;
            const Bucket* in = &bucket;
            int flocal = 0;
            bool retry_bucket = true;
            while (retry_bucket) {
                retry_bucket = false;
                bool collide = false, reject = false;
                int r = rep + parent_r + ftotal;

                if (in->size() == 0) {
                    reject = true;
                } else {
                    if (local_fallback_retries > 0 &&
                        flocal >= (in->size() >> 1) &&
                        flocal > local_fallback_retries)
                        item = perm_choose(*in, cx.work[in->id], x, r);
                    else
                        item = bucket_choose(cx.m, cx.work, *in, x, r, cx.ca,
                                             outpos);
                    if (item >= cx.m.max_devices) { skip_rep = true; break; }

                    const Bucket* child =
                        item < 0 ? cx.m.get(item) : nullptr;
                    if (item < 0 && !child) { skip_rep = true; break; }
                    int itemtype = item < 0 ? child->type : 0;

                    if (itemtype != type) {
                        if (item >= 0) { skip_rep = true; break; }
                        in = child;
                        retry_bucket = true;
                        continue;
                    }

                    for (int i = 0; i < outpos; i++)
                        if (out[i] == item) { collide = true; break; }

                    if (!collide && recurse_to_leaf) {
                        if (item < 0) {
                            int sub_r = vary_r ? (r >> (vary_r - 1)) : 0;
                            if (choose_firstn(
                                    cx, *cx.m.get(item), x,
                                    stable ? 1 : outpos + 1, 0, *out2,
                                    outpos, count, recurse_tries, 0,
                                    local_retries, local_fallback_retries,
                                    false, vary_r, stable, nullptr,
                                    sub_r) <= outpos)
                                reject = true;
                        } else {
                            if ((int)out2->size() <= outpos)
                                out2->resize(outpos + 1, ITEM_NONE);
                            (*out2)[outpos] = item;
                        }
                    }

                    if (!reject && !collide && itemtype == 0)
                        reject = is_out(cx.m, cx.weight, cx.wlen, item, x);
                }

                if (reject || collide) {
                    ftotal++;
                    flocal++;
                    if (collide && flocal <= local_retries)
                        retry_bucket = true;
                    else if (local_fallback_retries > 0 &&
                             flocal <= in->size() + local_fallback_retries)
                        retry_bucket = true;
                    else if (ftotal < tries)
                        retry_descent = true;
                    else
                        skip_rep = true;
                    if (!retry_bucket) break;
                }
            }
            if (skip_rep) break;
            if (retry_descent) continue;
            break;
        }
        if (skip_rep) continue;
        if ((int)out.size() <= outpos) out.resize(outpos + 1, ITEM_NONE);
        out[outpos] = item;
        outpos++;
        count--;
    }
    return outpos;
}

void choose_indep(Ctx& cx, const Bucket& bucket, uint32_t x, int left,
                  int numrep, int type, std::vector<int>& out, int outpos,
                  int tries, int recurse_tries, bool recurse_to_leaf,
                  std::vector<int>* out2, int parent_r) {
    int endpos = outpos + left;
    if ((int)out.size() < endpos) out.resize(endpos, ITEM_NONE);
    if (out2 && (int)out2->size() < endpos) out2->resize(endpos, ITEM_NONE);
    for (int rep = outpos; rep < endpos; rep++) {
        out[rep] = ITEM_UNDEF;
        if (out2) (*out2)[rep] = ITEM_UNDEF;
    }
    int ftotal = 0;
    while (left > 0 && ftotal < tries) {
        for (int rep = outpos; rep < endpos; rep++) {
            if (out[rep] != ITEM_UNDEF) continue;
            const Bucket* in = &bucket;
            for (;;) {
                int r = rep + parent_r;
                if (in->alg == 1 && in->size() % numrep == 0)
                    r += (numrep + 1) * ftotal;
                else
                    r += numrep * ftotal;

                if (in->size() == 0) break;

                int item =
                    bucket_choose(cx.m, cx.work, *in, x, r, cx.ca, outpos);
                if (item >= cx.m.max_devices) {
                    out[rep] = ITEM_NONE;
                    if (out2) (*out2)[rep] = ITEM_NONE;
                    left--;
                    break;
                }
                const Bucket* child = item < 0 ? cx.m.get(item) : nullptr;
                if (item < 0 && !child) {
                    out[rep] = ITEM_NONE;
                    if (out2) (*out2)[rep] = ITEM_NONE;
                    left--;
                    break;
                }
                int itemtype = item < 0 ? child->type : 0;
                if (itemtype != type) {
                    if (item >= 0) {
                        out[rep] = ITEM_NONE;
                        if (out2) (*out2)[rep] = ITEM_NONE;
                        left--;
                        break;
                    }
                    in = child;
                    continue;
                }
                bool collide = false;
                for (int i = outpos; i < endpos; i++)
                    if (out[i] == item) { collide = true; break; }
                if (collide) break;

                if (recurse_to_leaf) {
                    if (item < 0) {
                        choose_indep(cx, *cx.m.get(item), x, 1, numrep, 0,
                                     *out2, rep, recurse_tries, 0, false,
                                     nullptr, r);
                        if ((*out2)[rep] == ITEM_NONE) break;
                    } else {
                        (*out2)[rep] = item;
                    }
                }

                if (itemtype == 0 &&
                    is_out(cx.m, cx.weight, cx.wlen, item, x))
                    break;

                out[rep] = item;
                left--;
                break;
            }
        }
        ftotal++;
        if (left <= 0) break;
    }
    for (int rep = outpos; rep < endpos; rep++) {
        if (out[rep] == ITEM_UNDEF) out[rep] = ITEM_NONE;
        if (out2 && (*out2)[rep] == ITEM_UNDEF) (*out2)[rep] = ITEM_NONE;
    }
}

// ---- rule interpreter -----------------------------------------------------
enum {
    OP_NOOP = 0, OP_TAKE = 1, OP_CHOOSE_FIRSTN = 2, OP_CHOOSE_INDEP = 3,
    OP_EMIT = 4, OP_CHOOSELEAF_FIRSTN = 6, OP_CHOOSELEAF_INDEP = 7,
    OP_SET_CHOOSE_TRIES = 8, OP_SET_CHOOSELEAF_TRIES = 9,
    OP_SET_CHOOSE_LOCAL_TRIES = 10, OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11,
    OP_SET_CHOOSELEAF_VARY_R = 12, OP_SET_CHOOSELEAF_STABLE = 13,
};

int do_rule(const Map& m, int ruleno, uint32_t x, int result_max,
            const unsigned* weight, int wlen,
            const std::map<int, ChooseArgsEntry>* ca, int* result) {
    if (ruleno < 0 || ruleno >= (int)m.rules.size()) return 0;
    const Rule& rule = m.rules[ruleno];
    Work work;
    Ctx cx{m, work, weight, wlen, ca};
    const Tunables& t = m.t;

    int choose_tries = t.choose_total_tries + 1;
    int choose_leaf_tries = 0;
    int choose_local_retries = t.choose_local_tries;
    int choose_local_fallback_retries = t.choose_local_fallback_tries;
    int vary_r = t.chooseleaf_vary_r;
    int stable = t.chooseleaf_stable;

    std::vector<int> res, w, o, c;
    int wsize = 0;

    for (size_t s = 0; s < rule.ops.size(); s++) {
        int op = rule.ops[s], arg1 = rule.a1[s], arg2 = rule.a2[s];
        bool firstn = false;
        switch (op) {
            case OP_TAKE:
                if ((arg1 >= 0 && arg1 < m.max_devices) ||
                    (arg1 < 0 && m.get(arg1))) {
                    w.assign(1, arg1);
                    wsize = 1;
                }
                break;
            case OP_SET_CHOOSE_TRIES:
                if (arg1 > 0) choose_tries = arg1;
                break;
            case OP_SET_CHOOSELEAF_TRIES:
                if (arg1 > 0) choose_leaf_tries = arg1;
                break;
            case OP_SET_CHOOSE_LOCAL_TRIES:
                if (arg1 >= 0) choose_local_retries = arg1;
                break;
            case OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
                if (arg1 >= 0) choose_local_fallback_retries = arg1;
                break;
            case OP_SET_CHOOSELEAF_VARY_R:
                if (arg1 >= 0) vary_r = arg1;
                break;
            case OP_SET_CHOOSELEAF_STABLE:
                if (arg1 >= 0) stable = arg1;
                break;
            case OP_CHOOSELEAF_FIRSTN:
            case OP_CHOOSE_FIRSTN:
            case OP_CHOOSELEAF_INDEP:
            case OP_CHOOSE_INDEP: {
                firstn =
                    (op == OP_CHOOSELEAF_FIRSTN || op == OP_CHOOSE_FIRSTN);
                if (wsize == 0) break;
                bool recurse_to_leaf = (op == OP_CHOOSELEAF_FIRSTN ||
                                        op == OP_CHOOSELEAF_INDEP);
                int osize = 0;
                o.clear();
                c.clear();
                for (int i = 0; i < wsize; i++) {
                    int numrep = arg1;
                    if (numrep <= 0) {
                        numrep += result_max;
                        if (numrep <= 0) continue;
                    }
                    if (w[i] >= 0 || !m.get(w[i])) continue;
                    const Bucket& bucket = *m.get(w[i]);
                    if (firstn) {
                        int recurse_tries =
                            choose_leaf_tries
                                ? choose_leaf_tries
                                : (t.chooseleaf_descend_once ? 1
                                                             : choose_tries);
                        if ((int)o.size() < osize) o.resize(osize, ITEM_NONE);
                        if ((int)c.size() < osize) c.resize(osize, ITEM_NONE);
                        std::vector<int> sub_o(o.begin() + osize, o.end());
                        std::vector<int> sub_c(c.begin() + osize, c.end());
                        int n = choose_firstn(
                            cx, bucket, x, numrep, arg2, sub_o, 0,
                            result_max - osize, choose_tries, recurse_tries,
                            choose_local_retries,
                            choose_local_fallback_retries, recurse_to_leaf,
                            vary_r, stable,
                            &sub_c, 0);
                        o.resize(osize);
                        o.insert(o.end(), sub_o.begin(), sub_o.end());
                        c.resize(osize);
                        c.insert(c.end(), sub_c.begin(), sub_c.end());
                        osize += n;
                    } else {
                        int out_size = std::min(numrep, result_max - osize);
                        std::vector<int> sub_o, sub_c;
                        choose_indep(cx, bucket, x, out_size, numrep, arg2,
                                     sub_o, 0, choose_tries,
                                     choose_leaf_tries ? choose_leaf_tries
                                                       : 1,
                                     recurse_to_leaf, &sub_c, 0);
                        o.resize(osize);
                        o.insert(o.end(), sub_o.begin(), sub_o.end());
                        c.resize(osize);
                        c.insert(c.end(), sub_c.begin(), sub_c.end());
                        osize += out_size;
                    }
                }
                if (recurse_to_leaf) {
                    if ((int)c.size() < osize) c.resize(osize, ITEM_NONE);
                    for (int i = 0; i < osize && i < (int)o.size(); i++)
                        o[i] = c[i];
                    if ((int)o.size() < osize) {
                        size_t old = o.size();
                        o.resize(osize);
                        for (size_t i = old; i < (size_t)osize; i++)
                            o[i] = c[i];
                    }
                }
                w = o;
                wsize = osize;
                break;
            }
            case OP_EMIT:
                for (int i = 0; i < wsize && (int)res.size() < result_max;
                     i++)
                    res.push_back(w[i]);
                wsize = 0;
                break;
            default:
                break;
        }
    }
    int n = (int)res.size();
    for (int i = 0; i < n; i++) result[i] = res[i];
    return n;
}

}  // namespace

extern "C" {

void cm_set_ln_tables(const long long* rh_lh, const long long* ll) {
    std::memcpy(RH_LH, rh_lh, sizeof(RH_LH));
    std::memcpy(LL, ll, sizeof(LL));
}

void* cm_create(int clt, int clft, int ctt, int cdo, int cvr, int cs) {
    Map* m = new Map();
    m->t.choose_local_tries = clt;
    m->t.choose_local_fallback_tries = clft;
    m->t.choose_total_tries = ctt;
    m->t.chooseleaf_descend_once = cdo;
    m->t.chooseleaf_vary_r = cvr;
    m->t.chooseleaf_stable = cs;
    return m;
}

// derived arrays may be NULL when unused by the alg
int cm_add_bucket(void* h, int id, int alg, int type, int size,
                  const int* items, const int* weights,
                  const int* sum_weights, const int* node_weights,
                  int n_nodes, const int* straws) {
    Map* m = (Map*)h;
    int idx = -1 - id;
    if (idx < 0) return -1;
    if ((int)m->buckets.size() <= idx) {
        m->buckets.resize(idx + 1);
        m->present.resize(idx + 1, 0);
    }
    Bucket& b = m->buckets[idx];
    b.id = id;
    b.alg = alg;
    b.type = type;
    b.items.assign(items, items + size);
    b.weights.assign(weights, weights + size);
    if (sum_weights) b.sum_weights.assign(sum_weights, sum_weights + size);
    if (node_weights)
        b.node_weights.assign(node_weights, node_weights + n_nodes);
    if (straws) b.straws.assign(straws, straws + size);
    m->present[idx] = 1;
    for (int i = 0; i < size; i++)
        if (items[i] >= 0 && items[i] + 1 > m->max_devices)
            m->max_devices = items[i] + 1;
    return id;
}

int cm_add_rule(void* h, int ruleno, int ruleset, int type, int min_size,
                int max_size, int nsteps, const int* ops, const int* a1,
                const int* a2) {
    Map* m = (Map*)h;
    if (ruleno < 0) ruleno = (int)m->rules.size();
    if ((int)m->rules.size() <= ruleno) m->rules.resize(ruleno + 1);
    Rule& r = m->rules[ruleno];
    r.ruleset = ruleset;
    r.type = type;
    r.min_size = min_size;
    r.max_size = max_size;
    r.ops.assign(ops, ops + nsteps);
    r.a1.assign(a1, a1 + nsteps);
    r.a2.assign(a2, a2 + nsteps);
    return ruleno;
}

// weight_sets: positions x size flattened; ids NULL = bucket items
int cm_set_choose_args(void* h, int bucket_id, int positions,
                       const unsigned* weight_sets, const int* ids,
                       int size) {
    Map* m = (Map*)h;
    ChooseArgsEntry& e = m->choose_args[bucket_id];
    e.weight_sets.clear();
    for (int p = 0; p < positions; p++)
        e.weight_sets.emplace_back(weight_sets + (size_t)p * size,
                                   weight_sets + (size_t)(p + 1) * size);
    if (ids) e.ids.assign(ids, ids + size);
    return 0;
}

void cm_set_max_devices(void* h, int n) {
    Map* m = (Map*)h;
    if (n > m->max_devices) m->max_devices = n;
}

// out: n * result_max ints, ITEM_NONE-padded; returns mappings done
long long cm_map_batch(void* h, int ruleno, const unsigned* xs, long long n,
                       int result_max, const unsigned* weight, int wlen,
                       int* out, int n_threads, int use_choose_args) {
    Map* m = (Map*)h;
    if (n_threads <= 0)
        n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;

    const std::map<int, ChooseArgsEntry>* ca =
        (use_choose_args && !m->choose_args.empty()) ? &m->choose_args
                                                     : nullptr;
    std::atomic<long long> next(0);
    auto worker = [&]() {
        std::vector<int> res(result_max);
        constexpr long long CHUNK = 1024;
        for (;;) {
            long long start = next.fetch_add(CHUNK);
            if (start >= n) break;
            long long end = std::min(n, start + CHUNK);
            for (long long i = start; i < end; i++) {
                int* row = out + (size_t)i * result_max;
                for (int j = 0; j < result_max; j++) row[j] = ITEM_NONE;
                int got = do_rule(*m, ruleno, xs[i], result_max, weight,
                                  wlen, ca, res.data());
                for (int j = 0; j < got && j < result_max; j++)
                    row[j] = res[j];
            }
        }
    };
    std::vector<std::thread> threads;
    for (int i = 1; i < n_threads; i++) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();
    return n;
}

void cm_destroy(void* h) { delete (Map*)h; }

}  // extern "C"
