// The placement seed of a PG (reference src/osd/osd_types.cc:1798-1814):
// ceph_stable_mod of ps by pgp_num, then the pool's hash (hash32_2 with the
// pool id) or, without hashpspool, the plain sum.  Shared by the pipeline
// kernel (pipeline.cuh) and the diagnostics variant of the rule kernel
// (crush/csrc/crush_rule_diag.cu), which compute it in the PG's lane.
// Include crush_rule.cuh first.

#pragma once

#include <stdint.h>

namespace placement {

CRUSH_HD inline uint32_t placement_seed(uint32_t ps, uint32_t pgp_num,
                                        uint32_t pgp_mask, bool hashpspool,
                                        uint32_t pool_id) {
    const uint32_t lo = ps & pgp_mask;
    const uint32_t ps2 = lo < pgp_num ? lo : ps & (pgp_mask >> 1);
    return hashpspool ? crush_rule::hash2(ps2, pool_id) : ps2 + pool_id;
}

}  // namespace placement
