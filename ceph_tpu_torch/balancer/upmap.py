"""Upmap balancer: calc_pg_upmaps, with the cluster mapped on the card.

The port of `ceph_tpu/balancer/upmap.py`, the reference's greedy optimizer
(`OSDMap::calc_pg_upmaps`, reference src/osd/OSDMap.cc:4634-5208, with
`try_pg_upmap` :4590 and `CrushWrapper::try_remap_rule` /
`_choose_type_stack` at reference src/crush/CrushWrapper.cc:4061/3845).

A host-side greedy loop drops or adds `pg_upmap_items` pairs one small
change at a time, and accepts only changes that lower the PG-count
deviation stddev.  The O(PGs) part, mapping every PG of every pool to
build the membership state, runs through `PoolMapper` (the pipeline
kernel, one call per pool); the rest is O(changes) bookkeeping.

Backends (`backend=`): "sets" (dict-of-sets, the reference's form),
"device" (membership rows on the device, O(OSDs) on the host) and
"device_loop" (the whole multi-round plan on the device: one launch of
the plan kernel, csrc/upmap_loop.cu, and one read back on a card; its
plain version, torch ops with one small read a round, on the CPU).
`candidate_batch > 0` scores a batch of prospective changes per step.
Each makes exactly the decisions the JAX package's backend of the same
name makes (tests/test_torch_balancer.py).  It books the JAX package's
`balancer` perf group and spans (`balancer.round`,
`balancer.score_candidates`, `balancer.device_loop`,
`balancer.build_state`, the `balancer.stddev` counter track);
`COUNTERS` reads the group's counts.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ceph_tpu_torch import build, obs
from ceph_tpu_torch.balancer.crush_analysis import (
    get_parent_of_type,
    get_rule_weight_osd_map,
    parent_of_type_map,
    subtree_items,
)
from ceph_tpu_torch.crush import mapper_ref
from ceph_tpu_torch.crush.types import ITEM_NONE, RuleOp
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.utils.perf_counters import counters_attr
from ceph_tpu_torch.osd.types import PgId


# -- try_remap_rule ---------------------------------------------------------

def _choose_type_stack(
    m,
    stack: list[tuple[int, int]],
    overfull: set[int],
    underfull: list[int],
    more_underfull: list[int],
    orig: list[int],
    ipos: list[int],
    used: set[int],
    w: list[int],
    root_bucket: int,
    ruleno: int,
) -> list[int]:
    """reference CrushWrapper.cc:3845-4058; ipos is the shared orig cursor
    (a 1-list so the caller sees advancement).  get_parent_of_type and
    subtree_contains are answered from one walk of the tree per type or
    subtree (parent_of_type_map, subtree_items): called per item, they
    walk it again each time, O(OSDs x tree) a call at 10k OSDs."""
    crush = m.crush
    parents: dict[int, dict[int, int]] = {}
    subtrees: dict[int, set[int]] = {}

    def parent_of(item: int, type_: int) -> int:
        if ruleno < 0:
            return get_parent_of_type(crush, item, type_, ruleno)
        pm = parents.get(type_)
        if pm is None:
            pm = parents[type_] = parent_of_type_map(crush, type_, ruleno)
        return pm.get(item, 0)

    def contains(root: int, item: int) -> bool:
        sub = subtrees.get(root)
        if sub is None:
            sub = subtrees[root] = subtree_items(crush, root)
        return item in sub

    cumulative_fanout = [0] * len(stack)
    f = 1
    for j in range(len(stack) - 1, -1, -1):
        cumulative_fanout[j] = f
        f *= stack[j][1]

    # per-level buckets that contain >=1 underfull device
    underfull_buckets: list[set[int]] = [set() for _ in range(len(stack) - 1)]
    for osd in underfull:
        item = osd
        for j in range(len(stack) - 2, -1, -1):
            type_ = stack[j][0]
            item = parent_of(item, type_)
            if not contains(root_bucket, item):
                continue
            underfull_buckets[j].add(item)

    for j in range(len(stack)):
        type_, fanout = stack[j]
        cum_fanout = cumulative_fanout[j]
        o: list[int] = []
        tmpi = ipos[0]
        if ipos[0] >= len(orig):
            break
        for from_ in w:
            leaves: list[set[int]] = [set() for _ in range(fanout)]
            for pos in range(fanout):
                if type_ > 0:
                    if tmpi >= len(orig):
                        # reference "end of orig, break 1"
                        # (CrushWrapper.cc:3906): a degraded mapping is
                        # shorter than the rule's fanout product
                        break
                    item = parent_of(orig[tmpi], type_)
                    o.append(item)
                    n = cum_fanout
                    while n > 0 and tmpi < len(orig):
                        leaves[pos].add(orig[tmpi])
                        tmpi += 1
                        n -= 1
                else:
                    replaced = False
                    if orig[ipos[0]] in overfull:
                        for cand_list in (underfull, more_underfull):
                            for item in cand_list:
                                if item in used:
                                    continue
                                if not contains(from_, item):
                                    continue
                                if item in orig:
                                    continue
                                o.append(item)
                                used.add(item)
                                replaced = True
                                ipos[0] += 1
                                break
                            if replaced:
                                break
                    if not replaced:
                        o.append(orig[ipos[0]])
                        ipos[0] += 1
                    if ipos[0] >= len(orig):
                        break
            if j + 1 < len(stack):
                # swap buckets with overfull leaves but no underfull
                # candidates for peers that do have some
                for pos in range(fanout):
                    if pos >= len(o):
                        break
                    if o[pos] in underfull_buckets[j]:
                        continue
                    if not any(osd in overfull for osd in leaves[pos]):
                        continue
                    for alt in sorted(underfull_buckets[j]):
                        if alt in o:
                            continue
                        if j == 0 or parent_of(
                            o[pos], stack[j - 1][0]
                        ) == parent_of(alt, stack[j - 1][0]):
                            o[pos] = alt
                            break
            if ipos[0] >= len(orig):
                break
        w = o
    return w


def try_remap_rule(
    m: OSDMap,
    ruleno: int,
    maxout: int,
    overfull: set[int],
    underfull: list[int],
    more_underfull: list[int],
    orig: list[int],
) -> list[int] | None:
    """reference CrushWrapper.cc:4061-4156."""
    crush = m.crush
    rule = crush.rules[ruleno]
    w: list[int] = []
    out: list[int] = []
    ipos = [0]
    used: set[int] = set()
    type_stack: list[tuple[int, int]] = []
    root_bucket = 0
    for op, a1, a2 in rule.steps:
        if op == RuleOp.TAKE:
            w = [a1]
            root_bucket = a1
        elif op in (RuleOp.CHOOSELEAF_FIRSTN, RuleOp.CHOOSELEAF_INDEP):
            numrep, type_ = a1, a2
            if numrep <= 0:
                numrep += maxout
            type_stack.append((type_, numrep))
            if type_ > 0:
                type_stack.append((0, 1))
            w = _choose_type_stack(
                m, type_stack, overfull, underfull, more_underfull,
                orig, ipos, used, w, root_bucket, ruleno,
            )
            type_stack = []
        elif op in (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSE_INDEP):
            numrep, type_ = a1, a2
            if numrep <= 0:
                numrep += maxout
            type_stack.append((type_, numrep))
        elif op == RuleOp.EMIT:
            if type_stack:
                w = _choose_type_stack(
                    m, type_stack, overfull, underfull, more_underfull,
                    orig, ipos, used, w, root_bucket, ruleno,
                )
                type_stack = []
            out.extend(w)
            w = []
    return out


def try_pg_upmap(
    m: OSDMap,
    pg: PgId,
    overfull: set[int],
    underfull: list[int],
    more_underfull: list[int],
    orig: list[int],
) -> list[int] | None:
    """reference OSDMap.cc:4590-4632."""
    pool = m.get_pg_pool(pg.pool)
    if pool is None:
        return None
    ruleno = mapper_ref.find_rule(
        m.crush, pool.crush_rule, int(pool.type), pool.size
    )
    if ruleno < 0:
        return None
    if not any(osd in overfull for osd in orig):
        return None
    out = try_remap_rule(
        m, ruleno, pool.size, overfull, underfull, more_underfull, orig
    )
    if out is None or out == orig:
        return None
    return out


# -- calc_pg_upmaps ---------------------------------------------------------

# the JAX package's `balancer` perf group, and the port's plan_host_syncs
_L = obs.logger_for("balancer")
_L.add_u64("rounds", "greedy optimizer outer iterations")
_L.add_u64("changes_accepted", "upmap-item changes committed")
_L.add_u64("changes_rejected", "upmap-item changes rolled back (stddev up)")
_L.add_avg("stddev", "PG-count deviation stddev after each accepted change")
_L.add_avg("max_deviation", "max abs deviation after each accepted change")
_L.add_time_avg("round_seconds", "wall time per optimizer round")
_L.add_quantile("round_hist",
                "optimizer round wall-time distribution (p50/p99)")
_L.add_time_avg("build_state_seconds",
                "membership-state build wall time (the O(PGs) mapping "
                "pass), booked only when the state was built by mapping")
_L.add_u64("state_rows_reused",
           "membership builds served entirely from a caller's "
           "version-tagged rows (no mapping pass)")
_L.add_u64("candidate_batches", "candidate-scoring batch evaluations")
_L.add_u64("candidates_scored",
           "prospective upmap changes scored in those batches")
_L.add_u64("candidate_conflicts",
           "scored candidates skipped: an accepted one already touched "
           "one of their OSDs")
_L.add_u64("plan_dispatches", "device_loop plans run")
_L.add_u64("plan_readback_reverts",
           "device_loop moves rolled back at the readback (counted in "
           "changes_rejected too)")
_L.add_u64("plan_host_syncs",
           "device_loop reads from the device to the host (on a card one "
           "a plan, the readback; on the CPU one a plan round and the "
           "readback)")
__getattr__ = counters_attr("balancer", __name__, (
    "rounds", "changes_accepted", "changes_rejected", "candidate_batches",
    "candidates_scored", "candidate_conflicts", "plan_dispatches",
    "plan_readback_reverts", "plan_host_syncs"))


def _inc(name: str, n: int = 1) -> None:
    _L.inc(name, int(n))


def _book_deviation(stddev: float, max_deviation: float) -> None:
    _L.observe("stddev", stddev)
    _L.observe("max_deviation", max_deviation)
    obs.counter("balancer.stddev", stddev)


@dataclass
class UpmapResult:
    num_changed: int = 0
    new_pg_upmap_items: dict = field(default_factory=dict)
    old_pg_upmap_items: set = field(default_factory=set)
    stddev: float = 0.0
    max_deviation: float = 0.0
    # device_loop only: the applied moves as (pg, frm, to, round), the
    # readback's audit trail (tests replay the plan with it to check that
    # every move is OSD-disjoint and improves on its own)
    moves: list = field(default_factory=list)


def _build_pgs_by_osd(m: OSDMap, only_pools, use_tpu: bool,
                      rows_source=None, device=None) -> dict[int, set]:
    """Map every PG of every (selected) pool: the reference's per-PG loop
    (OSDMap.cc:4652-4665), or with use_tpu one overlay-free
    `PoolMapper.map_all_device` call per pool with the few upmap-carrying
    PGs fixed up from the host pipeline.  rows_source(pid) -> rows, where
    it answers, stands in for the mapping of that pool."""
    pgs_by_osd: dict[int, set] = {}

    def add_rows(pool_id, pool, up):
        for ps in range(pool.pg_num):
            pg = PgId(pool_id, ps)
            for osd in up[ps]:
                if osd != ITEM_NONE and osd >= 0:
                    pgs_by_osd.setdefault(int(osd), set()).add(pg)

    for pool_id, pool in sorted(m.pools.items()):
        if only_pools and pool_id not in only_pools:
            continue
        cached = rows_source(pool_id) if rows_source is not None \
            else None
        if cached is not None:
            add_rows(pool_id, pool, torch.as_tensor(cached).cpu().numpy())
        elif use_tpu:
            from ceph_tpu_torch.osd.pipeline import (
                PoolMapper,
                overlay_fixup_rows,
            )

            pm = PoolMapper(m, pool_id, device, overlays=False)
            up = pm.map_all_device().cpu().numpy().copy()
            seeds, fix = overlay_fixup_rows(m, pool_id, up.shape[1])
            up[seeds] = fix
            add_rows(pool_id, pool, up)
        else:
            for ps in range(pool.pg_num):
                pg = PgId(pool_id, ps)
                up, _, _, _ = m.pg_to_up_acting_osds(pg)
                for osd in up:
                    if osd != ITEM_NONE:
                        pgs_by_osd.setdefault(osd, set()).add(pg)
    return pgs_by_osd


# -- candidate-batched optimizer --------------------------------------------
# The sequential greedy (below) evaluates ONE prospective change per
# step.  The batched form scores a whole batch of prospective pg_upmap
# changes in one vectorized deviation-delta expression (on the device on
# the "device" backend), accepts the best NON-CONFLICTING subset on the
# host (the squared-deviation objective is separable per OSD, so
# OSD-disjoint candidates with negative deltas are each an independent
# improvement) and iterates.

_CAND_PAD = 32  # the candidate axis pads to multiples of this


def _score_math(xp, counts, target, inw, osd, sgn, dv):
    """Sum-of-squares deviation delta of applying each candidate's moves
    alone.  Candidates are [K, S] slot arrays of (osd id, ±1 count
    delta); osd<0 = empty slot.  With a_j the masked slot delta, w the
    in-weight-set mask and dev_j = counts[o_j] - target[o_j]:

        d(sum_sq) = Σ_j 2·a_j·w_j·dev_j + Σ_{j,j'} a_j·a_j'·w_j·[o_j=o_j']

    (the exact expansion of Σ_o (c_o+d_o-t_o)² - (c_o-t_o)², duplicate
    OSDs inside one candidate included).  One expression for numpy (the
    "sets" backend) and torch (the "device" backend): `xp` is the
    module, counts is float64."""
    ok = (osd >= 0) & (osd < dv)
    o = xp.clip(osd, 0, dv - 1)
    a = xp.where(ok, sgn, 0.0)
    w = inw[o]
    dev = counts[o] - target[o]
    lin = xp.sum(2.0 * a * w * dev, axis=1)
    eq = (o[:, :, None] == o[:, None, :]) \
        & ok[:, :, None] & ok[:, None, :]
    quad = xp.sum(
        a[:, :, None] * a[:, None, :] * w[:, :, None] * eq,
        axis=(1, 2))
    return lin + quad


def _classify_deviations(by_dev, max_deviation):
    """Overfull/underfull partition of the ascending (osd, deviation)
    list: the shared front half of both optimizer loops (reference
    OSDMap.cc:4707-4732)."""
    overfull: set[int] = set()
    more_overfull: set[int] = set()
    underfull: list[int] = []
    more_underfull: list[int] = []
    for osd, d in reversed(by_dev):
        if d <= 0:
            break
        if d > max_deviation:
            overfull.add(osd)
        else:
            more_overfull.add(osd)
    for osd, d in by_dev:
        if d >= 0:
            break
        if d < -max_deviation:
            underfull.append(osd)
        else:
            more_underfull.append(osd)
    return overfull, more_overfull, underfull, more_underfull


def _gen_candidates(m, st, by_dev, osd_deviation, overfull, underfull,
                    more_underfull, using_more_overfull, max_deviation,
                    only_pools, rng, aggressive, limit):
    """Up to `limit` prospective changes, AT MOST ONE per overfull OSD —
    each found exactly the way the sequential loop finds its single
    change (drop remaps INTO the osd, else add a pair via try_pg_upmap)
    but WITHOUT applying anything; the scorer arbitrates afterwards.
    Falls back to the underfull drop pass when the overfull sweep finds
    nothing, mirroring the sequential control flow."""
    cands: list[dict] = []
    seen_pgs: set = set()
    # underfull targets consume ACROSS the batch: without this every
    # overfull osd's try_pg_upmap picks the same most-underfull target
    # and the non-conflicting acceptance degenerates to one change per
    # round (the sequential rate with extra scoring)
    used_targets: set[int] = set()
    for osd, deviation in reversed(by_dev):
        if len(cands) >= limit:
            break
        if deviation < 0:
            break
        if not using_more_overfull and deviation <= max_deviation:
            break
        if osd not in overfull:
            continue
        pgs = [pg for pg in st.pgs_of(osd) if pg not in seen_pgs]
        if aggressive:
            rng.shuffle(pgs)
        cand = None
        # 1) drop existing remaps INTO this overfull osd
        for pg in pgs:
            items = m.pg_upmap_items.get(pg)
            if items is None:
                continue
            moves, new_items = [], []
            for frm, to in items:
                if to == osd:
                    moves.append((to, frm))
                else:
                    new_items.append((frm, to))
            if moves:
                cand = {"pg": pg, "moves": moves,
                        "unmap": not new_items, "items": new_items}
                break
        # 2) add a new remapping pair
        if cand is None:
            for pg in pgs:
                if pg in m.pg_upmap:
                    continue
                pool = m.get_pg_pool(pg.pool)
                new_items = list(m.pg_upmap_items.get(pg, []))
                if len(new_items) >= pool.size:
                    continue
                existing: set[int] = set()
                for frm, to in new_items:
                    existing.add(frm)
                    existing.add(to)
                raw, _ = m._pg_to_raw_osds(pool, pg)
                orig = list(raw)
                m._apply_upmap(pool, pg, orig)
                out = try_pg_upmap(
                    m, pg, overfull,
                    [o for o in underfull if o not in used_targets],
                    [o for o in more_underfull
                     if o not in used_targets],
                    orig)
                if out is None or len(out) != len(orig):
                    continue
                pos, max_dev = -1, 0.0
                for i2 in range(len(out)):
                    if orig[i2] == out[i2]:
                        continue
                    if orig[i2] in existing or out[i2] in existing:
                        continue
                    d = osd_deviation.get(orig[i2], 0.0)
                    if d > max_dev:
                        max_dev, pos = d, i2
                if pos != -1:
                    frm, to = orig[pos], out[pos]
                    cand = {"pg": pg, "moves": [(frm, to)],
                            "unmap": False,
                            "items": new_items + [(frm, to)]}
                    break
        if cand is not None:
            seen_pgs.add(cand["pg"])
            for _, to in cand["moves"]:
                used_targets.add(to)
            cands.append(cand)
    if not cands:
        # underfull pass: drop pairs remapping OUT of strongly-underfull
        # osds (the sequential loop's fallback when overfull found none)
        for osd, deviation in by_dev:
            if len(cands) >= limit or osd not in underfull:
                break
            if abs(deviation) < max_deviation:
                break
            candidates = [
                (pg, items)
                for pg, items in sorted(m.pg_upmap_items.items())
                if pg not in seen_pgs
                and (not only_pools or pg.pool in only_pools)
            ]
            if aggressive:
                rng.shuffle(candidates)
            for pg, items in candidates:
                moves, new_items = [], []
                for frm, to in items:
                    if frm == osd:
                        moves.append((to, frm))
                    else:
                        new_items.append((frm, to))
                if moves:
                    seen_pgs.add(pg)
                    cands.append({"pg": pg, "moves": moves,
                                  "unmap": not new_items,
                                  "items": new_items})
                    break
    return cands


def _score_candidates(st, cands, dv, target, inw, device):
    """Score a candidate batch: ONE vectorized deviation-delta
    expression over [K, S] move slots, in torch on `device` (the
    "device" backend) or in numpy (device None, the "sets" backend).
    Returns float64[K]."""
    smax = max(len(c["moves"]) for c in cands)
    S = 2
    while S < 2 * smax:
        S *= 2
    K = len(cands)
    Kp = -(-K // _CAND_PAD) * _CAND_PAD
    osd = np.full((Kp, S), -1, np.int64)
    sgn = np.zeros((Kp, S), np.float64)
    for i, c in enumerate(cands):
        for j, (frm, to) in enumerate(c["moves"]):
            osd[i, 2 * j] = frm
            sgn[i, 2 * j] = -1.0
            osd[i, 2 * j + 1] = to
            sgn[i, 2 * j + 1] = 1.0
    counts = st.counts_np(dv).astype(np.float64)
    _inc("candidate_batches")
    _inc("candidates_scored", K)
    with obs.span("balancer.score_candidates", candidates=K,
                  device=device is not None):
        if device is not None:
            def put(a):
                return torch.from_numpy(a).to(device)

            deltas = _score_math(torch, put(counts), put(target), put(inw),
                                 put(osd), put(sgn), dv)
            return deltas.cpu().numpy()[:K]
        return np.asarray(_score_math(np, counts, target, inw, osd, sgn,
                                      dv))[:K]


def _targets(st, dv):
    """float64[dv] targets (weight x PGs per weight) and the in-weight-
    set mask (1.0 for OSDs that carry weight)."""
    target = np.zeros(dv, np.float64)
    inw = np.zeros(dv, np.float64)
    for osd, w in st.osd_weight.items():
        if 0 <= osd < dv:
            target[osd] = w * st.ppw
            inw[osd] = 1.0
    return target, inw


def _run_batched(m, st, res, osd_deviation, stddev,
                 max_deviation, max_iter, only_pools, rng, aggressive,
                 candidate_batch, device):
    """The candidate-batched optimizer loop (see the block comment
    above).  `max_iter` bounds BOTH rounds and total accepted changes:
    the budget the sequential loop spends one change per round."""
    dv = max(int(m.max_osd), 1)
    target, inw = _targets(st, dv)
    rounds = 0
    while rounds < max_iter and res.num_changed < max_iter:
        rounds += 1
        _inc("rounds")
        with obs.span("balancer.round", iteration=rounds, batched=True), \
                _L.time("round_seconds"), _L.time("round_hist"):
            by_dev = sorted(osd_deviation.items(),
                            key=lambda kv: (kv[1], kv[0]))
            overfull, more_overfull, underfull, more_underfull = \
                _classify_deviations(by_dev, max_deviation)
            if not underfull and not overfull:
                break
            using_more = False
            if not overfull and underfull:
                overfull = more_overfull
                using_more = True
            cands = _gen_candidates(
                m, st, by_dev, osd_deviation, overfull, underfull,
                more_underfull, using_more, max_deviation, only_pools,
                rng, aggressive, candidate_batch)
            if not cands:
                break
            deltas = _score_candidates(st, cands, dv, target, inw, device)
            # candidates the scorer turned down; conflict skips count in
            # candidate_conflicts instead
            _inc("changes_rejected", int(np.sum(deltas >= 0.0)))
            # best non-conflicting subset: ascending delta, skip any
            # candidate touching an OSD an accepted one already moved, so the
            # deltas add up and every accept is an independent improvement
            order = np.argsort(deltas, kind="stable")
            txn = st.begin()
            accepted = []
            touched: set[int] = set()
            for i in order:
                if deltas[i] >= 0.0:
                    break
                if res.num_changed + len(accepted) >= max_iter:
                    break
                c = cands[i]
                osds = {x for mv in c["moves"] for x in mv}
                if osds & touched:
                    _inc("candidate_conflicts")
                    continue
                for frm, to in c["moves"]:
                    txn.move(c["pg"], frm, to)
                touched |= osds
                accepted.append(c)
            if not accepted:
                break
            stddev_before = stddev
            st.commit(txn)
            for c in accepted:
                pg = c["pg"]
                if c["unmap"]:
                    if pg in m.pg_upmap_items:
                        del m.pg_upmap_items[pg]
                    res.old_pg_upmap_items.add(pg)
                else:
                    m.pg_upmap_items[pg] = list(c["items"])
                    res.new_pg_upmap_items[pg] = list(c["items"])
                res.num_changed += 1
            _inc("changes_accepted", len(accepted))
            osd_deviation, stddev, cur_max_deviation = st.deviations()
            _book_deviation(stddev, cur_max_deviation)
            res.stddev = stddev
            res.max_deviation = cur_max_deviation
            if stddev >= stddev_before:
                break  # float-tie guard: never loop on a non-improvement
            if cur_max_deviation <= max_deviation:
                break
    return res


# -- the device-resident optimizer ------------------------------------------
# backend="device_loop": the whole plan (each round's candidates from the
# deviation vector on the device, the OSD-disjoint subset, the
# multi-round loop with the float-tie guard and the max_deviation exit)
# runs on the membership rows' device.  On a card it is one launch of the
# plan kernel (csrc/upmap_loop.cu, `upmap_loop_cuda`), whose output
# buffer is read back once.  On the CPU it is the kernel's plain version,
# `_loop_plan`: torch ops, a Python loop over the rounds that reads one
# small vector per round (its continue flag and accept/reject counts),
# and the changes buffer read back once at the end.  `loop_plan` chooses
# by the rows' device.  The host then turns each (pg, frm, to) move into
# pg_upmap_items pairs and checks that each PG's pair list gives the
# device row through the host pipeline (OSDMap._apply_upmap) before it
# commits it.
#
# The candidates are those of _classify_deviations/_gen_candidates: the
# strict overfull set, with the more_overfull takeover when only
# underfull remain; at most one candidate per overfull OSD (its
# "dominant" PG, the PG whose worst overfull member it is, lowest index
# first, by an exact integer scatter-min); targets drawn most-underfull
# first from the rule's weight map, excluding the row's own members and
# any OSD whose failure domain another member holds (the try_remap_rule
# constraint), each target used once per round.  An accepted move must
# improve the separable sum-of-squares objective on its own
# (delta = 2*(dev_to - dev_frm) + 2 < 0) and touch no OSD an earlier
# accept of its round touched.
#
# Not on the device, as in the JAX package: the sequential loop's
# underfull pass (drop remaps OUT of strongly-underfull OSDs), which needs
# the pg_upmap_items dict.
#
# Where torch differs from XLA, the plan is written so that the decisions
# do not: XLA's top_k returns equal values lowest index first, and
# torch.topk promises no order among them, so the top-B is a stable
# descending sort; `mode="drop"` scatters go to a buffer one slot longer
# (the sentinel index), cut off after; argmax/argmin take the first
# extremum in both.

_DOM_NONE = 0x7FFFFFFF  # dom_tbl sentinel: not in the rule


def _top_b(key: torch.Tensor, b: int):
    """The b largest values of key and their indices, equal values
    lowest index first: the order of XLA's top_k, which torch.topk does
    not promise among equal values (and deviations tie wherever targets
    are equal)."""
    v, i = torch.sort(key, descending=True, stable=True)
    return v[:b], i[:b]


def _loop_plan(rows, pidx, movable, dom_tbl, tgt_ok, target, inw, counts,
               max_dev: float, budget: int, nbatch: int, ncap: int):
    """The whole-plan optimizer on the device of `rows` (int32 [N, W]);
    the other operands are on the same device.  Returns, on the host,
    (cpg, cfrm, cto, crnd, crows) of the accepted changes in order, the
    rejected count, the rounds and the final counts."""
    dev_ = rows.device
    npg, w = int(rows.shape[0]), int(rows.shape[1])
    dv = int(target.numel())
    npool = int(dom_tbl.shape[0])
    B = nbatch
    inwm = inw > 0.0
    gidx = torch.arange(npg, dtype=torch.int64, device=dev_)
    warange = torch.arange(w, device=dev_)
    barange = torch.arange(B, device=dev_)
    psafe = pidx.long().clamp(0, npool - 1)
    inf = torch.tensor([float("inf")], dtype=torch.float64, device=dev_)
    true1 = torch.ones(1, dtype=torch.bool, device=dev_)

    def full(n, v):
        return torch.full((n,), v, dtype=torch.int64, device=dev_)

    # one spare row / slot past the end of each scatter target takes the
    # writes XLA's mode="drop" would drop (index npg, dv, B or ncap)
    rows_x = torch.cat([rows, rows.new_full((1, w), ITEM_NONE)])
    rows = rows_x[:npg]
    counts_x = torch.cat([counts.long(), counts.new_zeros(1).long()])
    counts = counts_x[:dv]
    cpg, cfrm, cto = full(ncap + 1, npg), full(ncap + 1, dv), \
        full(ncap + 1, dv)
    crnd = full(ncap + 1, 0)

    def dev_of(c):
        return torch.where(inwm, c.double() - target, 0.0)

    dev0 = dev_of(counts)
    sum_sq = (dev0 * dev0).sum()
    n_chg = n_rej = rounds = 0
    cont = True
    while cont:
        dev = dev_of(counts)
        has_over = (dev > max_dev).any()
        has_under = (dev < -max_dev).any()
        # more_overfull takeover when only underfull remain
        over = torch.where(has_over, dev > max_dev,
                           (dev > 0.0) & has_under) & inwm
        # candidate PG per overfull OSD: the lowest-index PG whose WORST
        # overfull member it is (exact integer scatter-min)
        valid_m = (rows >= 0) & (rows < dv)
        rsafe = torch.where(valid_m, rows, 0).long()
        rdev = torch.where(valid_m & over[rsafe], dev.float()[rsafe],
                           -float("inf"))
        dmax = rdev.amax(1)
        darg = rdev.argmax(1)
        dosd = torch.where(torch.isfinite(dmax) & movable,
                           rsafe.gather(1, darg[:, None])[:, 0], dv)
        pick = full(dv + 1, npg).scatter_reduce_(0, dosd, gidx, "amin")
        # top-B overfull OSDs by deviation
        topv, topi = _top_b(torch.where(over, dev, -inf), B)

        used = torch.zeros(dv + 1, dtype=torch.bool, device=dev_)
        apg, aslot, ato, afrm = full(B + 1, npg), full(B + 1, 0), \
            full(B + 1, dv), full(B + 1, dv)
        n_acc, rej = full(1, 0), full(1, 0)
        for k in range(B):
            frm = topi[k:k + 1]
            pg = pick.index_select(0, frm)
            valid = torch.isfinite(topv[k:k + 1]) \
                & ~used.index_select(0, frm) & (pg < npg)
            pgc = pg.clamp(0, npg - 1)
            row = rows.index_select(0, pgc)[0]
            vm = (row >= 0) & (row < dv)
            rsc = torch.where(vm, row, 0).long()
            smask = vm & (row == frm)
            valid = valid & smask.any()
            slot = smask.to(torch.int8).argmax().reshape(1)
            p = psafe.index_select(0, pgc)
            dtbl = dom_tbl.index_select(0, p)[0]
            in_row = torch.zeros(dv + 1, dtype=torch.bool, device=dev_)
            in_row.index_fill_(0, torch.where(vm, rsc, dv), True)
            # failure-domain constraint: the replacement may not land in
            # any OTHER member's domain
            mdom = torch.where(vm & (warange != slot), dtbl[rsc], _DOM_NONE)
            dom_ok = (dtbl[:, None] != mdom[None, :]).all(1)
            allowed = inwm & (dev < 0.0) & tgt_ok.index_select(0, p)[0] \
                & ~used[:dv] & ~in_row[:dv] & dom_ok
            has_t = allowed.any().reshape(1)
            t = torch.where(allowed, dev, inf).argmin().reshape(1)
            # separable objective: moving one PG frm -> to
            delta = 2.0 * (dev.index_select(0, t)
                           - dev.index_select(0, frm)) + 2.0
            cand_ok = valid & has_t
            accept = cand_ok & (delta < 0.0) & (n_chg + n_acc < budget)
            rej += (cand_ok & (delta >= 0.0)).long()
            ins = torch.where(accept, n_acc, B)
            apg.index_put_((ins,), pg)
            aslot.index_put_((ins,), slot)
            ato.index_put_((ins,), t)
            afrm.index_put_((ins,), frm)
            # targets are used up across the batch whether or not the
            # score accepts (as _gen_candidates' used_targets)
            used.index_put_((torch.where(cand_ok, t, dv),), true1)
            used.index_put_((torch.where(accept, frm, dv),), true1)
            n_acc += accept.long()
        # apply: a round's PGs are distinct (one dominant member each)
        # and its OSDs disjoint, so the scatters commute; slots past
        # n_acc still hold the sentinels
        apg, aslot, ato, afrm = apg[:B], aslot[:B], ato[:B], afrm[:B]
        rows_x.index_put_((apg, aslot), ato.to(rows_x.dtype))
        counts_x.index_add_(0, afrm, torch.full_like(afrm, -1))
        counts_x.index_add_(0, ato, torch.ones_like(ato))
        counts_x[dv] = 0
        bpos = torch.where(barange < n_acc, n_chg + barange, ncap)
        cpg.index_put_((bpos,), apg)
        cfrm.index_put_((bpos,), afrm)
        cto.index_put_((bpos,), ato)
        crnd.index_put_((bpos,), torch.full_like(bpos, rounds + 1))
        devn = dev_of(counts)
        ss2 = (devn * devn).sum()
        mx2 = devn.abs().max()
        # the sequential loop's exits: nothing accepted, the float-tie
        # guard (never loop on a non-improvement), max_deviation
        # reached, the round or change budget spent
        better = ((ss2 < sum_sq) & (mx2 > max_dev)).long().reshape(1)
        n_acc_h, rej_h, better_h = torch.cat([n_acc, rej, better]).tolist()
        _inc("plan_host_syncs")
        sum_sq = ss2
        n_chg += n_acc_h
        n_rej += rej_h
        rounds += 1
        cont = (n_acc_h > 0 and bool(better_h) and rounds < budget
                and n_chg < budget)
    # the final rows of every changed PG, gathered on the device: the
    # readback is one fetch of bounded-shape outputs
    crows = rows.index_select(0, cpg[:n_chg].clamp(0, max(npg - 1, 0)))
    out = [t.cpu().numpy() for t in (cpg[:n_chg], cfrm[:n_chg],
                                     cto[:n_chg], crnd[:n_chg], crows,
                                     counts)]
    _inc("plan_host_syncs")
    return (*out[:5], n_rej, rounds, out[5])


# -- the plan kernel ----------------------------------------------------------

_LOOP_SOURCE = "balancer/csrc/upmap_loop.cu"
_LOOP_W_CAP = 32  # upmap_loop.cuh W_CAP: the widest row the kernel takes
_LOOP_OUT_HEAD = 4  # upmap_loop.cuh OUT_HEAD: n_chg, n_rej, rounds, pad
_LOOP_GROUP = 16  # upmap_loop.cuh GROUP: candidates resolved together


def _loop_work(shape) -> tuple[int, int]:
    """(bytes, 0) of one plan launch of shape (npg, w, dv, npool, nbatch,
    ncap): its first round's bytes, each read once: the rows and the
    movable mask, the changed-PG bits (zeroed, then read), the per-pool
    tables and the per-OSD vectors; and the output written once.  Each
    later round reads the rows, the mask and the bits again; how many
    rounds run depends on the data, and the few PGs the candidates read
    (their pool positions and rows) are not counted.  The operations are
    not reckoned."""
    npg, w, dv, npool, nbatch, ncap = shape
    return (npg * (4 * w + 1) + 8 * (-(-npg // 32)) + npool * dv * 5
            + dv * 24 + 8 * (_LOOP_OUT_HEAD + ncap * (4 + w) + dv)), 0


# the plan kernel's launches, enqueue times and first-call build, booked
# into the kernel registry, which the `balancer` perf group reads; its
# launch span is balancer.device_loop.launch
_LOOP_ACCT = obs.LaunchAccount(_L, "upmap_loop", _LOOP_SOURCE,
                               span="balancer.device_loop", work=_loop_work)
_LOOP_LIBS: list = []  # the loaded library, once its signatures are set
_LOOP_LOCK = threading.Lock()


def _loop_lib():
    if _LOOP_LIBS:
        return _LOOP_LIBS[0]
    with _LOOP_LOCK:
        if _LOOP_LIBS:
            return _LOOP_LIBS[0]
        lib = _LOOP_ACCT.load(lambda: build.load(_LOOP_SOURCE))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.upmap_loop_launch.argtypes = (
            [p] * 8 + [ll, i, i, i, i, i, ctypes.c_double, ll] + [p] * 2
            + [i, p])
        lib.upmap_loop_launch.restype = i
        lib.upmap_loop_plan.argtypes = [p, i]
        lib.upmap_loop_plan.restype = i
        lib.upmap_loop_scratch_bytes.argtypes = [i, i, ll, i, i]
        lib.upmap_loop_scratch_bytes.restype = ll
        lib.upmap_loop_error_string.argtypes = [i]
        lib.upmap_loop_error_string.restype = ctypes.c_char_p
        _LOOP_LIBS.append(lib)
        return lib


def _loop_check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _loop_lib().upmap_loop_error_string(rc).decode()
        raise RuntimeError(f"upmap_loop {what} failed: {msg}")


@dataclass(frozen=True)
class LoopLaunchPlan:
    """What the build and the card give the plan kernel, from
    `upmap_loop_plan`."""

    registers: int  # per thread
    local_bytes: int  # per thread
    static_smem: int  # per block
    threads: int  # per block (the kernel's THREADS)
    blocks_per_sm: int  # resident at that size
    sms: int
    cooperative: int  # the card takes cooperative launches
    dynamic_smem: int  # per block, for the OSDs asked for

    @property
    def grid(self) -> int:
        """The most blocks a cooperative launch may have."""
        return self.blocks_per_sm * self.sms


@functools.cache
def loop_launch_plan(device_index: int, osds: int = 0) -> LoopLaunchPlan:
    """The launch of a plan over `osds` OSDs on the card (phase (a) keeps
    their deviations in shared memory where they fit)."""
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(device_index):
        _loop_check(_loop_lib().upmap_loop_plan(ctypes.addressof(out),
                                                osds), "plan")
    return LoopLaunchPlan(*out)


_LOOP_TYPES = (("rows", torch.int32), ("pidx", torch.int32),
               ("movable", torch.bool), ("dom_tbl", torch.int32),
               ("tgt_ok", torch.bool), ("target", torch.float64),
               ("inw", torch.float64), ("counts", torch.int64))


def upmap_loop_cuda(rows, pidx, movable, dom_tbl, tgt_ok, target, inw,
                    counts, max_dev: float, budget: int, nbatch: int,
                    ncap: int) -> torch.Tensor:
    """Launch the plan kernel once, on `_loop_plan`'s operands on one
    card: the whole plan, every round, with no host read.  Returns its
    int64 output buffer on the card, unsynchronised: n_chg, n_rej and
    rounds (then a pad), then cpg, cfrm, cto and crnd (ncap each), the
    final rows of the changes (ncap x w) and the final counts (dv); the
    entries past n_chg are undefined.  The caller's rows are read, never
    written, and not copied: the plan keeps the rows it changes apart.
    `upmap_loop_cuda.launches` counts the launches (the kernel's count in
    the kernel registry)."""
    ops = (rows, pidx, movable, dom_tbl, tgt_ok, target, inw, counts)
    dev = rows.device
    for (name, dtype), t in zip(_LOOP_TYPES, ops):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"upmap_loop_cuda: {name} on {t.device}, rows "
                             f"on {dev}; all must be on one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"upmap_loop_cuda: {name} is {t.dtype}, "
                            f"{dtype} expected")
        if not t.is_contiguous():
            raise ValueError(f"upmap_loop_cuda: {name} is not contiguous")
    npg, w = (int(x) for x in rows.shape)
    dv = int(target.numel())
    npool = int(dom_tbl.shape[0])
    if not (1 <= w <= _LOOP_W_CAP and npg < 2 ** 31 - 1 and dv >= 1
            and npool >= 1 and 1 <= nbatch <= dv and 1 <= ncap
            and budget <= ncap):
        raise ValueError(
            f"upmap_loop_cuda: rows [{npg}, {w}] (1 <= w <= {_LOOP_W_CAP}),"
            f" {dv} OSDs, {npool} pools, batch {nbatch}, cap {ncap} "
            f"(budget {budget} <= cap)")
    if (pidx.shape != (npg,) or movable.shape != (npg,)
            or dom_tbl.shape != (npool, dv) or tgt_ok.shape != (npool, dv)
            or inw.shape != (dv,) or counts.shape != (dv,)):
        raise ValueError("upmap_loop_cuda: operand shapes do not match "
                         f"rows [{npg}, {w}] and {dv} OSDs")
    lib = _loop_lib()
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    plan = loop_launch_plan(index, dv)
    if not plan.cooperative or plan.grid < 1:
        raise RuntimeError(f"upmap_loop_cuda: the card takes no cooperative "
                           f"launch of this kernel ({plan})")
    # a block a PG's thread, and at least a block a candidate of a group
    blocks = max(1, min(plan.grid, max(-(-npg // plan.threads),
                                       min(nbatch, _LOOP_GROUP))))
    out = torch.empty(_LOOP_OUT_HEAD + ncap * (4 + w) + dv,
                      dtype=torch.int64, device=dev)
    scratch = torch.empty(
        lib.upmap_loop_scratch_bytes(dv, nbatch, npg, w, ncap),
        dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = _LOOP_ACCT.launch(
            lib.upmap_loop_launch, *(t.data_ptr() for t in ops), npg, w, dv,
            npool, nbatch, ncap, float(max_dev), int(budget),
            out.data_ptr(), scratch.data_ptr(), blocks,
            torch.cuda.current_stream().cuda_stream,
            shape=(npg, w, dv, npool, nbatch, ncap))
        _loop_check(rc, "kernel launch")
    return out


upmap_loop_cuda = _LOOP_ACCT.entry(upmap_loop_cuda)


def _loop_kernel(rows, pidx, movable, dom_tbl, tgt_ok, target, inw,
                 counts, max_dev: float, budget: int, nbatch: int,
                 ncap: int):
    """The plan through the kernel: one launch, one read back to the
    host.  Returns what `_loop_plan` returns."""
    out = upmap_loop_cuda(rows, pidx, movable, dom_tbl, tgt_ok, target,
                          inw, counts, max_dev, budget, nbatch, ncap)
    o = out.cpu().numpy()
    _inc("plan_host_syncs")
    return unpack_loop_out(o, int(rows.shape[1]), int(target.numel()), ncap)


def unpack_loop_out(o: np.ndarray, w: int, dv: int, ncap: int):
    """The plan kernel's output buffer (int64, on the host) as
    `_loop_plan`'s return: (cpg, cfrm, cto, crnd, crows, n_rej, rounds,
    counts)."""
    n_chg, n_rej, rounds = (int(x) for x in o[:3])
    h = _LOOP_OUT_HEAD
    cpg, cfrm, cto, crnd = (o[h + k * ncap:h + k * ncap + n_chg]
                            for k in range(4))
    crows = o[h + 4 * ncap:h + 4 * ncap + n_chg * w].reshape(n_chg, w)
    return (cpg, cfrm, cto, crnd, crows.astype(np.int32), n_rej, rounds,
            o[h + ncap * (4 + w):h + ncap * (4 + w) + dv])


def loop_plan(rows, pidx, movable, dom_tbl, tgt_ok, target, inw, counts,
              max_dev: float, budget: int, nbatch: int, ncap: int):
    """The whole plan on the device of `rows`: one launch of the plan
    kernel on a card, its plain version `_loop_plan` on the CPU.  Returns,
    on the host, (cpg, cfrm, cto, crnd, crows) of the accepted changes in
    order, the rejected count, the rounds and the final counts."""
    args = (rows, pidx, movable, dom_tbl, tgt_ok, target, inw, counts,
            max_dev, budget, nbatch, ncap)
    if rows.device.type == "cpu":
        return _loop_plan(*args)
    if rows.device.type == "cuda":
        return _loop_kernel(*args)
    raise ValueError(f"device_loop: unsupported device {rows.device}")


def _run_device_loop(m, fst, res, max_deviation, max_iter,
                     candidate_batch):
    """Host side of the device_loop backend: build the O(OSDs)
    metadata (targets, domain tables), run the plan on the rows'
    device, then turn the changes buffer into pg_upmap_items, checking
    every pair list against the host pipeline before committing it."""
    st = fst.st
    dv = max(int(m.max_osd), 1)
    target, inw = _targets(st, dv)
    # per-pool valid-target mask and failure-domain table (the
    # try_remap_rule subtree/domain constraints, computed once)
    P = max(len(fst.pools), 1)
    dom_tbl = np.full((P, dv), _DOM_NONE, np.int32)
    tgt_ok = np.zeros((P, dv), bool)
    for i, pid in enumerate(fst.pools):
        pool = m.pools[pid]
        ruleno = mapper_ref.find_rule(
            m.crush, pool.crush_rule, int(pool.type), pool.size)
        if ruleno < 0:
            continue
        dom_type = 0
        for op, _a1, a2 in m.crush.rules[ruleno].steps:
            if op in (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSE_INDEP,
                      RuleOp.CHOOSELEAF_FIRSTN,
                      RuleOp.CHOOSELEAF_INDEP) and a2 > 0:
                dom_type = a2
                break
        parent = parent_of_type_map(m.crush, dom_type, ruleno) \
            if dom_type > 0 else None
        for osd in get_rule_weight_osd_map(m.crush, ruleno):
            if not (0 <= osd < dv):
                continue
            # a down OSD reads maximally underfull (its count is 0) but
            # can never be a target: the committed pair would be skipped
            # by the host pipeline and revert at the readback
            tgt_ok[i, osd] = m.exists(osd) and not m.is_down(osd)
            dom_tbl[i, osd] = parent.get(osd, 0) if parent is not None \
                else osd
    movable = np.ones(fst.n_total, bool)
    pool_pos = {pid: i for i, pid in enumerate(fst.pools)}
    for pg in m.pg_upmap:  # full-remap PGs are frozen
        i = pool_pos.get(pg.pool)
        if i is not None and pg.seed < m.pools[pg.pool].pg_num:
            movable[int(fst.offsets[i]) + pg.seed] = False

    B = max(1, min(int(candidate_batch), dv))
    C = -(-max(int(max_iter), 1) // 8) * 8  # change cap, padded
    device = fst.rows.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    _inc("plan_dispatches")
    with obs.span("balancer.device_loop", pgs=int(fst.rows.shape[0]),
                  osds=dv, batch=B, budget=int(max_iter)):
        (cpg, cfrm, cto, crnd, crows, n_rej, rounds_d,
         counts_np) = loop_plan(
            fst.rows, put(fst.pool_idx), put(movable), put(dom_tbl),
            put(tgt_ok), put(target), put(inw),
            put(st.counts.astype(np.int64)), float(max_deviation),
            int(max_iter), B, C)
    n_chg = len(cpg)
    _inc("rounds", rounds_d)
    _inc("changes_rejected", n_rej)
    counts_np = counts_np.copy()

    # readback: compose each changed PG's recorded moves (in round order)
    # onto its existing pg_upmap_items (a move whose `frm` is an earlier
    # pair's target rewrites that pair, or cancels it when it lands back
    # on the raw member), then check that the pair list gives the device
    # row through the host pipeline (_pg_to_raw_osds -> _apply_upmap ->
    # _raw_to_up_osds) before committing it
    last: dict[int, int] = {}
    moves_of: dict[int, list[int]] = {}
    for i in range(n_chg):
        g = int(cpg[i])
        last[g] = i
        moves_of.setdefault(g, []).append(i)
    W = int(crows.shape[1]) if n_chg else 0
    applied = 0
    for g in sorted(last):
        pid, seed = fst.locate(g)
        pool = m.pools[pid]
        pg = PgId(pid, seed)
        old = m.pg_upmap_items.get(pg)
        pairs = list(old or [])
        for j in moves_of[g]:
            frm, to = int(cfrm[j]), int(cto[j])
            for k2, (a, b) in enumerate(pairs):
                if b == frm:
                    if a == to:
                        del pairs[k2]  # back to the raw member
                    else:
                        pairs[k2] = (a, to)
                    break
            else:
                pairs.append((frm, to))
        raw, _ = m._pg_to_raw_osds(pool, pg)
        if pairs:
            m.pg_upmap_items[pg] = pairs
        elif pg in m.pg_upmap_items:
            del m.pg_upmap_items[pg]
        chk = list(raw)
        m._apply_upmap(pool, pg, chk)
        chk = m._raw_to_up_osds(pool, chk)
        want = chk + [ITEM_NONE] * (W - len(chk))
        if [int(x) for x in crows[last[g]]] != want[:W]:
            # the host pipeline cannot express this row (a pair-order or
            # skip interaction with earlier items): revert, roll the
            # counts back, count the moves rejected
            if old is not None:
                m.pg_upmap_items[pg] = old
            elif pg in m.pg_upmap_items:
                del m.pg_upmap_items[pg]
            for j in moves_of[g]:
                counts_np[int(cfrm[j])] += 1
                counts_np[int(cto[j])] -= 1
            _inc("plan_readback_reverts", len(moves_of[g]))
            _inc("changes_rejected", len(moves_of[g]))
            continue
        applied += len(moves_of[g])
        res.num_changed += len(moves_of[g])
        for j in moves_of[g]:
            res.moves.append((pg, int(cfrm[j]), int(cto[j]),
                              int(crnd[j])))
        if pairs:
            res.new_pg_upmap_items[pg] = list(pairs)
        elif old is not None:
            res.old_pg_upmap_items.add(pg)
    _inc("changes_accepted", applied)
    _, stddev, cur_max = st._dev_from_counts(counts_np)
    _book_deviation(stddev, cur_max)
    res.stddev = stddev
    res.max_deviation = cur_max
    return res


def calc_pg_upmaps(
    m: OSDMap,
    max_deviation: int = 5,
    max_iter: int = 10,
    only_pools: set[int] | None = None,
    aggressive: bool = True,
    local_fallback_retries: int = 100,
    use_tpu: bool = True,
    rng: np.random.Generator | None = None,
    backend: str = "sets",
    mesh=None,
    device_cache: dict | None = None,
    rows_source=None,
    candidate_batch: int = 0,
    device=None,
) -> UpmapResult:
    """Greedy upmap optimization; mutates m.pg_upmap_items.  Returns the
    change set (the reference's pending_inc).  reference OSDMap.cc:4634.

    backend: "sets" (the reference's dict-of-sets, small maps), "device"
    (membership rows on the device, O(OSDs) host state: the
    10M-PG/10k-OSD form) or "device_loop" (the whole multi-round greedy
    on the device: one launch of the plan kernel on a card, its plain
    version on the CPU; its changes read back once).  All evolve
    the same bookkeeping as the JAX package's backends of the same names.

    candidate_batch: 0 = the reference's sequential greedy (one evaluated
    change per step); N>0 = score up to N prospective changes per step
    and accept the best non-conflicting subset (device_loop: the
    candidates per plan round, 16 when 0).

    use_tpu (the JAX package's name, kept): the "sets" backend maps the
    PGs through `PoolMapper` rather than the host pipeline.  device: where
    PoolMapper and the device backends run; None is the card
    (`device.resolve_device`), "cpu" runs the rule's plain version.
    rng: the caller's numpy Generator (the "aggressive" shuffles), drawn
    from exactly as the JAX package draws.  device_cache: a caller-owned
    dict that keeps the per-pool PoolMapper across calls.  rows_source
    (pid -> rows or None) stands in for the mapping of the pools it
    answers.  mesh: the PG-axis device mesh (`parallel.sharded.Mesh`)
    the device backends' mapping passes split over; None resolves the
    CEPH_TPU_MESH_DEVICES knob (`sharded.default_mesh`), as the JAX
    package does.  The plan runs on the mesh's first device.
    """
    from ceph_tpu_torch.balancer.state import (
        DeviceState,
        FlatDeviceState,
        SetState,
    )

    if backend not in ("sets", "device", "device_loop"):
        raise ValueError(f"calc_pg_upmaps: unknown backend {backend!r}")
    on_device = backend in ("device", "device_loop")
    if on_device:
        from ceph_tpu_torch.parallel.sharded import mesh_for

        device, mesh = mesh_for(device, mesh)
    elif use_tpu:
        device = resolve_device(device)

    res = UpmapResult()
    max_deviation = max(1, max_deviation)
    only_pools = only_pools or set()
    rng = rng or np.random.default_rng(0)

    # per-osd weight from the pools' crush rules
    total_pgs = 0
    osd_weight: dict[int, float] = {}
    osd_weight_total = 0.0
    for pool_id, pool in sorted(m.pools.items()):
        if only_pools and pool_id not in only_pools:
            continue
        total_pgs += pool.size * pool.pg_num
        ruleno = mapper_ref.find_rule(
            m.crush, pool.crush_rule, int(pool.type), pool.size
        )
        if ruleno < 0:
            continue
        pmap = get_rule_weight_osd_map(m.crush, ruleno)
        for osd, w in pmap.items():
            adjusted = m.get_weightf(osd) * w if osd < m.max_osd else 0.0
            if adjusted == 0.0:
                continue
            osd_weight[osd] = osd_weight.get(osd, 0.0) + adjusted
            osd_weight_total += adjusted
    if osd_weight_total == 0 or max_iter <= 0:
        return res
    pgs_per_weight = total_pgs / osd_weight_total

    served = {"hit": 0, "miss": 0}

    def _counted_src(pid):
        rows = rows_source(pid)
        served["hit" if rows is not None else "miss"] += 1
        return rows

    src = _counted_src if rows_source is not None else None
    t0 = time.perf_counter()
    with obs.span("balancer.build_state", backend=backend, pgs=total_pgs,
                  reused=rows_source is not None):
        if on_device:
            st = DeviceState(
                m, osd_weight, pgs_per_weight, only_pools=only_pools,
                device=device, cache=device_cache, rows_source=src,
                mesh=mesh,
            )
        else:
            pgs_by_osd = _build_pgs_by_osd(m, only_pools, use_tpu,
                                           rows_source=src, device=device)
            st = SetState(pgs_by_osd, osd_weight, pgs_per_weight)
    if src is not None and not served["miss"] and served["hit"]:
        _inc("state_rows_reused")
    else:
        _L.observe("build_state_seconds", time.perf_counter() - t0)

    osd_deviation, stddev, cur_max_deviation = st.deviations()
    res.stddev, res.max_deviation = stddev, cur_max_deviation
    if cur_max_deviation <= max_deviation:
        return res

    if backend == "device_loop":
        return _run_device_loop(
            m, FlatDeviceState(st), res, max_deviation, max_iter,
            int(candidate_batch) or 16)

    if candidate_batch:
        return _run_batched(
            m, st, res, osd_deviation, stddev,
            max_deviation, max_iter, only_pools, rng, aggressive,
            int(candidate_batch),
            device=device if backend == "device" else None,
        )

    skip_overfull = False
    iter_left = max_iter
    while iter_left > 0:
        iter_left -= 1
        _inc("rounds")
        with obs.span("balancer.round", iteration=max_iter - iter_left), \
                _L.time("round_seconds"), _L.time("round_hist"):
            by_dev = sorted(
                osd_deviation.items(), key=lambda kv: (kv[1], kv[0])
            )
            overfull, more_overfull, underfull, more_underfull = \
                _classify_deviations(by_dev, max_deviation)
            if not underfull and not overfull:
                break
            using_more_overfull = False
            if not overfull and underfull:
                overfull = more_overfull
                using_more_overfull = True

            to_skip: set = set()
            local_fallback_retried = 0

            while True:  # retry: label
                to_unmap: set = set()
                to_upmap: dict = {}
                txn = st.begin()
                found = False

                # ---- overfull pass ---------------------------------------
                if not (skip_overfull and underfull):
                    for osd, deviation in reversed(by_dev):
                        if deviation < 0:
                            break
                        if (not using_more_overfull
                                and deviation <= max_deviation):
                            break
                        pgs = [
                            pg for pg in st.pgs_of(osd)
                            if pg not in to_skip
                        ]
                        if aggressive:
                            rng.shuffle(pgs)  # equal (in)attention
                        # 1) drop existing remaps INTO this overfull osd
                        for pg in pgs:
                            items = m.pg_upmap_items.get(pg)
                            if items is None:
                                continue
                            new_items = []
                            for frm, to in items:
                                if to == osd:
                                    txn.move(pg, to, frm)
                                else:
                                    new_items.append((frm, to))
                            if not new_items:
                                to_unmap.add(pg)
                                found = True
                                break
                            elif len(new_items) != len(items):
                                to_upmap[pg] = new_items
                                found = True
                                break
                        if found:
                            break
                        # 2) add a new remapping pair
                        for pg in pgs:
                            if pg in m.pg_upmap:
                                continue
                            pool = m.get_pg_pool(pg.pool)
                            new_items = list(m.pg_upmap_items.get(pg, []))
                            if len(new_items) >= pool.size:
                                continue
                            existing: set[int] = set()
                            for frm, to in new_items:
                                existing.add(frm)
                                existing.add(to)
                            # raw mapping including existing upmaps
                            raw, _ = m._pg_to_raw_osds(pool, pg)
                            orig = list(raw)
                            m._apply_upmap(pool, pg, orig)
                            out = try_pg_upmap(
                                m, pg, overfull, underfull, more_underfull,
                                orig
                            )
                            if out is None or len(out) != len(orig):
                                continue
                            pos, max_dev = -1, 0.0
                            for i2 in range(len(out)):
                                if orig[i2] == out[i2]:
                                    continue
                                if (
                                    orig[i2] in existing
                                    or out[i2] in existing
                                ):
                                    continue
                                d = osd_deviation.get(orig[i2], 0.0)
                                if d > max_dev:
                                    max_dev, pos = d, i2
                            if pos != -1:
                                frm, to = orig[pos], out[pos]
                                txn.move(pg, frm, to)
                                new_items.append((frm, to))
                                to_upmap[pg] = new_items
                                found = True
                                break
                        if found:
                            break

                # ---- underfull pass --------------------------------------
                if not found:
                    for osd, deviation in by_dev:
                        if osd not in underfull:
                            break
                        if abs(deviation) < max_deviation:
                            break
                        candidates = [
                            (pg, items)
                            for pg, items in sorted(m.pg_upmap_items.items())
                            if pg not in to_skip
                            and (not only_pools or pg.pool in only_pools)
                        ]
                        if aggressive:
                            rng.shuffle(candidates)
                        for pg, items in candidates:
                            new_items = []
                            for frm, to in items:
                                if frm == osd:
                                    txn.move(pg, to, frm)
                                else:
                                    new_items.append((frm, to))
                            if not new_items:
                                to_unmap.add(pg)
                                found = True
                                break
                            elif len(new_items) != len(items):
                                to_upmap[pg] = new_items
                                found = True
                                break
                        if found:
                            break

                if not found:
                    if not aggressive:
                        iter_left = 0
                    elif not skip_overfull:
                        iter_left = 0
                    else:
                        skip_overfull = False
                    break  # out of retry loop

                # ---- test_change -----------------------------------------
                temp_dev, new_stddev, cur_max_deviation = txn.deviations()
                if new_stddev >= stddev:
                    _inc("changes_rejected", len(to_unmap) + len(to_upmap))
                    if not aggressive:
                        iter_left = 0
                        break
                    local_fallback_retried += 1
                    if local_fallback_retried >= local_fallback_retries:
                        skip_overfull = not skip_overfull
                        break
                    to_skip |= to_unmap
                    to_skip |= set(to_upmap)
                    continue  # goto retry

                stddev = new_stddev
                st.commit(txn)
                osd_deviation = temp_dev
                for pg in to_unmap:
                    del m.pg_upmap_items[pg]
                    res.old_pg_upmap_items.add(pg)
                    res.num_changed += 1
                for pg, items in to_upmap.items():
                    m.pg_upmap_items[pg] = items
                    res.new_pg_upmap_items[pg] = items
                    res.num_changed += 1
                _inc("changes_accepted", len(to_unmap) + len(to_upmap))
                _book_deviation(stddev, cur_max_deviation)
                res.stddev = stddev
                res.max_deviation = cur_max_deviation
                if cur_max_deviation <= max_deviation:
                    iter_left = 0
                break  # exit retry loop, next outer iteration

    return res
