"""The plan kernel's in-order resolve of a round's candidates, held output
for output on operands built so that the shortlists matter.

The plan kernel (`balancer/csrc/upmap_loop.cuh`) builds each candidate's
first 2j + 1 allowed targets in parallel and resolves the candidates of a
group of GROUP in order; its top-B is a selection of TOPK at a time.
Each case here hands the same operands, made from a seed with numpy, to
the JAX package's `_loop_account` (jitted on the CPU), the port's plain
`_loop_plan` and the body built with g++ (tests/test_torch_upmap_kernel_
host.py's shim) as grids of 1, 3 and 16 blocks, and compares every
output with no tolerance.  The operands go to the plans directly, with
no map, so no PgId alias is needed.  The cases: candidates whose best
target is one OSD, equal deviations, a source an earlier candidate took
as its target (max_dev < 0, where an OSD can be both), a candidate whose
answer lies past its first j + 1 allowed targets, a later candidate's
allowed target that an earlier one gave up as its source, plans of 512
PGs an OSD, whose shortlists filter their pool's first 64 targets, also
where those all share a member's domain, the change budget
spent inside a round, more candidates than a group (and more than a
top-B pass), every OSD a candidate, rows of one member and of W_CAP,
the more_overfull takeover, and many rounds that change PGs again.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu.balancer import upmap as jax_upmap  # noqa: E402
from ceph_tpu_torch.balancer import upmap  # noqa: E402
from test_torch_upmap_kernel_host import (  # noqa: E402
    GRIDS,
    assert_same_outputs,
    body,  # noqa: F401 (the fixture)
    run_body,
)

GROUP = 16  # upmap_loop.cuh GROUP: candidates resolved together
TOPK = 32  # upmap_loop.cuh TOPK: top-B entries a selection pass takes
W_CAP = 32  # upmap_loop.cuh W_CAP
ITEM_NONE = 0x7FFFFFFF
DOM_NONE = 0x7FFFFFFF


def operands(seed: int, npg: int, w: int, dv: int, *, npool: int = 2,
             host: int = 4, skew: float = 0.5, heavy: int = 0,
             steps: tuple = (), no_weight: float = 0.05,
             holes: float = 0.03, frozen: float = 0.02,
             not_ok: float = 0.05, not_in_rule: float = 0.03):
    """loop_plan's eight operands: rows of w distinct OSDs drawn with
    weights (skew spreads them; `heavy` OSDs get 8 times the target of
    the rest, so they are the most underfull; with `steps`, OSD d's target
    sets its deviation to steps[d % len(steps)], so deviations tie), some
    slots ITEM_NONE or -1, pool positions (some out of range, as the plan
    clamps them), frozen PGs, failure domains of `host` OSDs
    (some OSDs outside a pool's rule) and OSDs no pool may target."""
    rng = np.random.default_rng(seed)
    weight = rng.uniform(1.0 - skew, 1.0 + skew, dv)
    weight[:heavy] *= 8.0
    weight[rng.random(dv) < no_weight] = 0.0
    pick_p = rng.uniform(0.5, 1.5, dv)
    pick_p /= pick_p.sum()
    # w distinct OSDs a row, drawn by pick_p (Gumbel top-w)
    keys = np.log(pick_p)[None, :] + rng.gumbel(size=(npg, dv))
    rows = np.argsort(-keys, axis=1)[:, :w].astype(np.int32)
    hole = rng.random((npg, w)) < holes
    rows[hole] = np.where(rng.random(int(hole.sum())) < 0.5, ITEM_NONE, -1)
    valid = (rows >= 0) & (rows < dv)
    counts = np.bincount(rows[valid], minlength=dv).astype(np.int64)
    target = np.where(weight > 0.0, weight / max(weight.sum(), 1e-9)
                      * counts.sum(), 0.0)
    if steps:
        step = np.asarray(steps, np.float64)[np.arange(dv) % len(steps)]
        target = np.where(weight > 0.0, counts - step, 0.0)
    pidx = rng.integers(0, npool, npg).astype(np.int32)
    pidx[rng.random(npg) < 0.01] = -1
    pidx[rng.random(npg) < 0.01] = npool
    movable = rng.random(npg) >= frozen
    dom_tbl = np.tile((np.arange(dv) // host).astype(np.int32), (npool, 1))
    dom_tbl[rng.random((npool, dv)) < not_in_rule] = DOM_NONE
    tgt_ok = rng.random((npool, dv)) >= not_ok
    return (rows, pidx, movable, dom_tbl, tgt_ok, target.astype(np.float64),
            weight.astype(np.float64), counts)


# name -> (operands kwargs, max_dev, budget, nbatch)
CASES = {
    # one OSD far below its target, allowed for nearly every candidate
    # (one-OSD domains, every OSD a target): most candidates' first
    # allowed target is that OSD, and all but the first skip past it
    "same_best_target": (dict(seed=1, npg=1500, w=3, dv=48, host=1,
                              heavy=1, not_ok=0.0, not_in_rule=0.0,
                              holes=0.0), 2.0, 64, 16),
    # deviations on four values: most of them tie
    "equal_deviations": (dict(seed=2, npg=1600, w=3, dv=40,
                              steps=(-6.0, -2.0, 3.0, 7.0), no_weight=0.0),
                         1.0, 64, 16),
    # max_dev < 0: an OSD with max_dev < dev < 0 is overfull and a target,
    # so a source can be one an earlier candidate took as its target
    "frm_was_target": (dict(seed=594300, npg=600, w=3, dv=32,
                            steps=(2.0, -1.0, -1.0, 5.0, -2.0), not_ok=0.2,
                            not_in_rule=0.0, no_weight=0.0), -2.5, 64, 16),
    # and the sources accepted early in a round are also the first
    # targets of a later candidate: its answer lies past its first j + 1
    # allowed targets (the shortlist of 2j + 1 reaches it)
    "shortlist_full": (dict(seed=570955, npg=600, w=3, dv=48,
                            steps=(-0.5, -0.5, -3.0), not_ok=0.2,
                            not_in_rule=0.0, no_weight=0.0), -2.5, 64, 16),
    # a source accepted early in a round is an allowed target of a later
    # candidate, ahead of its answer: the uses a later shortlist skips
    # include the earlier sources
    "source_in_later_shortlist": (dict(seed=387182, npg=600, w=3, dv=24,
                                       steps=(0.5, -2.5, -0.5, -2.5),
                                       not_ok=0.2, not_in_rule=0.0,
                                       no_weight=0.0), -0.75, 64, 16),
    # 512 PGs an OSD: the shortlists filter their pool's first 64 targets
    "prefix": (dict(seed=12, npg=512 * 24, w=3, dv=24, host=2), 1.0, 32,
               16),
    # and the 64 most underfull OSDs form one failure domain: a candidate
    # with another member there finds no target among its pool's first 64
    # and selects from every OSD
    "prefix_exhausted": (dict(seed=11, npg=512 * 160, w=3, dv=160,
                              host=64, npool=1,
                              steps=(-20.0,) * 64 + (5.0, -2.0, 3.0) * 32,
                              not_ok=0.0, not_in_rule=0.0, no_weight=0.0),
                         1.0, 64, 16),
    # the change budget runs out inside the first round
    "budget_mid_round": (dict(seed=4, npg=1500, w=3, dv=48, skew=0.8), 1.0,
                         5, 16),
    # more candidates than a group (three groups) and than a top-B pass
    "nbatch_over_group": (dict(seed=5, npg=3000, w=3, dv=96, skew=0.8),
                          1.0, 40, 40),
    # every OSD a candidate
    "nbatch_dv": (dict(seed=6, npg=800, w=3, dv=24, host=2), 1.0, 24, 24),
    # rows of one member: the slot's own domain is the only one left out
    "w1": (dict(seed=7, npg=1200, w=1, dv=32), 1.0, 32, 16),
    # rows as wide as the kernel takes
    "w_cap": (dict(seed=8, npg=600, w=W_CAP, dv=96, host=2), 1.0, 32, 16),
    # only underfull OSDs beyond max_dev: the more_overfull takeover
    "takeover": (dict(seed=9, npg=1500, w=3, dv=48,
                      steps=(-30.0, 2.0, 3.0, 4.0, 1.0, 5.0, 3.0, -1.0)),
                 10.0, 24, 16),
    # small batches, many rounds: PGs change again (the overlay's rows)
    "many_rounds": (dict(seed=10, npg=400, w=3, dv=32, skew=0.9), 0.5, 64,
                    2),
}


def run_jax(ops, max_dev, budget, nbatch, ncap):
    npg, w = ops[0].shape
    dv, npool = ops[5].shape[0], ops[3].shape[0]
    acct = jax_upmap._loop_account(npg, w, dv, npool, nbatch, ncap, 0)
    out = acct(*ops, np.float64(max_dev), np.int32(budget))
    (cpg, cfrm, cto, crnd, crows, n_chg, n_rej, rounds,
     counts) = (np.asarray(x) for x in out[:9])
    n = int(n_chg)
    return (cpg[:n], cfrm[:n], cto[:n], crnd[:n], crows[:n], int(n_rej),
            int(rounds), counts)


def plans(name):
    kw, max_dev, budget, nbatch = CASES[name]
    ops = operands(**kw)
    ncap = -(-budget // 8) * 8
    jax = run_jax(ops, max_dev, budget, nbatch, ncap)
    args = tuple(torch.from_numpy(a) for a in ops) + (
        max_dev, budget, nbatch, ncap)
    plain = upmap._loop_plan(*args)
    return ops, (max_dev, budget, nbatch, ncap), jax, plain


def round_of(out, r):
    """(cfrm, cto) of the changes of round r (1-based)."""
    crnd = np.asarray(out[3])
    return np.asarray(out[1])[crnd == r], np.asarray(out[2])[crnd == r]


@pytest.mark.parametrize("name", sorted(CASES))
def test_resolve_equals_plain_and_jax(name, body):
    ops, rest, jax, plain = plans(name)
    assert_same_outputs(jax, plain, f"{name}: plain against JAX")
    for blocks in GRIDS:
        got = run_body(body, ops + rest, blocks)
        assert_same_outputs(jax, got, f"{name}: body of {blocks} blocks")
    assert len(jax[0]) > 0, f"{name}: the plan changes nothing"


def test_cases_reach_what_they_are_for():
    """Each case is built for a path of the resolve; this holds that the
    plans take it."""
    ops, (max_dev, budget, nbatch, _), jax, _ = plans("same_best_target")
    target, counts = ops[5], ops[7]
    low = int(np.argmin(counts - target))
    frm1, to1 = round_of(jax, 1)
    assert low in to1 and len(to1) >= 3 and len(set(to1)) == len(to1)

    ops, _, jax, _ = plans("equal_deviations")
    dev = ops[7] - ops[5]
    assert len(np.unique(dev)) <= 5 < len(dev)

    for name in ("frm_was_target", "shortlist_full",
                 "source_in_later_shortlist"):
        ops, (max_dev, *_), jax, _ = plans(name)
        dev = ops[7] - ops[5]
        assert ((dev > max_dev) & (dev < 0.0)).sum() >= 4, name

    _, (_, budget, nbatch, _), jax, _ = plans("budget_mid_round")
    assert len(jax[0]) == budget and jax[6] == 1 and budget < nbatch

    _, (_, _, nbatch, _), jax, _ = plans("nbatch_over_group")
    assert nbatch > TOPK > GROUP and len(round_of(jax, 1)[0]) > GROUP

    ops, (*_, nbatch, _), _, _ = plans("nbatch_dv")
    assert nbatch == len(ops[5])

    ops, (max_dev, *_), jax, _ = plans("takeover")
    dev = np.where(ops[6] > 0.0, ops[7] - ops[5], 0.0)
    assert not (dev > max_dev).any() and (dev < -max_dev).any()

    _, _, jax, _ = plans("many_rounds")
    assert jax[6] >= 5 and len(np.unique(jax[0])) < len(jax[0])
