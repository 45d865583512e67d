"""The CRUSH rule interpreter on the card: crush_do_rule for a batch of
placement seeds.

Port of `ceph_tpu/crush/mapper_jax.py` (and `mapper_ref.find_rule`).  The
JAX package unrolls each (map, rule) into an XLA program with a bounded
candidate window and a loop-kernel rescue for the lanes the window could
not decide.  The port has one exact path:

- `compile_rule` is the plan pass: it checks that the map and rule are in
  scope (every bucket algorithm, no legacy local retries) and freezes the
  rule's steps and tunables into a `RuleProgram`;
- `crush_rule_cuda` launches the hand-written kernel
  (`crush/csrc/crush_rule.cu`, one thread per seed, the C interpreter's
  control flow over the map's packed records, a persistent grid) and
  counts its launches; `launch_plan` and `staged_records` are what it
  sizes the launch and the shared-memory staging from;
- `crush_rule_plain` computes the same function in lane-vectorised torch
  int64 ops (each retry loop a `while` over the still-active lanes), and
  counts the straw2 draws each lane made (or, by algorithm, the hash
  calls of its draws); with `diag=True` it also returns the decision
  planes of each lane (see below);
- `map_rule` dispatches on where the seeds lie: a CPU tensor goes to the
  plain version, a CUDA tensor to the kernel (or the call raises).

The diagnostics (the JAX package's `compile_rule(..., with_diag=True)`):
`crush_rule_diag_cuda` launches the kernel's diagnostics variant
(`crush/csrc/crush_rule_diag.cu`), which returns, beside the rows, each
lane's retry count of every placement (`tries`, the reference's
choose_tries histogram before it is summed), its collision, out-of-weight
and skip tallies, a bad-mapping flag and the work vector after each
choose step; `diag_rule` dispatches it as `map_rule` does the rows.  The
lane layout is the plan's (`RuleProgram.diag_plan`).  Unlike the JAX
package's window reconstruction, every lane is exact on every plan.

Inputs are u32 values: seeds and reweights may be given in any integer
dtype (int32 holds their bit patterns).  Rows are int32 [N, result_max],
padded with ITEM_NONE, as `compile_rule`'s fn returns them.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ceph_tpu_torch import build
from ceph_tpu_torch.core.intmath import div_trunc_s64
from ceph_tpu_torch.core.lntable import crush_ln, ln_tables
from ceph_tpu_torch.core.rjenkins import (
    M32,
    crush_hash32_2,
    crush_hash32_3,
    crush_hash32_4,
)
from ceph_tpu_torch.crush.soa import CrushArrays, DeviceArrays
from ceph_tpu_torch.crush.types import (
    ITEM_NONE,
    ITEM_UNDEF,
    BucketAlg,
    CrushMap,
    RuleOp,
)

RMAX_CAP = 32  # the kernel's longest row (crush_rule.cuh)
N_ALGS = 6  # BucketAlg values index the hash counts (0 is no algorithm)
RECORD_BYTES = 16  # one packed record (crush_rule.cuh Record)
BLOCK = 1 << 24  # seeds per kernel launch (map_rule)
PLAIN_CHUNK = 65536  # seeds per pass of the plain version: bounds its
                     # [chunk, max_size] temporaries
S64_MIN = -(2**63)

# descent outcomes (crush_rule.cuh)
_DESCENDING, _FOUND, _SKIP, _EMPTY = 0, 1, 2, 3

_CHOOSE_OPS = (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSELEAF_FIRSTN,
               RuleOp.CHOOSE_INDEP, RuleOp.CHOOSELEAF_INDEP)


def find_rule(map_: CrushMap, ruleset: int, type_: int, size: int) -> int:
    """reference src/crush/mapper.c:41-54."""
    for i, r in enumerate(map_.rules):
        if (
            r is not None
            and r.ruleset == ruleset
            and r.type == type_
            and r.min_size <= size <= r.max_size
        ):
            return i
    return -1


@dataclass(frozen=True)
class RuleProgram:
    """One rule of one map, ready for the kernel and its plain version.

    The diagnostics' lane layout (crush_rule.cuh Diag): diag_plan[s] is
    rule step s's first tries lane, its lanes per source bucket and its
    row of the steps plane, -1s where the step is not a choose step a
    lane can reach; diag_lanes and diag_steps are the planes' widths;
    diag_retry_lanes marks the lanes whose -1 is a placement that never
    succeeded (every lane but chooseleaf indep's per-round leaf calls,
    whose -1 is a call not made).  diag_tries_bound is the reference
    histogram's last index; diag_exact is True: every lane is exact."""

    ruleno: int
    result_max: int
    steps: np.ndarray  # int32 [n_steps, 3]: op, arg1, arg2
    choose_total_tries: int
    chooseleaf_descend_once: int
    chooseleaf_vary_r: int
    chooseleaf_stable: int
    diag_plan: np.ndarray  # int32 [n_steps, 3]
    diag_lanes: int
    diag_steps: int
    diag_retry_lanes: np.ndarray  # bool [diag_lanes]
    _dev: dict = field(default_factory=dict, compare=False, repr=False)
    diag_exact = True  # a class constant: every lane is exact

    @property
    def diag_tries_bound(self) -> int:
        return self.choose_total_tries

    def _on(self, name: str, device: torch.device) -> torch.Tensor:
        t = self._dev.get((name, device))
        if t is None:
            a = getattr(self, name)
            t = torch.from_numpy(a.reshape(-1).copy()).to(device)
            self._dev[(name, device)] = t
        return t

    def steps_on(self, device: torch.device) -> torch.Tensor:
        """The steps as an int32 tensor on `device`, uploaded once."""
        return self._on("steps", device)

    def diag_plan_on(self, device: torch.device) -> torch.Tensor:
        """diag_plan as an int32 tensor on `device`, uploaded once."""
        return self._on("diag_plan", device)


def _diag_layout(A: CrushArrays, steps: list, result_max: int,
                 choose_total_tries: int):
    """The diagnostics' lane layout, by the static bound on each step's
    sources that mapper_jax.compile_rule's plan keeps (wbound): a take of
    an item sets it to 1, a choose step multiplies it by its reps (at most
    result_max), an emit clears it.  Per source bucket, a firstn step has
    numrep lanes (2 * numrep for chooseleaf: the leaf recursion's
    placements), an indep step one (plus reps * tries for chooseleaf's
    leaf calls, one per rep and round).  Unlike the JAX plan, a step with
    numrep <= 0 has a steps row (it empties the work vector, as the
    reference does) and no lane.  Returns (plan, lanes, steps, retry
    lane mask)."""
    plan = np.full((len(steps), 3), -1, np.int32)
    retry: list[bool] = []
    wbound, n_rows = 0, 0
    tries = choose_total_tries + 1
    for s, (op, a1, _) in enumerate(steps):
        if op == RuleOp.TAKE:
            if (0 <= a1 < A.max_devices) or (a1 < 0 and -1 - a1 < A.n_buckets):
                wbound = 1
        elif op == RuleOp.SET_CHOOSE_TRIES and a1 > 0:
            tries = a1
        elif op == RuleOp.EMIT:
            wbound = 0
        elif op in _CHOOSE_OPS and wbound:
            numrep = a1 if a1 > 0 else a1 + result_max
            nr = min(max(numrep, 0), result_max)
            firstn = op in (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSELEAF_FIRSTN)
            leafy = op in (RuleOp.CHOOSELEAF_FIRSTN, RuleOp.CHOOSELEAF_INDEP)
            if numrep <= 0:
                per = []
            elif firstn:
                per = [True] * (numrep * (2 if leafy else 1))
            else:
                per = [True] + [False] * (nr * tries if leafy else 0)
            plan[s] = (len(retry), len(per), n_rows)
            retry += per * wbound
            n_rows += 1
            wbound = min(wbound * nr, result_max)
    return plan, len(retry), n_rows, np.asarray(retry, bool)


def compile_rule(A: CrushArrays, ruleno: int, result_max: int) -> RuleProgram:
    """The plan pass.  Raises NotImplementedError for the legacy
    local-retry tunables and rule steps (which the JAX kernel refuses too;
    the host oracle, `crush/mapper_ref.py`, maps them)."""
    t = A.tunables
    if t.choose_local_tries or t.choose_local_fallback_tries:
        raise NotImplementedError(
            "legacy local-retry tunables: not yet ported")
    if not 0 <= ruleno < len(A.rules) or A.rules[ruleno] is None:
        raise ValueError(f"no rule {ruleno}")
    if result_max < 1:
        raise ValueError(f"result_max {result_max} < 1")
    steps = [(int(op), int(a1), int(a2)) for op, a1, a2 in
             A.rules[ruleno].steps]
    for op, a1, _ in steps:
        if op in (RuleOp.SET_CHOOSE_LOCAL_TRIES,
                  RuleOp.SET_CHOOSE_LOCAL_FALLBACK_TRIES) and a1 > 0:
            raise NotImplementedError(
                "legacy local-retry rule steps: not yet ported")
    plan, lanes, n_rows, retry = _diag_layout(A, steps, result_max,
                                              t.choose_total_tries)
    return RuleProgram(
        ruleno=ruleno, result_max=result_max,
        steps=np.asarray(steps, np.int32).reshape(-1, 3),
        choose_total_tries=t.choose_total_tries,
        chooseleaf_descend_once=t.chooseleaf_descend_once,
        chooseleaf_vary_r=t.chooseleaf_vary_r,
        chooseleaf_stable=t.chooseleaf_stable,
        diag_plan=plan, diag_lanes=lanes, diag_steps=n_rows,
        diag_retry_lanes=retry,
    )


def u32_bits(t: torch.Tensor) -> torch.Tensor:
    """u32 values of any integer dtype -> int32 with the same bits."""
    t = t.long() & M32
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def _weight_vector(weight: torch.Tensor) -> torch.Tensor:
    """An empty reweight vector marks every device out, as [0] does."""
    if weight.numel() == 0:
        return torch.zeros(1, dtype=weight.dtype, device=weight.device)
    return weight


# -- the plain version --------------------------------------------------------

def _place(dst: torch.Tensor, rows: torch.Tensor, at: torch.Tensor,
           vals: torch.Tensor, n: torch.Tensor) -> None:
    """dst[rows, at + j] = vals[:, j] for j < n, where it fits.  dst has a
    spare last column that takes the writes that do not (torch's scatter
    has no drop mode)."""
    width = dst.shape[1] - 1
    col = torch.arange(vals.shape[1], device=dst.device)
    idx = at[:, None] + col
    keep = (col < n[:, None]) & (idx < width)
    sub = dst[rows]
    sub.scatter_(1, torch.where(keep, idx, width),
                 torch.where(keep, vals, ITEM_NONE))
    dst[rows] = sub


class _Lanes:
    """One chunk of seeds through the rule, lane-vectorised.  Every method
    takes `lanes`, the chunk indices of the lanes it works on, and
    per-lane tensors aligned with them; the control flow is
    crush_rule.cuh's, with each loop run over the lanes still in it."""

    def __init__(self, T: DeviceArrays, x: torch.Tensor,
                 weight: torch.Tensor, prog: RuleProgram | None = None):
        self.T = T
        self.x = x
        self.weight = weight
        # hash calls of each lane's draws, by bucket algorithm
        self.hashes = torch.zeros((x.numel(), N_ALGS), dtype=torch.long,
                                  device=x.device)
        self.col_s = torch.arange(T.max_size, device=x.device)
        # with a program: the diagnostics planes (crush_rule.cuh Diag)
        self.diag = prog is not None
        if self.diag:
            K, dev = x.numel(), x.device
            self.tries = torch.full((K, prog.diag_lanes), -1,
                                    dtype=torch.long, device=dev)
            self.tally = torch.zeros((K, 4), dtype=torch.long, device=dev)
            self.steps = torch.full((K, prog.diag_steps, prog.result_max),
                                    ITEM_NONE, dtype=torch.long, device=dev)

    def _count(self, alg, lanes, n):
        self.hashes[:, alg].index_add_(0, lanes, n)

    def _tally(self, col: int, lanes, hit) -> None:
        """Add one to tally column col (coll, rej, skip) where hit."""
        if self.diag:
            self.tally[:, col].index_add_(0, lanes, hit.long())

    def _first(self, hit):
        """The first column where `hit` holds per row (max_size if none)."""
        return torch.where(hit, self.col_s, self.T.max_size).amin(1)

    def straw2(self, lanes, slot, r, pos):
        """reference src/crush/mapper.c:334-384, for bucket `slot` per lane."""
        T = self.T
        w = T.pos_weights[pos.clamp(max=T.positions - 1), slot].long() & M32
        live = (w > 0) & (self.col_s < T.size[slot, None])
        u = crush_hash32_3(self.x[lanes, None], T.arg_ids[slot],
                           r[:, None]) & 0xFFFF
        draw = div_trunc_s64(crush_ln(u) - (1 << 48), w.clamp(min=1))
        draw = draw.masked_fill(~live, S64_MIN)
        # the first maximum wins
        first = self._first(draw == draw.amax(1, keepdim=True))
        self._count(BucketAlg.STRAW2, lanes, live.sum(1))
        return T.items[slot, first].long()

    # The legacy draws ignore choose_args and the position: they hash the
    # bucket's own items and read its own weights (reference
    # src/crush/mapper.c:387-418 passes a weight set to straw2 only).

    def straw(self, lanes, slot, r):
        """reference src/crush/mapper.c:227-245."""
        T = self.T
        live = self.col_s < T.size[slot, None]
        u = crush_hash32_3(self.x[lanes, None], T.items[slot],
                           r[:, None]) & 0xFFFF
        draw = (u * (T.straws[slot].long() & M32)).masked_fill(~live, -1)
        first = self._first(draw == draw.amax(1, keepdim=True))
        self._count(BucketAlg.STRAW, lanes, live.sum(1))
        return T.items[slot, first].long()

    def list_(self, lanes, slot, r):
        """reference src/crush/mapper.c:141-164: the last item whose
        scaled hash falls under its weight, else the first."""
        T = self.T
        size = T.size[slot].long()
        live = self.col_s < size[:, None]
        u = crush_hash32_4(self.x[lanes, None], T.items[slot], r[:, None],
                           -1 - slot[:, None]) & 0xFFFF
        w = (u * (T.sum_weights[slot].long() & M32)) >> 16
        hit = live & (w < (T.weights[slot].long() & M32))
        last = torch.where(hit, self.col_s, -1).amax(1)
        self._count(BucketAlg.LIST, lanes,
                    torch.where(last >= 0, size - last, size))
        return T.items[slot, last.clamp(min=0)].long()

    def tree(self, lanes, slot, r):
        """reference src/crush/mapper.c:195-222: down the node-weight heap
        to an odd node."""
        T = self.T
        nw = T.node_weights[slot].long() & M32
        n = (T.num_nodes[slot].long() >> 1)
        x = self.x[lanes]
        bid = -1 - slot
        while True:
            a = ((n > 0) & (n & 1 == 0)).nonzero()[:, 0]
            if a.numel() == 0:
                break
            na = n[a]
            h = crush_hash32_4(x[a], na, r[a], bid[a])
            w = nw[a, na]
            # (h * w) >> 32 for u32 h, w, without overflowing int64
            hi, lo = (h >> 16) * w, (h & 0xFFFF) * w
            t = (hi >> 16) + ((((hi & 0xFFFF) << 16) + lo) >> 32)
            half = (na & -na) >> 1
            left = na - half
            n[a] = torch.where(t < nw[a, left], left, na + half)
            self._count(BucketAlg.TREE, lanes[a], torch.ones_like(a))
        return T.items[slot, n >> 1].long()

    def uniform(self, lanes, slot, r):
        """reference src/crush/mapper.c:73-131: items[perm[r % size]],
        with perm[pr] traced backward through the Fisher-Yates steps
        0..pr, as crush_rule.cuh::uniform_choose does."""
        T = self.T
        size = T.size[slot].long().clamp(min=1)
        bid = -1 - slot
        x = self.x[lanes]
        pr = r % size
        q = pr.clone()
        a = (pr + 1 < size).nonzero()[:, 0]
        if a.numel():
            q[a] += crush_hash32_3(x[a], bid[a], pr[a]) % (size[a] - pr[a])
        self._count(BucketAlg.UNIFORM, lanes[a], torch.ones_like(a))
        for p in range(int(pr.max()) - 1 if pr.numel() else -1, -1, -1):
            a = (p < pr).nonzero()[:, 0]
            h = crush_hash32_3(x[a], bid[a], p) % (size[a] - p)
            q[a] = torch.where(p + h == q[a], p, q[a])
            self._count(BucketAlg.UNIFORM, lanes[a], torch.ones_like(a))
        return T.items[slot, q].long()

    def choose(self, lanes, slot, r, pos):
        """crush_rule.cuh::bucket_choose: the draw of bucket `slot`'s
        algorithm, per lane."""
        alg = self.T.alg[slot]
        item = torch.empty_like(slot, dtype=torch.long)
        for a in alg.unique().tolist():
            sel = (alg == a).nonzero()[:, 0]
            ln, sl, rr = lanes[sel], slot[sel], r[sel]
            if a == BucketAlg.STRAW2:
                item[sel] = self.straw2(ln, sl, rr, pos[sel])
            elif a == BucketAlg.STRAW:
                item[sel] = self.straw(ln, sl, rr)
            elif a == BucketAlg.LIST:
                item[sel] = self.list_(ln, sl, rr)
            elif a == BucketAlg.TREE:
                item[sel] = self.tree(ln, sl, rr)
            elif a == BucketAlg.UNIFORM:
                item[sel] = self.uniform(ln, sl, rr)
            else:
                item[sel] = self.T.items[sl, 0].long()
        return item

    def is_out(self, lanes, item):
        """reference src/crush/mapper.c:424-438."""
        D = self.weight.numel()
        w = self.weight[item.clamp(0, D - 1)]
        frac = (crush_hash32_2(self.x[lanes], item) & 0xFFFF) >= w
        return (item >= D) | ((w < 0x10000) & ((w == 0) | frac))

    def descend(self, lanes, start, r, pos, target, numrep=0, r_uniform=None):
        """crush_rule.cuh::descend: (item, status, r of the last draw) per
        lane.  With numrep > 0 (indep), a uniform bucket whose size numrep
        divides draws with r_uniform."""
        T = self.T
        item = start.clone()
        status = torch.full_like(start, _DESCENDING)
        r_last = r.clone()
        for _ in range(T.max_depth + 1):
            a = (status == _DESCENDING).nonzero()[:, 0]
            if a.numel() == 0:
                break
            slot = -1 - item[a]
            rb = r[a]
            if numrep > 0:
                uni = ((T.alg[slot] == BucketAlg.UNIFORM)
                       & (T.size[slot] % numrep == 0))
                rb = torch.where(uni, r_uniform[a], rb)
            r_last[a] = rb
            nonempty = T.size[slot] > 0
            nxt = torch.full_like(slot, ITEM_NONE, dtype=torch.long)
            ne = nonempty.nonzero()[:, 0]
            nxt[ne] = self.choose(lanes[a[ne]], slot[ne], rb[ne], pos[a[ne]])
            is_b = nxt < 0
            dangling = is_b & (-1 - nxt >= T.n_buckets)
            ntype = torch.where(
                is_b, T.btype[(-1 - nxt).clamp(0, T.n_buckets - 1)].long(), 0)
            st = torch.where(ntype == target, _FOUND,
                             torch.where(is_b, _DESCENDING, _SKIP))
            st = torch.where((nxt >= T.max_devices) | dangling, _SKIP, st)
            st = torch.where(nonempty, st, _EMPTY)
            item[a] = torch.where(st == _EMPTY, item[a], nxt)
            status[a] = st
        status[status == _DESCENDING] = _SKIP
        return item, status, r_last

    def leaf_firstn(self, lanes, bucket, r0, outpos, out2, tries):
        """crush_rule.cuh::leaf_firstn: (ok, leaf, retry count of the
        pick) per lane."""
        k = lanes.numel()
        col = torch.arange(out2.shape[1], device=lanes.device)
        ok = torch.zeros(k, dtype=torch.bool, device=lanes.device)
        leaf = torch.full_like(bucket, ITEM_NONE)
        ftotal = torch.zeros_like(bucket)
        pend = torch.ones_like(ok)
        while True:
            a = pend.nonzero()[:, 0]
            if a.numel() == 0:
                return ok, leaf, ftotal
            item, st, _ = self.descend(lanes[a], bucket[a],
                                       r0[a] + ftotal[a], outpos[a], 0)
            found = st == _FOUND
            collide = ((out2[a] == item[:, None])
                       & (col < outpos[a, None])).any(1)
            out = self.is_out(lanes[a], item)
            good = found & ~collide & ~out
            self._tally(0, lanes[a], found & collide)
            self._tally(1, lanes[a], found & ~collide & out)
            self._tally(2, lanes[a], st == _SKIP)
            ok[a[good]] = True
            leaf[a[good]] = item[good]
            fail = ~good & (st != _SKIP)
            ftotal[a[fail]] += 1
            pend[a] = fail & (ftotal[a] < tries)

    def choose_firstn(self, lanes, src, count, *, numrep, target, leafy,
                      tries, recurse_tries, vary_r, stable, width, base=0):
        """crush_rule.cuh::choose_firstn: (out, out2, n placed) per lane;
        `base` is the source's first tries lane."""
        k = lanes.numel()
        dev = lanes.device
        col = torch.arange(width, device=dev)
        out = torch.full((k, width), ITEM_NONE, dtype=torch.long, device=dev)
        out2 = out.clone()
        outpos = torch.zeros(k, dtype=torch.long, device=dev)
        count = count.clone()
        for rep in range(numrep):
            pend = count > 0
            ftotal = torch.zeros_like(outpos)
            while True:
                a = pend.nonzero()[:, 0]
                if a.numel() == 0:
                    break
                r = rep + ftotal[a]
                item, st, _ = self.descend(lanes[a], src[a], r, outpos[a],
                                           target)
                found = st == _FOUND
                collide = found & ((out[a] == item[:, None])
                                   & (col < outpos[a, None])).any(1)
                reject = torch.zeros_like(found)
                leaf = item.clone()
                leaf_tries = torch.full_like(item, -1)
                if leafy:
                    b = (found & ~collide & (item < 0)).nonzero()[:, 0]
                    if b.numel():
                        ab = a[b]
                        sub_r = r[b] >> (vary_r - 1) if vary_r else 0
                        r0 = (0 if stable else outpos[ab]) + sub_r
                        ok, lf, lt = self.leaf_firstn(
                            lanes[ab], item[b], r0 + torch.zeros_like(ab),
                            outpos[ab], out2[ab], recurse_tries)
                        reject[b] = ~ok
                        leaf[b] = lf
                        leaf_tries[b] = lt
                if target == 0:
                    out_rej = (found & ~collide & ~reject
                               & self.is_out(lanes[a], item))
                    reject |= out_rej
                    self._tally(1, lanes[a], out_rej)
                self._tally(0, lanes[a], collide)
                self._tally(2, lanes[a], st == _SKIP)
                placed = found & ~collide & ~reject
                p = a[placed]
                out[p, outpos[p]] = item[placed]
                out2[p, outpos[p]] = leaf[placed]
                outpos[p] += 1
                count[p] -= 1
                if self.diag:
                    self.tries[lanes[p], base + rep] = ftotal[p]
                    if leafy:
                        self.tries[lanes[p], base + numrep + rep] = \
                            leaf_tries[placed]
                fail = (st == _EMPTY) | (found & ~placed)
                ftotal[a[fail]] += 1
                pend[a] = fail & (ftotal[a] < tries)
        return out, out2, outpos

    def leaf_indep(self, lanes, bucket, rep, parent_r, numrep, tries):
        """crush_rule.cuh::leaf_indep: (the leaf or ITEM_NONE, the rounds
        the inner call ran) per lane."""
        res = torch.full_like(bucket, ITEM_NONE)
        rounds = torch.full_like(bucket, tries)
        pend = torch.ones_like(bucket, dtype=torch.bool)
        pos = torch.full_like(bucket, rep)
        for ftotal in range(tries):
            a = pend.nonzero()[:, 0]
            if a.numel() == 0:
                break
            item, st, _ = self.descend(
                lanes[a], bucket[a], rep + parent_r[a] + numrep * ftotal,
                pos[a], 0, numrep, rep + parent_r[a] + (numrep + 1) * ftotal)
            good = (st == _FOUND) & ~self.is_out(lanes[a], item)
            res[a[good]] = item[good]
            pend[a] = ~good & (st != _SKIP)
            rounds[a[~pend[a]]] = ftotal + 1
        return res, rounds

    def choose_indep(self, lanes, src, out_size, *, numrep, target, leafy,
                     tries, recurse_tries, width, base=0):
        """crush_rule.cuh::choose_indep: (out, out2) per lane; `base` is
        the source's first tries lane."""
        dev = lanes.device
        col = torch.arange(width, device=dev)
        out = torch.where(col < out_size[:, None], ITEM_UNDEF, ITEM_NONE)
        out2 = out.clone()
        zero = torch.zeros_like(src)
        rounds = torch.zeros_like(src)
        for ftotal in range(tries):
            live = (out == ITEM_UNDEF).any(1)  # left > 0
            if not live.any():
                break
            rounds += live
            for rep in range(width):
                a = (out[:, rep] == ITEM_UNDEF).nonzero()[:, 0]
                if a.numel() == 0:
                    continue
                item, st, r = self.descend(
                    lanes[a], src[a], zero[a] + rep + numrep * ftotal,
                    zero[a], target, numrep,
                    zero[a] + rep + (numrep + 1) * ftotal)
                skip = a[st == _SKIP]
                out[skip, rep] = ITEM_NONE
                out2[skip, rep] = ITEM_NONE
                go = (st == _FOUND) & ~(out[a] == item[:, None]).any(1)
                if leafy:
                    dv = go & (item >= 0)
                    out2[a[dv], rep] = item[dv]
                    b = (go & (item < 0)).nonzero()[:, 0]
                    if b.numel():
                        lf, lr = self.leaf_indep(lanes[a[b]], item[b], rep,
                                                 r[b], numrep, recurse_tries)
                        out2[a[b], rep] = lf
                        go[b] = lf != ITEM_NONE
                        if self.diag:
                            self.tries[lanes[a[b]],
                                       base + 1 + rep * tries + ftotal] = lr
                if target == 0:
                    go &= ~self.is_out(lanes[a], item)
                out[a[go], rep] = item[go]
        if self.diag:
            self.tries[lanes, base] = rounds
        out[out == ITEM_UNDEF] = ITEM_NONE
        out2[out2 == ITEM_UNDEF] = ITEM_NONE
        return out, out2

    def run(self, prog: RuleProgram) -> torch.Tensor:
        """crush_rule.cuh::do_rule for every lane of the chunk."""
        T = self.T
        K = self.x.numel()
        dev = self.x.device
        RMAX = prog.result_max
        all_lanes = torch.arange(K, device=dev)
        result = torch.full((K, RMAX + 1), ITEM_NONE, dtype=torch.long,
                            device=dev)
        rlen = torch.zeros(K, dtype=torch.long, device=dev)
        w = torch.full((K, RMAX), ITEM_NONE, dtype=torch.long, device=dev)
        wsize = torch.zeros_like(rlen)
        choose_tries = prog.choose_total_tries + 1
        leaf_tries = 0
        vary_r = prog.chooseleaf_vary_r
        stable = prog.chooseleaf_stable
        col = torch.arange(RMAX, device=dev)
        for s, (op, arg1, arg2) in enumerate(prog.steps.tolist()):
            if op == RuleOp.TAKE:
                if (0 <= arg1 < T.max_devices) or (
                        arg1 < 0 and -1 - arg1 < T.n_buckets):
                    w[:, 0] = arg1
                    wsize[:] = 1
            elif op == RuleOp.SET_CHOOSE_TRIES:
                if arg1 > 0:
                    choose_tries = arg1
            elif op == RuleOp.SET_CHOOSELEAF_TRIES:
                if arg1 > 0:
                    leaf_tries = arg1
            elif op == RuleOp.SET_CHOOSELEAF_VARY_R:
                if arg1 >= 0:
                    vary_r = arg1
            elif op == RuleOp.SET_CHOOSELEAF_STABLE:
                if arg1 >= 0:
                    stable = arg1
            elif op in _CHOOSE_OPS:
                has = wsize > 0  # a lane without sources keeps w as it is
                firstn = op in (RuleOp.CHOOSE_FIRSTN,
                                RuleOp.CHOOSELEAF_FIRSTN)
                leafy = op in (RuleOp.CHOOSELEAF_FIRSTN,
                               RuleOp.CHOOSELEAF_INDEP)
                o = torch.full((K, RMAX + 1), ITEM_NONE, dtype=torch.long,
                               device=dev)
                osize = torch.zeros_like(rlen)
                numrep = arg1 if arg1 > 0 else arg1 + RMAX
                width = min(max(numrep, 1), RMAX)
                lane0, per, row = prog.diag_plan[s].tolist()
                for i in range(int(wsize.max()) if numrep > 0 else 0):
                    src = w[:, i]
                    ok = (i < wsize) & (src < 0) & (-1 - src < T.n_buckets)
                    room = torch.clamp(RMAX - osize, max=numrep)
                    base = lane0 + i * per
                    if self.diag and not firstn:
                        # a call with no room still books its 0 rounds
                        self.tries[ok & (room == 0), base] = 0
                    a = (ok & (room > 0)).nonzero()[:, 0]
                    if a.numel() == 0:
                        continue
                    if firstn:
                        recurse_tries = leaf_tries or (
                            1 if prog.chooseleaf_descend_once
                            else choose_tries)
                        out, out2, n = self.choose_firstn(
                            a, src[a], RMAX - osize[a], numrep=numrep,
                            target=arg2, leafy=leafy, tries=choose_tries,
                            recurse_tries=recurse_tries, vary_r=vary_r,
                            stable=stable, width=width, base=base)
                    else:
                        n = room[a]
                        out, out2 = self.choose_indep(
                            a, src[a], n, numrep=numrep, target=arg2,
                            leafy=leafy, tries=choose_tries,
                            recurse_tries=leaf_tries or 1, width=width,
                            base=base)
                    _place(o, a, osize[a], out2 if leafy else out, n)
                    osize[a] += n
                w = torch.where(has[:, None], o[:, :RMAX], w)
                wsize = torch.where(has, osize, wsize)
                if self.diag and row >= 0:
                    self.steps[:, row] = torch.where(col < wsize[:, None], w,
                                                     ITEM_NONE)
            elif op == RuleOp.EMIT:
                _place(result, all_lanes, rlen, w, wsize)
                rlen = torch.clamp(rlen + wsize, max=RMAX)
                wsize = torch.zeros_like(wsize)
        rows = result[:, :RMAX].to(torch.int32)
        if self.diag:
            self.tally[:, 3] = (rows != ITEM_NONE).sum(1) < RMAX
        return rows

    def planes(self) -> dict:
        """The diagnostics planes, int32, as crush_rule_diag_cuda gives
        them."""
        return _planes(self.tries.int(), self.steps.int(), self.tally.int())


def _planes(tries, steps, tally) -> dict:
    """The diagnostics planes by name (mapper_jax's with_diag keys):
    tries [N, lanes], coll / rej / skip / bad [N], steps [N, S, RMAX]."""
    return {"tries": tries, "coll": tally[:, 0], "rej": tally[:, 1],
            "skip": tally[:, 2], "bad": tally[:, 3], "steps": steps}


def crush_rule_plain(T: DeviceArrays, prog: RuleProgram, x: torch.Tensor,
                     weight: torch.Tensor, by_alg: bool = False,
                     diag: bool = False):
    """The plain PyTorch version of the kernel, on any device.

    x: seeds [N]; weight: OSD reweights [D] (u32 values, any integer
    dtype), on T's device.  Returns (rows int32 [N, result_max], draws
    int64 [N]): the straw2 draws each lane made (items with a nonzero
    weight in every bucket it drew from).  With by_alg, draws is
    [N, N_ALGS]: column a counts the hash calls of the lane's draws from
    buckets of algorithm a (BucketAlg), column STRAW2 the straw2 draws;
    a straw draw hashes every item, a list draw the items it scans, a tree
    draw once a level, a uniform draw once a Fisher-Yates step.

    With diag, a third value: the diagnostics planes (`_planes`), as the
    diagnostics kernel writes them."""
    x = x.reshape(-1).long() & M32
    weight = _weight_vector(weight.reshape(-1).long() & M32)
    rows, draws, planes = [], [], []
    for i in range(0, x.numel(), PLAIN_CHUNK):
        lanes = _Lanes(T, x[i:i + PLAIN_CHUNK], weight,
                       prog if diag else None)
        rows.append(lanes.run(prog))
        draws.append(lanes.hashes if by_alg
                     else lanes.hashes[:, BucketAlg.STRAW2])
        if diag:
            planes.append(lanes.planes())
    if not rows:
        out = (torch.empty((0, prog.result_max), dtype=torch.int32,
                           device=x.device),
               torch.empty((0, N_ALGS) if by_alg else 0, dtype=torch.long,
                           device=x.device))
        if diag:
            out += (_empty_planes(prog, x.device),)
        return out
    out = (torch.cat(rows), torch.cat(draws))
    if diag:
        out += ({k: torch.cat([p[k] for p in planes]) for k in planes[0]},)
    return out


def _empty_planes(prog: RuleProgram, device, n: int = 0) -> dict:
    """Uninitialised int32 planes for n lanes."""
    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)
    return _planes(empty(n, prog.diag_lanes),
                   empty(n, prog.diag_steps, prog.result_max), empty(n, 4))


# -- the kernel ---------------------------------------------------------------

_LIBS: dict[bool, ctypes.CDLL] = {}
# the first load of a library (two reader threads, or a reader and an
# applier, may both be first) and the launch counts (kernels launch from several
# threads at once)
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _lib(diag: bool = False) -> ctypes.CDLL:
    """The rule kernel's library, or its diagnostics variant's, loaded
    and declared once; published only once its signatures are set."""
    lib = _LIBS.get(diag)
    if lib is not None:
        return lib
    with _LIB_LOCK:
        lib = _LIBS.get(diag)
        if lib is not None:
            return lib
        name = "crush_rule_diag" if diag else "crush_rule"
        lib = build.load(f"crush/csrc/{name}.cu")
        p, i = ctypes.c_void_p, ctypes.c_int
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = ([p] * 8 + [i] * 13 + [p, ctypes.c_longlong, p]
                           + ([p, i, i, p, p, p] if diag else []) + [p])
        launch.restype = i
        getattr(lib, f"{name}_plan").argtypes = [p]
        getattr(lib, f"{name}_plan").restype = i
        getattr(lib, f"{name}_error_string").argtypes = [i]
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        _LIBS[diag] = lib
        return lib


def _check(rc: int, what: str, diag: bool = False) -> None:
    if rc != 0:
        name = "crush_rule_diag" if diag else "crush_rule"
        msg = getattr(_lib(diag), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} {what} failed: {msg}")


@dataclass(frozen=True)
class LaunchPlan:
    """What the build and the card give the kernel, from
    `crush_rule_plan`."""

    registers: int  # per thread
    local_bytes: int  # per thread: the work vectors and any spills
    static_smem: int  # per block
    threads: int  # the occupancy calculator's block size
    blocks_per_sm: int  # resident at that size, crush_ln tables staged
    smem_per_sm: int
    smem_optin: int  # the most one block may take
    smem_reserved: int  # per block, by the system
    sms: int
    table_bytes: int  # shared memory of the crush_ln tables

    @property
    def stage_budget(self) -> int:
        """Records a block may stage without losing a resident block."""
        per_block = (self.smem_per_sm // self.blocks_per_sm
                     - self.smem_reserved)
        room = min(per_block, self.smem_optin) - self.static_smem \
            - self.table_bytes
        return max(room, 0) // RECORD_BYTES


@functools.cache
def launch_plan(device_index: int, diag: bool = False) -> LaunchPlan:
    """The kernel's (or its diagnostics variant's) LaunchPlan on one
    card."""
    out = (ctypes.c_int * 10)()
    name = "crush_rule_diag" if diag else "crush_rule"
    with torch.cuda.device(device_index):
        _check(getattr(_lib(diag), f"{name}_plan")(ctypes.addressof(out)),
               "plan", diag)
    return LaunchPlan(*out)


def staged_records(T: DeviceArrays, plan: LaunchPlan) -> int:
    """How many records (a prefix) a block stages in shared memory: all
    of the map when they fit the plan's budget, else the most whole
    breadth-first levels that do."""
    total = T.records.shape[0]
    budget = plan.stage_budget
    if total <= budget:
        return total
    return max((e for e in T.level_ends if e <= budget), default=0)


def _launch(T: DeviceArrays, prog: RuleProgram, x: torch.Tensor,
            weight: torch.Tensor, stage: int | None, diag: bool):
    """One launch of the rule kernel or of its diagnostics variant:
    (rows, planes or None)."""
    what = "crush_rule_diag_cuda" if diag else "crush_rule_cuda"
    dev = T.device
    if dev.type != "cuda" or x.device != dev or weight.device != dev:
        raise ValueError(
            f"{what}: map on {dev}, seeds on {x.device}, weights "
            f"on {weight.device}; all must be on one CUDA device")
    if x.dtype != torch.int32 or weight.dtype != torch.int32:
        raise TypeError(f"{what}: int32 seeds and weights expected "
                        "(u32 bit patterns)")
    if x.dim() != 1 or weight.dim() != 1 or weight.numel() == 0:
        raise ValueError(f"{what}: seeds [N] and weights [D >= 1] "
                         "expected")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError(f"{what}: contiguous tensors expected")
    if prog.result_max > RMAX_CAP:
        raise ValueError(f"{what}: result_max {prog.result_max} > "
                         f"{RMAX_CAP}, the kernel's longest row")
    n = x.numel()
    out = torch.empty((n, prog.result_max), dtype=torch.int32, device=dev)
    planes = _empty_planes(prog, dev, n) if diag else None
    if n == 0:
        return out, planes
    rh_lh, ll = ln_tables(dev)
    for t in (T.records, rh_lh, ll):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: records and crush_ln tables "
                             "must be 16-byte aligned")
    plan = launch_plan(dev.index if dev.index is not None
                       else torch.cuda.current_device(), diag)
    n_staged = staged_records(T, plan) if stage is None else stage
    if not 0 <= n_staged <= T.records.shape[0]:
        raise ValueError(f"{what}: stage {n_staged} outside "
                         f"[0, {T.records.shape[0]}]")
    args = [
        T.headers.data_ptr(), T.records.data_ptr(),
        T.packed_items.data_ptr(), T.nodes.data_ptr(),
        weight.data_ptr(), rh_lh.data_ptr(),
        ll.data_ptr(), prog.steps_on(dev).data_ptr(), T.n_buckets,
        T.positions, T.max_devices, T.max_depth, weight.numel(),
        len(prog.steps), prog.result_max, prog.choose_total_tries,
        prog.chooseleaf_descend_once, prog.chooseleaf_vary_r,
        prog.chooseleaf_stable, n_staged, plan.threads, x.data_ptr(), n,
        out.data_ptr()]
    if diag:
        tally = planes["coll"]  # column 0 of the [n, 4] tally plane
        args += [prog.diag_plan_on(dev).data_ptr(), prog.diag_lanes,
                 prog.diag_steps, planes["tries"].data_ptr(),
                 planes["steps"].data_ptr(), tally.data_ptr()]
    with torch.cuda.device(dev):
        launch = (_lib(True).crush_rule_diag_launch if diag
                  else _lib().crush_rule_launch)
        _check(launch(*args, torch.cuda.current_stream().cuda_stream),
               "kernel launch", diag)
    return out, planes


def crush_rule_cuda(T: DeviceArrays, prog: RuleProgram, x: torch.Tensor,
                    weight: torch.Tensor, stage: int | None = None
                    ) -> torch.Tensor:
    """Launch the kernel once: seeds x int32 [N] (u32 bit patterns) and
    reweights int32 [D] on T's card -> int32 rows [N, result_max].  Runs
    on the current stream, unsynchronised.  `stage` is the number of
    records each block copies to shared memory (None: `staged_records`;
    every choice gives the same rows).  `crush_rule_cuda.launches` counts
    the launches."""
    out, _ = _launch(T, prog, x, weight, stage, diag=False)
    if x.numel():
        with _COUNT_LOCK:
            crush_rule_cuda.launches += 1
    return out


crush_rule_cuda.launches = 0


def crush_rule_diag_cuda(T: DeviceArrays, prog: RuleProgram,
                         x: torch.Tensor, weight: torch.Tensor,
                         stage: int | None = None):
    """Launch the diagnostics variant once, with crush_rule_cuda's
    inputs, staging and grid: (rows int32 [N, result_max], planes), the
    planes int32 on the card (`_planes`: tries [N, diag_lanes], coll,
    rej, skip and bad [N], steps [N, diag_steps, result_max]).  The rows
    are crush_rule_cuda's.  `crush_rule_diag_cuda.launches` counts the
    launches."""
    out, planes = _launch(T, prog, x, weight, stage, diag=True)
    if x.numel():
        with _COUNT_LOCK:
            crush_rule_diag_cuda.launches += 1
    return out, planes


crush_rule_diag_cuda.launches = 0


def map_rule(T: DeviceArrays, prog: RuleProgram, x: torch.Tensor,
             weight: torch.Tensor) -> torch.Tensor:
    """The rule's rows for seeds x on T's device: int32 [N, result_max].
    On the card, one kernel launch per block of up to BLOCK seeds; on the
    CPU, the plain version."""
    if x.device != T.device or weight.device != T.device:
        raise ValueError(f"seeds on {x.device}, weights on {weight.device}, "
                         f"map on {T.device}")
    if x.device.type == "cpu":
        return crush_rule_plain(T, prog, x, weight)[0]
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = u32_bits(x.reshape(-1))
    weight = u32_bits(_weight_vector(weight.reshape(-1)))
    blocks = [crush_rule_cuda(T, prog, x[i:i + BLOCK], weight)
              for i in range(0, max(x.numel(), 1), BLOCK)]
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks)


def diag_rule(T: DeviceArrays, prog: RuleProgram, x: torch.Tensor,
              weight: torch.Tensor):
    """`map_rule` with the diagnostics: (rows, planes) for seeds x on
    T's device.  On the card, one launch of the diagnostics variant per
    block of up to BLOCK seeds; on the CPU, the plain version."""
    if x.device != T.device or weight.device != T.device:
        raise ValueError(f"seeds on {x.device}, weights on {weight.device}, "
                         f"map on {T.device}")
    if x.device.type == "cpu":
        rows, _, planes = crush_rule_plain(T, prog, x, weight, diag=True)
        return rows, planes
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = u32_bits(x.reshape(-1))
    weight = u32_bits(_weight_vector(weight.reshape(-1)))
    blocks = [crush_rule_diag_cuda(T, prog, x[i:i + BLOCK], weight)
              for i in range(0, max(x.numel(), 1), BLOCK)]
    if len(blocks) == 1:
        return blocks[0]
    return (torch.cat([b[0] for b in blocks]),
            {k: torch.cat([b[1][k] for b in blocks]) for k in blocks[0][1]})
