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
  calls of its draws);
- `map_rule` dispatches on where the seeds lie: a CPU tensor goes to the
  plain version, a CUDA tensor to the kernel (or the call raises).

Inputs are u32 values: seeds and reweights may be given in any integer
dtype (int32 holds their bit patterns).  Rows are int32 [N, result_max],
padded with ITEM_NONE, as `compile_rule`'s fn returns them.
"""

from __future__ import annotations

import ctypes
import functools
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
    """One rule of one map, ready for the kernel and its plain version."""

    ruleno: int
    result_max: int
    steps: np.ndarray  # int32 [n_steps, 3]: op, arg1, arg2
    choose_total_tries: int
    chooseleaf_descend_once: int
    chooseleaf_vary_r: int
    chooseleaf_stable: int
    _steps_dev: dict = field(default_factory=dict, compare=False, repr=False)

    def steps_on(self, device: torch.device) -> torch.Tensor:
        """The steps as an int32 tensor on `device`, uploaded once."""
        t = self._steps_dev.get(device)
        if t is None:
            t = torch.from_numpy(self.steps.reshape(-1).copy()).to(device)
            self._steps_dev[device] = t
        return t


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
    return RuleProgram(
        ruleno=ruleno, result_max=result_max,
        steps=np.asarray(steps, np.int32).reshape(-1, 3),
        choose_total_tries=t.choose_total_tries,
        chooseleaf_descend_once=t.chooseleaf_descend_once,
        chooseleaf_vary_r=t.chooseleaf_vary_r,
        chooseleaf_stable=t.chooseleaf_stable,
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
                 weight: torch.Tensor):
        self.T = T
        self.x = x
        self.weight = weight
        # hash calls of each lane's draws, by bucket algorithm
        self.hashes = torch.zeros((x.numel(), N_ALGS), dtype=torch.long,
                                  device=x.device)
        self.col_s = torch.arange(T.max_size, device=x.device)

    def _count(self, alg, lanes, n):
        self.hashes[:, alg].index_add_(0, lanes, n)

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
        """crush_rule.cuh::leaf_firstn: (ok, leaf) per lane."""
        k = lanes.numel()
        col = torch.arange(out2.shape[1], device=lanes.device)
        ok = torch.zeros(k, dtype=torch.bool, device=lanes.device)
        leaf = torch.full_like(bucket, ITEM_NONE)
        ftotal = torch.zeros_like(bucket)
        pend = torch.ones_like(ok)
        while True:
            a = pend.nonzero()[:, 0]
            if a.numel() == 0:
                return ok, leaf
            item, st, _ = self.descend(lanes[a], bucket[a],
                                       r0[a] + ftotal[a], outpos[a], 0)
            collide = ((out2[a] == item[:, None])
                       & (col < outpos[a, None])).any(1)
            good = (st == _FOUND) & ~collide & ~self.is_out(lanes[a], item)
            ok[a[good]] = True
            leaf[a[good]] = item[good]
            fail = ~good & (st != _SKIP)
            ftotal[a[fail]] += 1
            pend[a] = fail & (ftotal[a] < tries)

    def choose_firstn(self, lanes, src, count, *, numrep, target, leafy,
                      tries, recurse_tries, vary_r, stable, width):
        """crush_rule.cuh::choose_firstn: (out, out2, n placed) per lane."""
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
                if leafy:
                    b = (found & ~collide & (item < 0)).nonzero()[:, 0]
                    if b.numel():
                        ab = a[b]
                        sub_r = r[b] >> (vary_r - 1) if vary_r else 0
                        r0 = (0 if stable else outpos[ab]) + sub_r
                        ok, lf = self.leaf_firstn(
                            lanes[ab], item[b], r0 + torch.zeros_like(ab),
                            outpos[ab], out2[ab], recurse_tries)
                        reject[b] = ~ok
                        leaf[b] = lf
                if target == 0:
                    reject |= (found & ~collide & ~reject
                               & self.is_out(lanes[a], item))
                placed = found & ~collide & ~reject
                p = a[placed]
                out[p, outpos[p]] = item[placed]
                out2[p, outpos[p]] = leaf[placed]
                outpos[p] += 1
                count[p] -= 1
                fail = (st == _EMPTY) | (found & ~placed)
                ftotal[a[fail]] += 1
                pend[a] = fail & (ftotal[a] < tries)
        return out, out2, outpos

    def leaf_indep(self, lanes, bucket, rep, parent_r, numrep, tries):
        """crush_rule.cuh::leaf_indep: the leaf per lane, or ITEM_NONE."""
        res = torch.full_like(bucket, ITEM_NONE)
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
        return res

    def choose_indep(self, lanes, src, out_size, *, numrep, target, leafy,
                     tries, recurse_tries, width):
        """crush_rule.cuh::choose_indep: (out, out2) per lane."""
        dev = lanes.device
        col = torch.arange(width, device=dev)
        out = torch.where(col < out_size[:, None], ITEM_UNDEF, ITEM_NONE)
        out2 = out.clone()
        zero = torch.zeros_like(src)
        for ftotal in range(tries):
            todo_any = False
            for rep in range(width):
                a = (out[:, rep] == ITEM_UNDEF).nonzero()[:, 0]
                if a.numel() == 0:
                    continue
                todo_any = True
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
                        lf = self.leaf_indep(lanes[a[b]], item[b], rep, r[b],
                                             numrep, recurse_tries)
                        out2[a[b], rep] = lf
                        go[b] = lf != ITEM_NONE
                if target == 0:
                    go &= ~self.is_out(lanes[a], item)
                out[a[go], rep] = item[go]
            if not todo_any:
                break
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
        for op, arg1, arg2 in prog.steps.tolist():
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
                for i in range(int(wsize.max()) if numrep > 0 else 0):
                    src = w[:, i]
                    ok = (i < wsize) & (src < 0) & (-1 - src < T.n_buckets)
                    room = torch.clamp(RMAX - osize, max=numrep)
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
                            stable=stable, width=width)
                    else:
                        n = room[a]
                        out, out2 = self.choose_indep(
                            a, src[a], n, numrep=numrep, target=arg2,
                            leafy=leafy, tries=choose_tries,
                            recurse_tries=leaf_tries or 1, width=width)
                    _place(o, a, osize[a], out2 if leafy else out, n)
                    osize[a] += n
                w = torch.where(has[:, None], o[:, :RMAX], w)
                wsize = torch.where(has, osize, wsize)
            elif op == RuleOp.EMIT:
                _place(result, all_lanes, rlen, w, wsize)
                rlen = torch.clamp(rlen + wsize, max=RMAX)
                wsize = torch.zeros_like(wsize)
        return result[:, :RMAX].to(torch.int32)


def crush_rule_plain(T: DeviceArrays, prog: RuleProgram, x: torch.Tensor,
                     weight: torch.Tensor, by_alg: bool = False):
    """The plain PyTorch version of the kernel, on any device.

    x: seeds [N]; weight: OSD reweights [D] (u32 values, any integer
    dtype), on T's device.  Returns (rows int32 [N, result_max], draws
    int64 [N]): the straw2 draws each lane made (items with a nonzero
    weight in every bucket it drew from).  With by_alg, draws is
    [N, N_ALGS]: column a counts the hash calls of the lane's draws from
    buckets of algorithm a (BucketAlg), column STRAW2 the straw2 draws;
    a straw draw hashes every item, a list draw the items it scans, a tree
    draw once a level, a uniform draw once a Fisher-Yates step."""
    x = x.reshape(-1).long() & M32
    weight = _weight_vector(weight.reshape(-1).long() & M32)
    rows, draws = [], []
    for i in range(0, x.numel(), PLAIN_CHUNK):
        lanes = _Lanes(T, x[i:i + PLAIN_CHUNK], weight)
        rows.append(lanes.run(prog))
        draws.append(lanes.hashes if by_alg
                     else lanes.hashes[:, BucketAlg.STRAW2])
    if not rows:
        return (torch.empty((0, prog.result_max), dtype=torch.int32,
                            device=x.device),
                torch.empty((0, N_ALGS) if by_alg else 0, dtype=torch.long,
                            device=x.device))
    return torch.cat(rows), torch.cat(draws)


# -- the kernel ---------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("crush/csrc/crush_rule.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.crush_rule_launch.argtypes = (
        [p] * 8 + [i] * 13 + [p, ctypes.c_longlong, p, p])
    lib.crush_rule_launch.restype = i
    lib.crush_rule_plan.argtypes = [p]
    lib.crush_rule_plan.restype = i
    lib.crush_rule_error_string.argtypes = [i]
    lib.crush_rule_error_string.restype = ctypes.c_char_p
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().crush_rule_error_string(rc).decode()
        raise RuntimeError(f"crush_rule {what} failed: {msg}")


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
def launch_plan(device_index: int) -> LaunchPlan:
    """The kernel's LaunchPlan on one card."""
    out = (ctypes.c_int * 10)()
    with torch.cuda.device(device_index):
        _check(_lib().crush_rule_plan(ctypes.addressof(out)), "plan")
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


def crush_rule_cuda(T: DeviceArrays, prog: RuleProgram, x: torch.Tensor,
                    weight: torch.Tensor, stage: int | None = None
                    ) -> torch.Tensor:
    """Launch the kernel once: seeds x int32 [N] (u32 bit patterns) and
    reweights int32 [D] on T's card -> int32 rows [N, result_max].  Runs
    on the current stream, unsynchronised.  `stage` is the number of
    records each block copies to shared memory (None: `staged_records`;
    every choice gives the same rows).  `crush_rule_cuda.launches` counts
    the launches."""
    dev = T.device
    if dev.type != "cuda" or x.device != dev or weight.device != dev:
        raise ValueError(
            f"crush_rule_cuda: map on {dev}, seeds on {x.device}, weights "
            f"on {weight.device}; all must be on one CUDA device")
    if x.dtype != torch.int32 or weight.dtype != torch.int32:
        raise TypeError("crush_rule_cuda: int32 seeds and weights expected "
                        "(u32 bit patterns)")
    if x.dim() != 1 or weight.dim() != 1 or weight.numel() == 0:
        raise ValueError("crush_rule_cuda: seeds [N] and weights [D >= 1] "
                         "expected")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("crush_rule_cuda: contiguous tensors expected")
    if prog.result_max > RMAX_CAP:
        raise ValueError(f"crush_rule_cuda: result_max {prog.result_max} > "
                         f"{RMAX_CAP}, the kernel's longest row")
    out = torch.empty((x.numel(), prog.result_max), dtype=torch.int32,
                      device=dev)
    if x.numel() == 0:
        return out
    rh_lh, ll = ln_tables(dev)
    for t in (T.records, rh_lh, ll):
        if t.data_ptr() % 16:
            raise ValueError("crush_rule_cuda: records and crush_ln tables "
                             "must be 16-byte aligned")
    plan = launch_plan(dev.index if dev.index is not None
                       else torch.cuda.current_device())
    n_staged = staged_records(T, plan) if stage is None else stage
    if not 0 <= n_staged <= T.records.shape[0]:
        raise ValueError(f"crush_rule_cuda: stage {n_staged} outside "
                         f"[0, {T.records.shape[0]}]")
    steps = prog.steps_on(dev)
    with torch.cuda.device(dev):
        _check(_lib().crush_rule_launch(
            T.headers.data_ptr(), T.records.data_ptr(),
            T.packed_items.data_ptr(), T.nodes.data_ptr(),
            weight.data_ptr(), rh_lh.data_ptr(),
            ll.data_ptr(), steps.data_ptr(), T.n_buckets, T.positions,
            T.max_devices, T.max_depth, weight.numel(), len(prog.steps),
            prog.result_max, prog.choose_total_tries,
            prog.chooseleaf_descend_once, prog.chooseleaf_vary_r,
            prog.chooseleaf_stable, n_staged, plan.threads, x.data_ptr(),
            x.numel(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        ), "kernel launch")
    crush_rule_cuda.launches += 1
    return out


crush_rule_cuda.launches = 0


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
