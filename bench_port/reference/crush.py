"""A plain CRUSH walk over every PG of a pool, in torch, lane by lane.

The benchmark's own reference for placement: it imports nothing of the
program.  It follows the C reference (src/crush/mapper.c, src/crush/
hash.c, src/osd/osd_types.cc) for what the benchmark's configurations
use: straw2 buckets, the optimal ("jewel") tunables, and a rule of one
step `take root; chooseleaf {firstn|indep} 0 type T; emit`.  Each lane is
one PG; a step of the walk runs for every live lane at once, and lanes
drop out as they finish.

`Tree` is the map's hierarchy as padded tables.  `place_raw` gives the
raw rows (the rule's result, ITEM_NONE-padded to the pool's size) and
the straw2 draws each PG made (items of nonzero weight in every bucket it
drew from), which the issue bound of the benchmark counts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .lntable import crush_ln

M32 = 0xFFFFFFFF
ITEM_NONE = 0x7FFFFFFF
S64_MIN = -(1 << 63)
HASH_SEED = 1315423911
_X = 231232
_Y = 1232
IN_WEIGHT = 0x10000
# the optimal tunables' choose_total_tries is 50; the walk allows one more
# (crush_do_rule's off-by-one, src/crush/mapper.c:914)
TRIES = 51
# `chooseleaf indep` in an erasure rule runs under set_chooseleaf_tries 5
# (ErasureCode::create_rule); firstn descends once (chooseleaf_descend_once)
EC_LEAF_TRIES = 5


# -- rjenkins (src/crush/hash.c), u32 values held in int64 lanes ----------

def _mix(a, b, c):
    a = (a - b - c) & M32
    a = a ^ (c >> 13)
    b = (b - c - a) & M32
    b = b ^ ((a << 8) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 13)
    a = (a - b - c) & M32
    a = a ^ (c >> 12)
    b = (b - c - a) & M32
    b = b ^ ((a << 16) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 5)
    a = (a - b - c) & M32
    a = a ^ (c >> 3)
    b = (b - c - a) & M32
    b = b ^ ((a << 10) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 15)
    return a, b, c


def hash2(a, b):
    h = HASH_SEED ^ a ^ b
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(_X, a, h)
    b, y, h = _mix(b, _Y, h)
    return h


def hash3(a, b, c):
    h = HASH_SEED ^ a ^ b ^ c
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, _X, h)
    y, a, h = _mix(_Y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


# -- the map -----------------------------------------------------------

@dataclass
class Tree:
    """Straw2 buckets as padded tables: bucket id b sits at row -1 - b.

    items / weights [B, S] int64 (padding: weight 0), sizes [B], btype
    [B] (the bucket's type; 0 stands for a device), root (a bucket id),
    n_devices (devices have ids 0 .. n_devices - 1)."""

    items: torch.Tensor
    weights: torch.Tensor
    sizes: torch.Tensor
    btype: torch.Tensor
    root: int
    n_devices: int

    def to(self, device) -> "Tree":
        return Tree(self.items.to(device), self.weights.to(device),
                    self.sizes.to(device), self.btype.to(device),
                    self.root, self.n_devices)


def hierarchy(n_host: int, osd_per_host: int, n_rack: int) -> Tree:
    """The map `osdmaptool --createsimple` with a crush from conf builds
    (the program's `build_hierarchical`): hosts of osd_per_host devices of
    weight 1.0, created first (ids -1 .. -n_host); then n_rack racks of
    n_host // n_rack hosts each, in order; then the root over the racks
    (over the hosts when n_rack is 0).  Hosts past the racks' share hang
    under no rack and are never reached.  Every bucket is straw2."""
    buckets: list[tuple[int, list[int], list[int]]] = []  # (type, items, w)
    host_w = osd_per_host * IN_WEIGHT
    for h in range(n_host):
        items = list(range(h * osd_per_host, (h + 1) * osd_per_host))
        buckets.append((1, items, [IN_WEIGHT] * osd_per_host))
    host_ids = [-1 - h for h in range(n_host)]
    if n_rack:
        per = max(1, n_host // n_rack)
        top = []
        for r in range(n_rack):
            hs = host_ids[r * per:(r + 1) * per]
            if not hs:
                break
            buckets.append((3, hs, [host_w] * len(hs)))
            top.append((-len(buckets), host_w * len(hs)))
    else:
        top = [(h, host_w) for h in host_ids]
    buckets.append((11, [b for b, _ in top], [w for _, w in top]))
    root = -len(buckets)
    size = max(len(it) for _, it, _ in buckets)
    items = np.zeros((len(buckets), size), np.int64)
    weights = np.zeros((len(buckets), size), np.int64)
    sizes = np.zeros(len(buckets), np.int64)
    btype = np.zeros(len(buckets), np.int64)
    for i, (t, it, w) in enumerate(buckets):
        items[i, :len(it)] = it
        weights[i, :len(w)] = w
        sizes[i] = len(it)
        btype[i] = t
    return Tree(*(torch.from_numpy(a) for a in (items, weights, sizes,
                                                btype)),
                root, n_host * osd_per_host)


# -- the walk ----------------------------------------------------------

def placement_seeds(ps: torch.Tensor, pgp_num: int, pool_id: int):
    """ceph_stable_mod onto pgp_num, then the pool's hash (HASHPSPOOL)."""
    mask = (1 << (pgp_num - 1).bit_length()) - 1
    lo = ps & mask
    ps2 = torch.where(lo < pgp_num, lo, ps & (mask >> 1))
    return hash2(ps2 & M32, torch.full_like(ps2, pool_id & M32))


def straw2(tree: Tree, bucket: torch.Tensor, x: torch.Tensor,
           r: torch.Tensor):
    """bucket_straw2_choose for each lane: (item, draws) where draws is
    the number of items of nonzero weight the bucket holds."""
    row = -1 - bucket
    s = int(tree.sizes[row].max())  # the widest bucket drawn from
    it = tree.items[row, :s]
    w = tree.weights[row, :s]
    u = hash3(x[:, None], it & M32, r[:, None]) & 0xFFFF
    ln = crush_ln(u) - 0x1000000000000
    draw = torch.where(w > 0, torch.div(ln, w.clamp(min=1),
                                        rounding_mode="trunc"), S64_MIN)
    j = torch.argmax(draw, dim=1, keepdim=True)
    return it.gather(1, j)[:, 0], (w > 0).sum(1)


def is_out(reweight: torch.Tensor, item: torch.Tensor, x: torch.Tensor):
    w = reweight[item]
    return (w < IN_WEIGHT) & ((w == 0) | ((hash2(x, item) & 0xFFFF) >= w))


def descend(tree: Tree, x: torch.Tensor, r: torch.Tensor, target: int,
            draws: torch.Tensor, lanes: torch.Tensor):
    """From the root, straw2 down with the same r until an item of type
    `target`; the draws of each lane are added to draws[lanes]."""
    item = torch.full_like(x, tree.root)
    while True:
        is_bucket = item < 0
        t = torch.where(is_bucket, tree.btype[(-1 - item).clamp(min=0)], 0)
        go = is_bucket & (t != target)
        if not bool(go.any()):
            return item
        g = go.nonzero()[:, 0]
        got, n = straw2(tree, item[g], x[g], r[g])
        item[g] = got
        draws.index_add_(0, lanes[g], n)


def chooseleaf_firstn(tree: Tree, x: torch.Tensor, reweight: torch.Tensor,
                      numrep: int, ftype: int):
    """`chooseleaf firstn numrep type ftype` from the root (stable,
    vary_r 1, descend once): [N, numrep] leaves, ITEM_NONE-padded, and
    draws [N]."""
    n = x.numel()
    dev = x.device
    hosts = torch.full((n, numrep), ITEM_NONE, dtype=torch.long, device=dev)
    leaves = torch.full((n, numrep), ITEM_NONE, dtype=torch.long,
                        device=dev)
    outpos = torch.zeros(n, dtype=torch.long, device=dev)
    draws = torch.zeros(n, dtype=torch.long, device=dev)
    for rep in range(numrep):
        lanes = torch.arange(n, device=dev)
        for ftotal in range(TRIES):
            if lanes.numel() == 0:
                break
            xl = x[lanes]
            r = torch.full_like(xl, rep + ftotal)
            host = descend(tree, xl, r, ftype, draws, lanes)
            collide = (hosts[lanes] == host[:, None]).any(1)
            ok = ~collide
            g = ok.nonzero()[:, 0]
            # the leaf: one straw2 draw in the host with r (vary_r 1),
            # refused when the device is out
            leaf = torch.full_like(host, ITEM_NONE)
            got, nd = straw2(tree, host[g], xl[g], r[g])
            leaf[g] = got
            draws.index_add_(0, lanes[g], nd)
            ok[g] &= ~is_out(reweight, got, xl[g])
            done = lanes[ok]
            pos = outpos[done]
            hosts[done, pos] = host[ok]
            leaves[done, pos] = leaf[ok]
            outpos[done] += 1
            lanes = lanes[~ok]
    return leaves, draws


def chooseleaf_indep(tree: Tree, x: torch.Tensor, reweight: torch.Tensor,
                     numrep: int, ftype: int):
    """`chooseleaf indep numrep type ftype` from the root under
    set_chooseleaf_tries 5: [N, numrep] positional leaves (ITEM_NONE where
    a position stayed empty), and draws [N]."""
    n = x.numel()
    dev = x.device
    undef = -0x7FFFFFFF  # never an item id of these maps
    hosts = torch.full((n, numrep), undef, dtype=torch.long, device=dev)
    leaves = torch.full((n, numrep), ITEM_NONE, dtype=torch.long,
                        device=dev)
    draws = torch.zeros(n, dtype=torch.long, device=dev)
    for ftotal in range(TRIES):
        open_ = hosts == undef
        if not bool(open_.any()):
            break
        for rep in range(numrep):
            lanes = open_[:, rep].nonzero()[:, 0]
            if lanes.numel() == 0:
                continue
            xl = x[lanes]
            r = torch.full_like(xl, rep + numrep * ftotal)
            host = descend(tree, xl, r, ftype, draws, lanes)
            # a collision is with any position's item, as it stands now
            collide = (hosts[lanes] == host[:, None]).any(1)
            g = (~collide).nonzero()[:, 0]
            lg, hg, xg, rg = lanes[g], host[g], xl[g], r[g]
            placed = torch.zeros(g.numel(), dtype=torch.bool, device=dev)
            leaf = torch.full_like(hg, ITEM_NONE)
            # the leaf: up to 5 tries in the host, r' = rep + r + numrep
            # * ftotal' (the inner call's parent_r is r)
            for f2 in range(EC_LEAF_TRIES):
                t = (~placed).nonzero()[:, 0]
                if t.numel() == 0:
                    break
                got, nd = straw2(tree, hg[t], xg[t], rep + rg[t] + numrep
                                 * f2)
                draws.index_add_(0, lg[t], nd)
                keep = ~is_out(reweight, got, xg[t])
                leaf[t[keep]] = got[keep]
                placed[t[keep]] = True
            hosts[lg[placed], rep] = hg[placed]
            leaves[lg[placed], rep] = leaf[placed]
    return leaves, draws


def place_raw(tree: Tree, ps: torch.Tensor, reweight: torch.Tensor, *,
              pool_id: int, pgp_num: int, size: int, ftype: int,
              indep: bool):
    """Raw rows [N, size] int64 and draws [N] of PGs ps (every device of
    these maps exists, so nothing is removed after the rule)."""
    x = placement_seeds(ps.long(), pgp_num, pool_id)
    walk = chooseleaf_indep if indep else chooseleaf_firstn
    return walk(tree, x, reweight, size, ftype)
