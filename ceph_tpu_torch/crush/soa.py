"""Structure-of-arrays CrushMap for the rule kernel.

A copy of `ceph_tpu/crush/soa.py`, plus `to_device`.  The C reference walks
pointer-linked bucket structs per PG (reference src/crush/crush.h:354-461).
The frozen form is a padded array bundle: one row per bucket slot (slot b
holds bucket id -1-b), items/weights padded to the max bucket size with a
size vector for masking.  `build_arrays` freezes a map on the host (numpy);
`pack_buckets` lays the draws' inputs out for the rule kernel
(`crush/csrc/crush_rule.cuh`): one 16-byte record per item and weight-set
position, bucket by bucket in breadth-first order from the rules' roots,
with a header per bucket slot and the tree buckets' node weights beside
them.  `to_device` uploads the padded fields the
plain version reads and the packed ones the kernel reads, once per map.

Padding policy: item/weight rows pad with 0 (masked lanes never win a draw:
zero weight => S64_MIN draw in straw2, 0 straw in straw, excluded by the size
mask elsewhere).  Tree node arrays pad to the largest node count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

import torch

from ceph_tpu_torch.crush.types import BucketAlg, CrushMap, RuleOp, Tunables


@dataclass(frozen=True)
class CrushArrays:
    """Frozen SoA view of a CrushMap, numpy-held (`to_device` uploads)."""

    # static metadata
    n_buckets: int  # B: bucket slots
    max_size: int  # S: padded item axis
    max_nodes: int  # NN: padded tree-node axis
    positions: int  # P: choose_args weight-set positions (>=1)
    max_devices: int
    max_depth: int  # longest bucket->bucket chain (for loop bounds)
    tunables: Tunables
    rules: tuple  # tuple of Rule (static step data)

    # per-bucket arrays
    alg: np.ndarray  # [B] i32
    btype: np.ndarray  # [B] i32
    size: np.ndarray  # [B] i32
    bucket_weight: np.ndarray  # [B] u32 (sum of item weights)
    items: np.ndarray  # [B,S] i32
    weights: np.ndarray  # [B,S] u32  (16.16)
    sum_weights: np.ndarray  # [B,S] u32  (list prefix sums)
    straws: np.ndarray  # [B,S] u32  (straw scalers)
    node_weights: np.ndarray  # [B,NN] u32 (tree heap)
    num_nodes: np.ndarray  # [B] i32
    # choose_args (defaults mirror weights/items)
    pos_weights: np.ndarray  # [P,B,S] u32
    arg_ids: np.ndarray  # [B,S] i32

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


def _map_depth(m: CrushMap) -> int:
    """Longest chain of nested buckets (loop bound for descents)."""
    depth: dict[int, int] = {}

    def d(bid: int) -> int:
        if bid >= 0:
            return 0
        if bid in depth:
            return depth[bid]
        depth[bid] = 1  # guard cycles
        b = m.buckets.get(bid)
        if b is None:
            return 1
        depth[bid] = 1 + max((d(i) for i in b.items), default=0)
        return depth[bid]

    return max((d(b) for b in m.buckets), default=1)


def build_arrays(
    m: CrushMap, choose_args: Any | int | str | None = None,
) -> CrushArrays:
    """Freeze a CrushMap (+ optionally one named choose_args set) to SoA."""
    if isinstance(choose_args, (int, str)):
        choose_args = m.choose_args.get(choose_args)

    B = m.max_buckets
    S = max((b.size for b in m.buckets.values()), default=1) or 1
    NN = 2
    for b in m.buckets.values():
        if b.alg == BucketAlg.TREE and b.node_weights:
            NN = max(NN, len(b.node_weights))
    P = 1
    if choose_args is not None:
        for ws in choose_args.weight_sets.values():
            P = max(P, len(ws))

    alg = np.zeros(B, np.int32)
    btype = np.zeros(B, np.int32)
    size = np.zeros(B, np.int32)
    bw = np.zeros(B, np.uint32)
    items = np.zeros((B, S), np.int32)
    weights = np.zeros((B, S), np.uint32)
    sumw = np.zeros((B, S), np.uint32)
    straws = np.zeros((B, S), np.uint32)
    nodew = np.zeros((B, NN), np.uint32)
    nnodes = np.zeros(B, np.int32)
    arg_ids = np.zeros((B, S), np.int32)

    for bid, b in m.buckets.items():
        slot = -1 - bid
        alg[slot] = int(b.alg)
        btype[slot] = b.type
        size[slot] = b.size
        bw[slot] = b.weight & 0xFFFFFFFF
        items[slot, : b.size] = b.items
        weights[slot, : b.size] = b.weights
        arg_ids[slot, : b.size] = b.items
        if b.alg == BucketAlg.LIST:
            if b.sum_weights is None:
                b.finalize_derived(m.tunables.straw_calc_version)
            sumw[slot, : b.size] = b.sum_weights
        elif b.alg == BucketAlg.TREE:
            if b.node_weights is None:
                b.finalize_derived(m.tunables.straw_calc_version)
            nw = b.node_weights or []
            nodew[slot, : len(nw)] = nw
            nnodes[slot] = len(nw)
        elif b.alg == BucketAlg.STRAW:
            if b.straws is None:
                b.finalize_derived(m.tunables.straw_calc_version)
            straws[slot, : b.size] = b.straws

    pos_weights = np.broadcast_to(weights, (P, B, S)).copy()
    if choose_args is not None:
        for bid, ws in choose_args.weight_sets.items():
            slot = -1 - bid
            n = m.buckets[bid].size
            for p in range(P):
                row = ws[min(p, len(ws) - 1)]
                pos_weights[p, slot, :n] = row
        for bid, ids in choose_args.ids.items():
            slot = -1 - bid
            n = m.buckets[bid].size
            arg_ids[slot, :n] = ids

    return CrushArrays(
        n_buckets=B,
        max_size=S,
        max_nodes=NN,
        positions=P,
        max_devices=m.max_devices,
        max_depth=_map_depth(m),
        tunables=m.tunables,
        rules=tuple(m.rules),
        alg=alg,
        btype=btype,
        size=size,
        bucket_weight=bw,
        items=items,
        weights=weights,
        sum_weights=sumw,
        straws=straws,
        node_weights=nodew,
        num_nodes=nnodes,
        pos_weights=pos_weights,
        arg_ids=arg_ids,
    )


def magic_div_consts(w: int) -> tuple[int, int]:
    """Invariant-divisor constants for the straw2 draw (a copy of
    `ceph_tpu/crush/mapper_jax.py::_magic_div_consts`):
    floor(n / w) == (n * m) >> (49 + l) for all 0 <= n <= 2^48, where
    l = ceil(log2 w) and m = ceil(2^(49+l) / w).  It holds because
    m * w - 2^(49+l) < w <= 2^l.  m < 2^50 and l <= 32 for a u32 w."""
    assert w >= 1
    l = max(0, (int(w) - 1).bit_length())
    m = -((-(1 << (49 + l))) // int(w))  # ceil division
    return m, l


MAGIC_SHIFT = 56  # a record's magic word: m | l << MAGIC_SHIFT (0 for w = 0)

# one draw's inputs, read with one 16-byte load.  straw2: the id it
# hashes, its weight and the weight's magic word.  The legacy algorithms
# ignore choose_args, so their records hold the bucket's own items and
# weights, and `magic` holds the algorithm's word: straw's straw, list's
# sum_weights entry (0 for tree and uniform)
RECORD = np.dtype([("arg_id", "<i4"), ("weight", "<u4"), ("magic", "<u8")])
# a bucket slot's header, 32 bytes: the kernel reads the first 16 (item
# offset, size, type, alg) for every bucket and the second 16 only for a
# tree: `spare` is the offset of its node weights in `nodes`, `num_nodes`
# their count
HEADER = np.dtype([("offset", "<i4"), ("size", "<i4"), ("type", "<i4"),
                   ("alg", "<i4"), ("spare", "<i4"), ("num_nodes", "<i4"),
                   ("pad", "<i4", (2,))])


def magic_words(w: np.ndarray) -> np.ndarray:
    """The packed magic word of each u32 weight: m | l << MAGIC_SHIFT."""
    w = np.asarray(w, np.uint64)
    uniq, inv = np.unique(w, return_inverse=True)
    words = np.zeros(len(uniq), np.uint64)
    for i, v in enumerate(uniq.tolist()):
        if v:
            m, l = magic_div_consts(v)
            words[i] = m | l << MAGIC_SHIFT
    return words[inv].reshape(w.shape)


@dataclass(frozen=True)
class PackedBuckets:
    """The rule kernel's view of a map (numpy).

    headers[slot] (HEADER): `offset` is the bucket's first index into
    `items`; its records for weight-set position p are
    records[positions * offset + p * size + i], i < size.  Buckets are laid
    out breadth first from the roots the rules take, so the levels every
    lane visits come first; `level_ends[d]` counts the records of levels
    0..d, the prefixes the kernel may stage in shared memory."""

    headers: np.ndarray  # [B] HEADER
    records: np.ndarray  # [positions * sum(size)] RECORD
    items: np.ndarray  # [sum(size)] i32
    nodes: np.ndarray  # [sum of the trees' num_nodes] u32 node weights
    level_ends: tuple  # records through each breadth-first level


def _bfs_levels(A: CrushArrays) -> list[list[int]]:
    """Bucket slots by breadth-first level from the rules' TAKE roots;
    the slots no root reaches follow as one last level."""
    B = A.n_buckets
    live = [s for s in range(B) if A.size[s] > 0]
    seen: set[int] = set()
    level = []
    for r in A.rules:
        for op, a1, _ in (r.steps if r is not None else ()):
            s = -1 - int(a1)
            if op == RuleOp.TAKE and a1 < 0 and s < B and A.size[s] > 0 \
                    and s not in seen:
                seen.add(s)
                level.append(s)
    levels = []
    while level:
        levels.append(level)
        nxt = []
        for s in level:
            for it in A.items[s, : A.size[s]]:
                c = -1 - int(it)
                if it < 0 and c < B and A.size[c] > 0 and c not in seen:
                    seen.add(c)
                    nxt.append(c)
        level = nxt
    rest = [s for s in live if s not in seen]
    if rest:
        levels.append(rest)
    return levels


def pack_buckets(A: CrushArrays) -> PackedBuckets:
    """Lay out A's buckets for the rule kernel (see PackedBuckets)."""
    P = A.positions
    headers = np.zeros(A.n_buckets, HEADER)
    headers["type"] = A.btype
    headers["alg"] = A.alg
    items, recs, nodes, level_ends = [], [], [], []
    offset = n_nodes = 0
    for level in _bfs_levels(A):
        for s in level:
            n = int(A.size[s])
            alg = int(A.alg[s])
            headers[s]["offset"] = offset
            headers[s]["size"] = n
            items.append(A.items[s, :n])
            r = np.zeros((P, n), RECORD)
            if alg == BucketAlg.STRAW2:
                r["arg_id"] = A.arg_ids[s, :n]
                r["weight"] = A.pos_weights[:, s, :n]
                r["magic"] = magic_words(r["weight"])
            else:
                r["arg_id"] = A.items[s, :n]
                r["weight"] = A.weights[s, :n]
                if alg == BucketAlg.STRAW:
                    r["magic"] = A.straws[s, :n]
                elif alg == BucketAlg.LIST:
                    r["magic"] = A.sum_weights[s, :n]
            if alg == BucketAlg.TREE:
                nn = int(A.num_nodes[s])
                headers[s]["spare"] = n_nodes
                headers[s]["num_nodes"] = nn
                nodes.append(A.node_weights[s, :nn])
                n_nodes += nn
            recs.append(r.reshape(-1))
            offset += n
        level_ends.append(P * offset)
    return PackedBuckets(
        headers=headers,
        records=np.concatenate(recs) if recs else np.zeros(0, RECORD),
        items=(np.concatenate(items).astype(np.int32) if items
               else np.zeros(0, np.int32)),
        nodes=(np.concatenate(nodes).astype(np.uint32) if nodes
               else np.zeros(0, np.uint32)),
        level_ends=tuple(level_ends),
    )


@dataclass(frozen=True)
class DeviceArrays:
    """A map on one device: the padded fields of a CrushArrays that the
    plain version reads, as int32 tensors (u32 fields hold their bit
    patterns; pos_weights is [P, B, S], items, arg_ids, weights,
    sum_weights and straws [B, S], node_weights [B, NN]), and the
    kernel's PackedBuckets (headers int32 [B, 8], records int32 [R, 4],
    packed_items int32 [sum(size)], nodes int32 [at least 1]), with the
    sizes they need."""

    alg: torch.Tensor
    btype: torch.Tensor
    size: torch.Tensor
    items: torch.Tensor
    pos_weights: torch.Tensor
    arg_ids: torch.Tensor
    weights: torch.Tensor
    sum_weights: torch.Tensor
    straws: torch.Tensor
    node_weights: torch.Tensor
    num_nodes: torch.Tensor
    headers: torch.Tensor
    records: torch.Tensor
    packed_items: torch.Tensor
    nodes: torch.Tensor
    level_ends: tuple
    n_buckets: int
    max_size: int
    positions: int
    max_devices: int
    max_depth: int

    @property
    def device(self) -> torch.device:
        return self.items.device


def to_device(A: CrushArrays, device) -> DeviceArrays:
    """Upload the kernel's fields of `A` to `device`, once per map."""

    def put(a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)

    pk = pack_buckets(A)
    return DeviceArrays(
        alg=put(A.alg), btype=put(A.btype), size=put(A.size),
        items=put(A.items), pos_weights=put(A.pos_weights),
        arg_ids=put(A.arg_ids), weights=put(A.weights),
        sum_weights=put(A.sum_weights), straws=put(A.straws),
        node_weights=put(A.node_weights), num_nodes=put(A.num_nodes),
        headers=put(pk.headers.view(np.int32).reshape(-1, 8)),
        records=put(pk.records.view(np.int32).reshape(-1, 4)),
        packed_items=put(pk.items),
        nodes=put(pk.nodes if len(pk.nodes) else np.zeros(1, np.uint32)),
        level_ends=pk.level_ends,
        n_buckets=A.n_buckets, max_size=A.max_size, positions=A.positions,
        max_devices=A.max_devices, max_depth=A.max_depth,
    )
