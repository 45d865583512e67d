"""CRUSH map object model, semantics-compatible with the C reference
(reference src/crush/crush.h:229-461, src/crush/builder.c).  A copy of
`ceph_tpu/crush/types.py`: the port keeps its own.

A CrushMap is a hierarchy of weighted buckets (internal nodes, negative ids)
over devices (leaves, ids >= 0), plus placement rules.  Weights are 16.16
fixed point throughout (0x10000 == weight 1.0).

This is the *host-side* model: mutable, Pythonic, used by the builders.
The rule kernel consumes the frozen structure-of-arrays form built by
ceph_tpu_torch.crush.soa.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import IntEnum

ITEM_NONE = 0x7FFFFFFF  # CRUSH_ITEM_NONE  (reference src/crush/crush.h:33)
ITEM_UNDEF = 0x7FFFFFFE  # CRUSH_ITEM_UNDEF (mapping in progress)
MAX_DEPTH = 10  # CRUSH_MAX_DEPTH (reference src/crush/crush.h:26)


class BucketAlg(IntEnum):
    # reference src/crush/crush.h crush_algorithm
    UNIFORM = 1
    LIST = 2
    TREE = 3
    STRAW = 4
    STRAW2 = 5


class RuleOp(IntEnum):
    # reference src/crush/crush.h:52-70 crush_opcodes
    NOOP = 0
    TAKE = 1
    CHOOSE_FIRSTN = 2
    CHOOSE_INDEP = 3
    EMIT = 4
    CHOOSELEAF_FIRSTN = 6
    CHOOSELEAF_INDEP = 7
    SET_CHOOSE_TRIES = 8
    SET_CHOOSELEAF_TRIES = 9
    SET_CHOOSE_LOCAL_TRIES = 10
    SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
    SET_CHOOSELEAF_VARY_R = 12
    SET_CHOOSELEAF_STABLE = 13


@dataclass
class Tunables:
    """Mapping tunables; defaults = the modern "jewel" profile
    (reference src/crush/CrushWrapper.h:331-368 set_tunables_jewel)."""

    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    choose_total_tries: int = 50
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1
    straw_calc_version: int = 1
    allowed_bucket_algs: int = (
        (1 << BucketAlg.UNIFORM)
        | (1 << BucketAlg.LIST)
        | (1 << BucketAlg.STRAW)
        | (1 << BucketAlg.STRAW2)
    )

    @classmethod
    def profile(cls, name: str) -> "Tunables":
        # reference src/crush/CrushWrapper.h:331-368 (set_tunables_*)
        if name in ("legacy", "argonaut"):
            return cls(2, 5, 19, 0, 0, 0, 0, 0xFFFFFFFF)
        if name == "bobtail":
            return cls(0, 0, 50, 1, 0, 0, 0, 0xFFFFFFFF)
        if name in ("firefly", "hammer"):
            t = cls(0, 0, 50, 1, 1, 0)
            return t
        if name in ("jewel", "default", "optimal"):
            return cls()
        raise ValueError(f"unknown tunables profile {name!r}")


def _tree_height(n: int) -> int:
    h = 0
    while (n & 1) == 0:
        h += 1
        n >>= 1
    return h


def tree_node_of_leaf(i: int) -> int:
    """leaf index -> tree node id (reference src/crush/crush.h:504-507)."""
    return ((i + 1) << 1) - 1


def tree_parent(n: int) -> int:
    # reference src/crush/builder.c:305-311
    h = _tree_height(n)
    if n & (1 << (h + 1)):
        return n - (1 << h)
    return n + (1 << h)


@dataclass
class Bucket:
    """One internal node.  items are child ids (devices >= 0, buckets < 0);
    weights are per-child 16.16 fixed point."""

    id: int
    alg: BucketAlg
    type: int
    items: list[int] = field(default_factory=list)
    weights: list[int] = field(default_factory=list)
    hash: int = 0  # CRUSH_HASH_RJENKINS1
    # alg-specific derived tables (built lazily by finalize_derived):
    sum_weights: list[int] | None = None  # LIST: prefix sums
    node_weights: list[int] | None = None  # TREE: heap-layout node weights
    straws: list[int] | None = None  # STRAW: scaled straw lengths

    @property
    def size(self) -> int:
        return len(self.items)

    @property
    def weight(self) -> int:
        return sum(self.weights)

    def finalize_derived(self, straw_calc_version: int = 1) -> None:
        if self.alg == BucketAlg.LIST:
            s, acc = [], 0
            for w in self.weights:
                acc += w
                s.append(acc)
            self.sum_weights = s
        elif self.alg == BucketAlg.TREE:
            # reference src/crush/builder.c:328-391 crush_make_tree_bucket
            if self.size == 0:
                self.node_weights = []
                return
            # calc_depth semantics (reference src/crush/builder.c:314-326)
            t = self.size - 1
            depth = 1
            while t:
                t >>= 1
                depth += 1
            num_nodes = 1 << depth
            nw = [0] * num_nodes
            for i, w in enumerate(self.weights):
                node = tree_node_of_leaf(i)
                nw[node] = w
                for _ in range(1, depth):
                    node = tree_parent(node)
                    nw[node] += w
            self.node_weights = nw
        elif self.alg == BucketAlg.STRAW:
            self.straws = calc_straws(self.weights, straw_calc_version)


def calc_straws(weights: list[int], straw_calc_version: int = 1) -> list[int]:
    """Legacy straw(1) scaler (reference src/crush/builder.c:431-545
    crush_calc_straw).  Kept for parity with old maps; straw2 needs none."""
    size = len(weights)
    straws = [0] * size
    # stable reverse argsort by weight, ties keep original order (insertion
    # sort semantics of the reference)
    reverse = sorted(range(size), key=lambda i: (weights[i], i))
    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        if straw_calc_version == 0:
            if weights[reverse[i]] == 0:
                straws[reverse[i]] = 0
                i += 1
                continue
            straws[reverse[i]] = int(straw * 0x10000)
            i += 1
            if i == size:
                break
            if weights[reverse[i]] == weights[reverse[i - 1]]:
                continue
            wbelow += (float(weights[reverse[i - 1]]) - lastw) * numleft
            for j in range(i, size):
                if weights[reverse[j]] == weights[reverse[i]]:
                    numleft -= 1
                else:
                    break
            wnext = numleft * (weights[reverse[i]] - weights[reverse[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= math.pow(1.0 / pbelow, 1.0 / numleft)
            lastw = float(weights[reverse[i - 1]])
        else:
            if weights[reverse[i]] == 0:
                straws[reverse[i]] = 0
                i += 1
                numleft -= 1
                continue
            straws[reverse[i]] = int(straw * 0x10000)
            i += 1
            if i == size:
                break
            wbelow += (float(weights[reverse[i - 1]]) - lastw) * numleft
            numleft -= 1
            wnext = numleft * (weights[reverse[i]] - weights[reverse[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= math.pow(1.0 / pbelow, 1.0 / numleft)
            lastw = float(weights[reverse[i - 1]])
    return straws


@dataclass
class Rule:
    """A placement rule: list of (op, arg1, arg2) steps plus its mask
    (reference src/crush/crush.h crush_rule{,_mask,_step})."""

    steps: list[tuple[int, int, int]]
    ruleset: int = 0
    type: int = 1  # pool type: 1=replicated, 3=erasure
    min_size: int = 1
    max_size: int = 10


@dataclass
class ChooseArgs:
    """Per-bucket weight-set overrides (reference src/crush/crush.h:273-294
    crush_choose_arg{,_map}).  weight_sets[bucket_id] is a [positions][size]
    list of alternative 16.16 weights; ids[bucket_id] optionally remaps the
    hashed item ids."""

    weight_sets: dict[int, list[list[int]]] = field(default_factory=dict)
    ids: dict[int, list[int]] = field(default_factory=dict)


class CrushMap:
    """The full map: buckets + rules + tunables + named choose_args."""

    def __init__(self, tunables: Tunables | None = None):
        self.tunables = tunables or Tunables()
        self.buckets: dict[int, Bucket] = {}  # id (<0) -> Bucket
        self.rules: list[Rule | None] = []
        self.max_devices = 0
        self.choose_args: dict[int | str, ChooseArgs] = {}
        # naming layers (CrushWrapper equivalents)
        self.type_names: dict[int, str] = {0: "osd"}
        self.item_names: dict[int, str] = {}
        self.rule_names: dict[int, str] = {}
        self.item_classes: dict[int, str] = {}  # device id -> class name
        self.class_names: dict[int, str] = {}  # class id -> class name
        self.class_bucket: dict[int, dict[int, int]] = {}  # orig id -> class id -> shadow id
        self.choose_tries_histogram: list[int] | None = None

    # -- construction ------------------------------------------------------
    @property
    def max_buckets(self) -> int:
        return -min(self.buckets.keys(), default=0)

    def next_bucket_id(self) -> int:
        for i in range(len(self.buckets) + 1):
            if -1 - i not in self.buckets:
                return -1 - i
        raise AssertionError

    def add_bucket(
        self,
        alg: BucketAlg | int,
        type_: int,
        items: list[int],
        weights: list[int],
        id: int | None = None,
        hash: int = 0,
        name: str | None = None,
    ) -> int:
        bid = self.next_bucket_id() if id is None else id
        assert bid < 0 and bid not in self.buckets
        b = Bucket(bid, BucketAlg(alg), type_, list(items), list(weights), hash)
        b.finalize_derived(self.tunables.straw_calc_version)
        self.buckets[bid] = b
        for it in items:
            if it >= 0:
                self.max_devices = max(self.max_devices, it + 1)
        if name is not None:
            self.item_names[bid] = name
        return bid

    def add_rule(self, rule: Rule, ruleno: int | None = None) -> int:
        if ruleno is None:
            self.rules.append(rule)
            return len(self.rules) - 1
        while len(self.rules) <= ruleno:
            self.rules.append(None)
        self.rules[ruleno] = rule
        return ruleno

    def bucket(self, item: int) -> Bucket | None:
        return self.buckets.get(item)

    def refresh_derived(self) -> None:
        for b in self.buckets.values():
            b.finalize_derived(self.tunables.straw_calc_version)

    def parent_of(self, item: int) -> int | None:
        for bid, b in self.buckets.items():
            if item in b.items:
                return bid
        return None

    def adjust_item_weight(self, item: int, weight: int) -> None:
        """Set a device/bucket's weight and propagate the delta up every
        ancestor chain (reference CrushWrapper::adjust_item_weight /
        bucket_adjust_item_weight semantics)."""
        shadows = {
            sid for per in self.class_bucket.values() for sid in per.values()
        }
        for bid, b in self.buckets.items():
            if bid in shadows:
                continue
            for j, it in enumerate(b.items):
                if it == item:
                    delta = weight - b.weights[j]
                    b.weights[j] = weight
                    # bubble the delta up to the roots
                    cur = bid
                    while True:
                        parent = self.parent_of(cur)
                        if parent is None or parent in shadows:
                            break
                        pb = self.buckets[parent]
                        idx = pb.items.index(cur)
                        pb.weights[idx] += delta
                        cur = parent
        self.refresh_derived()

    # -- device classes ----------------------------------------------------
    def class_id(self, name: str) -> int:
        for cid, n in self.class_names.items():
            if n == name:
                return cid
        cid = max(self.class_names.keys(), default=-1) + 1
        self.class_names[cid] = name
        return cid

    def build_class_shadow_trees(
        self, preferred: dict[int, dict[str, int]] | None = None
    ) -> None:
        """Build per-class shadow hierarchies — the semantics of the
        reference's class-filtered trees (`device_class_clone`, reference
        src/crush/CrushWrapper.cc:2693 / rebuild_roots_with_classes): for
        every device class, clone each bucket keeping only that class's
        devices, so `step take <root> class <c>` TAKEs the shadow root.
        Shadow buckets are ordinary buckets here (the SoA kernel maps them
        like any other); they are named "<orig>~<class>" and recorded in
        class_bucket[orig][class_id].

        `preferred` pins shadow ids: {orig_bucket_id: {class_name: id}} —
        used by the text compiler to honor `id -N class <c>` declarations
        so choose_args entries keyed by shadow bucket id stay attached to
        the right bucket."""
        # drop previous shadows
        old = {
            sid
            for per in self.class_bucket.values()
            for sid in per.values()
        }
        for sid in old:
            self.buckets.pop(sid, None)
            self.item_names.pop(sid, None)
        self.class_bucket = {}
        classes = sorted(set(self.item_classes.values()))
        if not classes:
            return
        originals = sorted(self.buckets.keys(), reverse=True)  # -1, -2, ...

        for cname in classes:
            cid = self.class_id(cname)
            shadow_of: dict[int, int] = {}

            def clone(bid: int) -> int:
                if bid in shadow_of:
                    return shadow_of[bid]
                b = self.buckets[bid]
                items: list[int] = []
                weights: list[int] = []
                for it, w in zip(b.items, b.weights):
                    if it >= 0:
                        if self.item_classes.get(it) == cname:
                            items.append(it)
                            weights.append(w)
                    else:
                        sid = clone(it)
                        items.append(sid)
                        weights.append(self.buckets[sid].weight)
                want_id = (preferred or {}).get(bid, {}).get(cname)
                if want_id is not None and want_id in self.buckets:
                    want_id = None
                sid = self.add_bucket(
                    b.alg, b.type, items, weights, hash=b.hash,
                    id=want_id,
                    name=(
                        f"{self.item_names[bid]}~{cname}"
                        if bid in self.item_names else None
                    ),
                )
                shadow_of[bid] = sid
                self.class_bucket.setdefault(bid, {})[cid] = sid
                return sid

            for bid in originals:
                clone(bid)

    def split_id_class(self, item: int) -> tuple[int, int]:
        """shadow id -> (original id, class id); (item, -1) if not a
        shadow (reference CrushWrapper::split_id_class)."""
        for orig, per in self.class_bucket.items():
            for cid, sid in per.items():
                if sid == item:
                    return orig, cid
        return item, -1

    # -- convenience -------------------------------------------------------
    def insert_item(
        self, item: int, weightf: float, name: str,
        loc: dict[str, str],
    ) -> None:
        """CrushWrapper::insert_item semantics (reference
        src/crush/CrushWrapper.cc:1095-1210): walk the type hierarchy
        bottom-up creating missing location buckets (straw2, weight 0)
        and splice the chain into the first existing ancestor; then set
        the item's weight and bubble the delta to the roots.  Bucket ids
        are allocated lowest-free-slot (-1-slot), matching the C
        builder, so maps built this way decompile identically."""
        if self.item_names.get(item, name) != name and item >= 0:
            raise ValueError(f"name {name!r} vs existing "
                             f"{self.item_names[item]!r}")
        self.item_names.setdefault(item, name)
        name_to_id = {n: i for i, n in self.item_names.items()}
        cur = item
        for type_id in sorted(self.type_names):
            if type_id == 0:
                continue
            tname = self.type_names[type_id]
            if tname not in loc:
                continue
            bname = loc[tname]
            if bname not in name_to_id:
                bid = self.add_bucket(
                    BucketAlg.STRAW2, type_id, [cur], [0], name=bname
                )
                name_to_id[bname] = bid
                cur = bid
                continue
            b = self.buckets[name_to_id[bname]]
            b.items.append(cur)
            b.weights.append(0)
            b.finalize_derived(self.tunables.straw_calc_version)
            break
        if item >= 0:
            self.max_devices = max(self.max_devices, item + 1)
        self.adjust_item_weight(item, int(round(weightf * 0x10000)))

    def _detach_item(self, item: int) -> bool:
        """Remove `item` from EVERY bucket holding it (shadow class trees
        included), bubbling the weight delta up each chain.  Returns True
        if it was held anywhere."""
        found = False
        for bid, holder in list(self.buckets.items()):
            if item not in holder.items:
                continue
            found = True
            j = holder.items.index(item)
            delta = -holder.weights[j]
            holder.items.pop(j)
            holder.weights.pop(j)
            holder.finalize_derived(self.tunables.straw_calc_version)
            cur = bid
            while delta:
                parent = self.parent_of(cur)
                if parent is None:
                    break
                pb = self.buckets[parent]
                idx = pb.items.index(cur)
                pb.weights[idx] += delta
                pb.finalize_derived(self.tunables.straw_calc_version)
                cur = parent
        return found

    def remove_item(self, item: int) -> bool:
        """Detach a device/bucket from the tree and destroy its identity
        (reference CrushWrapper::remove_item: bucket freed, name erased).
        Returns True if found."""
        found = self._detach_item(item)
        if item < 0:
            found = self.buckets.pop(item, None) is not None or found
        self.item_names.pop(item, None)
        if item >= 0:
            self.item_classes.pop(item, None)
        return found

    def item_loc(self, item: int) -> dict[str, str]:
        """{type_name: bucket_name} chain of the item's current ancestors
        (non-shadow), for check_item_loc-style comparisons."""
        shadows = {
            sid for per in self.class_bucket.values()
            for sid in per.values()
        }
        out: dict[str, str] = {}
        cur = item
        while True:
            parent = next(
                (bid for bid, b in self.buckets.items()
                 if bid not in shadows and cur in b.items), None
            )
            if parent is None:
                return out
            b = self.buckets[parent]
            out[self.type_names.get(b.type, str(b.type))] = \
                self.item_names.get(parent, str(parent))
            cur = parent

    def item_weight(self, item: int) -> int | None:
        """Current (non-shadow) weight of the item, or None if absent."""
        shadows = {
            sid for per in self.class_bucket.values()
            for sid in per.values()
        }
        for bid, b in self.buckets.items():
            if bid in shadows:
                continue
            if item in b.items:
                return b.weights[b.items.index(item)]
        return None

    def create_or_move_item(
        self, item: int, weightf: float, name: str, loc: dict[str, str]
    ) -> bool:
        """reference CrushWrapper::create_or_move_item: no-op when the
        item already sits at loc; otherwise detach and re-insert, keeping
        an existing item's current weight over the passed one.  Returns
        True if the map changed."""
        cur_loc = self.item_loc(item)
        if cur_loc and all(cur_loc.get(t) == n for t, n in loc.items()
                           if t in cur_loc):
            return False  # already there
        w = self.item_weight(item)
        if w is not None:
            weightf = w / 0x10000  # "resetting name/weight to current"
        self._detach_item(item)
        self.item_names.pop(item, None)
        self.insert_item(item, weightf, name, loc)
        return True

    def make_replicated_rule(
        self, root: int, failure_domain_type: int, num_rep: int = 0
    ) -> int:
        """CrushWrapper::add_simple_rule semantics for a replicated pool
        (reference src/crush/CrushWrapper.cc:2370): take root ->
        chooseleaf_firstn {0|n} type fd -> emit."""
        steps = [(RuleOp.TAKE, root, 0)]
        if failure_domain_type == 0:
            steps.append((RuleOp.CHOOSE_FIRSTN, num_rep, 0))
        else:
            steps.append((RuleOp.CHOOSELEAF_FIRSTN, num_rep, failure_domain_type))
        steps.append((RuleOp.EMIT, 0, 0))
        return self.add_rule(Rule(steps, ruleset=len(self.rules), type=1))

    def make_erasure_rule(
        self, root: int, failure_domain_type: int, num_chunks: int = 0
    ) -> int:
        """ErasureCode::create_rule semantics (reference
        src/erasure-code/ErasureCode.cc:64-83): set_chooseleaf_tries 5 ->
        take root -> chooseleaf_indep {0|n} type fd -> emit."""
        steps = [
            (RuleOp.SET_CHOOSELEAF_TRIES, 5, 0),
            (RuleOp.TAKE, root, 0),
        ]
        if failure_domain_type == 0:
            steps.append((RuleOp.CHOOSE_INDEP, num_chunks, 0))
        else:
            steps.append((RuleOp.CHOOSELEAF_INDEP, num_chunks, failure_domain_type))
        steps.append((RuleOp.EMIT, 0, 0))
        return self.add_rule(
            Rule(steps, ruleset=len(self.rules), type=3, max_size=20)
        )
