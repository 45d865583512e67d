"""Tree-analysis helpers over CrushMap used by the upmap balancer.

The port's copy of `ceph_tpu/balancer/crush_analysis.py`: the
CrushWrapper query surface the balancer depends on (reference
src/crush/CrushWrapper.cc): subtree_contains (:341), get_parent_of_type
(:1687), find_takes_by_rule, get_children_of_type, get_rule_weight_osd_map
(the weight map per TAKE, normalized then merged).
"""

from __future__ import annotations

from ceph_tpu_torch.crush.types import CrushMap, RuleOp


def subtree_contains(m: CrushMap, root: int, item: int) -> bool:
    if root == item:
        return True
    if root >= 0:
        return False
    b = m.buckets.get(root)
    if b is None:
        return False
    return any(subtree_contains(m, c, item) for c in b.items)


def find_takes_by_rule(m: CrushMap, ruleno: int) -> list[int]:
    rule = m.rules[ruleno]
    return [a1 for op, a1, _ in rule.steps if op == RuleOp.TAKE]


def get_children_of_type(
    m: CrushMap, root: int, type_: int, include_shadow: bool = False
) -> list[int]:
    if root >= 0:
        return []
    b = m.buckets.get(root)
    if b is None:
        return []
    if b.type == type_:
        return [root]
    out: list[int] = []
    for c in b.items:
        if c >= 0:
            if type_ == 0:
                out.append(c)
        else:
            cb = m.buckets.get(c)
            if cb is not None and cb.type == type_:
                out.append(c)
            else:
                out.extend(get_children_of_type(m, c, type_))
    return out


def get_immediate_parent_id(m: CrushMap, item: int) -> int | None:
    for bid, b in m.buckets.items():
        if item in b.items:
            return bid
    return None


def get_parent_of_type(
    m: CrushMap, item: int, type_: int, ruleno: int = -1
) -> int:
    """reference CrushWrapper.cc:1687-1712."""
    if ruleno < 0:
        cur = item
        while True:
            p = get_immediate_parent_id(m, cur)
            if p is None:
                return 0
            cur = p
            b = m.buckets.get(cur)
            if b is not None and b.type == type_:
                return cur
    for root in find_takes_by_rule(m, ruleno):
        for cand in get_children_of_type(m, root, type_):
            if subtree_contains(m, cand, item):
                return cand
    return 0


def _take_weight_map(m: CrushMap, root: int, out: dict[int, float]) -> float:
    """Accumulate leaf crush-weights (float) under root; returns the sum
    (reference _get_take_weight_osd_map)."""
    total = 0.0
    b = m.buckets.get(root)
    if b is None:
        return 0.0
    for item, w in zip(b.items, b.weights):
        if item >= 0:
            wf = w / 0x10000
            out[item] = out.get(item, 0.0) + wf
            total += wf
        else:
            total += _take_weight_map(m, item, out)
    return total


def get_rule_weight_osd_map(m: CrushMap, ruleno: int) -> dict[int, float]:
    """Per-TAKE normalized weight maps, merged (reference
    get_rule_weight_osd_map)."""
    pmap: dict[int, float] = {}
    rule = m.rules[ruleno]
    for op, a1, _ in rule.steps:
        if op != RuleOp.TAKE:
            continue
        sub: dict[int, float] = {}
        if a1 >= 0:
            sub[a1] = 1.0
            s = 1.0
        else:
            s = _take_weight_map(m, a1, sub)
        if s > 0:
            for k, v in sub.items():
                pmap[k] = pmap.get(k, 0.0) + v / s
    return pmap


def parent_of_type_map(m: CrushMap, type_: int, ruleno: int) -> dict[int, int]:
    """`get_parent_of_type(m, item, type_, ruleno)` for every item at
    once, ruleno >= 0: {item: the first bucket of type_ under the rule's
    takes, in get_children_of_type order, whose subtree holds item}.
    Items in none of them are absent (get_parent_of_type gives 0).  One
    walk of each subtree, where the per-item calls walk them per item."""
    out: dict[int, int] = {}
    for root in find_takes_by_rule(m, ruleno):
        for cand in get_children_of_type(m, root, type_):
            todo = [cand]
            while todo:
                item = todo.pop()
                out.setdefault(item, cand)
                b = m.buckets.get(item) if item < 0 else None
                if b is not None:
                    todo.extend(b.items)
    return out
