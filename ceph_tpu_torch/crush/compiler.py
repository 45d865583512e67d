"""Text crushmap compiler/decompiler.

A copy of `ceph_tpu/crush/compiler.py`, its imports pointed at the port.

Reads and writes the crushtool text format (the grammar of the reference's
CrushCompiler, reference src/crush/CrushCompiler.{h,cc} and
src/crush/grammar.h; `crushtool -d` output is the canonical form): tunables,
devices (with device classes), types, buckets, rules, choose_args.
Implemented as a straightforward tokenizer + recursive-descent parser — no
parser framework needed for this grammar.

compile_text(text) -> CrushMap     (builds class shadow trees when classes
                                    are present, so `take X class Y` works)
decompile(m)       -> str          (matches the reference's emitted layout,
                                    shadow buckets elided, `take` splits the
                                    shadow id back into name + class)
"""

from __future__ import annotations

import re

from ceph_tpu_torch.crush.types import (
    BucketAlg,
    CrushMap,
    ChooseArgs,
    Rule,
    RuleOp,
    Tunables,
)

_ALG_NAMES = {
    BucketAlg.UNIFORM: "uniform",
    BucketAlg.LIST: "list",
    BucketAlg.TREE: "tree",
    BucketAlg.STRAW: "straw",
    BucketAlg.STRAW2: "straw2",
}
_ALG_BY_NAME = {v: k for k, v in _ALG_NAMES.items()}

_SET_STEPS = {
    "set_choose_tries": RuleOp.SET_CHOOSE_TRIES,
    "set_choose_local_tries": RuleOp.SET_CHOOSE_LOCAL_TRIES,
    "set_choose_local_fallback_tries": RuleOp.SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    "set_chooseleaf_tries": RuleOp.SET_CHOOSELEAF_TRIES,
    "set_chooseleaf_vary_r": RuleOp.SET_CHOOSELEAF_VARY_R,
    "set_chooseleaf_stable": RuleOp.SET_CHOOSELEAF_STABLE,
}
_SET_STEP_NAMES = {v: k for k, v in _SET_STEPS.items()}

_TUNABLES = (
    "choose_local_tries",
    "choose_local_fallback_tries",
    "choose_total_tries",
    "chooseleaf_descend_once",
    "chooseleaf_vary_r",
    "chooseleaf_stable",
    "straw_calc_version",
    "allowed_bucket_algs",
)


class CompileError(ValueError):
    pass


def _tokenize(text: str) -> list[str]:
    out = []
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        for tok in re.findall(r"[\[\]{}]|[^\s\[\]{}]+", line):
            out.append(tok)
    return out


class _Parser:
    def __init__(self, toks: list[str]):
        self.toks = toks
        self.i = 0

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise CompileError("unexpected end of input")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, want: str) -> None:
        t = self.next()
        if t != want:
            raise CompileError(f"expected {want!r}, got {t!r}")

    def int_(self) -> int:
        t = self.next()
        try:
            return int(t)
        except ValueError:
            raise CompileError(f"expected integer, got {t!r}")

    def fixed(self) -> int:
        t = self.next()
        try:
            return int(round(float(t) * 0x10000))
        except ValueError:
            raise CompileError(f"expected weight, got {t!r}")


def compile_text(text: str) -> CrushMap:
    """Parse a text crushmap into a CrushMap."""
    p = _Parser(_tokenize(text))
    m = CrushMap(Tunables())
    m.type_names = {}
    devices: dict[str, int] = {}
    dev_class: dict[int, str] = {}
    # (bucket body parsed before ids of referenced buckets may be known?
    #  no: the text format requires children to be defined first, same as
    #  the reference compiler)
    name_to_item: dict[str, int] = {}
    pending_rules: list[tuple[str | None, list]] = []
    shadow_decls: dict[int, dict[str, int]] = {}  # bucket -> class -> id

    def resolve(name: str) -> int:
        if name in name_to_item:
            return name_to_item[name]
        raise CompileError(f"unknown item {name!r}")

    while (tok := p.peek()) is not None:
        if tok == "tunable":
            p.next()
            key = p.next()
            val = p.int_()
            if key not in _TUNABLES:
                raise CompileError(f"unknown tunable {key!r}")
            setattr(m.tunables, key, val)
        elif tok == "device":
            p.next()
            did = p.int_()
            name = p.next()
            devices[name] = did
            name_to_item[name] = did
            m.item_names[did] = name
            m.max_devices = max(m.max_devices, did + 1)
            if p.peek() == "class":
                p.next()
                dev_class[did] = p.next()
        elif tok == "type":
            p.next()
            tid = p.int_()
            m.type_names[tid] = p.next()
        elif tok == "rule":
            p.next()
            name = None
            if p.peek() != "{":
                name = p.next()
            p.expect("{")
            body: dict = {"steps": []}
            while p.peek() != "}":
                k = p.next()
                if k in ("id", "ruleset"):
                    body["id"] = p.int_()
                elif k == "type":
                    t = p.next()
                    body["type"] = {"replicated": 1, "erasure": 3}.get(
                        t, None
                    )
                    if body["type"] is None:
                        body["type"] = int(t)
                elif k == "min_size":
                    body["min_size"] = p.int_()
                elif k == "max_size":
                    body["max_size"] = p.int_()
                elif k == "step":
                    body["steps"].append(_parse_step(p))
                else:
                    raise CompileError(f"unknown rule field {k!r}")
            p.expect("}")
            pending_rules.append((name, body))
        elif tok == "choose_args":
            p.next()
            ca_id_tok = p.next()
            try:
                ca_id: int | str = int(ca_id_tok)
                # the reference stores choose_args keys as s64 but some
                # dumps print them as u64 (the compat set shows up as
                # 18446744073709551615): normalize so -1 stays -1 and
                # the binary codec's i64 encode can round-trip the map
                if ca_id >= 1 << 63:
                    ca_id -= 1 << 64
            except ValueError:
                ca_id = ca_id_tok
            ca = ChooseArgs()
            p.expect("{")
            while p.peek() == "{":
                p.next()
                bucket_id = None
                ws = None
                ids = None
                while p.peek() != "}":
                    k = p.next()
                    if k == "bucket_id":
                        bucket_id = p.int_()
                    elif k == "weight_set":
                        ws = []
                        p.expect("[")
                        while p.peek() == "[":
                            p.next()
                            row = []
                            while p.peek() != "]":
                                row.append(p.fixed())
                            p.expect("]")
                            ws.append(row)
                        p.expect("]")
                    elif k == "ids":
                        ids = []
                        p.expect("[")
                        while p.peek() != "]":
                            ids.append(p.int_())
                        p.expect("]")
                    else:
                        raise CompileError(
                            f"unknown choose_args field {k!r}"
                        )
                p.expect("}")
                if bucket_id is None:
                    raise CompileError("choose_args entry missing bucket_id")
                if ws is not None:
                    ca.weight_sets[bucket_id] = ws
                if ids is not None:
                    ca.ids[bucket_id] = ids
            p.expect("}")
            m.choose_args[ca_id] = ca
        else:
            # bucket: <typename> <name> { ... }
            typename = p.next()
            tid = None
            for t, n in m.type_names.items():
                if n == typename:
                    tid = t
                    break
            if tid is None:
                raise CompileError(
                    f"unknown keyword or type name {typename!r}"
                )
            bname = p.next()
            p.expect("{")
            bid = None
            alg = None
            hash_ = 0
            items: list[tuple[int, int | None, int | None]] = []
            class_ids: dict[str, int] = {}
            while p.peek() != "}":
                k = p.next()
                if k == "id":
                    v = p.int_()
                    if p.peek() == "class":
                        p.next()
                        class_ids[p.next()] = v  # declared shadow id
                    else:
                        bid = v
                elif k == "alg":
                    a = p.next()
                    if a not in _ALG_BY_NAME:
                        raise CompileError(f"unknown bucket alg {a!r}")
                    alg = _ALG_BY_NAME[a]
                elif k == "hash":
                    hash_ = p.int_()
                elif k == "item":
                    iname = p.next()
                    w = None
                    pos = None
                    while p.peek() in ("weight", "pos"):
                        if p.next() == "weight":
                            w = p.fixed()
                        else:
                            pos = p.int_()
                    items.append((resolve(iname), w, pos))
                else:
                    raise CompileError(f"unknown bucket field {k!r}")
            p.expect("}")
            if alg is None:
                raise CompileError(f"bucket {bname!r} missing alg")
            # place items honoring explicit pos
            n = len(items)
            slot_items: list[int | None] = [None] * n
            slot_weights: list[int] = [0] * n
            unplaced = []
            for item, w, pos in items:
                if w is None:
                    b = m.buckets.get(item)
                    w = b.weight if b is not None else 0
                if pos is not None:
                    if pos >= n or slot_items[pos] is not None:
                        raise CompileError(
                            f"bad pos {pos} in bucket {bname!r}"
                        )
                    slot_items[pos] = item
                    slot_weights[pos] = w
                else:
                    unplaced.append((item, w))
            fill = iter(unplaced)
            for j in range(n):
                if slot_items[j] is None:
                    item, w = next(fill)
                    slot_items[j] = item
                    slot_weights[j] = w
            bid = m.add_bucket(
                alg, tid, slot_items, slot_weights, id=bid, hash=hash_,
                name=bname,
            )
            name_to_item[bname] = bid
            if class_ids:
                shadow_decls[bid] = class_ids

    for did, cname in dev_class.items():
        m.item_classes[did] = cname
        m.class_id(cname)
    m.build_class_shadow_trees(preferred=shadow_decls)

    # resolve + install rules (after buckets & shadows exist)
    for name, body in pending_rules:
        steps = []
        for st in body["steps"]:
            op, a1, a2 = st
            if op == RuleOp.TAKE:
                iname, cname = a1
                item = resolve(iname)
                if cname is not None:
                    cid = m.class_id(cname)
                    shadow = m.class_bucket.get(item, {}).get(cid)
                    if shadow is None:
                        raise CompileError(
                            f"no class {cname!r} subtree under {iname!r}"
                        )
                    item = shadow
                steps.append((RuleOp.TAKE, item, 0))
            elif op in (
                RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSE_INDEP,
                RuleOp.CHOOSELEAF_FIRSTN, RuleOp.CHOOSELEAF_INDEP,
            ):
                tname = a2
                tid = None
                for t, n in m.type_names.items():
                    if n == tname:
                        tid = t
                        break
                if tid is None:
                    raise CompileError(f"unknown type {tname!r}")
                steps.append((op, a1, tid))
            else:
                steps.append((op, a1, a2))
        rule = Rule(
            steps,
            ruleset=body.get("id", len(m.rules)),
            type=body.get("type", 1),
            min_size=body.get("min_size", 1),
            max_size=body.get("max_size", 10),
        )
        ruleno = m.add_rule(rule, body.get("id"))
        if name:
            m.rule_names[ruleno] = name
    m.refresh_derived()
    return m


def _parse_step(p: _Parser):
    kind = p.next()
    if kind == "noop":
        return (RuleOp.NOOP, 0, 0)
    if kind == "take":
        name = p.next()
        cname = None
        if p.peek() == "class":
            p.next()
            cname = p.next()
        return (RuleOp.TAKE, (name, cname), 0)
    if kind == "emit":
        return (RuleOp.EMIT, 0, 0)
    if kind in _SET_STEPS:
        return (_SET_STEPS[kind], p.int_(), 0)
    if kind in ("choose", "chooseleaf"):
        mode = p.next()
        if mode not in ("firstn", "indep"):
            raise CompileError(f"bad choose mode {mode!r}")
        n = p.int_()
        p.expect("type")
        tname = p.next()
        op = {
            ("choose", "firstn"): RuleOp.CHOOSE_FIRSTN,
            ("choose", "indep"): RuleOp.CHOOSE_INDEP,
            ("chooseleaf", "firstn"): RuleOp.CHOOSELEAF_FIRSTN,
            ("chooseleaf", "indep"): RuleOp.CHOOSELEAF_INDEP,
        }[(kind, mode)]
        return (op, n, tname)
    raise CompileError(f"unknown step {kind!r}")


# -- decompile --------------------------------------------------------------

def _fixedpoint(v: int) -> str:
    return f"{v / 0x10000:.5f}"


def _item_name(m: CrushMap, i: int) -> str:
    if i in m.item_names:
        return m.item_names[i]
    return f"device{i}" if i >= 0 else f"bucket{-1 - i}"


def _type_name(m: CrushMap, t: int) -> str:
    if t in m.type_names:
        return m.type_names[t]
    return "device" if t == 0 else f"type{t}"


def _shadow_ids(m: CrushMap) -> set[int]:
    return {
        sid for per in m.class_bucket.values() for sid in per.values()
    }


def decompile(m: CrushMap) -> str:
    """Emit the text form (layout-compatible with `crushtool -d`)."""
    out = ["# begin crush map\n"]
    t = m.tunables
    for key in _TUNABLES:
        out.append(f"tunable {key} {getattr(t, key)}\n")

    out.append("\n# devices\n")
    for did in range(m.max_devices):
        # unnamed device slots are holes: no line (reference
        # CrushCompiler.cc decompile device loop)
        name = m.item_names.get(did)
        if name is None:
            if any(did in b.items for b in m.buckets.values()):
                name = f"osd.{did}"  # in-tree but unnamed
            else:
                continue
        line = f"device {did} {name}"
        if did in m.item_classes:
            line += f" class {m.item_classes[did]}"
        out.append(line + "\n")

    out.append("\n# types\n")
    for tid in sorted(m.type_names):
        out.append(f"type {tid} {m.type_names[tid]}\n")

    out.append("\n# buckets\n")
    shadows = _shadow_ids(m)
    done: set[int] = set()

    def emit_bucket(bid: int) -> None:
        if bid in done or bid >= 0 or bid in shadows:
            return
        done.add(bid)
        b = m.buckets[bid]
        for it in b.items:
            if it < 0:
                emit_bucket(it)
        out.append(f"{_type_name(m, b.type)} {_item_name(m, bid)} {{\n")
        out.append(f"\tid {bid}\t\t# do not change unnecessarily\n")
        for cid, sid in sorted(m.class_bucket.get(bid, {}).items()):
            out.append(
                f"\tid {sid} class {m.class_names[cid]}"
                "\t\t# do not change unnecessarily\n"
            )
        out.append(f"\t# weight {_fixedpoint(b.weight)}\n")
        out.append(f"\talg {_ALG_NAMES[b.alg]}\n")
        out.append(f"\thash {b.hash}\t# rjenkins1\n")
        for it, w in zip(b.items, b.weights):
            out.append(
                f"\titem {_item_name(m, it)} weight {_fixedpoint(w)}\n"
            )
        out.append("}\n")

    for bid in sorted(m.buckets, reverse=True):
        emit_bucket(bid)

    out.append("\n# rules\n")
    for ruleno, rule in enumerate(m.rules):
        if rule is None:
            continue
        rname = m.rule_names.get(ruleno, f"rule{ruleno}")
        out.append(f"rule {rname} {{\n")
        out.append(f"\tid {ruleno}\n")
        tname = {1: "replicated", 3: "erasure"}.get(
            rule.type, str(rule.type)
        )
        out.append(f"\ttype {tname}\n")
        out.append(f"\tmin_size {rule.min_size}\n")
        out.append(f"\tmax_size {rule.max_size}\n")
        for op, a1, a2 in rule.steps:
            if op == RuleOp.NOOP:
                out.append("\tstep noop\n")
            elif op == RuleOp.TAKE:
                orig, cid = m.split_id_class(a1)
                line = f"\tstep take {_item_name(m, orig)}"
                if cid >= 0:
                    line += f" class {m.class_names[cid]}"
                out.append(line + "\n")
            elif op == RuleOp.EMIT:
                out.append("\tstep emit\n")
            elif op in _SET_STEP_NAMES:
                out.append(f"\tstep {_SET_STEP_NAMES[op]} {a1}\n")
            elif op in (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSE_INDEP):
                mode = "firstn" if op == RuleOp.CHOOSE_FIRSTN else "indep"
                out.append(
                    f"\tstep choose {mode} {a1} type {_type_name(m, a2)}\n"
                )
            elif op in (RuleOp.CHOOSELEAF_FIRSTN, RuleOp.CHOOSELEAF_INDEP):
                mode = (
                    "firstn" if op == RuleOp.CHOOSELEAF_FIRSTN else "indep"
                )
                out.append(
                    f"\tstep chooseleaf {mode} {a1} "
                    f"type {_type_name(m, a2)}\n"
                )
        out.append("}\n")

    if m.choose_args:
        out.append("\n# choose_args\n")
        for ca_id in sorted(m.choose_args, key=str):
            ca = m.choose_args[ca_id]
            out.append(f"choose_args {ca_id} {{\n")
            for bucket_id in sorted(
                set(ca.weight_sets) | set(ca.ids), reverse=True
            ):
                out.append("  {\n")
                out.append(f"    bucket_id {bucket_id}\n")
                if bucket_id in ca.weight_sets:
                    out.append("    weight_set [\n")
                    for row in ca.weight_sets[bucket_id]:
                        out.append(
                            "      [ "
                            + " ".join(_fixedpoint(w) for w in row)
                            + " ]\n"
                        )
                    out.append("    ]\n")
                if bucket_id in ca.ids:
                    out.append(
                        "    ids [ "
                        + " ".join(str(i) for i in ca.ids[bucket_id])
                        + " ]\n"
                    )
                out.append("  }\n")
            out.append("}\n")

    out.append("\n# end crush map\n")
    return "".join(out)
