"""crushtool — flag-compatible CLI over the text compiler + tester.

The port of `ceph_tpu/cli/crushtool.py`, with the same flags, messages,
exit codes and output.  Covers the reference tool's
compile/decompile/build/test surface (reference
src/tools/crushtool.cc:129-231 usage, :436-1276 arg loop):

    crushtool -c map.txt -o map        compile to the wire-format binary
    crushtool -d map [-o out.txt]      decompile (binary or text input)
    crushtool --build --num_osds N layer1 alg size ...
    crushtool -i map --test [--min-x --max-x --num-rep --rule --pool-id
                             --weight osd w --show-statistics
                             --show-utilization[-all] --show-mappings
                             --show-bad-mappings --show-choose-tries
                             --simulate --backend torch|native|ref]
    crushtool -i map --tree
    crushtool -i map --reweight-item name w -o out
    crushtool -i map explain <x> | <pool>.<seed> [--rule --num-rep]
    crushtool -i map --locate-divergence [--against map] [--min-x --max-x]

Extra:

    --backend torch|native|ref the rule kernel (default; "jax" is its
                               alias), the threaded C++ host mapper, or
                               the pure-Python host mapper
    --device cuda|cpu          where the torch backend runs (default: the
                               card; cpu runs the kernel's plain version)

`explain` replays one placement through the host oracle's decision
recorder; `--locate-divergence` runs the rule kernel's diagnostics
variant over the x range (on `--device`) and the host oracle over the
same seeds (walking `--against`'s map, default the input map) and names
the first choose step where they differ: exit 0 when none does, 2 when
one does (crush/explain.py).

    python -m ceph_tpu_torch.cli.crushtool -i map --test --device cpu
    python -m ceph_tpu_torch.cli.crushtool -i map explain 42 --num-rep 3
"""

from __future__ import annotations

import sys

import numpy as np

from ceph_tpu_torch.crush import explain as explain_mod
from ceph_tpu_torch.crush.codec import (
    decode_crushmap,
    encode_crushmap,
    looks_like_crushmap,
)
from ceph_tpu_torch.crush.compiler import compile_text, decompile
from ceph_tpu_torch.crush.soa import build_arrays
from ceph_tpu_torch.crush.tester import CrushTester, TesterConfig
from ceph_tpu_torch.crush.types import BucketAlg, CrushMap
from ceph_tpu_torch.osd.osdmap import DEFAULT_TYPES


def _read_map(path: str) -> CrushMap:
    """Binary (wire format) or text, auto-detected like the real tool."""
    with open(path, "rb") as f:
        data = f.read()
    if looks_like_crushmap(data):
        return decode_crushmap(data)
    return compile_text(data.decode())


def _write(path: str | None, text: str) -> None:
    if path is None or path == "-":
        sys.stdout.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)


def _write_map(path: str, m: CrushMap) -> None:
    """One suffix policy everywhere: .txt -> decompiled text, else the
    wire-format binary (what the reference tool emits)."""
    if path.endswith(".txt"):
        _write(path, decompile(m))
    else:
        with open(path, "wb") as f:
            f.write(encode_crushmap(m))


_ALGS = {
    "uniform": BucketAlg.UNIFORM,
    "list": BucketAlg.LIST,
    "tree": BucketAlg.TREE,
    "straw": BucketAlg.STRAW,
    "straw2": BucketAlg.STRAW2,
}


def build_map(num_osds: int, layers: list[tuple[str, str, int]]) -> CrushMap:
    """--build: stack layers bottom-up (reference crushtool.cc:731-919
    semantics: each layer groups `size` children of the previous layer into
    buckets of `alg`; size 0 = one bucket holding everything)."""
    m = CrushMap()
    m.type_names = dict(DEFAULT_TYPES)
    prev: list[tuple[int, int]] = [(i, 0x10000) for i in range(num_osds)]
    for i in range(num_osds):
        m.item_names[i] = f"osd.{i}"
    type_id = 0
    for lname, alg_name, size in layers:
        type_id += 1
        # register the layer name as a type if it isn't a default one
        if lname not in m.type_names.values():
            m.type_names[type_id] = lname
        else:
            type_id = next(
                t for t, n in m.type_names.items() if n == lname
            )
        alg = _ALGS[alg_name]
        groups: list[list[tuple[int, int]]] = []
        if size == 0:
            groups = [prev]
        else:
            for j in range(0, len(prev), size):
                groups.append(prev[j : j + size])
        new_prev = []
        for gi, g in enumerate(groups):
            name = f"{lname}{gi}" if len(groups) > 1 else lname
            bid = m.add_bucket(
                alg,
                type_id,
                [it for it, _ in g],
                [w for _, w in g],
                name=name,
            )
            new_prev.append((bid, sum(w for _, w in g)))
        prev = new_prev
    # default rule over failure-domain type 1, like the reference's
    # build path (crushtool.cc:1043 -> OSDMap::build_simple_crush_rules)
    if prev and prev[0][0] < 0:
        ruleno = m.make_replicated_rule(prev[0][0], failure_domain_type=1)
        m.rule_names[ruleno] = "replicated_rule"
    return m


def print_tree(m: CrushMap, out=sys.stdout) -> None:
    roots = set(m.buckets)
    shadow = {
        sid for per in m.class_bucket.values() for sid in per.values()
    }
    for b in m.buckets.values():
        for it in b.items:
            roots.discard(it)

    def walk(item: int, depth: int, weight: int | None):
        name = m.item_names.get(
            item, f"osd.{item}" if item >= 0 else f"bucket{-1-item}"
        )
        b = m.buckets.get(item)
        w = weight if weight is not None else (b.weight if b else 0x10000)
        kind = m.type_names.get(b.type, "bucket") if b else "osd"
        print(
            f"{'  ' * depth}{item}\t{w / 0x10000:.5f}\t{kind} {name}",
            file=out,
        )
        if b:
            for it, iw in zip(b.items, b.weights):
                walk(it, depth + 1, iw)

    print("ID\tWEIGHT\tTYPE NAME", file=out)
    for r in sorted(roots - shadow, reverse=True):
        walk(r, 0, None)


def _pick_rule(m: CrushMap, cfg: TesterConfig) -> tuple[int, int]:
    """(ruleno, numrep) for the single-placement commands: --rule wins,
    else the first present rule; --num-rep wins, else the rule's
    max_size (the tester's default numrep sweep upper bound)."""
    ruleno = (
        cfg.rule
        if cfg.rule >= 0
        else next((i for i, r in enumerate(m.rules) if r is not None), -1)
    )
    if not (0 <= ruleno < len(m.rules)) or m.rules[ruleno] is None:
        raise SystemExit(f"rule {ruleno} dne")
    nr = cfg.num_rep if cfg.num_rep >= 0 else m.rules[ruleno].max_size
    return ruleno, nr


def run_explain(m: CrushMap, cfg: TesterConfig, explain_x: str,
                out=None) -> int:
    """`crushtool -i map explain <x>`: replay one placement through the
    instrumented host oracle and print the decision log."""
    out = out if out is not None else sys.stdout
    if "." in explain_x:
        p, s = explain_x.split(".", 1)
        cfg.pool_id, x = int(p), int(s)
    else:
        x = int(explain_x)
    tester = CrushTester(m, cfg, out=out)
    ruleno, nr = _pick_rule(m, cfg)
    real_x = int(tester._real_xs(np.array([x], np.int64))[0])
    ex = explain_mod.explain_seed(m, ruleno, real_x, nr, tester.weight)
    if cfg.pool_id != -1:
        ex.update(pool=cfg.pool_id, seed=x, pps=real_x,
                  up=ex["result"], up_primary=(ex["result"] or [-1])[0])
    out.write(explain_mod.render_text(ex, m.item_names))
    return 0


def run_divergence(m: CrushMap, cfg: TesterConfig,
                   against_fn: str | None, out=None) -> int:
    """`crushtool -i map --locate-divergence [--against other]`: the
    device kernel (from `m`) against the host oracle (walking `against`,
    default `m`) over min-x..max-x; report the earliest differing choose
    step.  Returns 0 when every step agrees, 2 on a located divergence."""
    out = out if out is not None else sys.stdout
    tester = CrushTester(m, cfg, out=out)
    ruleno, nr = _pick_rule(m, cfg)
    xs = tester._real_xs(
        np.arange(cfg.min_x, cfg.max_x + 1, dtype=np.int64)
    )
    m_host = _read_map(against_fn) if against_fn else m
    d = explain_mod.first_divergence(
        m_host, build_arrays(m), ruleno, xs, nr, tester.weight,
        device=tester.device,
    )
    span = f"rule {ruleno} x {cfg.min_x}..{cfg.max_x} numrep {nr}"
    if d is None:
        print(f"no divergence: {span} agrees step-for-step", file=out)
        return 0
    print(f"DIVERGENCE: {span}", file=out)
    print(
        f"  first differing choose step: {d['step']} at x={d['x']} "
        f"(batch index {d['batch_index']})",
        file=out,
    )
    print(f"  jax:  {d['jax']}", file=out)
    print(f"  host: {d['host']}", file=out)
    print(
        f"  {d['n_divergent']}/{d['n_checked']} seeds diverge "
        f"({d['n_unresolved_skipped']} unresolved lanes host-rescued, "
        "not compared)",
        file=out,
    )
    print("host decision log for that seed:", file=out)
    out.write(explain_mod.render_text(d["host_log"], m_host.item_names))
    return 2


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    infn = None
    outfn = None
    compilefn = None
    decompilefn = None
    do_test = False
    do_tree = False
    do_build = False
    explain_x: str | None = None
    do_divergence = False
    against_fn: str | None = None
    num_osds = 0
    layers: list[tuple[str, str, int]] = []
    cfg = TesterConfig()
    reweights: list[tuple[str, float]] = []

    i = 0

    def next_arg(what: str) -> str:
        nonlocal i
        i += 1
        if i >= len(args):
            print(f"missing argument for {what}", file=sys.stderr)
            raise SystemExit(1)
        return args[i]

    while i < len(args):
        a = args[i]
        if a in ("-i", "--infn"):
            infn = next_arg(a)
        elif a in ("-o", "--outfn"):
            outfn = next_arg(a)
        elif a in ("-c", "--compile"):
            compilefn = next_arg(a)
        elif a in ("-d", "--decompile"):
            decompilefn = next_arg(a)
        elif a == "--test":
            do_test = True
        elif a == "explain":
            explain_x = next_arg(a)
        elif a == "--locate-divergence":
            do_divergence = True
        elif a == "--against":
            against_fn = next_arg(a)
        elif a == "--tree":
            do_tree = True
        elif a == "--build":
            do_build = True
        elif a == "--num_osds":
            num_osds = int(next_arg(a))
        elif a == "--min-x":
            cfg.min_x = int(next_arg(a))
        elif a == "--max-x":
            cfg.max_x = int(next_arg(a))
        elif a == "--x":
            cfg.min_x = cfg.max_x = int(next_arg(a))
        elif a == "--num-rep":
            cfg.num_rep = int(next_arg(a))
        elif a == "--min-rep":
            cfg.min_rep = int(next_arg(a))
        elif a == "--max-rep":
            cfg.max_rep = int(next_arg(a))
        elif a == "--rule":
            cfg.rule = int(next_arg(a))
        elif a == "--pool-id":
            cfg.pool_id = int(next_arg(a))
        elif a in ("-w", "--weight"):
            osd = int(next_arg(a))
            w = float(next_arg(a))
            cfg.weights[osd] = int(w * 0x10000)
        elif a == "--simulate":
            cfg.simulate = True
        elif a == "--backend":
            cfg.backend = next_arg(a)
        elif a == "--device":
            cfg.device = next_arg(a)
        elif a == "--show-statistics":
            cfg.show_statistics = True
        elif a == "--show-mappings":
            cfg.show_mappings = True
        elif a == "--show-bad-mappings":
            cfg.show_bad_mappings = True
        elif a == "--show-choose-tries":
            cfg.show_choose_tries = True
        elif a == "--show-utilization":
            cfg.show_utilization = True
        elif a == "--show-utilization-all":
            cfg.show_utilization_all = True
        elif a == "--reweight-item":
            name = next_arg(a)
            w = float(next_arg(a))
            reweights.append((name, w))
        elif do_build and i + 2 < len(args) + 1:
            # build layer triple: name alg size
            lname = a
            alg = next_arg("layer alg")
            size = int(next_arg("layer size"))
            if alg not in _ALGS:
                print(f"unknown bucket alg {alg!r}", file=sys.stderr)
                return 1
            layers.append((lname, alg, size))
        else:
            print(f"unrecognized argument {a!r}", file=sys.stderr)
            return 1
        i += 1

    if decompilefn:
        m = _read_map(decompilefn)
        _write(outfn, decompile(m))
        return 0
    if compilefn:
        m = _read_map(compilefn)  # parse = validate
        _write_map(outfn or "crushmap", m)
        return 0
    if do_build:
        if not num_osds or not layers:
            print("--build requires --num_osds and layers", file=sys.stderr)
            return 1
        m = build_map(num_osds, layers)
        if outfn:
            _write_map(outfn, m)
        else:
            print_tree(m)
        return 0

    if infn is None:
        print("no input map (-i), nothing to do", file=sys.stderr)
        return 1
    m = _read_map(infn)

    changed = False
    by_name = {v: k for k, v in m.item_names.items()}
    for name, w in reweights:
        item = by_name.get(name)
        if item is None:
            print(f"unknown item {name!r}", file=sys.stderr)
            return 1
        m.adjust_item_weight(item, int(w * 0x10000))
        m.build_class_shadow_trees()
        changed = True

    if explain_x is not None:
        return run_explain(m, cfg, explain_x)
    if do_divergence:
        try:
            return run_divergence(m, cfg, against_fn)
        except NotImplementedError as e:  # legacy local retries
            print(e, file=sys.stderr)
            return 1
    if do_tree:
        print_tree(m)
    if do_test:
        try:
            tester = CrushTester(m, cfg, out=sys.stdout)
        except ValueError as e:
            print(e, file=sys.stderr)
            return 1
        try:
            tester.test()
        except NotImplementedError as e:  # legacy local retries
            print(e, file=sys.stderr)
            return 1
    if changed and outfn:
        _write_map(outfn, m)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
