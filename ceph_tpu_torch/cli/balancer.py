"""balancer: the `ceph balancer` command surface, on the card.

The port of `ceph_tpu/cli/balancer.py` (the reference's mgr commands
`ceph balancer status|eval|optimize|show|execute`, reference
pybind/mgr/balancer/module.py:130-330), with the same verbs, flags and
output, plus `--device cuda|cpu`:

    python -m ceph_tpu_torch.cli.balancer -i map.bin status
    python -m ceph_tpu_torch.cli.balancer -i map.bin eval [--pool P] [-v]
    python -m ceph_tpu_torch.cli.balancer -i map.bin optimize myplan \\
        [--mode upmap|crush-compat] [--pool P] [--plan-out plan.inc] \\
        [--execute -o out.bin]
    python -m ceph_tpu_torch.cli.balancer show plan.inc
    python -m ceph_tpu_torch.cli.balancer -i map.bin execute plan.inc -o out.bin

A plan file is an OSDMap Incremental (osd.incremental wire format):
`optimize --plan-out` writes one, `show` decodes one, `execute` applies
one.

Map sources: `-i` reads a binary osdmap (osd.codec); `--synthetic
H,P,PGS[,skew]` builds an H-host x P-osd cluster with PGS placement
groups, weights skewed on alternate hosts.  `--mapper torch|host` picks
the scoring mapper (`jax` is an alias of `torch`): torch maps on the
rule kernel, on `--device` (the card by default; `cpu` runs its plain
version), host walks the host pipeline PG by PG.

    python -m ceph_tpu_torch.cli.balancer --synthetic 4,4,128 optimize p \\
        --device cpu
"""

from __future__ import annotations

import json
import sys

from ceph_tpu_torch.mgr import Balancer, MappingState, synthetic_pg_stats
from ceph_tpu_torch.osd.codec import decode_osdmap, encode_osdmap
from ceph_tpu_torch.osd.incremental import (
    apply_incremental,
    decode_incremental,
    encode_incremental,
)
from ceph_tpu_torch.osd.osdmap import OSDMap, build_hierarchical
from ceph_tpu_torch.osd.types import PgPool, PoolType


def build_synthetic(spec: str) -> OSDMap:
    """H,P,PGS[,skew] -> an unbalanced hierarchical cluster."""
    parts = spec.split(",")
    n_host, per, pg_num = int(parts[0]), int(parts[1]), int(parts[2])
    skew = float(parts[3]) if len(parts) > 3 else 2.0

    def wf(osd: int) -> int:
        # alternate-host weight skew: deviation to optimize
        return int(0x10000 * (skew if (osd // per) % 2 else 1.0))

    pool = PgPool(
        type=PoolType.REPLICATED, size=3, crush_rule=0,
        pg_num=pg_num, pgp_num=pg_num,
    )
    return build_hierarchical(n_host, per, pool=pool, weight_fn=wf)


def _load_map(infn: str | None, synthetic: str | None) -> OSDMap:
    if synthetic:
        return build_synthetic(synthetic)
    if infn is None:
        print("no input map: -i <osdmap> or --synthetic H,P,PGS",
              file=sys.stderr)
        raise SystemExit(1)
    with open(infn, "rb") as f:
        return decode_osdmap(f.read())


def _state(m: OSDMap, mapper: str, device) -> MappingState:
    return MappingState(
        m, synthetic_pg_stats(m), desc="current cluster", mapper=mapper,
        device=device,
    )


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    infn = None
    outfn = None
    synthetic = None
    mapper = "torch"
    device = None
    mode = None
    pools: list[str] = []
    plan_out = None
    verbose = False
    do_execute = False
    cmd: list[str] = []

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
        elif a == "--synthetic":
            synthetic = next_arg(a)
        elif a == "--mapper":
            mapper = next_arg(a)
            if mapper not in ("torch", "jax", "host"):
                print(f"unknown mapper {mapper!r} (torch, jax, host)",
                      file=sys.stderr)
                return 1
        elif a == "--device":
            device = next_arg(a)
        elif a == "--mode":
            mode = next_arg(a)
        elif a == "--pool":
            pools.append(next_arg(a))
        elif a == "--plan-out":
            plan_out = next_arg(a)
        elif a in ("-v", "--verbose"):
            verbose = True
        elif a == "--execute":
            do_execute = True
        elif a.startswith("-") and a not in ("-",):
            print(f"unrecognized option {a!r}", file=sys.stderr)
            return 1
        else:
            cmd.append(a)
        i += 1

    if not cmd:
        print(__doc__, file=sys.stderr)
        return 1
    verb = cmd[0]

    if verb == "show":
        if len(cmd) < 2:
            print("show <planfile>", file=sys.stderr)
            return 1
        with open(cmd[1], "rb") as f:
            inc = decode_incremental(f.read())
        print(f"plan epoch {inc.epoch}")
        for pg in sorted(
            inc.new_pg_upmap_items, key=lambda p: (p.pool, p.seed)
        ):
            pairs = inc.new_pg_upmap_items[pg]
            print(f"ceph osd pg-upmap-items {pg.pool}.{pg.seed:x} "
                  + " ".join(f"{a} {b}" for a, b in pairs))
        for pg in sorted(
            inc.old_pg_upmap_items, key=lambda p: (p.pool, p.seed)
        ):
            print(f"ceph osd rm-pg-upmap-items {pg.pool}.{pg.seed:x}")
        for osd in sorted(inc.new_weight):
            print(f"ceph osd reweight osd.{osd} "
                  f"{inc.new_weight[osd] / 0x10000:.6f}")
        if inc.crush:
            from ceph_tpu_torch.crush.codec import decode_crushmap

            crush = decode_crushmap(inc.crush)
            ca = crush.choose_args.get(-1)
            n = len(ca.weight_sets) if ca else 0
            print(f"new crush map: {len(inc.crush)} bytes, compat "
                  f"weight-set over {n} buckets")
        return 0

    bal = Balancer()
    if mode:
        bal.options["mode"] = mode

    if verb == "status":  # needs no map: options and plans only
        print(json.dumps(bal.status(), indent=2))
        return 0

    m = _load_map(infn, synthetic)

    if verb == "eval":
        pe = bal.eval(_state(m, mapper, device), pools or None)
        print(pe.show(verbose=verbose))
        return 0

    if verb == "optimize":
        if len(cmd) < 2:
            print("optimize <plan-name>", file=sys.stderr)
            return 1
        ms = _state(m, mapper, device)
        pe0 = bal.eval(ms, pools or None)
        plan = bal.plan_create(cmd[1], ms, pools or None, mode=mode)
        rc, detail = bal.optimize(plan)
        if rc != 0:
            print(f"optimize failed ({rc}): {detail}", file=sys.stderr)
            return 1
        # crush-compat has scored its accepted state; upmap needs one
        pe1 = plan.final_eval or bal.eval(plan.final_state(), pools or None)
        print(plan.show())
        print(f"score {pe0.score:.6f} -> {pe1.score:.6f} "
              f"(mode {plan.mode})")
        if plan_out:
            with open(plan_out, "wb") as f:
                f.write(encode_incremental(plan.finalize_inc()))
            print(f"wrote plan incremental to {plan_out}")
        if do_execute:
            rc, detail = bal.execute(plan, m)
            if rc != 0:
                print(f"execute failed ({rc}): {detail}", file=sys.stderr)
                return 1
            if outfn:
                with open(outfn, "wb") as f:
                    f.write(encode_osdmap(m))
                print(f"wrote epoch {m.epoch} map to {outfn}")
        return 0

    if verb == "execute":
        if len(cmd) < 2:
            print("execute <planfile> [-o outmap]", file=sys.stderr)
            return 1
        with open(cmd[1], "rb") as f:
            inc = decode_incremental(f.read())
        if inc.epoch != m.epoch + 1:
            print(f"plan epoch {inc.epoch} != map epoch {m.epoch}+1 "
                  "(map changed since the plan was computed)",
                  file=sys.stderr)
            return 1
        apply_incremental(m, inc)
        print(f"applied plan: map now epoch {m.epoch}")
        if outfn:
            with open(outfn, "wb") as f:
                f.write(encode_osdmap(m))
            print(f"wrote epoch {m.epoch} map to {outfn}")
        return 0

    print(f"unknown command {verb!r}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
