"""fleet — drive N clusters through one stacked stats call per epoch.

    python -m ceph_tpu_torch.cli.fleet run [--spec FLEETSPEC] [--epochs N]
        [--device DEV] [--checkpoint PATH] [--resume] [--stop-after N]
        [--json]
    python -m ceph_tpu_torch.cli.fleet pareto [--spec FLEETSPEC] ...
    python -m ceph_tpu_torch.cli.fleet digest [--spec FLEETSPEC] ...

The port of `ceph_tpu/cli/fleet.py`, with its output and exit codes.
`--spec` is the fleet sweep grammar (see `ceph_tpu_torch.fleet.spec`):
semicolon-separated `base=<scenario>`, `axis=key:v1|v2|...`
(cross-product), `clusters=N`, `cluster=i:k=v,...` overrides, and
`backend=torch|jax|ref`.  The device members run on the card unless
`--device cpu` is given.

`run` prints the fleet summary (aggregate rate, steady-compile
contract, per-member digests) — or, with `--json`, the machine-readable
record on one line.  `pareto` prints the non-dominated front as a
triage table (front members first, dominated points with the front
index that beats them).  `digest` prints one line per member:
`<index> <digest>` — the solo-equivalence witnesses.

Exit status: 0 clean, 1 when any member booked an invariant violation.

Crash safety: with `--checkpoint`, the WHOLE stack flushes atomically
every `CEPH_TPU_FLEET_CHECKPOINT_EVERY` fleet epochs; `--resume`
refuses a fleet whose cluster count, order, or any single member's
pinned spec differs from the checkpoint (per-cluster diff in the
error).
"""

from __future__ import annotations

import argparse
import json
import sys

from ceph_tpu_torch.fleet import FleetSim, parse_fleet, triage_table

DEFAULT_SPEC = ("base=epochs=12,hosts=4,osds_per_host=3,racks=2,"
                "pgs=32,ec=2+1,ec_pgs=16,chunk=256,balance_every=0,"
                "spotcheck_every=0,checkpoint_every=0,recovery=queue,"
                "max_backfills=4,recovery_mbps=200,osd_mbps=400;"
                "axis=seed:1|2;axis=correlated:0|1")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.cli.fleet",
        description=__doc__.split("\n\n")[0],
    )
    ap.add_argument("cmd", choices=("run", "pareto", "digest"))
    ap.add_argument("--spec", default=DEFAULT_SPEC,
                    help="fleet sweep-grammar string "
                         "(ceph_tpu_torch.fleet.spec)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override the fleet epoch count (default: "
                         "the longest member scenario)")
    ap.add_argument("--device", default=None,
                    help="torch device of the device members (default: "
                         "the card; 'cpu' runs the plain versions)")
    ap.add_argument("--checkpoint", default=None,
                    help="atomic whole-stack state file")
    ap.add_argument("--resume", action="store_true",
                    help="continue from --checkpoint's last state")
    ap.add_argument("--stop-after", type=int, default=None,
                    help="stop after this fleet epoch (checkpoint + "
                         "exit; the resume test's controlled "
                         "interrupt)")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable record as one "
                         "JSON line")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    if args.resume and not args.checkpoint:
        print("--resume needs --checkpoint", file=sys.stderr)
        return 2
    members = parse_fleet(args.spec)
    fleet = FleetSim(members, checkpoint=args.checkpoint,
                     resume=args.resume, device=args.device)
    fleet.warm()
    out = fleet.run(epochs=args.epochs, stop_after=args.stop_after)
    violations = sum(m["invariant_violations"] for m in out["members"])
    if args.cmd == "digest":
        if args.json:
            print(json.dumps({m["index"]: m["digest"]
                              for m in out["members"]}))
        else:
            for m in out["members"]:
                print(f"{m['index']} {m['digest']}")
        return 1 if violations else 0
    if args.cmd == "pareto":
        pts = fleet.points()
        if args.json:
            print(json.dumps(out["pareto"]))
        else:
            print(triage_table(pts))
        return 1 if violations else 0
    if args.json:
        print(json.dumps(out))
        return 1 if violations else 0
    t = out["trace_once"]
    print(f"clusters        {out['clusters']} "
          f"({'stacked' if out['stacked'] else 'solo-stepped'}, "
          f"balancer {out['balancer_backend']})")
    print(f"fleet epochs    {out['fleet_epochs']} "
          f"({out['cluster_epochs']} cluster-epochs)")
    print(f"rate            {out['cluster_epochs_per_sec']} "
          f"cluster-epochs/s")
    print(f"trace-once      {t['structural_epochs']} structural / "
          f"{t['steady_epochs']} steady epochs, "
          f"{t['steady_compiles']} steady compile(s)")
    front = out["pareto"]
    print(f"pareto          front {front['front_size']} / dominated "
          f"{len(front['dominated'])}")
    for m in out["members"]:
        p = m["pareto"]
        print(f"  [{m['index']:>3}] {m['backend']:<3} "
              f"epochs {m['epochs']:>4} "
              f"cyrs/h {p['cluster_years_per_hour']:<8g} "
              f"qps {p['served_qps']:<8g} "
              f"pg_lost {int(p['pg_lost'])} "
              f"digest {m['digest'][:12]}")
    if out.get("resumed_from") is not None:
        print(f"resumed from    fleet epoch {out['resumed_from']}")
    print(f"invariants      {violations} violation(s)")
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
