"""sim — drive the cluster-lifetime chaos simulator from the shell.

    python -m ceph_tpu_torch.cli.sim run [--scenario SPEC] [--epochs N]
        [--backend torch|jax|ref] [--device DEV] [--checkpoint PATH]
        [--resume] [--stop-after N] [--json]
    python -m ceph_tpu_torch.cli.sim digest [--scenario SPEC] ...

The port of `ceph_tpu/cli/sim.py`, with its output.  `run` evolves one
cluster through the scenario's epochs (see `ceph_tpu_torch.sim.lifetime`
for the scenario syntax), printing a summary — or, with `--json`, the
full machine-readable run record on one line.  Exit status: 0 clean, 1
when any epoch invariant was violated.

`digest` runs the same engine but prints only the final trajectory
digest: the bit-identical-replay witness two runs (or a killed run plus
`--resume`, or the two packages) are compared by.

The backend "torch" (alias "jax") runs on the card unless `--device cpu`
is given; "ref" is the host oracle with the numpy mirrors.

Crash safety: with `--checkpoint`, state flushes atomically every
`checkpoint_every` epochs; after a kill (or an armed
`CEPH_TPU_FAULTS="lifetime_step.<epoch>=exit:9"`), re-running with
`--resume` continues from the checkpointed epoch and lands on the digest
an uninterrupted run prints.
"""

from __future__ import annotations

import argparse
import json
import sys

from ceph_tpu_torch.sim.lifetime import LifetimeSim, Scenario


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.cli.sim",
        description=__doc__.split("\n\n")[0],
    )
    ap.add_argument("cmd", choices=("run", "digest"))
    ap.add_argument("--scenario", default=None,
                    help="comma-separated key=value scenario overrides "
                         "(ceph_tpu_torch.sim.lifetime.Scenario fields)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override the scenario's epoch count")
    ap.add_argument("--backend", default="torch",
                    choices=("torch", "jax", "ref"),
                    help="device accounting (torch, alias jax) or "
                         "host-only (ref)")
    ap.add_argument("--device", default=None,
                    help="torch device of the torch backend (default: "
                         "the card; 'cpu' runs the plain versions)")
    ap.add_argument("--checkpoint", default=None,
                    help="atomic state file for crash-safe runs")
    ap.add_argument("--resume", action="store_true",
                    help="continue from --checkpoint's last state")
    ap.add_argument("--stop-after", type=int, default=None,
                    help="stop after this epoch (checkpoint + exit; "
                         "the resume test's controlled interrupt)")
    ap.add_argument("--json", action="store_true",
                    help="print the full run record as one JSON line")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    if args.resume and not args.checkpoint:
        print("--resume needs --checkpoint", file=sys.stderr)
        return 2
    spec = args.scenario
    if args.resume and spec is None:
        # resume without --scenario adopts the checkpoint's pinned
        # scenario; a missing checkpoint falls back to defaults
        try:
            state = json.loads(
                open(args.checkpoint).read()).get("lifetime") or {}
            spec = state.get("scenario")
        except (OSError, ValueError):
            pass
    sc = Scenario.parse(spec)
    if args.epochs is not None:
        sc.epochs = args.epochs
    sim = LifetimeSim(sc, backend=args.backend, device=args.device,
                      checkpoint=args.checkpoint, resume=args.resume)
    out = sim.run(stop_after=args.stop_after)
    if args.cmd == "digest":
        print(out["digest"])
    elif args.json:
        print(json.dumps(out))
    else:
        prov = out["provenance"]
        print(f"epochs          {out['epochs']} "
              f"(map epoch {out['map_epoch']})")
        print(f"digest          {out['digest']}")
        print(f"sim time        {out['sim_seconds']:.0f}s "
              f"({out['sim_years']:.4f} cluster-years)")
        print(f"rate            {out['epochs_per_sec']} epochs/s, "
              f"{out['cluster_years_per_hour']} cluster-years/hour")
        print(f"events          {out['events']}")
        print(f"movement        {out['report']}")
        print(f"degraded epochs {out['degraded_epochs']}")
        h = out.get("health")
        if h:
            ep = h.get("epochs") or {}
            codes = ",".join(sorted(h.get("checks") or ())) or "-"
            print(f"health          {h['status']} (epochs: "
                  f"{ep.get('ok', 0)} ok / {ep.get('warn', 0)} warn / "
                  f"{ep.get('err', 0)} err; raised: {codes}; "
                  f"{h.get('timeline_samples', 0)} timeline samples)")
        rec = out.get("recovery")
        if rec:
            print(f"recovery        queue: {rec['enqueued_gb']} GB "
                  f"enqueued, {rec['drained_gb']} drained, "
                  f"{rec['backlog_gb']} backlog "
                  f"(peak {rec['backlog_peak_gb']}), "
                  f"{rec['completed_pgs']} PG recoveries, "
                  f"{rec['conservation_violations']} conservation "
                  f"violation(s)")
        else:
            print(f"recovery        {out['recovery_model']}")
        wl = out.get("workload")
        if wl:
            print(f"workload        {wl['requests']} requests "
                  f"({wl['served_qps']} QPS): "
                  f"{wl['degraded_reads']} degraded reads, "
                  f"{wl['at_risk_hits']} at-risk hits, "
                  f"{wl['backlog_hits']} backlog hits, "
                  f"{wl['contended_osd_epochs']} contended OSD-epochs")
        ch = out.get("chaos")
        if ch:
            # the correlated-chaos triage table: worst failure domains,
            # the cascade record and the repeat offenders
            print(f"chaos           {ch['cascades']} cascade(s) "
                  f"(longest {ch['longest_cascade']}), "
                  f"{ch['hazard_windows']} hazard window(s), "
                  f"{ch['false_flap_revives']} false-flap revive(s)")
            if ch.get("domain_outages"):
                print("  domain outages:")
                for name, cnt in ch["domain_outages"].items():
                    print(f"    {name:<12} {cnt}")
            if ch.get("flap_counts"):
                print("  flap offenders (designated flappers: "
                      + ",".join(f"osd.{o}"
                                 for o in ch["flapper_osds"]) + "):")
                for name, cnt in ch["flap_counts"].items():
                    print(f"    {name:<12} {cnt}")
        dur = out.get("durability")
        if dur:
            print(f"durability      pg_lost {dur['pg_lost']}, "
                  f"{dur['exposed_pg_epochs']} exposed PG-epochs, "
                  f"{dur['wounded_pgs']} wounded PG(s) "
                  f"(max {dur['max_wounds']} dead chunks)")
            for pid, pgs in (dur.get("lost") or {}).items():
                print(f"  LOST pool {pid}: pgs {pgs}")
        if out.get("pareto"):
            print(f"pareto          {out['pareto']}")
        print(f"trace-once      {out['trace_once']}")
        print(f"backend         {prov['backend']} "
              f"({prov['device_loss_fallbacks']} device-loss "
              f"degradations)")
        print(f"invariants      {out['invariant_violations']} "
              f"violation(s)")
        for v in out["violations"]:
            print(f"  VIOLATION {v}")
    return 1 if out["invariant_violations"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
