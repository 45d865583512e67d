"""serve — drive the placement serving daemon from the shell.

    python -m ceph_tpu_torch.cli.serve run [--pgs N] [--osds N]
        [--seconds S] [--clients N] [--checkpoint PATH] [--resume]
        [--device DEV] [--json]
    python -m ceph_tpu_torch.cli.serve chaos [--scenario SPEC]
        [--epochs N] [--clients N] [--checkpoint PATH] [--resume]
        [--device DEV] [--json]
    python -m ceph_tpu_torch.cli.serve query <pool>.<seed> | --object NAME
        [--pgs N] [--osds N] [--checkpoint PATH] [--resume] [--device DEV]

The port of `ceph_tpu/cli/serve.py`, with its output; the service runs
on the card unless `--device cpu` is given.  `run` serves a synthetic
cluster (or a checkpointed epoch with `--resume`) under a seeded
self-load for `--seconds`, printing a QPS / p50 / p99 / shed summary.  `chaos` points the lifetime engine's epoch
churn at the live service while the load runs: the client-visible tail
under control-plane churn is the headline.

Crash safety: with `--checkpoint`, every accepted epoch flushes
`{epoch, map blob}` atomically (`runtime.Checkpoint`).  After a kill
(e.g. `CEPH_TPU_FAULTS="serve_dispatch.40=exit:9"` dies at the 40th
micro-batch), re-running with `--resume` restores the same epoch and
prints `resumed_epoch` + `sample_digest` — the digest must equal the
host oracle's over the checkpointed map, which is how the restart test
proves the daemon answers identically.

Exit status: 0 clean, 1 when any submitted query was dropped (no
reply) — shed/expired replies are answers, drops are the one
forbidden outcome.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _build(pgs: int, osds: int):
    from ceph_tpu_torch.osd.osdmap import build_hierarchical
    from ceph_tpu_torch.osd.types import PgPool, PoolType

    per_host = 4
    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                  pg_num=pgs, pgp_num=pgs)
    return build_hierarchical(
        max(1, osds // per_host), per_host,
        n_rack=max(1, osds // per_host // 4), pool=pool,
    )


def _service(args):
    from ceph_tpu_torch.serve import PlacementService, ServeConfig

    cfg = ServeConfig.from_env()
    if args.resume:
        return PlacementService(config=cfg, checkpoint=args.checkpoint,
                                resume=True, device=args.device)
    return PlacementService(_build(args.pgs, args.osds), config=cfg,
                            checkpoint=args.checkpoint, device=args.device)


def _run(args) -> int:
    import threading

    from ceph_tpu_torch.serve.chaos import _Client, _pct

    svc = _service(args)
    stop = threading.Event()
    clients = [_Client(svc, i, args.batch, stop)
               for i in range(args.clients)]
    t0 = time.perf_counter()
    for c in clients:
        c.thread.start()
    time.sleep(args.seconds)
    stop.set()
    for c in clients:
        c.thread.join(timeout=30)
    wall = time.perf_counter() - t0
    lat = [v for c in clients for v in c.latencies]
    submitted = sum(c.submitted for c in clients)
    replied = sum(c.replied for c in clients)
    ok = sum(c.by_status.get("ok", 0) for c in clients)
    st = svc.status()
    out = {
        "epoch": svc.epoch,
        "wall_s": round(wall, 3),
        "submitted": submitted,
        "dropped": submitted - replied,
        "answered_ok": ok,
        "qps": round(ok / wall, 1) if wall else 0.0,
        "p50_s": _pct(lat, 50),
        "p99_s": _pct(lat, 99),
        "queries_shed": st["queries_shed"],
        "queries_expired": st["queries_expired"],
        "degraded_answered": st["degraded_answered"],
        "sample_digest": svc.sample_digest(),
    }
    if svc.resumed_from is not None:
        out["resumed_epoch"] = svc.resumed_from
    svc.close()
    return _emit(args, out)


def _chaos(args) -> int:
    from ceph_tpu_torch.serve.chaos import run_chaos

    out = run_chaos(
        scenario=args.scenario, epochs=args.epochs,
        checkpoint=args.checkpoint, resume=args.resume,
        clients=args.clients, client_batch=args.batch,
        device=args.device,
    )
    return _emit(args, out)


def _query(args) -> int:
    svc = _service(args)
    try:
        if args.object is not None:
            pool = args.pool if args.pool >= 0 else \
                sorted(svc._active.m.pools)[0]
            r = svc.lookup_object(pool, args.object)
            what = f"object {args.object!r} pool {pool}"
        else:
            if not args.pgid or "." not in args.pgid:
                print("query needs <pool>.<seed> or --object NAME",
                      file=sys.stderr)
                return 2
            p, _, s = args.pgid.partition(".")
            r = svc.lookup(int(p), int(s, 0))  # "1.42" or "1.0x2a"
            what = f"pg {args.pgid}"
        out = {
            "query": what, "status": r.status, "epoch": r.epoch,
            "source": r.source,
        }
        if r.ok:
            out["up"] = [int(o) for o in r.up[0]]
            out["up_primary"] = int(r.up_primary[0])
            out["acting"] = [int(o) for o in r.acting[0]]
            out["acting_primary"] = int(r.acting_primary[0])
        print(json.dumps(out, indent=None if args.json else 1))
        return 0 if r.ok else 1
    finally:
        svc.close()


def _emit(args, out: dict) -> int:
    if args.json:
        print(json.dumps(out))
    else:
        for k in ("resumed_epoch", "sample_digest", "epochs",
                  "final_epoch", "epoch", "wall_s", "submitted",
                  "dropped", "answered_ok", "qps", "p50_s", "p99_s",
                  "swaps_ok", "swaps_rejected", "swap_stall_p99_s",
                  "queries_shed", "queries_expired",
                  "degraded_answered", "sim_digest"):
            if k in out and out[k] is not None:
                print(f"{k:20} {out[k]}")
        slo = out.get("slo")
        if slo:
            print(f"{'slo':20} burning={slo['burning']} "
                  f"raised={slo['burns_raised']} "
                  f"cleared={slo['burns_cleared']} "
                  f"burn_minutes={slo['burn_minutes']} "
                  f"breaches={slo['breaches']}/{slo['samples']}")
        h = out.get("health")
        if h:
            codes = ",".join(sorted(h.get("checks") or ())) or "-"
            print(f"{'health':20} {h['status']} ({codes})")
    return 1 if out.get("dropped") else 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.cli.serve",
        description=__doc__.split("\n\n")[0],
    )
    ap.add_argument("cmd", choices=("run", "chaos", "query"))
    ap.add_argument("pgid", nargs="?", default=None,
                    help="query: <pool>.<seed>")
    ap.add_argument("--pgs", type=int, default=1024,
                    help="synthetic cluster pg_num (default 1024)")
    ap.add_argument("--osds", type=int, default=32,
                    help="synthetic cluster OSD count (default 32)")
    ap.add_argument("--seconds", type=float, default=5.0,
                    help="run: load duration (default 5)")
    ap.add_argument("--clients", type=int, default=2,
                    help="seeded client-load threads (default 2)")
    ap.add_argument("--batch", type=int, default=256,
                    help="queries per client request (default 256)")
    ap.add_argument("--scenario", default=None,
                    help="chaos: lifetime Scenario overrides "
                         "(comma-separated key=value)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="chaos: churn epochs (default: scenario's)")
    ap.add_argument("--object", default=None,
                    help="query: object name instead of <pool>.<seed>")
    ap.add_argument("--pool", type=int, default=-1,
                    help="query --object: pool id (default: first)")
    ap.add_argument("--checkpoint", default=None,
                    help="atomic epoch+map state file for crash-safe "
                         "serving")
    ap.add_argument("--resume", action="store_true",
                    help="restore the checkpointed epoch and serve it")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable record")
    ap.add_argument("--device", default=None,
                    help="torch device of the service (default: the "
                         "card; cpu runs the rule's plain version)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    if args.resume and not args.checkpoint:
        print("--resume needs --checkpoint", file=sys.stderr)
        return 2
    if args.cmd == "run":
        return _run(args)
    if args.cmd == "chaos":
        return _chaos(args)
    return _query(args)


if __name__ == "__main__":
    raise SystemExit(main())
