"""daemon — the `ceph daemon <name> <command>` surface for the port.

The port of `ceph_tpu/cli/daemon.py`.  The reference queries a live
daemon's internals over its admin socket (`ceph daemon osd.0 perf dump`,
reference src/common/admin_socket.cc); the same commands work here in
two modes:

    # against a LIVE process (started with CEPH_TPU_ADMIN_SOCKET=/p/x.asok):
    python -m ceph_tpu_torch.cli.daemon --sock /p/x.asok perf dump

    # in-process: run a small self-test workload (pipeline mapping, the
    # placement diagnostics and an RS(8,4) encode) to populate the
    # registry, then execute the command:
    python -m ceph_tpu_torch.cli.daemon perf dump          # on the card
    python -m ceph_tpu_torch.cli.daemon --device cpu perf dump

Commands (reference names):

    perf dump     perf-dump JSON (u64 bare, avg/time_avg avgcount+sum,
                  histogram bounds+buckets, quantile + p50/p90/p99) plus
                  the `executables` kernel-registry section
    perf schema   kind + description per counter
    perf reset    zero every counter, keep declarations
    metrics       Prometheus text exposition (format 0.0.4)
    cache dump    kernel registry: each hand kernel's launches, enqueue
                  quantiles, bytes per launch, nvcc seconds, ptxas rows
    bad dump      placement-diagnostics snapshots (per-source bad
                  mappings, retry histograms; obs/placement.py)
    explain X.Y   host-oracle decision log for PG Y of pool X (the
                  crushtool-explain replay, served for mapped pools)
    trace flush   write the Chrome trace-event file (CEPH_TPU_TRACE)
    runtime       the process's device and armed fault points
    serve status  live placement-service status (epoch, queue depth,
                  shed counters, swap-stall tail)
    health        summarized HEALTH_OK/WARN/ERR + raised checks
    timeline dump every recorded timeline series (obs/timeline.py),
                  both retention tiers, chronological
    help          command list

Unlike the JAX CLI, whose self-test pins the CPU, the port's runs on the
card (it launches the rule, diagnostics and GF(2^8) kernels), unless
`--device cpu` is given; without a card and without `--device cpu` it
raises, as every entry point of the port does.  `--no-selftest` skips
the workload and dumps whatever this process has; `--sock` inspects a
live process on whatever device it owns.
"""

from __future__ import annotations

import argparse
import os
import sys

from ceph_tpu_torch.utils.dout import subsys_logger

log = subsys_logger("obs")


def _import_obs_without_serving():
    """A one-shot diagnostic CLI never serves the admin socket itself —
    an inherited CEPH_TPU_ADMIN_SOCKET would otherwise race the live
    process this tool is querying (obs starts the server at first
    import).  The env var is hidden only for the import, then restored:
    importing this module must not mutate the process environment."""
    saved = os.environ.pop("CEPH_TPU_ADMIN_SOCKET", None)
    try:
        from ceph_tpu_torch.obs import admin_socket
    finally:
        if saved is not None:
            os.environ["CEPH_TPU_ADMIN_SOCKET"] = saved
    return admin_socket


SELFTEST_PGS = 256
SELFTEST_OSDS = 16


def _selftest(device=None) -> None:
    """A small mapping run, its diagnostics and an RS(8,4) encode on
    `device` (default: the card), so every hot-path counter group
    (pipeline, placement, ec) exists and has advanced."""
    import numpy as np

    from ceph_tpu_torch import obs
    from ceph_tpu_torch.device import resolve_device
    from ceph_tpu_torch.ec.registry import create_erasure_code
    from ceph_tpu_torch.osd.osdmap import build_hierarchical
    from ceph_tpu_torch.osd.pipeline import PoolMapper
    from ceph_tpu_torch.osd.types import PgPool, PoolType

    dev = resolve_device(device)
    with obs.span("daemon.selftest"):
        pool = PgPool(
            type=PoolType.REPLICATED, size=3, crush_rule=0,
            pg_num=SELFTEST_PGS, pgp_num=SELFTEST_PGS,
        )
        # 4 hosts so size-3 chooseleaf placements resolve: `bad dump`
        # then shows a real tries histogram
        m = build_hierarchical(SELFTEST_OSDS // 4, 4, n_rack=1, pool=pool)
        pm = PoolMapper(m, 0, device=dev, overlays=False)
        pm.map_batch(np.arange(SELFTEST_PGS, dtype=np.uint32))
        pm.diagnose()  # populates `bad dump` + the explain registry
        log(5, f"selftest: mapped {SELFTEST_PGS} pgs on {dev}")

        rs = create_erasure_code({"plugin": "jax", "k": "8", "m": "4"},
                                 device=dev)
        data = np.arange(8 * 4096, dtype=np.uint8).reshape(8, 4096)
        rs.encode_chunks(data)
        log(5, "selftest: RS(8,4) encode done")


def main(argv: list[str] | None = None) -> int:
    asok = _import_obs_without_serving()
    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.cli.daemon",
        description=__doc__.split("\n\n")[0],
    )
    ap.add_argument(
        "--sock", metavar="PATH",
        help="admin socket of a live process (CEPH_TPU_ADMIN_SOCKET); "
        "default is in-process execution",
    )
    ap.add_argument(
        "--no-selftest", action="store_true",
        help="in-process mode: skip the counter-populating workload",
    )
    ap.add_argument(
        "--device", default=None,
        help="in-process mode: where the self-test runs (default: the "
        "card; `cpu` runs the kernels' plain versions)",
    )
    ap.add_argument(
        "command", nargs="+",
        help=f"one of: {', '.join(repr(c) for c in asok.COMMANDS)}",
    )
    args = ap.parse_args(argv)
    cmd = " ".join(args.command)

    if args.sock:
        try:
            out = asok.client_command(args.sock, cmd)
        except OSError as e:
            print(f"daemon: cannot reach {args.sock}: {e}", file=sys.stderr)
            return 1
        print(out)
        return 0

    # read-only commands benefit from a populated registry; mutating or
    # metadata commands run against the process as-is
    if ((cmd in ("perf dump", "perf schema", "metrics", "cache dump",
                 "bad dump") or cmd.startswith("explain"))
            and not args.no_selftest):
        _selftest(args.device)
    print(asok.handle_command(cmd))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
