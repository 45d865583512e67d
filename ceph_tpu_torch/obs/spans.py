"""Span registry — the single authoritative list of trace event names.

The port of `ceph_tpu/obs/spans.py`, limited to the names the port
emits.  Every name but `ADDED`'s is the JAX registry's, with the JAX
meaning: a trace of either package reads the same in Perfetto.  Every
literal `obs.span("...")` / `obs.instant("...")` / `obs.counter("...")` name in
`ceph_tpu_torch` is declared here (tests/test_torch_obs.py scans the
package); a typo'd name would silently orphan its events.

Three kinds of entry:

- `SPANS`: complete ("ph":"X") span names -> one-line doc.  Names that
  serve as a base for derived events (LaunchAccount appends `.launch`)
  are still declared once, by the base name; LaunchAccount's own
  `f"{group}.{key}.launch"` names and timed_fetch's `.fetch` names carry
  no static head and are exempt by construction.
- `INSTANTS` / `COUNTERS`: zero-duration markers and counter tracks.
- `PREFIXES`: allowed prefixes for dynamically built span names (the
  stage scheduler's `stage.<name>`).

`ADDED` holds the port's own span names, which the JAX package has
no counterpart for (like `cuda_accounting.ADDED` for perf keys).

Spans time the host; `DISPATCH_SPANS` are the spans around launches
(enqueue only), inside which nothing may wait for the card.  While a
torch profiler records, every span is also a range of its trace, so the
device work a span launches is put down to it there.
"""

from __future__ import annotations

SPANS: dict[str, str] = {
    # osd/pipeline.py - the batched mapping pipeline
    "pipeline.map_block": "launch of one mapping block (the pipeline "
                          "kernel on the card, its plain torch-op chain "
                          "on the CPU; and LaunchAccount base of the "
                          "pipeline kernel)",
    "pipeline.fetch": "d2h fetch of finished mapping results",
    "pipeline.diagnose": "launch of one diagnostics-kernel block",
    # runtime/
    "runtime.acquire_backend": "ladder descent to a healthy backend",
    "runtime.probe": "one watchdogged device preflight probe",
    # obs/ itself
    "obs.exec_analyze": "kernel-registry analysis sweep",
    # balancer/
    "balancer.map_pool": "DeviceState full-pool mapping pass",
    "balancer.pgs_of": "device membership query for one OSD",
    "balancer.build_state": "O(PGs) membership-state build",
    "balancer.round": "one greedy upmap optimizer round",
    "balancer.score_candidates": "one vectorized deviation-delta "
                                 "evaluation over a batch of "
                                 "prospective upmap changes",
    "balancer.device_loop": "one whole-plan device-resident optimizer "
                            "run (every round of the greedy in one "
                            "launch of the upmap_loop kernel on a card, "
                            "its plain torch ops on the CPU; and "
                            "LaunchAccount base of that kernel)",
    # mgr/
    "mgr.map_pool": "eval distribution mapping pass for one pool",
    "mgr.pool_counts": "per-OSD pg/object/byte count reduction",
    "mgr.calc_eval": "full eval scoring pass",
    "mgr.optimize": "one Balancer.optimize() call",
    "mgr.do_upmap_pool": "upmap optimization of one pool",
    "mgr.execute": "plan application through apply_incremental",
    # ec/
    "ec.encode": "RS encode_chunks call",
    "ec.decode": "RS decode_chunks call",
    "ec.encode_batch": "batched multi-stripe encode",
    "ec.decode_batch": "batched multi-stripe decode",
    "ec.clay_encode": "Clay encode_chunks call",
    "ec.clay_decode": "Clay decode_chunks call",
    "ec.clay_repair": "Clay minimum-bandwidth single-chunk repair",
    "ec.gf_dispatch": "GF product launch (device work only)",
    "ec.gf_matmul": "GF matmul entry (and LaunchAccount base of the "
                    "GF(2^8) kernel)",
    "ec.gf_matmul_batch": "batched GF matmul entry",
    # osd/state.py — the device-resident ClusterState
    "state.apply": "one ClusterState.apply: classify + host model "
                   "advance + O(delta) device scatter (value) or "
                   "re-key (structural)",
    "state.rebuild": "structural re-key: CRUSH arrays rebuilt, operand "
                     "tables re-uploaded, mappers reconstructed",
    "state.rows": "version-tagged device rows (re)build for one pool "
                  "(mapping launch + overlay fixup scatter)",
    "state.raw_fixup": "rule-kernel refresh of overlay-carrying PGs' "
                       "descent rows",
    # sim/lifetime.py
    "sim.epoch": "one lifetime epoch: Incremental apply + remap + "
                 "device accounting + invariant checks",
    "sim.recovery": "one epoch's recovery-queue drain",
    "sim.workload": "one epoch's client-workload pass",
    # fleet/
    "fleet.epoch": "one fleet epoch batch: every live member's chaos "
                   "event + ONE stacked accounting call + data planes "
                   "+ digests",
    # serve/ — the placement service
    "serve.batch": "one micro-batch: deadline triage + device map + "
                   "reply delivery (host syncs allowed: the mapper "
                   "fetches results inside)",
    "serve.bulk": "one bulk protocol block (query_block/submit_many)",
    "serve.front": "one bulk block through the multi-replica front",
    "serve.swap": "epoch-swap staging: clone + incremental apply + "
                  "mapper construction + warm launch (off the reader "
                  "path; the flip itself is swap_stall_seconds)",
    "serve.chaos": "chaos-client harness: lifetime churn against a "
                   "live service under client load",
    "serve.background_balance": "one background balancing round",
    # cli/
    "daemon.selftest": "daemon CLI miniature workload",
}

# the port's own spans: around the batched EC entries' copies, so the
# profiler's trace tells their device work from the GF kernel's
ADDED: dict[str, str] = {
    "ec.concat": "encode_batch's join of data and parity into [N, k+m, "
                 "cs] (a copy on the device)",
    "ec.stack": "decode_batch's stack of the k survivors into [N, k, cs] "
                "(a copy on the device)",
}

INSTANTS: dict[str, str] = {
    "fault.fired": "an armed fault point fired",
    "stage.overrun": "a stage was abandoned by the watchdog",
    "runtime.acquired": "backend acquisition finished",
    "sharded.make_mesh": "device mesh construction",
    "sim.checkpoint": "a lifetime-sim checkpoint was flushed",
    "fleet.checkpoint": "a whole-stack fleet checkpoint was flushed",
    "serve.swap_applied": "an epoch swap flipped the active buffer",
    "serve.degraded": "serve dispatch lost the device; the batch was "
                      "answered EFAULT on a card, by the host mapper "
                      "on the host",
    "serve.recovered": "serve dispatch returned to the device",
    "health.raised": "a health check transitioned OK -> raised",
    "health.cleared": "a health check transitioned raised -> OK",
}

COUNTERS: dict[str, str] = {
    "balancer.stddev": "deviation trajectory across optimizer rounds",
    "mgr.score": "eval score after each calc_eval",
}

# f-string span names must start with one of these static heads
PREFIXES: tuple[str, ...] = (
    "stage.",  # runtime/scheduler.py: f"stage.{stage_name}"
)

# spans that time launches only: no host sync inside their bodies
DISPATCH_SPANS: tuple[str, ...] = (
    "pipeline.map_block",
    "pipeline.diagnose",
    "ec.gf_dispatch",
)


def known(name: str) -> bool:
    """True if `name` is a declared event name or matches a dynamic
    prefix."""
    if name in SPANS or name in ADDED or name in INSTANTS or \
            name in COUNTERS:
        return True
    return any(name.startswith(p) for p in PREFIXES)
