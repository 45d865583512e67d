"""CEPH_TPU_* environment-knob registry — one name, one doc line, once.

The port of `ceph_tpu/utils/knobs.py`.  Every read of a `CEPH_TPU_*`
variable in `ceph_tpu_torch` goes through `get`, and every name `get`
accepts has an entry here: the knobs are the operator surface, and an
undocumented one is invisible until someone greps the source.  The
names and meanings are the JAX package's; the registry holds only the
ones the port reads (tests/test_torch_obs.py scans the package both
ways: every read is registered, every entry is read).

The README's knob table for the port is `render_table()`'s output.

The option system (`utils/config.py`) additionally accepts
`CEPH_TPU_<OPTION_NAME>` overrides for every declared `Option` — a
derived family, documented there, deliberately not enumerated here
(the port declares no option yet, so the family is empty).
"""

from __future__ import annotations

import os

KNOBS: dict[str, str] = {
    "CEPH_TPU_ADMIN_SOCKET": (
        "path of the admin socket to serve (perf dump/schema/reset, "
        "metrics, runtime) from a live process"
    ),
    "CEPH_TPU_DEBUG": (
        'subsystem log levels to stderr, e.g. "crush=10,osd=5"'
    ),
    "CEPH_TPU_EC_STRATEGY": (
        "force the EC engine strategy (xor/xor_cse/bitplane/logexp/"
        "pallas/auto), overriding profile and autotune; pallas is the "
        "GF(2^8) kernel on the card"
    ),
    "CEPH_TPU_FAULTS": (
        "arm deterministic fault points: "
        "point[.qual]=action[:arg][@pP][ xN], comma-separated "
        "(@pP = fire with probability P, deterministically seeded; "
        "see runtime/faults.py)"
    ),
    "CEPH_TPU_FLEET_CHECKPOINT_EVERY": (
        "fleet epochs between whole-stack fleet checkpoints (one "
        "atomic file holding every member's state; default 50, 0 "
        "disables periodic flushes — run() still flushes at the end)"
    ),
    "CEPH_TPU_FLEET_STACK": (
        "0 = disable the fleet's stacked accounting dispatch: every "
        "member accounts through its own solo path (the A/B lever "
        "behind the fleet digest-equivalence proof; default 1)"
    ),
    "CEPH_TPU_HEALTH": (
        "0 = disable health-check evaluation in the sim/serve loops "
        "(the A/B lever for the pure-observer proof: digests must be "
        "bit-identical either way; default 1)"
    ),
    "CEPH_TPU_HEALTH_MUTE": (
        "comma-separated health check codes (e.g. PG_DEGRADED) to mute: "
        "muted checks still evaluate and dump but stop contributing to "
        "the summarized HEALTH_OK/WARN/ERR status"
    ),
    "CEPH_TPU_INIT_ATTEMPTS": (
        "backend probe attempts per ladder rung before descending "
        "(default 2)"
    ),
    "CEPH_TPU_INIT_BACKOFF": (
        "base seconds of the exponential probe-retry backoff (default 1)"
    ),
    "CEPH_TPU_INIT_TIMEOUT": (
        "watchdog timeout in seconds for one device preflight probe "
        "(default 120)"
    ),
    "CEPH_TPU_LADDER": (
        'degradation ladder override, e.g. "cuda,cpu,native" '
        '(default "cuda": without a card the entry point raises; a '
        "lower rung is used only when named here or by ladder=)"
    ),
    "CEPH_TPU_MESH_DEVICES": (
        "shard the PG axis of the production pipeline over an N-device "
        "mesh (parallel.sharded.default_mesh -> make_mesh): ClusterState "
        "rows, balancer membership, mgr eval, lifetime accounting and "
        "serve staging all partition over it; unset/<=1 = single-device. "
        "Degrades to the available device count with requested-vs-actual "
        "provenance (torch.cuda.device_count() devices on the card)"
    ),
    "CEPH_TPU_PLACEMENT_DIAG": (
        "1 = run the instrumented placement-diagnostics pass (bad "
        "mappings, retry histograms) after every ClusterSim epoch and "
        "balancer execute; default off (costs one launch of the "
        "diagnostics kernel per block an epoch)"
    ),
    "CEPH_TPU_SERVE_BULK_MAX": (
        "placement-service bulk sub-block width in lookups: "
        "query_block/submit_many cycle-pad to this width, one rule "
        "dispatch per sub-block (default 8192)"
    ),
    "CEPH_TPU_SERVE_BLOCK": (
        "placement-service fixed dispatch block width in queries — "
        "batches cycle-pad to this shape (default 1024)"
    ),
    "CEPH_TPU_SERVE_DEGRADED_BATCHES": (
        "host-mapper batches the placement service serves after a "
        "device loss before re-trying the device (default 16)"
    ),
    "CEPH_TPU_SERVE_DEADLINE_MS": (
        "placement-service default per-request deadline budget in "
        "milliseconds (default 250; 0 disables deadline bookkeeping "
        "entirely — no per-request deadline, no expiry triage)"
    ),
    "CEPH_TPU_SERVE_FILL": (
        "placement-service micro-batch fill threshold: stop collecting "
        "once this many queries wait (default 4096)"
    ),
    "CEPH_TPU_SERVE_QUEUE": (
        "placement-service admission bound on pending requests; "
        "overflow is answered EBUSY instead of queued (default 256)"
    ),
    "CEPH_TPU_SERVE_REPLICAS": (
        "PlacementService replica count behind a ServeFront "
        "(serve/front.py): rendezvous-hashed lane routing, staggered "
        "epoch fan-out, slowest-replica shedding (default 2)"
    ),
    "CEPH_TPU_SERVE_WINDOW_US": (
        "placement-service micro-batch collection window in "
        "microseconds (default 1000 = 1 ms)"
    ),
    "CEPH_TPU_SIM_CHECKPOINT_EVERY": (
        "epochs between lifetime-sim checkpoints (atomic JSON via "
        "runtime.Checkpoint; default 100, 0 disables periodic flushes "
        "— the final state still checkpoints)"
    ),
    "CEPH_TPU_SIM_RECOVERY": (
        "lifetime-sim recovery model when the scenario does not pin "
        "one: 'queue' (default — per-PG backlog, per-OSD "
        "bandwidth/slot drain, recovery/) or 'flat' (the legacy "
        "one-division model, bit-identical); scenario spec() pins the "
        "resolved value so --resume can never mix models"
    ),
    "CEPH_TPU_SIM_SPOTCHECK": (
        "epochs between lifetime-sim device==host spot-check lanes "
        "(default 16, 0 disables)"
    ),
    "CEPH_TPU_SLO_ERROR_PCT": (
        "serve SLO allowed error (expired-deadline) percentage per "
        "dispatch window (default 1)"
    ),
    "CEPH_TPU_SLO_P99_MS": (
        "serve SLO p99 latency objective in milliseconds (default 250); "
        "windowed p99 above this marks the sample as burning"
    ),
    "CEPH_TPU_SLO_SHED_PCT": (
        "serve SLO allowed load-shed (EBUSY) percentage per dispatch "
        "window (default 5)"
    ),
    "CEPH_TPU_STATE_DELTA": (
        "0 = disable the ClusterState O(delta) on-device incremental "
        "apply: every apply falls back to a full structural rebuild "
        "(the A/B lever behind the state.delta_applies / "
        "state.full_rebuilds counters; default 1)"
    ),
    "CEPH_TPU_TIMELINE_CAP": (
        "tier-0 ring capacity per timeline series (obs/timeline.py); "
        "older samples downsample 8:1 into a tier-1 ring of the same "
        "size; 0 disables timeline recording entirely (default 512)"
    ),
    "CEPH_TPU_TRACE": (
        "write a Chrome trace-event JSON of all spans to this path"
    ),
    "CEPH_TPU_TRACE_MAX_EVENTS": (
        "ring-buffer size of the in-memory trace (default 1M events)"
    ),
}


def get(name: str, default: str | None = None) -> str | None:
    """Registry-checked env read: raises KeyError on a knob this module
    does not declare, so new call sites cannot bypass the doc contract."""
    if name not in KNOBS:
        raise KeyError(f"undeclared CEPH_TPU knob {name!r}; add it to "
                       "ceph_tpu_torch/utils/knobs.py with a doc line")
    return os.environ.get(name, default)


def render_table() -> str:
    """The README knob table, one markdown row per registry entry."""
    lines = ["| knob | meaning |", "|------|---------|"]
    for name in sorted(KNOBS):
        lines.append(f"| `{name}` | {KNOBS[name]} |")
    return "\n".join(lines) + "\n"
