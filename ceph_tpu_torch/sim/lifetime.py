"""Cluster-lifetime chaos simulator: many epochs of failure, churn and
growth under deterministic fault schedules.

The port of `ceph_tpu/sim/lifetime.py` (`LifetimeSim`).  It composes the
port's subsystems into one long-running run:

- **Events are real epoch deltas.**  Each simulated epoch builds an
  `osd.incremental.Incremental` (OSD flaps, deaths and removals, host and
  rack outages, reweights, pg_temp overrides, pool creation, `pg_num`
  splits, cluster expansion through `CrushMap.insert_item`) and advances
  the map through one `osd.state.ClusterState` (O(delta) on the device
  for a value-only delta, a rebuild for a structural one).  Every
  `balance_every` epochs the mgr balancer (`mgr.Balancer`, upmap mode)
  plans and `execute()`s on the same state.
- **Deterministic chaos.**  The event at epoch `e` is drawn on the host
  from `numpy.random.default_rng([seed, e])`: no RNG state spans epochs,
  so one seed gives one event trajectory and a resumed run continues
  where the interrupted one stopped.  The running `digest` (a SHA-256
  chain over per-epoch event and accounting lines, the JAX package's
  lines character for character) is the equality witness: same seed,
  same digest; resume, same final digest; and the JAX package's digest.
- **Correlated failures (`correlated=1`).**  Repeat-offender flappers,
  failure-domain hazard windows that cascade outages onto sibling
  domains, and durability accounting: true deaths wound every PG that
  carried the OSD, wounds heal when the PG's recovery backlog drains,
  and a PG wounded past its tolerance while un-drained is lost (the `|D`
  digest segment and the latched `DATA_LOSS` health check).
- **Accounting stays on the device.**  A pool's rows are
  `ClusterState.rows` (the pipeline kernel on the card), version-tagged: an
  epoch that changed nothing feeding a pool's mapping skips its remap
  and its stats (equal tags guarantee equal rows).  The epoch stats
  (`_stats_torch`), the recovery drain (`recovery.queue`) and the client
  traffic (`sim.workload`) are torch ops on the rows' device; only a
  handful of int64 scalars come to the host per pool per epoch.  The
  "ref" backend runs the host oracle and the JAX package's numpy mirrors
  of the same formulas (`_stats_np`, `drain_pool_np`,
  `workload_pool_np`), digest-equal.
- **Invariants.**  No PG silently unmapped, no duplicate OSDs in a row,
  upmap and pg_temp respected, periodic device==host spot-check lanes;
  recovery byte conservation every epoch.
- **Crash safety** rides `runtime.Checkpoint`: the whole state (map
  blob, digest, event bookkeeping, recovery and workload state, the
  timeline) flushes atomically every `checkpoint_every` epochs under the
  key "lifetime", in the JAX package's layout, and `resume=True`
  continues from the last checkpointed epoch (`CEPH_TPU_FAULTS=
  "lifetime_step.<e>=exit:9"` and `cli/sim.py --resume` are the kill
  test).

**Device loss** (`runtime.faults.degrade_or_raise`): a loss, real (a
torch error `runtime.faults.looks_like_device_loss` accepts) or injected
(`epoch_apply=lost`, `recovery_step=lost`), raises out of `step()` on a
card.  On a run placed on the host (`device="cpu"`) it degrades as the
JAX package does: that pool's accounting, or the rest of the epoch's
recovery drain, goes through the bit-exact host mapper and numpy
mirrors with the digest unchanged, and every descent is booked in
`fallback_events`, `provenance()` and the `runtime` group's
`device_loss_fallbacks`.  Any other error raises.  The port compiles
nothing per shape, so `trace_once`'s compile counts read 0.

`mesh` (a `parallel.sharded.Mesh`; None resolves CEPH_TPU_MESH_DEVICES)
splits the ClusterState's mapping launches over its devices: the same
digests.

Scenario syntax (`Scenario.parse`): comma-separated `key=value` pairs
over the `Scenario` dataclass fields, e.g.

    epochs=500,seed=7,hosts=8,osds_per_host=4,racks=2,ec=4+2,
    balance_every=16,p_flap=0.3,recovery_mbps=250

Headline metric: simulated cluster-years per wall-clock hour
(`cluster_years_per_hour` in the summary).
"""

from __future__ import annotations

import base64
import copy
import hashlib
import time
from dataclasses import dataclass, fields

import numpy as np
import torch

from ceph_tpu_torch import obs
from ceph_tpu_torch.core import reduce
from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.obs import health, timeline
from ceph_tpu_torch.osd.incremental import Incremental, apply_incremental
from ceph_tpu_torch.osd.osdmap import IN_WEIGHT, OSD_EXISTS, OSD_UP, OSDMap
from ceph_tpu_torch.osd.types import PgId, PgPool, PoolType
from ceph_tpu_torch.parallel.sharded import mesh_for
from ceph_tpu_torch.runtime import Checkpoint, faults
from ceph_tpu_torch.sim.failure import MovementReport, _map_ref
from ceph_tpu_torch.utils import knobs
from ceph_tpu_torch.utils.dout import subsys_logger
from ceph_tpu_torch.utils.perf_counters import counters_attr

_log = subsys_logger("sim")

BACKENDS = {"torch": "torch", "jax": "torch", "ref": "ref"}

# The JAX package's `sim` perf group, plus `stats_calls` (the torch-op
# epoch stats run; a tag-equal pool-epoch makes none; the fleet's stacked
# calls are the `fleet` group's `stats_calls`)
_L = obs.logger_for("sim")
_L.add_u64("epochs", "lifetime epochs applied (one Incremental chain "
           "step + remap + accounting each)")
_L.add_u64("events_applied", "non-quiet chaos events applied")
_L.add_u64("invariant_violations",
           "epochs whose device-side invariant scalars flagged a "
           "violation (duplicate OSDs, overfull rows, down/out OSDs in "
           "up sets)")
_L.add_u64("degraded_pg_epochs", "epochs that ended with >=1 degraded PG")
_L.add_u64("structural_epochs",
           "epochs that changed a pool's compiled structure (expected "
           "compile events)")
_L.add_u64("spot_checks", "device==host spot-check lanes compared")
_L.add_u64("spotcheck_mismatches", "spot-check lanes that disagreed")
_L.add_u64("checkpoints", "lifetime checkpoints flushed")
_L.add_u64("cascade_outages",
           "correlated cascade outages: a host or rack of OSDs failing "
           "together")
_L.add_u64("flap_revives",
           "flapping OSDs revived at the end of their down window")
_L.add_u64("pgs_lost",
           "PGs that lost more shards than their pool tolerates before "
           "recovery drained them (irreversible)")
_L.add_avg("at_risk_pg_seconds",
           "per-epoch at-risk PG-seconds (PGs past EC tolerance x "
           "simulated epoch duration)")
_L.add_quantile("epoch_seconds",
                "wall time per lifetime epoch (apply + remap + "
                "accounting + checks)")
_L.add_u64("stats_calls", "torch-op epoch stats runs (one per pool "
           "whose rows changed)")
__getattr__ = counters_attr("sim", __name__, (
    "epochs", "events_applied", "invariant_violations",
    "degraded_pg_epochs", "structural_epochs", "spot_checks",
    "spotcheck_mismatches", "checkpoints", "cascade_outages",
    "flap_revives", "pgs_lost", "stats_calls"))


def _inc(name: str, n: int = 1) -> None:
    _L.inc(name, int(n))


def _recovery_counters():
    """The `recovery` perf group (declared by recovery/queue.py)."""
    return obs.logger_for("recovery")


def _host(x) -> np.ndarray:
    """A numpy view of rows or a per-PG vector, fetched from the device
    when it is a tensor."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


# --------------------------------------------------------------- scenario

# The chaos-event registry: kind -> what it does.
EVENT_KINDS: dict[str, str] = {
    "flap": "one OSD marked down transiently; bytes intact, revives "
            "after flap_len epochs (repeat offenders under correlated)",
    "death": "one OSD marked down and weighted out permanently; its "
             "chunks are gone and the recovery queue re-replicates",
    "remove": "a previously-dead OSD destroyed and pulled from CRUSH",
    "host_outage": "a whole host bucket's OSDs marked down together; "
                   "bytes intact, revives after outage_len epochs",
    "rack_outage": "a whole rack bucket's OSDs marked down together; "
                   "bytes intact, revives after outage_len epochs",
    "reweight": "one in OSD's weight nudged (0.6..1.0 of IN_WEIGHT)",
    "pg_temp": "one PG's acting set rotated via pg_temp/primary_temp, "
               "cleared after temp_len epochs",
    "pool_create": "a new replicated pool (up to max_pools)",
    "split": "one pool's pg_num doubled (up to max_pgs)",
    "expand": "a new host of osds_per_host OSDs joins CRUSH (up to "
              "max_expand over the lifetime)",
}


@dataclass
class Scenario:
    """One lifetime run's shape: cluster, chaos mix, recovery model.

    Parsed from comma-separated `key=value` pairs (`Scenario.parse`);
    `spec()` renders the canonical string a checkpoint pins so a resume
    cannot silently continue a different scenario.  `chunk` shapes
    nothing in the port (its ClusterState takes no block size); it stays
    because `spec()`, and so the digest seed, includes it."""

    epochs: int = 500
    seed: int = 0
    # initial cluster
    hosts: int = 8
    osds_per_host: int = 4
    racks: int = 2
    pgs: int = 256           # replicated pool pg_num
    size: int = 3            # replicated pool size
    ec: str = "4+2"          # EC pool "k+m" ("" disables it)
    ec_pgs: int = 128
    chunk: int = 4096        # the JAX package's PG-axis block size
    # mgr balancer cadence (0 disables)
    balance_every: int = 16
    balance_max: int = 8     # upmap_max_optimizations per run
    # chaos probabilities per epoch (remaining mass = quiet epoch)
    p_flap: float = 0.25
    p_death: float = 0.04
    p_remove: float = 0.02
    p_host_outage: float = 0.04
    p_rack_outage: float = 0.01
    p_reweight: float = 0.10
    p_pg_temp: float = 0.04
    p_pool_create: float = 0.01
    p_split: float = 0.01
    p_expand: float = 0.01
    # transient-event durations (epochs, drawn uniform in [1, len])
    flap_len: int = 4
    outage_len: int = 6
    temp_len: int = 5
    # recovery model.  "" resolves from CEPH_TPU_SIM_RECOVERY (default
    # "queue": the per-PG backlog / per-OSD slot+bandwidth data plane of
    # ceph_tpu_torch.recovery; "flat" is the one-division model).
    # spec() pins the resolved value.
    recovery: str = ""
    pg_gb: float = 1.0       # data per PG (GB), spread over `size` shards
    recovery_mbps: float = 100.0
    interval_s: float = 30.0  # floor of one epoch's simulated duration
    # queue-model resources (ignored under recovery=flat)
    max_backfills: int = 2   # per-OSD concurrent recovery streams
    osd_mbps: float = 125.0  # per-OSD epoch bandwidth (client + recovery)
    pipeline_repair: int = 0  # 1 = RapidRAID-style stage overlap (EC)
    # EC encode GB/s of the repair streams; the default is the JAX
    # package's TPU figure, kept so default scenarios keep its digests
    ec_gbps: float = 1.6
    # client workload generator (0 disables; metrics + digest lines
    # only exist when enabled)
    workload: int = 0
    base_qps: float = 1000.0
    read_fraction: float = 0.75
    zipf_a: float = 4.0      # hot-key skew exponent (higher = hotter)
    hot_pool: float = 1.0    # Zipf rank weight across pools
    diurnal_amp: float = 0.5
    diurnal_period: int = 288
    obj_kb: int = 64         # bytes per modeled object request
    wl_sample: int = 128     # sampled requests per pool per epoch
    # correlated-failure model (0 = independent draws)
    correlated: int = 0
    flappers: int = 2           # repeat-offender OSDs (drawn once)
    flapper_boost: float = 8.0  # flap-victim weight for offenders
    cascade_hazard: float = 0.35  # outage hazard added on siblings
    cascade_decay: float = 0.6  # per-epoch hazard strength multiplier
    cascade_len: int = 6        # epochs a hazard window stays open
    # growth limits
    new_pool_pgs: int = 64
    max_pools: int = 6
    max_pgs: int = 4096      # per-pool pg_num cap for splits
    max_expand: int = 8      # hosts added over the whole lifetime
    # cadences (0 disables); -1 = take the CEPH_TPU_SIM_* env knob
    checkpoint_every: int = -1
    spotcheck_every: int = -1
    spotcheck_lanes: int = 4

    def __post_init__(self):
        if self.checkpoint_every < 0:
            self.checkpoint_every = int(
                knobs.get("CEPH_TPU_SIM_CHECKPOINT_EVERY", "100"))
        if self.spotcheck_every < 0:
            self.spotcheck_every = int(
                knobs.get("CEPH_TPU_SIM_SPOTCHECK", "16"))
        if not self.recovery:
            self.recovery = knobs.get("CEPH_TPU_SIM_RECOVERY",
                                           "queue")
        if self.recovery not in ("queue", "flat"):
            raise ValueError(
                f"recovery={self.recovery!r}: known models are 'queue' "
                "(per-PG backlog / per-OSD slot+bandwidth drain) and "
                "'flat' (legacy one-division)")

    @classmethod
    def parse(cls, spec: str | None) -> "Scenario":
        kw: dict = {}
        types = {f.name: f.type for f in fields(cls)}
        for item in (spec or "").replace("\n", ",").split(","):
            item = item.strip()
            if not item:
                continue
            key, sep, val = item.partition("=")
            key, val = key.strip(), val.strip()
            if not sep or key not in types:
                raise ValueError(f"bad scenario item {item!r} "
                                 f"(known keys: {sorted(types)})")
            t = types[key]
            kw[key] = val if t == "str" else (
                float(val) if t == "float" else int(val))
        return cls(**kw)

    def spec(self) -> str:
        return ",".join(
            f"{f.name}={getattr(self, f.name)}" for f in fields(self)
        )

    def ec_km(self) -> tuple[int, int] | None:
        if not self.ec:
            return None
        k, _, mm = self.ec.partition("+")
        return int(k), int(mm)

    def event_probs(self) -> tuple[tuple[str, float], ...]:
        """(kind, probability) in a FIXED order: the cumulative walk the
        per-epoch draw runs over (the order is part of determinism)."""
        return (
            ("flap", self.p_flap),
            ("death", self.p_death),
            ("remove", self.p_remove),
            ("host_outage", self.p_host_outage),
            ("rack_outage", self.p_rack_outage),
            ("reweight", self.p_reweight),
            ("pg_temp", self.p_pg_temp),
            ("pool_create", self.p_pool_create),
            ("split", self.p_split),
            ("expand", self.p_expand),
        )


def build_cluster(sc: Scenario) -> OSDMap:
    """The scenario's initial map: hierarchical hosts/racks, one
    replicated pool, optionally one EC pool with a real erasure rule
    and profile entry."""
    from ceph_tpu_torch.osd.osdmap import build_hierarchical

    m = build_hierarchical(
        sc.hosts, sc.osds_per_host, n_rack=sc.racks,
        pool=PgPool(
            type=PoolType.REPLICATED, size=sc.size, crush_rule=0,
            pg_num=sc.pgs, pgp_num=sc.pgs,
        ),
    )
    km = sc.ec_km()
    if km is not None:
        k, mm = km
        root = next(
            bid for bid, b in m.crush.buckets.items() if b.type == 11
        )
        ruleno = m.crush.make_erasure_rule(
            root, 1 if sc.hosts > 1 else 0, num_chunks=k + mm
        )
        m.erasure_code_profiles["lifetime-ec"] = {
            "k": str(k), "m": str(mm), "plugin": "jax",
        }
        m.add_pool("lifetime-ec", PgPool(
            type=PoolType.ERASURE, size=k + mm, min_size=k + 1,
            crush_rule=ruleno, pg_num=sc.ec_pgs, pgp_num=sc.ec_pgs,
            erasure_code_profile="lifetime-ec",
        ))
    return m


# --------------------------------------------------- shared stat formulas
# One formula, two executors: torch ops on the rows' device, and the JAX
# package's numpy mirror for the "ref" backend.  Digest equality across
# backends depends on the two never diverging.


def _stats_np(prev, rows, n: int, size: int, tol: int):
    """Returns ([degraded, unmapped, at_risk, dup, moved, remapped],
    per-PG moved-lane counts int64 [N]) — the second output feeds the
    recovery queue's per-PG enqueue."""
    rows = np.asarray(rows)
    prev = np.asarray(prev)
    real = np.arange(rows.shape[0]) < n
    valid = (rows != ITEM_NONE) & (rows >= 0)
    occ = valid.sum(axis=1)
    degraded = int((real & (occ < size)).sum())
    unmapped = int((real & (occ == 0)).sum())
    at_risk = int((real & (occ < size - tol)).sum())
    w = rows.shape[1]
    eq = (rows[:, :, None] == rows[:, None, :]) \
        & valid[:, :, None] & valid[:, None, :]
    dup = int((real & (eq & np.triu(np.ones((w, w), bool), 1)).any(
        axis=(1, 2))).sum())
    mem_ab = (rows[:, :, None] == prev[:, None, :]).any(axis=2)
    moved_l = ~mem_ab & valid
    moved_rows = (moved_l & real[:, None]).sum(axis=1).astype(np.int64)
    moved = int(moved_rows.sum())
    pvalid = (prev != ITEM_NONE) & (prev >= 0)
    mem_ba = (prev[:, :, None] == rows[:, None, :]).any(axis=2)
    changed = moved_l.any(axis=1) | (~mem_ba & pvalid).any(axis=1)
    remapped = int((real & changed).sum())
    return [degraded, unmapped, at_risk, dup, moved, remapped], \
        moved_rows


def _stats_lanes(prevs, rowss, ns, sizes, tols):
    """`_stats_np` as torch ops over a leading lane axis: lane i is
    (prev, rows) int32 [N_i, W_i] on one device, with its n, size and tol.
    The lanes are copied into one [L, Nmax, Wmax] block filled with
    ITEM_NONE (fresh memory: no lane's tensors are written), and `real =
    arange(Nmax) < min(n, N_i)` keeps the padded rows out of every sum;
    ITEM_NONE lanes are never occupied, so the padded columns count
    nowhere.  A single lane is a view, not a copy.  Returns (int64
    [L, 6] in STAT_KEYS order, each lane's per-PG moved lanes int64
    [N_i], sliced back from the block), on the device."""
    L = len(rowss)
    if L == 1:
        prev, rows = prevs[0][None], rowss[0][None]
    else:
        nmax = max(r.shape[0] for r in rowss)
        wmax = max(r.shape[1] for r in rowss)
        prev = torch.full((L, nmax, wmax), ITEM_NONE,
                          dtype=rowss[0].dtype, device=rowss[0].device)
        rows = torch.full_like(prev, ITEM_NONE)
        for i, (p, r) in enumerate(zip(prevs, rowss)):
            prev[i, :p.shape[0], :p.shape[1]] = p
            rows[i, :r.shape[0], :r.shape[1]] = r
    dev = rows.device
    # a lane's real rows: arange(Nmax) < min(n, N_i), as the solo
    # arange(N_i) < n (an n past N_i must not count the padding)
    n, size, tol = torch.tensor(
        [[min(int(x), r.shape[0]) for x, r in zip(ns, rowss)],
         [int(x) for x in sizes], [int(x) for x in tols]],
        dtype=torch.int64).to(dev)[:, :, None]
    real = torch.arange(rows.shape[1], device=dev)[None, :] < n
    occ = reduce.result_sizes(rows)
    moved_rows = (reduce.moved_in_lanes(prev, rows)
                  & real[..., None]).sum(-1)
    out = torch.stack([
        (real & (occ < size)).sum(-1),
        (real & (occ == 0)).sum(-1),
        (real & (occ < size - tol)).sum(-1),
        (real & reduce.duplicate_rows(rows)).sum(-1),
        moved_rows.sum(-1),
        (real & reduce.changed_rows(prev, rows)).sum(-1),
    ], dim=1)
    return out, tuple(moved_rows[i, :r.shape[0]]
                      for i, r in enumerate(rowss))


def _stats_torch(prev: torch.Tensor, rows: torch.Tensor, n: int, size: int,
                 tol: int):
    """One pool's epoch stats: the L = 1 case of `_stats_lanes`.  Returns
    (int64 [6] in STAT_KEYS order, per-PG moved lanes int64 [N]), both on
    the device."""
    _inc("stats_calls")
    out, moved = _stats_lanes((prev,), (rows,), (n,), (size,), (tol,))
    return out[0], moved[0]


STAT_KEYS = ("degraded", "unmapped", "at_risk", "dup", "moved",
             "remapped")

# recovery digest fields: the per-pool ints chained into the epoch line
# when the queue model runs
RECOVERY_DIGEST_KEYS = ("enqueued", "drained", "backlog", "risk_us",
                        "completed")
WORKLOAD_DIGEST_KEYS = ("requests", "reads", "degraded_reads",
                        "at_risk_hits", "backlog_hits")
# durability digest fields (correlated model only): per-pool dead-chunk
# sum, exposed-PG count, and the irreversible lost-PG count
DURABILITY_DIGEST_KEYS = ("wounds", "exposed", "lost")


# ------------------------------------------------------------- invariants


def check_rows_invariants(m: OSDMap, pid: int, rows, n: int,
                          only_seeds: set[int] | None = None,
                          oracle=None) -> list[str]:
    """Host-side invariant check over one pool's up rows [>=n, W]
    (numpy; lanes beyond n ignored).  Used as the detailed reporter when
    the device scalars flag a problem, and directly by the
    negative-control tests.  `only_seeds` restricts every check to that
    seed subset (the engine's sampled overlay checks, where the other
    rows were never fetched); `rows` may then hold just those seeds'
    rows, in sorted seed order, and no O(n) array is built.  Returns
    violation strings (empty = clean).

    - no PG silently unmapped: an empty row only violates when the
      bit-exact host oracle maps the PG somewhere (device/host
      divergence).  CRUSH itself legitimately returns nothing when its
      tries exhaust under heavy weight-out, or when every replica is
      down — the reference calls that a *bad mapping* / a `down` PG
      (degradation, accounted), never an invariant breach;
    - no duplicate OSD inside one row;
    - pg_upmap / pg_upmap_items entries respected by the rows;

    `oracle(seed) -> up list` overrides the host replay source (the
    engine passes ClusterState.host_up, memoised).
    """
    rows = np.asarray(rows)
    if only_seeds is None:
        seed_iter = range(n)
        rows = rows[:n]
        at = None
    else:
        seed_iter = sorted(only_seeds)
        if rows.shape[0] != len(seed_iter):  # every row: take the seeds'
            rows = rows[np.asarray(seed_iter, np.int64)]
        at = {s: i for i, s in enumerate(seed_iter)}

    def row_of(seed: int) -> int:
        return seed if at is None else at[seed]

    if oracle is None:
        def oracle(seed):
            up, _, _, _ = m.pg_to_up_acting_osds(PgId(pid, int(seed)))
            return up
    out: list[str] = []
    valid = (rows != ITEM_NONE) & (rows >= 0)
    occ = valid.sum(axis=1)
    empty = [s for s in seed_iter if occ[row_of(s)] == 0][:8]
    for seed in empty:  # bounded host replays
        want = [o for o in oracle(int(seed)) if o != ITEM_NONE]
        if want:
            out.append(
                f"pool {pid} pg {pid}.{int(seed):x} device row empty "
                f"but the host oracle maps {want}"
            )
    # duplicate scan stays vectorized; python only walks the hits
    w = rows.shape[1]
    eq = (rows[:, :, None] == rows[:, None, :]) \
        & valid[:, :, None] & valid[:, None, :]
    dup_rows = (eq & np.triu(np.ones((w, w), bool), 1)).any(axis=(1, 2))
    for seed in seed_iter:
        if dup_rows[row_of(seed)]:
            lanes = [int(o) for o in rows[row_of(seed)]
                     if o != ITEM_NONE and o >= 0]
            out.append(
                f"pool {pid} pg {pid}.{seed:x} carries duplicate OSDs "
                f"{lanes}"
            )
            if len(out) >= 16:
                return out
    for pg, p in m.pg_upmap.items():
        if pg.pool != pid or pg.seed >= n or (
                only_seeds is not None and pg.seed not in only_seeds):
            continue
        if any(o != ITEM_NONE and 0 <= o < m.max_osd
               and m.osd_weight[o] == 0 for o in p):
            continue  # rejected upmap (out target): not applied
        want = sorted(o for o in p if m.is_up(o))
        got = sorted(int(o) for o in rows[row_of(pg.seed)]
                     if o != ITEM_NONE and o >= 0)
        if want and got != want:
            out.append(
                f"pool {pid} pg {pg} pg_upmap {list(p)} not respected: "
                f"row {got}"
            )
    for pg, pairs in m.pg_upmap_items.items():
        if pg.pool != pid or pg.seed >= n or (
                only_seeds is not None and pg.seed not in only_seeds):
            continue
        lanes = {int(o) for o in rows[row_of(pg.seed)]
                 if o != ITEM_NONE and o >= 0}
        for frm, to in pairs:
            if (0 <= to < m.max_osd and m.is_up(to) and m.is_in(to)
                    and frm in lanes and to not in lanes):
                out.append(
                    f"pool {pid} pg {pg} upmap item {frm}->{to} not "
                    f"respected: {frm} still mapped, {to} absent"
                )
    return out


def check_pg_temp_invariants(m: OSDMap) -> list[str]:
    """Model-level pg_temp check: every live pg_temp entry must drive
    the acting set the reference semantics prescribe (entries filtered
    of dead OSDs, primary_temp honored)."""
    out: list[str] = []
    for pg, temp in m.pg_temp.items():
        pool = m.pools.get(pg.pool)
        if pool is None or pg.seed >= pool.pg_num:
            continue
        expect = [o for o in temp if m.exists(o) and not m.is_down(o)] \
            if pool.can_shift_osds() else [
                o if (m.exists(o) and not m.is_down(o)) else ITEM_NONE
                for o in temp]
        if not [o for o in expect if o != ITEM_NONE]:
            continue  # fully-dead temp: acting falls back to up
        _, _, acting, actp = m.pg_to_up_acting_osds(pg)
        if list(acting) != list(expect):
            out.append(
                f"pg_temp {pg} {list(temp)} not respected: acting "
                f"{list(acting)} != {list(expect)}"
            )
        want_p = m.primary_temp.get(pg)
        if want_p is not None and actp != want_p:
            out.append(
                f"primary_temp {pg} {want_p} not respected: acting "
                f"primary {actp}"
            )
    return out


# ------------------------------------------------------------- the engine


class LifetimeSim:
    """Scenario-driven lifetime engine (see module docstring).

    backend: "torch" (alias "jax"): a ClusterState on `device` (None:
    the card; "cpu" runs the rule's plain version) and the torch-op data
    planes; "ref": the host mapper and the numpy mirrors end to end, the
    same digests.  checkpoint: path of the atomic state file
    (runtime.Checkpoint); resume=True restores from it and continues;
    restore_state: a `_state()` dict held elsewhere (a fleet checkpoint's
    member slice) to continue from instead."""

    def __init__(self, scenario: Scenario | str | None = None,
                 backend: str = "torch",
                 checkpoint: str | None = None, resume: bool = False,
                 device=None, restore_state: dict | None = None,
                 mesh=None):
        if isinstance(scenario, str) or scenario is None:
            scenario = Scenario.parse(scenario)
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: torch (jax), "
                             "or ref")
        self.scenario = scenario
        self.backend = backend
        self.on_device = BACKENDS[backend] == "torch"
        # PG-axis device mesh of the whole epoch loop: the ClusterState
        # splits its launches over it; the digests are the same
        self.device, self.mesh = (mesh_for(device, mesh) if self.on_device
                                  else (None, None))
        self.steps = 0
        self.digest = hashlib.sha256(
            scenario.spec().encode()).hexdigest()
        self.sim_seconds = 0.0
        self.report = MovementReport()
        self.violations: list[str] = []
        self.fallback_events: list[str] = []
        self.event_counts: dict[str, int] = {}
        self.degraded_epochs = 0
        self.structural_epochs = 0
        self.steady_epochs = 0
        self.steady_compiles = 0
        self.steady_pipe_misses = 0
        self.total_compiles = 0
        # transient-event bookkeeping (all JSON-serializable)
        self.flap_down: dict[int, int] = {}     # osd -> revive step
        self.outages: list[list] = []           # [revive step, [osds]]
        self.temps: list[list] = []             # [pool, seed, clear step]
        self.dead: list[int] = []
        self.host_seq = scenario.hosts
        self.expanded = 0
        # correlated-failure model state: hazard windows are path
        # dependent, so they are checkpointed, never recomputed.
        # [bucket type, bucket id, expire epoch, strength]
        self.hazards: list[list] = []
        self.wounded: dict[int, np.ndarray] = {}   # pid -> dead chunks/PG
        self.healing: dict[int, np.ndarray] = {}   # pid -> repair seen
        self.lost: dict[int, list[int]] = {}       # pid -> lost seeds
        self.pg_lost_total = 0
        self.exposed_pg_epochs = 0
        self.flap_counts: dict[int, int] = {}
        self.false_flap_revives = 0
        self.domain_outages: dict[str, int] = {}
        self.cascades = 0
        self.longest_cascade = 0
        self._cascade_run = 0
        self.hazard_windows = 0
        # repeat offenders: one draw per lifetime, a pure function of
        # the scenario (resume recomputes the same set)
        self.flapper_osds: list[int] = []
        if scenario.correlated and scenario.flappers > 0:
            n0 = scenario.hosts * scenario.osds_per_host
            pick = np.random.default_rng(
                [scenario.seed, 0xF1A9]).choice(
                n0, size=min(scenario.flappers, n0), replace=False)
            self.flapper_osds = sorted(int(o) for o in pick)
        self._flapper_set = set(self.flapper_osds)
        self.resumed_from: int | None = None
        # in-process caches (never checkpointed).  self.state is the
        # device-resident ClusterState (torch backend): per-OSD vectors
        # scatter-updated in O(delta), per-pool rows version-tagged so
        # unchanged pools skip all device work.
        self.state = None
        self._prev_rows: dict[int, tuple] = {}   # pid -> (tag, rows)
        self._stats_cache: dict[int, tuple] = {}  # pid -> (tag, row-stats)
        self._moved: dict[int, object] = {}  # pid -> per-PG moved lanes
        self.recovery = None
        if scenario.recovery == "queue":
            from ceph_tpu_torch.recovery import RecoveryQueue

            self.recovery = RecoveryQueue(
                pg_gb=scenario.pg_gb,
                recovery_mbps=scenario.recovery_mbps,
                interval_s=scenario.interval_s,
                max_backfills=scenario.max_backfills,
                osd_mbps=scenario.osd_mbps,
                pipeline_repair=scenario.pipeline_repair,
                ec_gbps=scenario.ec_gbps, device=self.device)
        self.workload = None
        if scenario.workload:
            from ceph_tpu_torch.sim.workload import WorkloadGen

            self.workload = WorkloadGen(
                seed=scenario.seed, base_qps=scenario.base_qps,
                read_fraction=scenario.read_fraction,
                zipf_a=scenario.zipf_a, hot_pool=scenario.hot_pool,
                diurnal_amp=scenario.diurnal_amp,
                diurnal_period=scenario.diurnal_period,
                obj_kb=scenario.obj_kb, sample=scenario.wl_sample,
                interval_s=scenario.interval_s)
        self._cap_rem = None  # per-OSD capacity left after clients
        # test hook: perturb a pool-epoch's drain scalars to prove the
        # byte-conservation invariant catches a disagreeing data plane
        self.recovery_corrupt_hook = None
        self.steady_full_rebuilds = 0
        # per-epoch summarized health status tallies (obs/health.py)
        self._health_counts = {"ok": 0, "warn": 0, "err": 0}
        self._prev_skeys: frozenset | None = None
        self._last_balance_key = None
        self._overlay_checked: dict[int, tuple] = {}
        self._pg_temp_checked = None
        self._structural_apply = False
        self._steps_this_proc = 0
        self._wall_this_proc = 0.0
        self._sim_this_proc = 0.0
        # test hook: host-path row corruption for invariant negative
        # controls (fn(pid, rows_np) -> rows_np); None in production
        self.corrupt_hook = None
        # extra mgr Balancer options merged into every _balance round
        self.balancer_options: dict = {}

        self.ck = Checkpoint(checkpoint, resume=resume) \
            if checkpoint else None
        # restore_state: an externally held _state() dict (the fleet
        # checkpoints the whole stack in one file and hands each member
        # its slice); otherwise the engine's own checkpoint
        state = restore_state
        if state is None:
            state = (self.ck.data.get("lifetime")
                     if (self.ck is not None and resume) else None)
        if state:
            self._restore(state)
        else:
            self.m = build_cluster(scenario)
        # baseline: map every pool once so epoch 1 has prev rows
        self._baseline()

    # -- checkpoint/resume -------------------------------------------------

    def _state(self) -> dict:
        from ceph_tpu_torch.osd.codec import encode_osdmap

        return {
            "scenario": self.scenario.spec(),
            "backend": self.backend,
            "steps": self.steps,
            "digest": self.digest,
            "sim_seconds": self.sim_seconds,
            "report": vars(self.report),
            "violations": self.violations,
            "fallback_events": self.fallback_events,
            "event_counts": self.event_counts,
            "degraded_epochs": self.degraded_epochs,
            "structural_epochs": self.structural_epochs,
            "steady_epochs": self.steady_epochs,
            "steady_compiles": self.steady_compiles,
            "steady_pipe_misses": self.steady_pipe_misses,
            "steady_full_rebuilds": self.steady_full_rebuilds,
            "total_compiles": self.total_compiles,
            "flap_down": {str(k): v for k, v in self.flap_down.items()},
            "outages": self.outages,
            "temps": self.temps,
            "dead": self.dead,
            "host_seq": self.host_seq,
            "expanded": self.expanded,
            # hazard windows carry their current decayed strengths
            "hazards": [list(h) for h in self.hazards],
            "wounded": {str(pid): [int(x) for x in w]
                        for pid, w in self.wounded.items()},
            "healing": {str(pid): [int(x) for x in h]
                        for pid, h in self.healing.items()},
            "lost": {str(pid): list(s) for pid, s in self.lost.items()},
            "pg_lost_total": self.pg_lost_total,
            "exposed_pg_epochs": self.exposed_pg_epochs,
            "chaos": {
                "flap_counts": {str(k): v
                                for k, v in self.flap_counts.items()},
                "false_flap_revives": self.false_flap_revives,
                "domain_outages": dict(self.domain_outages),
                "cascades": self.cascades,
                "longest_cascade": self.longest_cascade,
                "cascade_run": self._cascade_run,
                "hazard_windows": self.hazard_windows,
            },
            "map_b64": base64.b64encode(
                encode_osdmap(self.m)).decode(),
            "recovery": (None if self.recovery is None
                         else self.recovery.state()),
            "workload": (None if self.workload is None
                         else self.workload.state()),
            "health_epochs": dict(self._health_counts),
            "timeline": timeline.state("sim"),
        }

    def _restore(self, state: dict) -> None:
        from ceph_tpu_torch.osd.codec import decode_osdmap

        if state.get("scenario") != self.scenario.spec():
            raise ValueError(
                "checkpoint was written by a different scenario:\n"
                f"  checkpoint: {state.get('scenario')}\n"
                f"  requested:  {self.scenario.spec()}"
            )
        self.m = decode_osdmap(base64.b64decode(state["map_b64"]))
        self.steps = int(state["steps"])
        self.digest = state["digest"]
        self.sim_seconds = float(state["sim_seconds"])
        self.report = MovementReport(**state["report"])
        self.violations = list(state["violations"])
        self.fallback_events = list(state["fallback_events"])
        self.event_counts = dict(state["event_counts"])
        self.degraded_epochs = int(state["degraded_epochs"])
        self.structural_epochs = int(state["structural_epochs"])
        self.steady_epochs = int(state["steady_epochs"])
        self.steady_compiles = int(state["steady_compiles"])
        self.steady_pipe_misses = int(state["steady_pipe_misses"])
        self.steady_full_rebuilds = int(
            state.get("steady_full_rebuilds", 0))
        self.total_compiles = int(state["total_compiles"])
        self.flap_down = {int(k): int(v)
                          for k, v in state["flap_down"].items()}
        self.outages = [list(x) for x in state["outages"]]
        self.temps = [list(x) for x in state["temps"]]
        self.dead = list(state["dead"])
        self.host_seq = int(state["host_seq"])
        self.expanded = int(state["expanded"])
        self.hazards = [list(h) for h in state.get("hazards", [])]
        self.wounded = {int(k): np.asarray(v, np.int64)
                        for k, v in (state.get("wounded") or {}).items()}
        self.healing = {int(k): np.asarray(v, bool)
                        for k, v in (state.get("healing") or {}).items()}
        self.lost = {int(k): [int(s) for s in v]
                     for k, v in (state.get("lost") or {}).items()}
        self.pg_lost_total = int(state.get("pg_lost_total", 0))
        self.exposed_pg_epochs = int(state.get("exposed_pg_epochs", 0))
        cz = state.get("chaos") or {}
        self.flap_counts = {
            int(k): int(v)
            for k, v in (cz.get("flap_counts") or {}).items()}
        self.false_flap_revives = int(cz.get("false_flap_revives", 0))
        self.domain_outages = dict(cz.get("domain_outages") or {})
        self.cascades = int(cz.get("cascades", 0))
        self.longest_cascade = int(cz.get("longest_cascade", 0))
        self._cascade_run = int(cz.get("cascade_run", 0))
        self.hazard_windows = int(cz.get("hazard_windows", 0))
        if self.recovery is not None and state.get("recovery"):
            self.recovery.restore(state["recovery"])
        if self.workload is not None and state.get("workload"):
            self.workload.restore(state["workload"])
        self._health_counts = dict(
            state.get("health_epochs") or {"ok": 0, "warn": 0, "err": 0})
        if state.get("timeline"):
            # resumed runs continue the same monotonic sample indices
            timeline.restore("sim", state["timeline"])
        self.resumed_from = self.steps

    def _checkpoint(self) -> None:
        if self.ck is None:
            return
        self.ck.progress("lifetime", self._state())
        _inc("checkpoints")
        obs.instant("sim.checkpoint", epoch=self.steps)

    # -- mapping + accounting ---------------------------------------------

    def _baseline(self) -> None:
        """Map every pool once (rows become epoch 1's `prev`) and record
        the structure key set the structural classification diffs."""
        if self.on_device:
            from ceph_tpu_torch.osd.state import ClusterState

            try:
                self.state = ClusterState(self.m, device=self.device,
                                          mesh=self.mesh)
            except Exception as e:
                self._degrade(0, "state", e)
        skeys = set()
        for pid in sorted(self.m.pools):
            try:
                _, skey = self._account_pool(pid, baseline=True)
            except Exception as e:
                self._degrade(0, pid, e)
                _, skey = self._account_pool(pid, baseline=True,
                                             force_host=True)
            skeys.add(skey)
        self._prev_skeys = frozenset(skeys)

    def _dv(self) -> int:
        """Per-OSD vector bound of the recovery/workload programs: the
        ClusterState's on the torch backend, the same power-of-two
        formula on "ref".  Lanes past max_osd are never addressed, so
        the bound does not shape the digested outputs."""
        if self.state is not None:
            return self.state.DV
        n = max(self.m.max_osd, 1)
        return 1 << max(int(n - 1).bit_length(), 5)

    def _fresh_cap(self, device: bool):
        """A fresh epoch's per-OSD (capacity, slots) vectors."""
        DV = self._dv()
        cap_bytes = (self.recovery.cap_epoch_bytes
                     if self.recovery is not None else 0)
        slots = (self.recovery.max_backfills
                 if self.recovery is not None else 0)
        if device:
            return (torch.full((DV,), cap_bytes, dtype=torch.int64,
                               device=self.device),
                    torch.full((DV,), slots, dtype=torch.int64,
                               device=self.device))
        return (np.full(DV, cap_bytes, np.int64),
                np.full(DV, slots, np.int64))

    def _pool_tolerance(self, pool: PgPool) -> int:
        """Chunks/replicas the pool can lose before data is at risk:
        EC -> m (from the profile), replicated -> size-1."""
        if pool.is_erasure():
            prof = self.m.erasure_code_profiles.get(
                pool.erasure_code_profile, {})
            try:
                return int(prof["m"])
            except (KeyError, ValueError):
                return max(0, pool.size - 1)
        return max(0, pool.size - 1)

    def _host_up(self, pid: int, seed: int) -> list[int]:
        """One PG's host-exact `up` set, the invariant oracle: the
        ClusterState's (memoised) on the torch backend, a direct host
        replay on "ref"."""
        if self.state is not None:
            return self.state.host_up(pid, int(seed))
        m = self.m
        pool = m.pools[pid]
        pg = PgId(pid, int(seed))
        raw, pps = m._pg_to_raw_osds(pool, pg)
        m._apply_upmap(pool, pg, raw)
        up = m._raw_to_up_osds(pool, raw)
        up_primary = m._pick_primary(up)
        m._apply_primary_affinity(pps, pool, up, up_primary)
        return up

    # stats that are pure functions of the CURRENT rows — replayable
    # without device work when the rows' version tag is unchanged
    # (moved/remapped compare against prev rows: identical rows give 0)
    _ROW_STATS = ("degraded", "unmapped", "at_risk", "dup")

    def _account_pool(self, pid: int, baseline: bool = False,
                      force_host: bool = False):
        """Map one pool and reduce the epoch stats: torch ops on the
        state's rows, or the host oracle and `_stats_np` on "ref" or
        when a device loss degraded this call (`force_host`).

        O(delta) steady path: when the pool's ClusterState version tag
        matches both the previous epoch's rows and the cached row-stats,
        the epoch does no device work for the pool: the rows are equal by
        the tag contract, so moved/remapped are 0 and the row-pure stats
        replay from the cache."""
        if self.state is not None and not force_host:
            lane, skey = self._plan_pool(pid)
            out = moved_rows = None
            if lane["cached"] is None:
                out, moved_rows = _stats_torch(
                    lane["prev"], lane["rows"], lane["n"], lane["size"],
                    lane["tol"])
                out = out.tolist()
            st = self._commit_pool(lane, out, moved_rows)
            if baseline:  # ran for the warmup, not the books
                return None, skey
            return st, skey
        pool = self.m.pools[pid]
        tol = self._pool_tolerance(pool)
        up, _, _, _ = _map_ref(self.m, pid)
        rows = up.astype(np.int32)
        if self.corrupt_hook is not None:
            rows = self.corrupt_hook(pid, rows)
        n = pool.pg_num
        skey = ("ref", n, int(rows.shape[1]))
        prev = self._prev_rows.get(pid)
        prev_np = rows if (
            prev is None
            or tuple(np.shape(prev[1])) != tuple(rows.shape)
        ) else _host(prev[1])
        self._prev_rows[pid] = (None, rows)
        self._stats_cache.pop(pid, None)
        if baseline:
            self._moved[pid] = None
            return None, skey
        stats_list, moved_rows = _stats_np(
            prev_np, rows, n, pool.size, tol)
        self._moved[pid] = moved_rows
        st = dict(zip(STAT_KEYS, stats_list))
        st["n"] = n
        st["size"] = pool.size
        st["tol"] = tol
        return st, skey

    # The fleet engine (ceph_tpu_torch.fleet) reduces many engines' pools
    # in one `_stats_lanes` call.  _plan_pool/_commit_pool are the read
    # and write halves of _account_pool's device path, which is built from
    # them, so a fleet member's digest equals a solo run's.

    def _plan_pool(self, pid: int):
        """Read half (device path only): the version-tagged rows, the
        tag-equal decision and the prev operand, without reducing.
        Returns (lane, skey); `lane["cached"]` not None means the stats
        replay from the cache (the rows did not change) and the lane needs
        no stats call."""
        pool = self.m.pools[pid]
        tol = self._pool_tolerance(pool)
        rows, skey, tag = self.state.rows(pid)
        prev = self._prev_rows.get(pid)
        cached = self._stats_cache.get(pid)
        lane = {"pid": pid, "rows": rows, "n": pool.pg_num,
                "size": pool.size, "tol": tol, "tag": tag,
                "cached": None}
        if (prev is not None and prev[0] == tag
                and cached is not None and cached[0] == tag
                and cached[1]["tol"] == tol):
            lane["cached"] = dict(cached[1]["stats"], moved=0, remapped=0)
            lane["prev"] = rows
        elif (prev is None
                or tuple(prev[1].shape) != tuple(rows.shape)):
            lane["prev"] = rows  # fresh/resized pool: self-compare
        elif isinstance(prev[1], np.ndarray):
            # host rows of an epoch a device loss degraded
            lane["prev"] = torch.from_numpy(prev[1]).to(rows.device)
        else:
            lane["prev"] = prev[1]
        return lane, skey

    def _commit_pool(self, lane: dict, out, moved_rows) -> dict:
        """Write half: book one lane's stats (`out`, the six ints in
        STAT_KEYS order; `moved_rows`, the per-PG moved lanes on the
        device) into the caches the solo path keeps.  A cached lane
        ignores both."""
        pid, tag = lane["pid"], lane["tag"]
        if lane["cached"] is not None:
            st = dict(lane["cached"])
            self._moved[pid] = None  # tag-equal rows: nothing moved
        else:
            st = {k: int(v) for k, v in zip(STAT_KEYS, out)}
            self._moved[pid] = moved_rows  # stays on the device
            self._stats_cache[pid] = (tag, {
                "tol": lane["tol"],
                "stats": {k: st[k] for k in self._ROW_STATS},
            })
        self._prev_rows[pid] = (tag, lane["rows"])  # stays on the device
        st["n"] = lane["n"]
        st["size"] = lane["size"]
        st["tol"] = lane["tol"]
        return st

    def _degrade(self, e: int, pid, exc) -> None:
        """Called from an `except` block around device work: raises
        `exc` unless `faults.degrade_or_raise` lets a device loss degrade
        (a run placed on the host), then records the descent; the caller
        goes on through the host mapper and numpy mirrors."""
        faults.degrade_or_raise(exc, self.device)
        msg = f"epoch {e} pool {pid}: {exc} -> host mapper"
        self.fallback_events.append(msg)
        _log(1, "device lost mid-lifetime; degrading accounting to "
                f"the bit-exact host mapper ({msg})")

    def _account_epoch(self, e: int):
        stats: dict[int, dict] = {}
        skeys = set()
        for pid in sorted(self.m.pools):
            try:
                faults.check("epoch_apply", qual=str(e))
                st, skey = self._account_pool(pid)
            except Exception as exc:
                # a device loss degrades on the host, raises on a card;
                # any other error raises
                self._degrade(e, pid, exc)
                st, skey = self._account_pool(pid, force_host=True)
            stats[pid] = st
            skeys.add(skey)
        self._prune_removed_pools()
        return stats, frozenset(skeys)

    def _prune_removed_pools(self) -> None:
        """Removed pools leave no stale prev rows (or queue/durability
        state) behind."""
        for pid in list(self._prev_rows):
            if pid not in self.m.pools:
                del self._prev_rows[pid]
                self._stats_cache.pop(pid, None)
                self._moved.pop(pid, None)
                self.wounded.pop(pid, None)
                self.healing.pop(pid, None)
                self.lost.pop(pid, None)  # pg_lost_total stays booked
                if self.recovery is not None:
                    self.recovery.drop(pid)

    # -- invariants --------------------------------------------------------

    def _row_slice(self, pid: int, seeds: np.ndarray) -> np.ndarray:
        rows = self._prev_rows[pid][1]
        if isinstance(rows, np.ndarray):
            return rows[seeds]
        return rows[torch.from_numpy(
            np.asarray(seeds, np.int64)).to(rows.device)].cpu().numpy()

    def _invariants(self, e: int, rng, stats: dict) -> None:
        up_osds = sum(
            1 for o in range(self.m.max_osd) if self.m.is_up(o))
        for pid, st in stats.items():
            pool = self.m.pools[pid]
            flagged = st["dup"] > 0 or (
                st["unmapped"] > 0 and up_osds >= pool.size)
            if flagged:
                rows = self._prev_rows[pid][1]
                oracle = (lambda s, pid=pid: self._host_up(pid, s))
                if isinstance(rows, np.ndarray):
                    msgs = check_rows_invariants(
                        self.m, pid, rows, st["n"], oracle=oracle)
                else:
                    seeds = self._flagged_seeds(pid, rows, st["n"])
                    msgs = check_rows_invariants(
                        self.m, pid, self._row_slice(pid, seeds), st["n"],
                        only_seeds=set(seeds.tolist()), oracle=oracle)
                if st["dup"] and not any("duplicate" in v
                                         for v in msgs):
                    msgs.append(
                        f"pool {pid}: device scalars flagged "
                        f"dup={st['dup']} but the host detail pass "
                        "found none (device/host divergence)")
                self._violate(e, msgs)  # may be empty: an empty up
                # row whose raw replay maps nothing is degradation
            else:
                # overlay respect stays cheap: only overlay-carrying
                # seeds are fetched (bounded sample), and a pool whose
                # rows version tag is unchanged since its last CLEAN
                # check is skipped outright
                tag = self._prev_rows[pid][0]
                if tag is None or self._overlay_checked.get(pid) != tag:
                    self._check_overlays(e, pid, st["n"], rng)
                    if tag is not None:
                        self._overlay_checked[pid] = tag
        tkey = None
        if self.state is not None:
            # pg_temp semantics only need re-checking when an input
            # changed: the temp/primary entries themselves or anything
            # feeding the mapping (the state's aggregate version tag)
            tkey = (
                self.state.state_tag(),
                tuple(sorted(((pg.pool, pg.seed), tuple(v))
                             for pg, v in self.m.pg_temp.items())),
                tuple(sorted(((pg.pool, pg.seed), v)
                             for pg, v in self.m.primary_temp.items())),
            )
        if tkey is None or tkey != self._pg_temp_checked:
            temp_msgs = check_pg_temp_invariants(self.m)
            if temp_msgs:
                self._violate(e, temp_msgs)
            elif tkey is not None:
                self._pg_temp_checked = tkey
        every = self.scenario.spotcheck_every
        if every and e % every == 0:
            self._spot_check(e, rng)

    def _flagged_seeds(self, pid: int, rows: torch.Tensor,
                       n: int) -> np.ndarray:
        """The seeds a full check_rows_invariants pass could report on,
        sorted: the empty and the duplicate-carrying rows (found on the
        rows' device) and the upmap-carrying seeds.  Checking these rows
        alone gives the full pass's messages without fetching the
        pool's rows."""
        r = rows[:n]
        bad = ~reduce.valid_lanes(r).any(1) | reduce.duplicate_rows(r)
        over = [pg.seed for src in (self.m.pg_upmap, self.m.pg_upmap_items)
                for pg in src if pg.pool == pid and pg.seed < n]
        return np.union1d(torch.nonzero(bad)[:, 0].cpu().numpy(),
                          np.asarray(over, np.int64))

    def _check_overlays(self, e: int, pid: int, n: int, rng) -> None:
        seeds = sorted({
            pg.seed for src in (self.m.pg_upmap, self.m.pg_upmap_items)
            for pg in src if pg.pool == pid and pg.seed < n
        })
        if not seeds:
            return
        if len(seeds) > 32:
            pick = rng.choice(len(seeds), 32, replace=False)
            seeds = sorted(seeds[i] for i in pick)
        sub = self._row_slice(pid, np.asarray(seeds, np.int64))
        msgs = check_rows_invariants(
            self.m, pid, sub, n, only_seeds=set(seeds),
            oracle=lambda s, pid=pid: self._host_up(pid, s))
        if msgs:
            self._violate(e, msgs)

    def _spot_check(self, e: int, rng) -> None:
        K = self.scenario.spotcheck_lanes
        for pid in sorted(self.m.pools):
            n = self.m.pools[pid].pg_num
            seeds = np.unique(rng.integers(0, n, size=K))
            got = self._row_slice(pid, seeds)
            for seed, row in zip(seeds, got):
                _inc("spot_checks")
                up, _, _, _ = self.m.pg_to_up_acting_osds(
                    PgId(pid, int(seed)))
                want = sorted(o for o in up if o != ITEM_NONE)
                have = sorted(int(o) for o in row
                              if o != ITEM_NONE and o >= 0)
                if want != have:
                    _inc("spotcheck_mismatches")
                    self._violate(e, [
                        f"spot-check pool {pid} pg {pid}.{int(seed):x}: "
                        f"device {have} != host {want}"
                    ])

    def _violate(self, e: int, msgs: list[str]) -> None:
        for msg in msgs:
            _inc("invariant_violations")
            self.violations.append(f"epoch {e}: {msg}")

    # -- events ------------------------------------------------------------

    def _devices_under(self, bid: int) -> list[int]:
        out: list[int] = []
        b = self.m.crush.buckets.get(bid)
        if b is None:
            return out
        for it in b.items:
            if it >= 0:
                out.append(it)
            else:
                out.extend(self._devices_under(it))
        return out

    def _buckets_of_type(self, type_: int) -> list[int]:
        shadows = {
            sid for per in self.m.crush.class_bucket.values()
            for sid in per.values()
        }
        return sorted(
            (bid for bid, b in self.m.crush.buckets.items()
             if b.type == type_ and bid not in shadows),
            reverse=True,
        )

    def _sibling_domains(self, bid: int, type_: int) -> list[int]:
        """The failure domains a bucket's outage raises hazard on: the
        other same-type buckets under the same (non-shadow) parent,
        or every other same-type bucket when no parent carries
        siblings (flat hierarchies)."""
        pool = self._buckets_of_type(type_)
        shadows = {
            sid for per in self.m.crush.class_bucket.values()
            for sid in per.values()
        }
        parent = next(
            (pb for pb, b in self.m.crush.buckets.items()
             if bid in b.items and pb not in shadows), None)
        sibs: list[int] = []
        if parent is not None:
            inside = set(self.m.crush.buckets[parent].items)
            sibs = [b for b in pool if b in inside and b != bid]
        if not sibs:
            sibs = [b for b in pool if b != bid]
        return sibs

    def _floor(self) -> int:
        return max((p.size for p in self.m.pools.values()), default=3)

    def _ups(self, exclude: set) -> list[int]:
        return [o for o in range(self.m.max_osd)
                if self.m.is_up(o) and o not in exclude]

    def _hazard_boost(self) -> dict[int, float]:
        """Summed live hazard strength per bucket type (1=host,
        3=rack): the correlation mass added to the outage draws."""
        add: dict[int, float] = {}
        for t, _bid, _exp, s in self.hazards:
            add[t] = add.get(t, 0.0) + float(s)
        return add

    def _decay_hazards(self, e: int) -> None:
        """Advance every open hazard window by one epoch: strength
        decays geometrically, expired windows close.  Runs once per
        epoch, before the kind draw."""
        faults.check("hazard_decay", qual=str(e))
        kept: list[list] = []
        for rec in self.hazards:
            rec[3] = float(rec[3]) * self.scenario.cascade_decay
            if rec[2] > e and rec[3] >= 1e-9:
                kept.append(rec)
        self.hazards = kept

    def _draw_kind(self, rng) -> str:
        u = float(rng.random())
        boost = self._hazard_boost() if (
            self.scenario.correlated and self.hazards) else {}
        acc = 0.0
        for kind, p in self.scenario.event_probs():
            if kind == "host_outage":
                p += boost.get(1, 0.0)
            elif kind == "rack_outage":
                p += boost.get(3, 0.0)
            acc += p
            if u < acc:
                return kind
        return "quiet"

    def _apply_event(self, e: int, rng, force: str | None) -> str:
        m = self.m
        sc = self.scenario
        inc = Incremental(epoch=m.epoch + 1)
        notes: list[str] = []
        touched: set[int] = set()

        if sc.correlated:
            self._decay_hazards(e)

        # transient expiries ride the same epoch delta
        for osd in sorted(o for o, t in self.flap_down.items()
                          if t <= e):
            del self.flap_down[osd]
            if m.exists(osd) and m.is_down(osd):
                inc.new_state[osd] = OSD_UP
                touched.add(osd)
                # a flap revive: the OSD comes back with every byte
                # intact (no recovery enqueue ever happened for it)
                self.false_flap_revives += 1
                _inc("flap_revives")
                notes.append(f"revive osd.{osd}")
        for rec in [r for r in self.outages if r[0] <= e]:
            self.outages.remove(rec)
            back = []
            for osd in rec[1]:
                if (m.exists(osd) and m.is_down(osd)
                        and osd not in touched
                        and osd not in self.flap_down
                        and osd not in self.dead):
                    inc.new_state[osd] = OSD_UP
                    touched.add(osd)
                    back.append(osd)
            notes.append(f"outage-end osds={back}")
        for rec in [r for r in self.temps if r[2] <= e]:
            self.temps.remove(rec)
            pg = PgId(int(rec[0]), int(rec[1]))
            inc.new_pg_temp[pg] = []
            inc.new_primary_temp[pg] = -1
            notes.append(f"pg_temp-clear {pg}")

        balance = (sc.balance_every
                   and e % sc.balance_every == 0 and force is None)
        kind = "balance" if balance else (force or self._draw_kind(rng))
        if kind != "balance":
            kind, detail = self._apply_kind(kind, e, rng, inc, touched)
            self._apply_inc(inc)
        else:
            if (inc.new_state or inc.new_pg_temp
                    or inc.new_primary_temp):
                self._apply_inc(inc)  # expiries first, own epoch
            detail = self._balance(e)
        if kind != "quiet":
            _inc("events_applied")
        self.event_counts[kind] = self.event_counts.get(kind, 0) + 1
        if notes:
            detail = detail + " +" + "+".join(notes)
        return detail

    def _apply_inc(self, inc: Incremental) -> None:
        """Advance the map by one epoch delta: through the ClusterState
        (value deltas in O(delta) on the device, structural ones
        rebuild) on the torch backend, plain host application on "ref".
        A structural delta marks the epoch structural; a forced rebuild
        (CEPH_TPU_STATE_DELTA=0) does not: that is the contract break
        steady_full_rebuilds exposes."""
        if self.state is not None:
            if self.state.apply(inc) == "rebuild":
                self._structural_apply = True
        else:
            apply_incremental(self.m, inc)

    def _apply_kind(self, kind: str, e: int, rng, inc: Incremental,
                    touched: set) -> tuple[str, str]:
        m, sc = self.m, self.scenario
        ups = self._ups(touched)
        floor = self._floor()

        def quiet(why: str) -> tuple[str, str]:
            return "quiet", f"quiet({why})"

        if kind == "quiet":
            return "quiet", "quiet"

        if kind == "flap":
            if len(ups) - 1 < floor or not ups:
                return quiet("flap:floor")
            if sc.correlated and self._flapper_set:
                # repeat offenders: the once-per-lifetime flakiness
                # multipliers weight the victim draw (cumulative-sum
                # draw, exact float64)
                w = np.asarray(
                    [sc.flapper_boost if o in self._flapper_set
                     else 1.0 for o in ups], np.float64)
                cum = np.cumsum(w)
                u = float(rng.random()) * float(cum[-1])
                idx = min(int(np.searchsorted(cum, u, side="right")),
                          len(ups) - 1)
                osd = int(ups[idx])
            else:
                osd = int(ups[int(rng.integers(len(ups)))])
            self.flap_counts[osd] = self.flap_counts.get(osd, 0) + 1
            inc.new_state[osd] = OSD_UP
            self.flap_down[osd] = e + 1 + int(
                rng.integers(1, sc.flap_len + 1))
            return kind, f"flap osd.{osd}"

        if kind == "death":
            if len(ups) - 1 < floor or not ups:
                return quiet("death:floor")
            osd = int(ups[int(rng.integers(len(ups)))])
            inc.new_state[osd] = OSD_UP
            inc.new_weight[osd] = 0
            self.dead.append(osd)
            if sc.correlated:
                self._wound_osd(osd)
            return kind, f"death osd.{osd}"

        if kind == "remove":
            if not self.dead:
                return quiet("remove:none-dead")
            cand = sorted(self.dead)
            osd = int(cand[int(rng.integers(len(cand)))])
            self.dead.remove(osd)
            c2 = copy.deepcopy(m.crush)
            c2.remove_item(osd)
            from ceph_tpu_torch.crush.codec import encode_crushmap

            inc.crush = encode_crushmap(c2)
            inc.new_state[osd] = OSD_EXISTS  # destroy
            return kind, f"remove osd.{osd}"

        if kind in ("host_outage", "rack_outage"):
            type_ = 1 if kind == "host_outage" else 3
            buckets = self._buckets_of_type(type_)
            if not buckets:
                return quiet(f"{kind}:no-bucket")
            if sc.correlated:
                # cascade bias: while hazard windows of this type are
                # open, the outage strikes a hazarded sibling domain
                hot = {int(h[1]) for h in self.hazards
                       if h[0] == type_}
                hazarded = [b for b in buckets if b in hot]
                if hazarded:
                    buckets = hazarded
            bid = int(buckets[int(rng.integers(len(buckets)))])
            victims = [o for o in self._devices_under(bid)
                       if m.is_up(o) and o not in touched]
            if not victims or len(ups) - len(victims) < floor:
                return quiet(f"{kind}:floor")
            for osd in victims:
                inc.new_state[osd] = OSD_UP
            self.outages.append([
                e + 1 + int(rng.integers(1, sc.outage_len + 1)),
                victims,
            ])
            name = m.crush.item_names.get(bid, str(bid))
            self.domain_outages[name] = \
                self.domain_outages.get(name, 0) + 1
            if sc.correlated:
                if self.hazards:
                    # fired inside an open window: one more link of the
                    # current cascade chain
                    self.cascades += 1
                    self._cascade_run += 1
                    _inc("cascade_outages")
                else:
                    self._cascade_run = 1
                self.longest_cascade = max(self.longest_cascade,
                                           self._cascade_run)
                for sib in self._sibling_domains(bid, type_):
                    self.hazards.append([
                        type_, int(sib), e + 1 + sc.cascade_len,
                        float(sc.cascade_hazard),
                    ])
                    self.hazard_windows += 1
            return kind, f"{kind} {name} osds={victims}"

        if kind == "reweight":
            cand = [o for o in ups if m.is_in(o)]
            if not cand:
                return quiet("reweight:none")
            osd = int(cand[int(rng.integers(len(cand)))])
            w = int(round((0.6 + 0.4 * float(rng.random())) * IN_WEIGHT))
            inc.new_weight[osd] = w
            return kind, f"reweight osd.{osd} {w}"

        if kind == "pg_temp":
            pids = sorted(m.pools)
            pid = int(pids[int(rng.integers(len(pids)))])
            pool = m.pools[pid]
            seed = int(rng.integers(pool.pg_num))
            pg = PgId(pid, seed)
            if any(r[0] == pid and r[1] == seed for r in self.temps):
                return quiet("pg_temp:exists")
            up, _, _, _ = m.pg_to_up_acting_osds(pg)
            members = [o for o in up if o != ITEM_NONE]
            if len(members) < 2:
                return quiet("pg_temp:thin")
            temp = members[1:] + members[:1]  # rotated acting override
            inc.new_pg_temp[pg] = temp
            inc.new_primary_temp[pg] = temp[0]
            self.temps.append([
                pid, seed,
                e + 1 + int(rng.integers(1, sc.temp_len + 1)),
            ])
            return kind, f"pg_temp {pg} {temp}"

        if kind == "pool_create":
            if len(m.pools) >= sc.max_pools:
                return quiet("pool_create:cap")
            pid = m.pool_max + 1
            inc.new_pool_max = pid
            inc.new_pools[pid] = PgPool(
                type=PoolType.REPLICATED, size=sc.size, crush_rule=0,
                pg_num=sc.new_pool_pgs, pgp_num=sc.new_pool_pgs,
            )
            inc.new_pool_names[pid] = f"pool{pid}"
            return kind, f"pool_create pool{pid} pgs={sc.new_pool_pgs}"

        if kind == "split":
            cand = sorted(
                pid for pid, p in m.pools.items()
                if p.pg_num * 2 <= sc.max_pgs
            )
            if not cand:
                return quiet("split:cap")
            pid = int(cand[int(rng.integers(len(cand)))])
            pool = inc.get_new_pool(pid, m.pools[pid])
            pool.pg_num *= 2
            pool.pgp_num = pool.pg_num
            return kind, f"split pool{pid} pg_num={pool.pg_num}"

        if kind == "expand":
            if self.expanded >= sc.max_expand:
                return quiet("expand:cap")
            H = self.host_seq
            first = m.max_osd
            new = list(range(first, first + sc.osds_per_host))
            c2 = copy.deepcopy(m.crush)
            loc = {"host": f"host{H}", "root": "default"}
            if sc.racks:
                loc["rack"] = f"rack{int(rng.integers(sc.racks))}"
            for o in new:
                c2.insert_item(o, 1.0, f"osd.{o}", loc)
            from ceph_tpu_torch.crush.codec import encode_crushmap

            inc.crush = encode_crushmap(c2)
            inc.new_max_osd = first + sc.osds_per_host
            for o in new:
                inc.new_up_client[o] = b""
                inc.new_weight[o] = IN_WEIGHT
            self.host_seq += 1
            self.expanded += 1
            return kind, (f"expand host{H} osds={new} "
                          f"rack={loc.get('rack', '-')}")

        raise ValueError(f"unknown event kind {kind!r}")

    def _balance(self, e: int) -> str:
        """One mgr balancer round (upmap mode) on the state: plan,
        optimize and execute.  A device error raises.  On the torch
        backend the plan's membership state is the "device" one (rows on
        the card, O(OSDs) on the host), which makes the decisions of the
        JAX package's default "sets" (the reference's dict of sets, a
        Python set per PG): equal digests on every corpus scenario."""
        from ceph_tpu_torch.mgr import Balancer, MappingState, \
            synthetic_pg_stats

        bal = Balancer(
            options={"upmap_max_optimizations":
                     self.scenario.balance_max,
                     "upmap_state_backend":
                     "device" if self.on_device else "sets",
                     **self.balancer_options},
            rng=np.random.default_rng(
                [self.scenario.seed, e, 1]),
        )
        ms = MappingState(self.m, synthetic_pg_stats(self.m),
                          desc=f"epoch{e}",
                          mapper="torch" if self.on_device else "host",
                          state=self.state)
        plan = bal.plan_create(f"epoch{e}", ms, mode="upmap")
        rc, _ = bal.optimize(plan)
        if rc == 0:
            rc2, msg = bal.execute(plan, self.m, state=self.state)
            if rc2 != 0:
                raise RuntimeError(f"balancer execute: {msg}")
            changed = (len(plan.inc.new_pg_upmap_items)
                       + len(plan.inc.old_pg_upmap_items))
            timeline.sample("balancer", {"epoch": e, "changed": changed})
            return f"balance changed={changed}"
        self._apply_inc(Incremental(epoch=self.m.epoch + 1))
        return "balance changed=0"

    # -- recovery + workload data plane ------------------------------------

    def _workload_epoch(self, e: int) -> dict:
        """One epoch of modeled client traffic through the current
        placement rows (sim/workload.py): per-pool request samples,
        client-visible tallies, and the per-OSD capacity remainder the
        recovery drain then competes for."""
        t0 = time.perf_counter()
        with obs.span("sim.workload", epoch=e):
            out = self._workload_body(e)
        self.workload.observe_epoch(self.workload.qps(e),
                                    time.perf_counter() - t0)
        return out

    def _workload_body(self, e: int) -> dict:
        from ceph_tpu_torch.sim.workload import (
            contention_np,
            contention_torch,
        )

        wl = self.workload
        use_device = self.state is not None
        pids = sorted(self.m.pools)
        reqs = wl.pool_requests(e, pids)
        per_pool: dict[int, dict] = {}
        client_total = None
        for pid in pids:
            pool = self.m.pools[pid]
            tol = self._pool_tolerance(pool)
            rows = self._prev_rows[pid][1]
            wq = reqs[pid] // wl.sample
            backlog = None
            if self.recovery is not None:
                self.recovery.ensure(pid, int(rows.shape[0]))
            kw = dict(n=pool.pg_num, size=pool.size, tol=tol,
                      DV=self._dv(), wq=wq)
            on_dev = use_device and not isinstance(rows, np.ndarray)
            if on_dev:
                try:
                    if self.recovery is not None:
                        backlog = self.recovery.device_backlog(pid)
                    client, scal = wl.step_pool_device(
                        e, pid, rows, backlog, **kw)
                except Exception as exc:
                    self._degrade(e, "workload", exc)
                    use_device = on_dev = False
            if not on_dev:
                if self.recovery is not None:
                    backlog = self.recovery.host_backlog(pid)
                client, scal = wl.step_pool_host(
                    e, pid, _host(rows), backlog, **kw)
                if client_total is not None:
                    client_total = _host(client_total)
            elif isinstance(client_total, np.ndarray):
                client = _host(client)
            wl.book(scal)
            per_pool[pid] = scal
            # a new sum each pool: the first client vector is not
            # written in place
            client_total = client if client_total is None \
                else client_total + client
        cap_bytes = self._epoch_cap_bytes()
        if isinstance(client_total, np.ndarray):
            rem, throttled, contended = contention_np(
                client_total, cap_bytes)
        else:
            rem, throttled, contended = contention_torch(
                client_total, cap_bytes)
        wl.book_contention(throttled, contended)
        self._cap_rem = rem
        return {"per_pool": per_pool, "throttled": throttled,
                "contended": contended}

    def _epoch_cap_bytes(self) -> int:
        """ONE capacity number: clients are charged against exactly the
        bytes the recovery drain then competes for."""
        if self.recovery is not None:
            return self.recovery.cap_epoch_bytes
        sc = self.scenario
        t_us = int(round(sc.interval_s * 1e6))
        return (int(sc.osd_mbps * 1e6) * t_us) // 1_000_000

    def _recovery_epoch(self, e: int, stats: dict) -> dict:
        """One epoch of the recovery queue (ceph_tpu_torch.recovery):
        enqueue from the per-PG moved lanes, slot-limited priority drain
        against the per-OSD capacity clients left over, byte
        conservation checked per pool.  A device loss (real, or the
        `recovery_step` fault) degrades the rest of the epoch to the
        bit-exact host mirror: the digest is unchanged."""
        t0 = time.perf_counter()
        with obs.span("sim.recovery", epoch=e):
            out = self._recovery_body(e, stats)
        _recovery_counters().observe("drain_seconds",
                                     time.perf_counter() - t0)
        return out

    def _recovery_body(self, e: int, stats: dict) -> dict:
        rq = self.recovery
        use_device = self.state is not None
        try:
            faults.check("recovery_step", qual=str(e))
        except Exception as exc:
            self._recovery_fallback(e, exc)
            use_device = False
        cap = self._cap_rem
        _, slots = self._fresh_cap(use_device)
        if cap is None:
            cap, _ = self._fresh_cap(use_device)
        per_pool: dict[int, dict] = {}
        for pid in sorted(self.m.pools):
            pool = self.m.pools[pid]
            tol = self._pool_tolerance(pool)
            rows = self._prev_rows[pid][1]
            rq.ensure(pid, int(rows.shape[0]))
            kw = dict(n=pool.pg_num, size=pool.size, tol=tol,
                      is_erasure=pool.is_erasure())
            if (stats[pid]["moved"] == 0
                    and rq.prev_total.get(pid, 0) == 0):
                # nothing queued, nothing enqueued: the drain is
                # identically zero — at-risk PGs (nothing queued to
                # fix them) accrue the whole epoch
                scal = dict.fromkeys(
                    ("enqueued", "drained", "backlog", "completed",
                     "queued", "streams"), 0)
                scal["risk_us"] = stats[pid]["at_risk"] * rq.t_us
            else:
                moved = self._moved.get(pid)
                # the capacity vectors follow the pool: host rows (a
                # degraded pool or epoch) drain on the host mirror
                dev_pool = use_device and not isinstance(rows, np.ndarray)
                if dev_pool:
                    try:
                        cap, slots, scal = rq.drain_device(
                            pid, moved, rows,
                            torch.as_tensor(cap, device=self.device),
                            torch.as_tensor(slots, device=self.device),
                            **kw)
                    except Exception as exc:
                        self._recovery_fallback(e, exc)
                        use_device = dev_pool = False
                if not dev_pool:
                    cap, slots, scal = rq.drain_host(
                        pid, None if moved is None else _host(moved),
                        _host(rows), _host(cap), _host(slots), **kw)
            if self.recovery_corrupt_hook is not None:
                scal = self.recovery_corrupt_hook(pid, scal) or scal
            if not rq.book(pid, scal):
                self._violate(e, [
                    f"pool {pid}: recovery byte conservation "
                    f"broken: prev+enqueued != drained+backlog "
                    f"({scal})"
                ])
            per_pool[pid] = scal
        total = rq.end_epoch()
        self._cap_rem = None
        return {"per_pool": per_pool, "backlog_total": total}

    def _recovery_fallback(self, e: int, exc) -> None:
        self._degrade(e, "recovery", exc)
        self.recovery.fallback_epochs += 1
        _recovery_counters().inc("fallbacks")

    # -- durability accounting (correlated model) --------------------------

    def _wounds(self, pid: int, n: int) -> np.ndarray:
        """The pool's per-PG simultaneously-dead-chunk counts, grown
        with zeros on splits (parent seeds keep their wounds, children
        start whole)."""
        w = self.wounded.get(pid)
        if w is None or w.shape[0] < n:
            grown = np.zeros(n, np.int64)
            if w is not None:
                grown[:w.shape[0]] = w
            self.wounded[pid] = w = grown
        return w

    def _heal_flags(self, pid: int, n: int) -> np.ndarray:
        """Per-PG 'repair observed' flags: a wound may only heal after
        its PG's repair was seen running (lanes moved or backlog held)."""
        h = self.healing.get(pid)
        if h is None or h.shape[0] < n:
            grown = np.zeros(n, bool)
            if h is not None:
                grown[:h.shape[0]] = h
            self.healing[pid] = h = grown
        return h

    def _wound_osd(self, osd: int) -> None:
        """Chunk-loss bookkeeping for a true death: every PG whose
        current up set carries the OSD has one more simultaneously-dead
        chunk.  The hit mask reduces where the rows are; only [n] flags
        come to the host."""
        for pid in sorted(self.m.pools):
            ent = self._prev_rows.get(pid)
            if ent is None:
                continue
            rows = ent[1]
            n = min(self.m.pools[pid].pg_num, rows.shape[0])
            hit = _host((rows[:n] == osd).any(1))
            if hit.any():
                self._wounds(pid, n)[:n][hit] += 1

    def _durability_epoch(self, e: int) -> dict:
        """Post-recovery durability pass (exact host ints on every
        backend: the |D digest segment hangs off these).  A wound heals
        once its PG's repair was observed (lanes moved, or backlog
        held) and the backlog has drained to zero.  A PG whose wounds
        exceed the pool's tolerance before its repair drains is LOST.
        Only wounded pools fetch their backlog and moved lanes."""
        rq = self.recovery
        per_pool: dict[int, dict] = {}
        exposed_total = 0
        for pid in sorted(self.m.pools):
            pool = self.m.pools[pid]
            n = pool.pg_num
            w = self._wounds(pid, n)
            wnz = w[:n] > 0
            if wnz.any() and rq is not None:
                heal = self._heal_flags(pid, n)
                undrained = rq.pg_undrained(pid, n)
                repairing = undrained.copy()
                moved = self._moved.get(pid)
                if moved is not None:
                    mv = _host(moved)
                    k = min(n, mv.shape[0])
                    repairing[:k] |= mv[:k] > 0
                heal[:n][wnz & repairing] = True
                done = wnz & heal[:n] & ~undrained
                w[:n][done] = 0
                heal[:n][done] = False
                wnz = w[:n] > 0
            tol = self._pool_tolerance(pool)
            lost = self.lost.setdefault(pid, [])
            lmask = np.zeros(n, bool)
            if lost:
                lmask[np.asarray([s for s in lost if s < n],
                                 np.int64)] = True
            newly = (w[:n] > tol) & ~lmask
            if newly.any():
                lost.extend(int(s) for s in np.nonzero(newly)[0])
                lost.sort()
                k = int(newly.sum())
                self.pg_lost_total += k
                _inc("pgs_lost", k)
            if rq is None:
                # flat model: recovery completes within the stretched
                # epoch by construction, so surviving wounds heal now
                w[:n] = 0
                wnz = w[:n] > 0
            exposed = int(wnz.sum())
            exposed_total += exposed
            per_pool[pid] = {
                "wounds": int(w[:n].sum()),
                "exposed": exposed,
                "lost": len(lost),
            }
        self.exposed_pg_epochs += exposed_total
        return {"per_pool": per_pool, "exposed": exposed_total}

    # -- the step ----------------------------------------------------------

    def _overlay_presence(self) -> tuple:
        m = self.m
        return tuple(sorted(
            (pid,
             any(pg.pool == pid for pg in m.pg_upmap),
             any(pg.pool == pid for pg in m.pg_upmap_items),
             any(pg.pool == pid for pg in m.pg_temp))
            for pid in m.pools
        ))

    def step(self, force_event: str | None = None) -> dict:
        """One epoch: `_step_begin` (the fault gate, the epoch's seeded
        rng, the event), the accounting, `_step_finish` (the data planes,
        invariants, the digest line and observation)."""
        ctx = self._step_begin(force_event)
        try:
            stats, skeys = self._account_epoch(ctx["e"])
        except BaseException:
            ctx["span"].__exit__(None, None, None)
            raise
        return self._step_finish(ctx, stats, skeys)

    def _step_begin(self, force_event: str | None = None) -> dict:
        """First half of one epoch, up to the mapping accounting: the
        fault gate, the epoch's seeded rng, the rebuild snapshot and the
        event.  Split out so the fleet engine (`ceph_tpu_torch.fleet`)
        can account many engines' pools in one stats call between begin
        and finish; `step()` composes the halves."""
        e = self.steps + 1
        faults.check("lifetime_step", qual=str(e))
        rng = np.random.default_rng([self.scenario.seed, e])
        ctx = {"e": e, "rng": rng, "t0": time.perf_counter(),
               "rb0": (self.state.full_rebuilds
                       if self.state is not None else 0)}
        self._structural_apply = False
        # the epoch's span closes in _step_finish (or where the epoch
        # raises), so the fleet's stacked accounting between the halves
        # sits inside it
        span = obs.span("sim.epoch", epoch=e)
        span.__enter__()
        ctx["span"] = span
        try:
            event = self._apply_event(e, rng, force_event)
        except BaseException:
            span.__exit__(None, None, None)
            raise
        if event.startswith("balance"):
            bal_key = (self._prev_skeys, self._overlay_presence())
            ctx["hint"] = bal_key != self._last_balance_key
            self._last_balance_key = bal_key
        else:
            ctx["hint"] = False
        ctx["event"] = event
        return ctx

    def _step_finish(self, ctx: dict, stats: dict,
                     skeys: frozenset) -> dict:
        """Second half of one epoch: data planes, integration,
        invariants, structural classification, the digest line and
        observation.  The JAX signature's `jit_delta` has no counterpart:
        the port compiles nothing per shape."""
        e, rng, event = ctx["e"], ctx["rng"], ctx["event"]
        t0 = ctx["t0"]
        try:
            wl = (self._workload_epoch(e)
                  if self.workload is not None else None)
            rec = (self._recovery_epoch(e, stats)
                   if self.recovery is not None else None)
            dur = (self._durability_epoch(e)
                   if self.scenario.correlated else None)
            epoch_s = self._integrate(stats, rec)
            self._invariants(e, rng, stats)
        finally:
            ctx["span"].__exit__(None, None, None)
        compiles = 0  # the port compiles nothing per shape
        rebuilds = (self.state.full_rebuilds - ctx["rb0"]
                    if self.state is not None else 0)
        structural = (ctx["hint"]
                      or self._structural_apply
                      or self._prev_skeys is None
                      or skeys != self._prev_skeys)
        self._prev_skeys = skeys
        self.total_compiles += compiles
        if structural:
            self.structural_epochs += 1
            _inc("structural_epochs")
        else:
            self.steady_epochs += 1
            self.steady_compiles += compiles
            self.steady_full_rebuilds += rebuilds
        line = (
            f"{e}|{event}|"
            + ";".join(
                "{}:{}".format(pid, ":".join(
                    str(stats[pid][k]) for k in ("n",) + STAT_KEYS))
                for pid in sorted(stats))
            + f"|{epoch_s:.6f}"
        )
        # new digest segments exist ONLY when the subsystem is enabled:
        # a flat-model, workload-off run chains the exact legacy lines
        if rec is not None:
            line += "|R" + ";".join(
                "{}:{}".format(pid, ":".join(
                    str(rec["per_pool"][pid][k])
                    for k in RECOVERY_DIGEST_KEYS))
                for pid in sorted(rec["per_pool"]))
        if wl is not None:
            line += "|W" + ";".join(
                "{}:{}".format(pid, ":".join(
                    str(wl["per_pool"][pid][k])
                    for k in WORKLOAD_DIGEST_KEYS))
                for pid in sorted(wl["per_pool"])
            ) + f"|C{wl['throttled']}:{wl['contended']}"
        if dur is not None:
            line += "|D" + ";".join(
                "{}:{}".format(pid, ":".join(
                    str(dur["per_pool"][pid][k])
                    for k in DURABILITY_DIGEST_KEYS))
                for pid in sorted(dur["per_pool"])
            ) + f"|L{self.pg_lost_total}"
        self.digest = hashlib.sha256(
            (self.digest + line).encode()).hexdigest()
        self.steps = e
        self._steps_this_proc += 1
        _inc("epochs")
        wall = time.perf_counter() - t0
        self._wall_this_proc += wall
        _L.observe("epoch_seconds", wall)
        # observation AFTER the digest update: health/timeline read only
        # the host ints accounting already fetched
        health_status = self._observe_epoch(e, stats, rec, wl, dur,
                                            structural)
        every = self.scenario.checkpoint_every
        if self.ck is not None and every and e % every == 0:
            self._checkpoint()
        return {
            "epoch": e,
            "event": event,
            "stats": {pid: dict(st) for pid, st in stats.items()},
            "sim_epoch_s": epoch_s,
            "structural": structural,
            "compiles": compiles,
            "health": health_status,
        }

    def _observe_epoch(self, e: int, stats: dict, rec: dict | None,
                       wl: dict | None, dur: dict | None,
                       structural: bool) -> str:
        """Pure-observer tail of step(): evaluate the health checks and
        record the "sim" timeline sample from numbers already on the
        host.  No device work, no digest input."""
        totals = {k: 0 for k in ("degraded", "unmapped", "at_risk",
                                 "moved")}
        for st in stats.values():
            for k in totals:
                totals[k] += st[k]
        backlog_gb = (rec["backlog_total"] / 1e9) if rec else 0.0
        status = health.OK
        if health.enabled():
            if self.pg_lost_total > 0:
                # raised directly, outside evaluate()'s auto-clearing:
                # data loss is irreversible, so DATA_LOSS never clears
                # on its own
                health.raise_check(
                    "DATA_LOSS", health.ERR,
                    f"{self.pg_lost_total} PG(s) suffered unrecoverable"
                    " chunk loss (dead chunks exceeded tolerance before"
                    " the backlog drained)",
                    count=self.pg_lost_total)
            exists = down = 0
            for o in range(self.m.max_osd):
                if self.m.exists(o):
                    exists += 1
                    if self.m.is_down(o):
                        down += 1
            status = health.evaluate(
                osds_down=down, osd_count=exists,
                degraded=totals["degraded"], unmapped=totals["unmapped"],
                at_risk=totals["at_risk"], backlog_gb=backlog_gb,
                device_degraded=len(self.fallback_events),
            )
            key = {health.OK: "ok", health.WARN: "warn",
                   health.ERR: "err"}[status]
            self._health_counts[key] += 1
        timeline.sample("sim", {
            "epoch": e,
            "degraded": totals["degraded"],
            "unmapped": totals["unmapped"],
            "at_risk": totals["at_risk"],
            "moved": totals["moved"],
            "backlog_gb": backlog_gb,
            "throttled": (wl or {}).get("throttled", 0),
            "structural": int(structural),
            "health": health.rank(status),
            "exposed": 0 if dur is None else dur["exposed"],
            "pg_lost": self.pg_lost_total,
        })
        return status

    def _integrate(self, stats: dict, rec: dict | None = None) -> float:
        sc = self.scenario
        moved_bytes = 0.0
        totals = {k: 0 for k in STAT_KEYS}
        total_pgs = 0
        for st in stats.values():
            for k in STAT_KEYS:
                totals[k] += st[k]
            total_pgs += st["n"]
            moved_bytes += st["moved"] * (sc.pg_gb / st["size"]) * 1e9
        if rec is None:
            # flat model (recovery=flat): one division, floored at
            # interval_s
            epoch_s = max(sc.interval_s,
                          moved_bytes / (sc.recovery_mbps * 1e6))
            at_risk_s = totals["at_risk"] * epoch_s
        else:
            # queue model: epochs are fixed control-plane intervals,
            # unfinished work carries as backlog, and the risk window
            # is the drain's per-PG completion-time integral
            epoch_s = sc.interval_s
            at_risk_s = sum(
                p["risk_us"] for p in rec["per_pool"].values()) / 1e6
        self.sim_seconds += epoch_s
        self._sim_this_proc += epoch_s
        rep = MovementReport(
            total_pgs=total_pgs,
            pgs_remapped=totals["remapped"],
            replicas_moved=totals["moved"],
            degraded_pgs=totals["degraded"],
            pgs_at_risk=totals["at_risk"],
            at_risk_pg_seconds=at_risk_s,
        )
        self.report.merge(rep)
        _L.observe("at_risk_pg_seconds", rep.at_risk_pg_seconds)
        if totals["degraded"]:
            # epochs that ended with degraded PGs (the JAX package's
            # meaning; no device degradation is counted here)
            self.degraded_epochs += 1
            _inc("degraded_pg_epochs")
        return epoch_s

    # -- driving -----------------------------------------------------------

    def run(self, stop_after: int | None = None,
            epochs: int | None = None) -> dict:
        total = self.scenario.epochs if epochs is None else epochs
        while self.steps < total:
            if stop_after is not None and self.steps >= stop_after:
                break
            self.step()
        self._checkpoint()
        return self.summary()

    def provenance(self) -> dict:
        """Which backend produced the accounting, and every descent to
        the host a device loss forced."""
        return {
            "backend": self.backend,
            "device_loss_fallbacks": len(self.fallback_events),
            "fallback_events": list(self.fallback_events),
        }

    def summary(self) -> dict:
        wall = self._wall_this_proc
        steps = self._steps_this_proc
        sim_years = self.sim_seconds / (86400.0 * 365.0)
        out = {
            "scenario": self.scenario.spec(),
            "epochs": self.steps,
            "map_epoch": self.m.epoch,
            "digest": self.digest,
            "sim_seconds": round(self.sim_seconds, 3),
            "sim_years": round(sim_years, 6),
            "events": dict(sorted(self.event_counts.items())),
            "invariant_violations": len(self.violations),
            "violations": self.violations[:20],
            "degraded_epochs": self.degraded_epochs,
            "report": vars(self.report),
            "trace_once": {
                "structural_epochs": self.structural_epochs,
                "steady_epochs": self.steady_epochs,
                "steady_compiles": self.steady_compiles,
                "steady_pipe_misses": self.steady_pipe_misses,
                "steady_full_rebuilds": self.steady_full_rebuilds,
                "total_compiles": self.total_compiles,
            },
            "state": None if self.state is None else {
                "delta_applies": self.state.delta_applies,
                "full_rebuilds": self.state.full_rebuilds,
            },
            "jit_compiles_per_epoch": round(
                self.total_compiles / self.steps, 4
            ) if self.steps else 0.0,
            "provenance": self.provenance(),
            "wall_s": round(wall, 3),
            "epochs_per_sec": round(steps / wall, 2) if wall else 0.0,
            # simulated years covered by THIS process's epochs per
            # wall-clock hour (a resumed run reports its own portion)
            "cluster_years_per_hour": round(
                (self._sim_this_proc / (86400.0 * 365.0))
                / (wall / 3600.0), 3
            ) if wall else 0.0,
            "recovery_model": self.scenario.recovery,
            "health": {
                **health.summary(),
                "epochs": dict(self._health_counts),
                "timeline_samples": timeline.next_index("sim"),
            },
            "recovery": (None if self.recovery is None
                         else self.recovery.summary()),
            "workload": (None if self.workload is None
                         else self.workload.summary(self.sim_seconds)),
        }
        if self.scenario.correlated:
            worst = sorted(self.flap_counts.items(),
                           key=lambda kv: (-kv[1], kv[0]))
            out["chaos"] = {
                "flapper_osds": list(self.flapper_osds),
                "flap_counts": {f"osd.{o}": c for o, c in worst[:8]},
                "repeat_flaps": max(self.flap_counts.values(),
                                    default=0),
                "false_flap_revives": self.false_flap_revives,
                "domain_outages": dict(sorted(
                    self.domain_outages.items(),
                    key=lambda kv: (-kv[1], kv[0]))),
                "cascades": self.cascades,
                "longest_cascade": self.longest_cascade,
                "hazard_windows": self.hazard_windows,
                "active_hazards": len(self.hazards),
            }
            out["durability"] = {
                "pg_lost": self.pg_lost_total,
                "lost": {str(pid): list(s)
                         for pid, s in sorted(self.lost.items()) if s},
                "exposed_pg_epochs": self.exposed_pg_epochs,
                "wounded_pgs": int(sum(
                    int((w > 0).sum())
                    for w in self.wounded.values())),
                "max_wounds": int(max(
                    (int(w.max()) for w in self.wounded.values()
                     if w.size), default=0)),
            }
        if self.workload is not None:
            # the pareto headline: simulated coverage rate AT a stated
            # client service level
            out["pareto"] = {
                "cluster_years_per_hour":
                    out["cluster_years_per_hour"],
                "served_qps": out["workload"]["served_qps"],
            }
        if self.resumed_from is not None:
            out["resumed_from"] = self.resumed_from
        return out
