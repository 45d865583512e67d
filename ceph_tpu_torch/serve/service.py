"""The placement service: micro-batcher, double-buffered epoch swaps,
admission control, crash-restart.

The port of `ceph_tpu/serve/service.py`.  Lookups run through
`PoolMapper.map_batch` over a `ClusterState`: on the card the rule kernel
(`crush/csrc/crush_rule.cu`), on the CPU (`device="cpu"`) its plain
version.

Threading model (all bounded, all join-able):

- client threads call `lookup`/`lookup_batch`/`lookup_object`: admission
  check under the queue lock (full queue -> immediate EBUSY reply), then
  block on the request's event with a watchdog timeout: a reply that
  misses its deadline is abandoned by the waiter (late results are
  discarded, never delivered);
- the BULK protocol edge (`query_block`/`submit_many`) answers thousands
  of lookups per call ON the caller's thread, one `map_batch` per
  sub-block of at most `max(bulk_max, block)` lanes (the deadline is
  checked between sub-blocks), with per-lane statuses: every lane gets
  exactly one.  The scalar `submit()` path is a thin wrapper over the
  queued micro-batcher;
- ONE dispatcher thread drains the queue: collects requests for at most
  `window_s` (or until `fill` queries are pending), groups them by pool
  and maps each pool's seeds as one `map_batch`;
- epoch swaps run on the caller's thread: stage a complete new buffer
  off the reader path, then flip the active reference.  A structural
  staging (`apply` structural epochs, `adopt_map`) builds a fresh
  ClusterState and every pool's mapper on a CUDA stream of its own, so
  the readers' kernels on the default stream never queue behind the
  uploads; the staging stream is synchronised before the flip, so every
  staged tensor is complete when a reader first sees it.  VALUE-ONLY
  epochs (reweights, osd state, overlay values: `osd.state.
  classify_incremental`) stage by FORKING the active buffer's
  ClusterState (the O(delta) apply: host crush/pools shared, the four
  per-OSD vectors copied on the device, then scattered;
  `swap_delta_applies`).  Structural epochs stage from scratch
  (`swap_full_restages`).  The flip is the only reader-visible window
  and is timed into the `swap_stall_seconds` quantile; in-flight
  batches keep draining on the buffer they captured, and nothing a
  captured buffer holds is written after the flip (a fork copies the
  vectors before its scatter; tables are replaced, never written).

Device loss: a loss inside the dispatch (a torch transport error
`runtime.faults.looks_like_device_loss` accepts, or the `serve_dispatch`
fault point's `lost`) is recorded in `fallback_events`/`provenance()`,
and the first device answer after it records the recovery
(`device_recoveries`).  On a card the lost batch is answered EFAULT and
the next batch goes to the device again: nothing is answered by the
host.  On a service placed on the host (`device="cpu"`) it degrades as
the JAX service does: the bit-exact host mapper answers that batch and
the next `degraded_batches` batches (`degraded_answered` counts those
lanes).  Any other dispatch error (a kernel wrapper's own RuntimeError
included) answers its lanes EFAULT and degrades nothing.  Queries are
answered, never dropped: every submitted request ends in exactly one
reply (ok / EBUSY / ETIMEDOUT / ESHUTDOWN / EFAULT).

Crash-restart: every accepted epoch flushes `{epoch, map blob}`
atomically through `runtime.Checkpoint` (the JAX package's layout, so
each package resumes the other's file); constructing the service with
`resume=True` restores the map and serves the same epoch.

Differences by design from the JAX service: nothing is compiled, so
there is no warm dispatch, no overlay-structure prewarm (no `prewarm`
knob, no `prewarmed_structures` count), no staging thread (the JAX one
also ran the prewarm compiles) and no cycle padding of lanes to a fixed
shape; on a card a device loss answers EFAULT where the JAX service
answers through the host oracle (ROADMAP C.3); a failed
stage is never served "without ClusterState": the first stage raises,
a later one is a rejected swap.  The service books
the JAX package's `serve` perf group (`dump()`; `COUNTERS` reads its
counts) and spans (`serve.batch`, `serve.bulk`, `serve.swap`,
`serve.background_balance`, the swap and device instants); the admin
socket's `serve status` is `status_dump()`.

Mesh: the serving buffer's ClusterState splits its launches over
`mesh` (a `parallel.sharded.Mesh`; None resolves CEPH_TPU_MESH_DEVICES,
as the JAX service does), and `status()["mesh"]` reports it with
`last_mesh_provenance()`; answers are the same on any split.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ceph_tpu_torch import obs
from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.obs import health, quantiles, timeline
from ceph_tpu_torch.osd.incremental import Incremental, apply_incremental
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import PgId
from ceph_tpu_torch.parallel.sharded import mesh_for
from ceph_tpu_torch.runtime import Checkpoint, faults
from ceph_tpu_torch.serve.slo import SloEngine
from ceph_tpu_torch.utils import knobs
from ceph_tpu_torch.utils.perf_counters import counters_attr

_log = logging.getLogger("ceph_tpu_torch.serve")

# the JAX package's `serve` perf group (the front's keys are declared in
# front.py); `prewarmed_structures` is absent (nothing to pre-trace)
_L = obs.logger_for("serve")
_L.add_u64("queries", "queries answered ok (device or degraded host path)")
_L.add_u64("queries_shed",
           "queries refused at admission with an EBUSY reply (bounded "
           "queue full — shed, not queued into collapse)")
_L.add_u64("queries_expired",
           "queries answered ETIMEDOUT (deadline budget spent before "
           "the reply; late results are discarded, never delivered)")
_L.add_u64("degraded_answered",
           "queries answered by the host mapper after a device loss")
_L.add_u64("batches", "micro-batches dispatched to the mapper")
_L.add_u64("epoch_swaps", "epoch swaps applied (staged + flipped)")
_L.add_u64("swap_rejected",
           "epoch swaps refused (fault/apply error) with the old epoch "
           "left serving")
_L.add_u64("device_recoveries",
           "dispatches answered on the device after a recorded device "
           "loss")
_L.add_u64("swap_delta_applies",
           "value-only epoch swaps staged by ClusterState fork: no "
           "full-map copy, no table re-upload, vectors scattered on "
           "the device in O(delta)")
_L.add_u64("swap_full_restages",
           "structural epoch swaps staged from scratch (deepcopy + "
           "fresh ClusterState + warm launches)")
_L.add_u64("serve_checkpoints", "epoch+map checkpoints flushed")
_L.add_avg("batch_fill", "queries per dispatched micro-batch")
_L.add_quantile("batch_fill_hist",
                "queries per dispatched micro-batch as a distribution "
                "(p50/p99 in the dump)",
                bounds=[1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                        2048, 4096, 8192, 16384, 32768, 65536])
_L.add_u64("bulk_blocks",
           "bulk protocol blocks answered on the caller's thread "
           "(query_block/submit_many)")
_L.add_u64("bulk_lookups",
           "lookups submitted through the bulk protocol edge (every "
           "lane, whatever its per-lane status)")
_L.add_u64("structural_swap_stalls",
           "structural epoch flips whose reader-visible stall exceeded "
           "STRUCTURAL_STALL_BOUND_S (must stay 0)")
_L.add_u64("warm_stages",
           "structural stagings run off every thread that answers "
           "queries")
_L.add_quantile("request_seconds",
                "submit-to-reply latency per client request (p50/p99 "
                "in the dump)")
_L.add_quantile("swap_stall_seconds",
                "reader-visible stall of one epoch swap: the atomic "
                "buffer flip only")
_L.add_time_avg("swap_prepare_seconds",
                "off-path staging cost of one epoch swap (clone + "
                "apply + mapper construction + warm launches)")
_L.add_u64("background_rounds",
           "background balancing rounds (one device-loop plan each, "
           "computed off the query path)")
_L.add_u64("background_changes",
           "upmap changes applied by background balancing rounds "
           "(value-only overlay epochs)")
_L.add_u64("background_stale_plans",
           "background plans discarded unapplied because another "
           "epoch flipped in while the plan was being computed")
_L.add_time_avg("background_round_seconds",
                "wall time of one background balancing round (plan + "
                "value-only apply)")
_L.add_quantile("background_round_hist",
                "background balancing round wall-time distribution")
__getattr__ = counters_attr("serve", __name__, (
    "queries", "queries_shed", "queries_expired", "degraded_answered",
    "batches", "epoch_swaps", "swap_rejected", "device_recoveries",
    "swap_delta_applies", "swap_full_restages", "serve_checkpoints",
    "bulk_blocks", "bulk_lookups", "structural_swap_stalls",
    "warm_stages", "background_rounds", "background_changes",
    "background_stale_plans"))


def _inc(name: str, n: int = 1) -> None:
    _L.inc(name, int(n))


def dump() -> dict:
    """The `serve` group in the JAX perf-dump layout (the front's keys
    included: one group, as in the JAX package)."""
    return _L.dump()


def reset_counters() -> None:
    """Zero the group (counters are process-wide, as the JAX group is)."""
    _L.reset_values()


# reader-visible stall budget for a STRUCTURAL epoch flip: the flip is
# one reference assignment, so anything past this bound means staging
# leaked work onto the flip window (counted by `structural_swap_stalls`)
STRUCTURAL_STALL_BOUND_S = 0.05


@dataclass
class ServeConfig:
    """Service tuning; `from_env` reads the CEPH_TPU_SERVE_* variables."""

    window_s: float = 0.001   # micro-batch collection window (<=1ms)
    block: int = 1024         # scalar block width (lane capacity unit)
    fill: int = 4096          # stop collecting once this many queries wait
    max_queue: int = 256      # admission bound (pending requests)
    deadline_s: float = 0.25  # default per-request deadline (<=0 disables)
    degraded_batches: int = 16  # host batches before re-trying the device
    #                             (a service placed on the host only)
    checkpoint_every: int = 1   # flush every Nth accepted epoch
    bulk_max: int = 8192      # bulk sub-block width (deadline granularity)

    @classmethod
    def from_env(cls) -> "ServeConfig":
        return cls(
            window_s=float(
                knobs.get("CEPH_TPU_SERVE_WINDOW_US", "1000")) / 1e6,
            block=int(knobs.get("CEPH_TPU_SERVE_BLOCK", "1024")),
            fill=int(knobs.get("CEPH_TPU_SERVE_FILL", "4096")),
            max_queue=int(knobs.get("CEPH_TPU_SERVE_QUEUE", "256")),
            deadline_s=float(
                knobs.get("CEPH_TPU_SERVE_DEADLINE_MS", "250")) / 1e3,
            degraded_batches=int(knobs.get(
                "CEPH_TPU_SERVE_DEGRADED_BATCHES", "16")),
            bulk_max=int(knobs.get("CEPH_TPU_SERVE_BULK_MAX", "8192")),
        )


# reply-status registry: the single vocabulary of answer codes.  Every
# `Reply(...)` and every `STATUS_CODES[...]` lane code names one of these.
REPLY_STATUSES: dict[str, str] = {
    "ok": "answered with placement rows",
    "EBUSY": "shed at admission: queue (or bulk lane capacity) full",
    "ETIMEDOUT": "deadline budget spent before the reply; late results "
                 "are discarded, never delivered",
    "ESHUTDOWN": "service stopped before the reply",
    "EFAULT": "invalid request (unknown pool, empty batch) or a "
              "dispatcher error (a device loss on a card included) "
              "answered loudly",
}

# dense per-lane codes for the bulk path's status vector ("ok" == 0)
STATUS_NAMES: tuple[str, ...] = tuple(REPLY_STATUSES)
STATUS_CODES: dict[str, int] = {s: i for i, s in enumerate(STATUS_NAMES)}


@dataclass
class Reply:
    """One request's answer.  `status` is always set; rows are present
    only on "ok".  EBUSY/ETIMEDOUT/ESHUTDOWN/EFAULT are *answers*: the
    never-dropped contract is that every submit ends in exactly one."""

    status: str                      # ok|EBUSY|ETIMEDOUT|ESHUTDOWN|EFAULT
    epoch: int = 0
    source: str = ""                 # "device" | "host" (degraded)
    up: np.ndarray | None = None          # [n, W] i32, NONE-padded
    up_primary: np.ndarray | None = None  # [n] i32
    acting: np.ndarray | None = None      # [n, W] i32
    acting_primary: np.ndarray | None = None  # [n] i32
    error: str = ""

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclass
class BulkReply:
    """One bulk block's answer: per-lane status codes + full-width rows.

    `statuses[i]` indexes STATUS_NAMES ("ok" == 0); non-ok lanes carry
    NONE-padded rows.  Every submitted lane ends with exactly one
    status."""

    statuses: np.ndarray                  # [n] uint8 -> STATUS_NAMES
    epoch: int = 0
    source: str = ""                 # "device" | "host" | "mixed"
    up: np.ndarray | None = None          # [n, W] i32, NONE-padded
    up_primary: np.ndarray | None = None  # [n] i32
    acting: np.ndarray | None = None      # [n, W] i32
    acting_primary: np.ndarray | None = None  # [n] i32
    error: str = ""

    @property
    def ok(self) -> bool:
        return bool((self.statuses == STATUS_CODES["ok"]).all())

    def counts(self) -> dict[str, int]:
        """Per-status lane tallies, zero entries elided."""
        out: dict[str, int] = {}
        for name, code in STATUS_CODES.items():
            c = int((self.statuses == code).sum())
            if c:
                out[name] = c
        return out


class _Request:
    """One queued lookup batch: (pool, seeds) + deadline + reply slot.
    Exactly ONE reply wins, under the request's own lock: the first
    `answer()` delivers, and `abandon()` (the waiter gave up) refuses
    every later delivery, so a request is never counted both answered
    and expired."""

    __slots__ = ("pool", "seeds", "deadline", "t0", "event", "reply",
                 "abandoned", "_lock")

    def __init__(self, pool: int, seeds: np.ndarray,
                 deadline: float | None):
        self.pool = pool
        self.seeds = seeds
        self.deadline = deadline
        self.t0 = time.perf_counter()
        self.event = threading.Event()
        self.reply: Reply | None = None
        self.abandoned = False
        self._lock = threading.Lock()

    def answer(self, reply: Reply) -> bool:
        """Deliver; False when the waiter already abandoned the request
        or a reply was already won."""
        with self._lock:
            if self.abandoned or self.reply is not None:
                return False
            self.reply = reply
        self.event.set()
        return True

    def abandon(self) -> bool:
        """Waiter gives up; False when a reply won the race first."""
        with self._lock:
            if self.reply is not None:
                return False
            self.abandoned = True
            return True


def _empty_rows(n: int, width: int):
    return (np.full((n, width), ITEM_NONE, np.int32),
            np.full(n, -1, np.int32),
            np.full((n, width), ITEM_NONE, np.int32),
            np.full(n, -1, np.int32))


class _Buffer:
    """One immutable serving generation: a ClusterState and the
    PoolMappers that share its tables and vectors.

    `warm()` builds every pool's mapper (its overlay uploads); it
    dispatches nothing.  A staging does it, so the first reader after
    the flip finds them built; a mapper asked for later is built under
    the buffer's lock."""

    def __init__(self, state):
        self.state = state
        self.m: OSDMap = state.m
        self.epoch = self.m.epoch
        self._mappers: dict[int, object] = {}
        self._lock = threading.Lock()

    def mapper(self, pool_id: int):
        from ceph_tpu_torch.osd.pipeline import PoolMapper

        pm = self._mappers.get(pool_id)
        if pm is None:
            with self._lock:
                pm = self._mappers.get(pool_id)
                if pm is None:
                    pm = PoolMapper(self.m, pool_id, state=self.state)
                    self._mappers[pool_id] = pm
        return pm

    def warm(self) -> None:
        for pid in sorted(self.m.pools):
            self.mapper(pid)

    def host_rows(self, pool_id: int, seeds: np.ndarray):
        """The host oracle's rows for a seed batch, at the device
        pipeline's padded width (`meshcheck.placement_digest` and the
        checks hold the device replies to it; no reply comes from it)."""
        pm = self._mappers.get(pool_id)
        W = pm.spec.out_width if pm is not None \
            else max(self.m.pools[pool_id].size, 1)
        up, upp, act, actp = _empty_rows(len(seeds), W)
        for i, s in enumerate(seeds):
            u, u_p, a, a_p = self.m.pg_to_up_acting_osds(
                PgId(pool_id, int(s)))
            up[i, : min(len(u), W)] = u[:W]
            act[i, : min(len(a), W)] = a[:W]
            upp[i], actp[i] = u_p, a_p
        return up, upp, act, actp


# live services of THIS process, for `status_dump` (name -> service); a
# closed service removes itself
_SERVICES: dict[str, "PlacementService"] = {}
_services_lock = threading.Lock()


def status_dump() -> dict:
    """Every live service's status (the JAX `serve status` payload)."""
    with _services_lock:
        svcs = dict(_SERVICES)
    return {"services": {name: s.status() for name, s in svcs.items()}}


class PlacementService:
    """See the module docstring.  `m` may be None with `resume=True` and
    a checkpoint that holds a serialized epoch.  `device` (None: the
    card, `device.resolve_device`; "cpu" runs the rule's plain version)
    is where the ClusterState lives; `mesh` (None: the
    CEPH_TPU_MESH_DEVICES mesh) is what its launches split over."""

    def __init__(self, m: OSDMap | None = None,
                 config: ServeConfig | None = None,
                 checkpoint: str | None = None, resume: bool = False,
                 name: str = "serve", device=None, mesh=None):
        self.config = config or ServeConfig.from_env()
        self.name = name
        self.device, self.mesh = mesh_for(device, mesh)
        self.ck = Checkpoint(checkpoint, resume=resume) \
            if checkpoint else None
        self.resumed_from: int | None = None
        if resume and self.ck is not None:
            state = self.ck.data.get("serve")
            if state:
                from ceph_tpu_torch.osd.codec import decode_osdmap

                m = decode_osdmap(base64.b64decode(state["map_b64"]))
                self.resumed_from = int(state["epoch"])
                if state.get("timeline"):
                    # resumed services continue the same sample indices
                    timeline.restore("serve", state["timeline"])
                _log.info("serve resumed at epoch %d", self.resumed_from)
        if m is None:
            raise ValueError(
                "PlacementService needs a map (or resume=True with a "
                "checkpoint that holds one)")
        self._q: deque[_Request] = deque()
        self._q_lock = threading.Lock()
        self._q_cv = threading.Condition(self._q_lock)
        self._apply_lock = threading.Lock()
        self._events_lock = threading.Lock()
        self._stop = False
        self._paused = False
        self._batch_seq = 0
        self._bulk_inflight = 0  # lanes inside query_block calls
        self.fallback_events: list[str] = []
        self._degraded_left = 0  # host batches left in a degraded spell
        self._swaps_since_ck = 0
        self.slo = SloEngine()
        self._slo_prev: dict = {}  # counter snapshot at last window sample
        self._slo_t = 0.0
        # structural stagings run on a CUDA stream of their own
        self._stage_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)
        self._active = self._stage(m)
        self._checkpoint()
        self._thread = threading.Thread(
            target=self._loop, name=f"ceph-tpu-{name}", daemon=True)
        self._thread.start()
        with _services_lock:
            _SERVICES[name] = self

    # -- client surface ----------------------------------------------------

    @property
    def epoch(self) -> int:
        return self._active.epoch

    def lookup_batch(self, pool: int, seeds, deadline_s: float | None
                     = None) -> Reply:
        """Answer a batch of placement seeds of one pool.  Blocks until
        the reply or the deadline; an expired wait abandons the request
        (ETIMEDOUT reply, late dispatcher results discarded)."""
        seeds = np.asarray(seeds, np.uint32)
        if not len(seeds):
            return Reply("EFAULT", epoch=self.epoch,
                         error="empty seed batch")
        deadline_s = self.config.deadline_s if deadline_s is None \
            else deadline_s
        # deadline_s <= 0 disables deadline bookkeeping entirely (an
        # unbounded reply wait; shutdown still answers)
        timed = deadline_s > 0
        req = _Request(pool, seeds,
                       time.perf_counter() + deadline_s if timed
                       else None)
        with self._q_cv:
            if self._stop:
                return Reply("ESHUTDOWN", epoch=self.epoch,
                             error="service stopped")
            if len(self._q) >= self.config.max_queue:
                # shed at admission: an explicit busy answer beats an
                # unbounded queue whose tail latency collapses for all
                _inc("queries_shed", len(seeds))
                return Reply("EBUSY", epoch=self.epoch,
                             error="admission queue full")
            self._q.append(req)
            self._q_cv.notify()
        # watchdogged wait: a margin past the deadline covers the
        # in-flight dispatch that may still answer
        if not req.event.wait(deadline_s + 0.25 if timed else None) \
                and req.abandon():
            _inc("queries_expired", len(seeds))
            return Reply("ETIMEDOUT", epoch=self.epoch,
                         error=f"no reply within {deadline_s:.3f}s")
        return req.reply

    def lookup(self, pool: int, seed: int,
               deadline_s: float | None = None) -> Reply:
        return self.lookup_batch(pool, [seed], deadline_s)

    def lookup_object(self, pool: int, key: str, ns: str = "",
                      deadline_s: float | None = None) -> Reply:
        """object name (+namespace) -> PG -> OSDs (the osdmaptool
        --test-map-object sequence: rjenkins str hash, stable_mod to a
        PG seed, then the normal placement path)."""
        p = self._active.m.pools.get(pool)
        if p is None:
            return Reply("EFAULT", epoch=self.epoch,
                         error=f"no pool {pool}")
        seed = p.raw_pg_to_pg(PgId(pool, p.hash_key(key, ns))).seed
        return self.lookup(pool, seed, deadline_s)

    def submit(self, pool: int, seed: int,
               deadline_s: float | None = None) -> Reply:
        """Scalar protocol edge: a thin wrapper over the queued
        micro-batcher (the bulk edge is where the throughput lives)."""
        return self.lookup_batch(pool, [seed], deadline_s)

    # -- the bulk protocol edge --------------------------------------------

    def _bulk_admit(self, n: int) -> int:
        """Grant up to `n` bulk lanes against the lane-capacity bound
        (`max_queue * block` lanes in flight across concurrent bulk
        calls).  Lanes beyond the grant shed EBUSY per lane; the caller
        releases the grant."""
        cap = self.config.max_queue * self.config.block
        with self._q_lock:
            granted = max(0, min(n, cap - self._bulk_inflight))
            self._bulk_inflight += granted
        return granted

    def _bulk_release(self, granted: int) -> None:
        with self._q_lock:
            self._bulk_inflight -= granted

    def _map_rows(self, buf: _Buffer, pool: int, seeds: np.ndarray,
                  qual: str):
        """One pool's seeds through the mapper: (rows, "device" | "host").
        A device loss is recorded in `fallback_events`, and the first
        device answer after it records the recovery.  On a card the loss
        raises, as any other error does (the caller answers the lanes
        EFAULT), and the next batch goes to the device again.  On a
        service placed on the host the loss degrades as the JAX service
        does (`faults.degrade_or_raise`): the host oracle answers the
        batch and the next `degraded_batches` batches.  `qual`
        qualifies the `serve_dispatch` fault point."""
        with self._events_lock:
            spell = self._degraded_left > 0
            if spell:
                self._degraded_left -= 1
        if spell:
            _inc("degraded_answered", len(seeds))
            return buf.host_rows(pool, seeds), "host"
        try:
            faults.check("serve_dispatch", qual=qual)
            rows = buf.mapper(pool).map_batch(seeds)
        except Exception as e:
            if faults.looks_like_device_loss(e):
                host = self.device.type == "cpu"
                msg = (f"epoch {buf.epoch} pool {pool}: "
                       f"{type(e).__name__}: {e}"[:200]
                       + (" -> host mapper" if host else " -> EFAULT"))
                with self._events_lock:
                    if host:
                        self._degraded_left = self.config.degraded_batches
                    self.fallback_events.append(msg)
                _log.warning("device lost mid-serve; %s", msg)
                obs.instant("serve.degraded", pool=pool)
            faults.degrade_or_raise(e, self.device, book=False)
            _inc("degraded_answered", len(seeds))
            return buf.host_rows(pool, seeds), "host"
        with self._events_lock:
            recovered = (bool(self.fallback_events)
                         and not self._recovered_logged())
            if recovered:
                self.fallback_events.append(
                    "recovered: device dispatch healthy again")
        if recovered:
            _inc("device_recoveries")
            obs.instant("serve.recovered", pool=pool)
        return rows, "device"

    def query_block(self, pool: int, seeds,
                    deadline_s: float | None = None) -> BulkReply:
        """Bulk protocol edge: answer thousands of lookups of ONE pool
        in one call, on the caller's thread, one `map_batch` per
        sub-block of at most `max(bulk_max, block)` lanes.  Per-lane
        statuses keep the never-dropped contract: over-capacity lanes
        shed EBUSY, lanes past the deadline answer ETIMEDOUT, every lane
        gets exactly one status.  The `serve_dispatch` fault qualifier
        is the service name, so a front can aim at one replica."""
        seeds = np.ascontiguousarray(
            np.asarray(seeds, np.uint32).ravel())
        n = len(seeds)
        if n == 0:
            return BulkReply(np.zeros(0, np.uint8), epoch=self.epoch)
        t0 = time.perf_counter()
        if self._stop:
            return BulkReply(
                np.full(n, STATUS_CODES["ESHUTDOWN"], np.uint8),
                epoch=self.epoch, error="service stopped")
        buf = self._active  # captured once: swaps flip under us safely
        if pool not in buf.m.pools:
            return BulkReply(
                np.full(n, STATUS_CODES["EFAULT"], np.uint8),
                epoch=buf.epoch, error=f"no pool {pool}")
        deadline_s = self.config.deadline_s if deadline_s is None \
            else deadline_s
        deadline = t0 + deadline_s if deadline_s > 0 else None
        granted = self._bulk_admit(n)
        statuses = np.zeros(n, np.uint8)
        error = ""
        if granted < n:
            statuses[granted:] = STATUS_CODES["EBUSY"]
            _inc("queries_shed", n - granted)
            error = "bulk lane capacity full"
        up, upp, act, actp = _empty_rows(n, buf.mapper(pool).spec.out_width)
        bmax = max(self.config.bulk_max, self.config.block)
        done = 0
        sources: set[str] = set()
        try:
            with obs.span("serve.bulk", lookups=n, pool=pool):
                while done < granted:
                    if deadline is not None and time.perf_counter() > deadline:
                        statuses[done:granted] = STATUS_CODES["ETIMEDOUT"]
                        _inc("queries_expired", granted - done)
                        error = error or f"deadline spent after {done} lanes"
                        break
                    take = min(bmax, granted - done)
                    rows, src = self._map_rows(
                        buf, pool, seeds[done:done + take], self.name)
                    sources.add(src)
                    for dst, part in zip((up, upp, act, actp), rows):
                        dst[done:done + take] = part
                    done += take
        except Exception as e:
            # a dispatcher error must not eat lanes: the rest of the
            # grant answers EFAULT loudly, the shed/done lanes keep
            # their statuses
            statuses[done:granted] = STATUS_CODES["EFAULT"]
            error = f"{type(e).__name__}: {e}"[:200]
            _log.error("bulk dispatch error: %s", error)
        finally:
            self._bulk_release(granted)
        if done:
            _inc("queries", done)
        _inc("bulk_blocks")
        _inc("bulk_lookups", n)
        _L.observe("request_seconds", time.perf_counter() - t0)
        return BulkReply(statuses, epoch=buf.epoch,
                         source=_merged_source(sources), up=up,
                         up_primary=upp, acting=act, acting_primary=actp,
                         error=error)

    def submit_many(self, pools, seeds,
                    deadline_s: float | None = None) -> BulkReply:
        """Mixed-pool bulk submit: ONE stable argsort groups the lanes
        by pool, each group goes through `query_block`, and the replies
        scatter back to input order.  `pools` may be a scalar (pure
        single-pool fast path) or a per-lane array."""
        seeds = np.asarray(seeds, np.uint32).ravel()
        pools_a = np.asarray(pools, np.int64).ravel()
        if pools_a.size == 1:
            return self.query_block(int(pools_a[0]), seeds, deadline_s)
        if pools_a.shape != seeds.shape:
            return BulkReply(
                np.full(len(seeds), STATUS_CODES["EFAULT"], np.uint8),
                epoch=self.epoch, error="pools/seeds length mismatch")
        n = len(seeds)
        if n == 0:
            return BulkReply(np.zeros(0, np.uint8), epoch=self.epoch)
        deadline_s = self.config.deadline_s if deadline_s is None \
            else deadline_s
        t_end = time.perf_counter() + deadline_s if deadline_s > 0 \
            else None
        order = np.argsort(pools_a, kind="stable")
        cuts = np.flatnonzero(np.diff(pools_a[order])) + 1
        replies: list[tuple[np.ndarray, BulkReply]] = []
        for idx in np.split(order, cuts):
            left = (t_end - time.perf_counter()) if t_end is not None \
                else 0.0
            if t_end is not None and left <= 0:
                r = BulkReply(
                    np.full(len(idx), STATUS_CODES["ETIMEDOUT"],
                            np.uint8),
                    epoch=self.epoch, error="deadline spent")
            else:
                # the remaining absolute budget is shared across the
                # pool groups (0 = bookkeeping disabled end to end)
                r = self.query_block(int(pools_a[idx[0]]), seeds[idx],
                                     left)
            replies.append((idx, r))
        return _merge(n, replies, self.epoch)

    # -- epoch swaps -------------------------------------------------------

    def apply(self, inc: Incremental) -> dict:
        """Apply one `osd.incremental` epoch: stage off the reader path,
        flip atomically.  A failure (including the `epoch_swap` fault
        point) leaves the old epoch serving and reports it.  Value-only
        epochs fork the active ClusterState; structural epochs stage a
        fresh one on the staging stream."""
        from ceph_tpu_torch.osd.state import classify_incremental

        with self._apply_lock:
            old = self._active
            try:
                faults.check("epoch_swap", qual=str(inc.epoch))
                with obs.span("serve.swap", epoch=inc.epoch), \
                        _L.time("swap_prepare_seconds"):
                    structural = (classify_incremental(inc, old.m)[0]
                                  != "delta")
                    if not structural:
                        buf = self._stage_value(old, inc)
                        _inc("swap_delta_applies")
                    else:
                        m2 = apply_incremental(copy.deepcopy(old.m), inc)
                        buf = self._stage(m2)
                        _inc("warm_stages")
                        _inc("swap_full_restages")
            except Exception as e:
                return self._rejected(old, inc.epoch, e)
            return self._flip(buf, structural=structural)

    def adopt_map(self, m: OSDMap, reason: str = "") -> dict:
        """Swap to a complete map (the chaos harness hands the lifetime
        engine's evolved map over wholesale): ONE deepcopy, as the
        caller keeps mutating its map, then a full stage on the staging
        stream; same flip, same fault point."""
        with self._apply_lock:
            old = self._active
            try:
                faults.check("epoch_swap", qual=str(m.epoch))
                with obs.span("serve.swap", epoch=m.epoch), \
                        _L.time("swap_prepare_seconds"):
                    m2 = copy.deepcopy(m)
                    buf = self._stage(m2)
                    _inc("warm_stages")
            except Exception as e:
                return self._rejected(old, m.epoch, e, reason)
            return self._flip(buf, structural=True)

    def _rejected(self, old: _Buffer, epoch: int, e: Exception,
                  reason: str = "") -> dict:
        _inc("swap_rejected")
        _log.warning("epoch swap to %d rejected (%s: %s); epoch %d keeps "
                     "serving %s", epoch, type(e).__name__, e, old.epoch,
                     reason)
        return {"ok": False, "epoch": old.epoch,
                "error": f"{type(e).__name__}: {e}"[:200]}

    def _stage(self, m: OSDMap) -> _Buffer:
        """Full staging: a fresh ClusterState (vectors and tables
        uploaded once) and every pool's mapper, on the staging stream,
        which is synchronised before the buffer is returned.  The
        initial buffer, adopt_map and structural epochs come through
        here; an error raises (the caller rejects the swap)."""
        from ceph_tpu_torch.osd.state import ClusterState

        stream = self._stage_stream
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            buf = _Buffer(ClusterState(m, device=self.device,
                                       mesh=self.mesh))
            buf.warm()
        if stream is not None:
            stream.synchronize()
        return buf

    def _stage_value(self, old: _Buffer, inc: Incremental) -> _Buffer:
        """Value-only staging: fork the active ClusterState (the
        O(delta) apply; the old state's vectors are copied, never
        written) and build every pool's mapper over the fork (no table
        upload: the fork shares the old state's tables)."""
        buf = _Buffer(old.state.fork(inc))
        buf.warm()
        return buf

    def _flip(self, buf: _Buffer, structural: bool = False) -> dict:
        # the only reader-visible window of a swap: one reference
        # assignment.  Readers that already captured the old buffer
        # drain on it.
        t0 = time.perf_counter()
        self._active = buf
        stall = time.perf_counter() - t0
        _L.observe("swap_stall_seconds", stall)
        if structural and stall > STRUCTURAL_STALL_BOUND_S:
            _inc("structural_swap_stalls")
        _inc("epoch_swaps")
        obs.instant("serve.swap_applied", epoch=buf.epoch)
        self._swaps_since_ck += 1
        every = self.config.checkpoint_every
        if every and self._swaps_since_ck >= every:
            self._checkpoint()
        return {"ok": True, "epoch": buf.epoch,
                "swap_stall_s": round(stall, 6)}

    def background_balance(self, max_deviation: int = 1,
                           max_iter: int = 16,
                           candidate_batch: int = 16) -> dict:
        """One continuous-balancing round: a whole-plan device_loop
        upmap optimization against the active epoch's map, computed
        without the apply lock, applied as one value-only overlay epoch.
        A plan that raced a concurrent epoch swap is discarded, never
        applied stale."""
        from ceph_tpu_torch.balancer.upmap import calc_pg_upmaps
        from ceph_tpu_torch.osd.state import value_copy_map

        t0 = time.perf_counter()
        buf = self._active  # snapshot; planning never blocks appliers
        applied: dict = {"ok": True, "epoch": buf.epoch}
        with obs.span("serve.background_balance", epoch=buf.epoch):
            m2 = value_copy_map(buf.m)
            res = calc_pg_upmaps(
                m2, max_deviation=max_deviation, max_iter=max_iter,
                backend="device_loop", candidate_batch=candidate_batch,
                rows_source=buf.state.rows_source_for(m2),
                device=self.device)
            if res.num_changed:
                if self._active is buf:
                    inc = Incremental(epoch=buf.epoch + 1)
                    inc.new_pg_upmap_items = {
                        pg: list(v)
                        for pg, v in res.new_pg_upmap_items.items()}
                    inc.old_pg_upmap_items = set(res.old_pg_upmap_items)
                    applied = self.apply(inc)
                else:
                    _inc("background_stale_plans")
                    applied = {"ok": False, "epoch": self._active.epoch,
                               "error": "stale plan (epoch moved during "
                                        "planning)"}
        _inc("background_rounds")
        if applied.get("ok"):
            _inc("background_changes", res.num_changed)
        dt = time.perf_counter() - t0
        _L.observe("background_round_seconds", dt)
        _L.observe("background_round_hist", dt)
        return {"ok": bool(applied.get("ok", False)),
                "epoch": int(applied.get("epoch", buf.epoch)),
                "num_changed": res.num_changed,
                "stddev": res.stddev,
                "max_deviation": res.max_deviation,
                "round_s": round(dt, 6)}

    def _checkpoint(self) -> None:
        if self.ck is None:
            return
        from ceph_tpu_torch.osd.codec import encode_osdmap

        self.ck.progress("serve", {
            "epoch": self._active.epoch,
            "map_b64": base64.b64encode(
                encode_osdmap(self._active.m)).decode(),
            "timeline": timeline.state("serve"),
        })
        self._swaps_since_ck = 0
        _inc("serve_checkpoints")

    # -- the dispatcher ----------------------------------------------------

    def pause(self) -> None:
        """Hold the dispatcher (deterministic overload tests: with the
        drain stopped, the max_queue+1'th request MUST shed)."""
        self._paused = True

    def unpause(self) -> None:
        with self._q_cv:
            self._paused = False
            self._q_cv.notify()

    def _collect(self) -> list[_Request]:
        """Block for work, then gather up to `window_s` / `fill`; the
        window clock is read once per wait cycle, not per request."""
        cfg = self.config
        with self._q_cv:
            while not self._stop and (not self._q or self._paused):
                self._q_cv.wait(timeout=0.05)
            if self._stop:
                return []
            batch = [self._q.popleft()]
            n = len(batch[0].seeds)
            t_end = None  # window starts at the first dry wait
            while n < cfg.fill:
                if self._q:
                    req = self._q.popleft()
                    batch.append(req)
                    n += len(req.seeds)
                    continue
                now = time.perf_counter()
                if t_end is None:
                    t_end = now + cfg.window_s
                left = t_end - now
                if left <= 0:
                    break
                self._q_cv.wait(timeout=left)
                if not self._q:
                    break
        return batch

    def _loop(self) -> None:
        while not self._stop:
            batch = self._collect()
            if not batch:
                continue
            try:
                self._dispatch(batch)
            except Exception as e:  # a bug must not kill the drain:
                # answer loudly, keep serving
                _log.error("serve dispatch error: %s: %s",
                           type(e).__name__, e)
                err = Reply("EFAULT", epoch=self.epoch,
                            error=f"{type(e).__name__}: {e}"[:200])
                for req in batch:
                    req.answer(err)
        # shutdown drain: pending requests still get an answer
        with self._q_cv:
            pending = list(self._q)
            self._q.clear()
        bye = Reply("ESHUTDOWN", epoch=self.epoch,
                    error="service stopped")
        for req in pending:
            req.answer(bye)

    def _recovered_logged(self) -> bool:
        return bool(self.fallback_events) and \
            self.fallback_events[-1].startswith("recovered")

    def _dispatch(self, batch: list[_Request]) -> None:
        buf = self._active  # captured once: swaps flip under us safely
        self._batch_seq += 1
        now = time.perf_counter()
        live: dict[int, list[_Request]] = {}
        n_live = 0
        for req in batch:
            if req.abandoned:
                continue
            if req.deadline is not None and now > req.deadline:
                if req.answer(Reply(
                        "ETIMEDOUT", epoch=buf.epoch,
                        error="deadline budget spent in the queue")):
                    _inc("queries_expired", len(req.seeds))
                continue
            if req.pool not in buf.m.pools:
                req.answer(Reply("EFAULT", epoch=buf.epoch,
                                 error=f"no pool {req.pool}"))
                continue
            live.setdefault(req.pool, []).append(req)
            n_live += len(req.seeds)
        if not live:
            return
        _inc("batches")
        _L.observe("batch_fill", n_live)
        _L.observe("batch_fill_hist", n_live)
        with obs.span("serve.batch", queries=n_live, pools=len(live)):
            for pool, reqs in live.items():
                seeds = np.concatenate([r.seeds for r in reqs])
                # the fault qualifier is the batch sequence number, so
                # `exit`/`lost` can be aimed mid-serve deterministically
                (up, upp, act, actp), source = self._map_rows(
                    buf, pool, seeds, str(self._batch_seq))
                off = 0
                for r in reqs:
                    n = len(r.seeds)
                    delivered = r.answer(Reply(
                        "ok", epoch=buf.epoch, source=source,
                        up=up[off:off + n], up_primary=upp[off:off + n],
                        acting=act[off:off + n],
                        acting_primary=actp[off:off + n],
                    ))
                    if delivered:
                        _inc("queries", n)
                        _L.observe("request_seconds",
                                   time.perf_counter() - r.t0)
                    off += n
        self._observe_window()

    def _observe_window(self) -> None:
        """Pure-observer tail of a dispatch window: score an SLO sample
        and record a "serve" timeline point from counter deltas already
        on the host.  The windowed p99 comes from the delta of the
        cumulative request-latency histogram between samples.  Throttled
        to one sample per 50 ms of dispatch activity."""
        if not (health.enabled() or timeline.enabled()):
            return
        now = time.perf_counter()
        if now - self._slo_t < 0.05:
            return
        self._slo_t = now
        d = dump()
        prev = self._slo_prev

        def delta(k: str) -> int:
            return int(d.get(k, 0)) - int(prev.get(k, 0))

        req = d["request_seconds"]
        buckets = req["buckets"]
        p99 = None
        pb = prev.get("_req_buckets")
        window = ([a - b for a, b in zip(buckets, pb)]
                  if pb is not None and len(pb) == len(buckets)
                  else list(buckets))
        if sum(window) > 0:
            p99 = quantiles.summarize(req["bounds"], window)["p99"]
        ok = delta("queries")
        errors = delta("queries_expired")
        shed = delta("queries_shed")
        total = ok + errors + shed
        self._slo_prev = {
            k: d.get(k, 0)
            for k in ("queries", "queries_expired", "queries_shed",
                      "degraded_answered")
        }
        self._slo_prev["_req_buckets"] = list(buckets)
        if total <= 0:
            return  # nothing answered since the last sample
        sample = {"fast_burn": self.slo._burn(self.slo.FAST)}
        if health.enabled():
            sample = self.slo.observe(
                p99_s=p99, queries=total, errors=errors, shed=shed)
        timeline.sample("serve", {
            "epoch": self.epoch,
            "queries": total,
            "expired": errors,
            "shed": shed,
            "degraded": delta("degraded_answered"),
            "p99_ms": (p99 or 0.0) * 1e3,
            "burning": int(self.slo.burning),
            "fast_burn": sample["fast_burn"],
        })

    # -- introspection / lifecycle ----------------------------------------

    def sample_digest(self, per_pool: int = 64) -> str:
        """SHA-256 over the replies to a deterministic query sample of
        every pool: two services serving the same epoch produce the same
        digest (the JAX service's too)."""
        import hashlib

        h = hashlib.sha256(str(self.epoch).encode())
        for pid in sorted(self._active.m.pools):
            n = self._active.m.pools[pid].pg_num
            rng = np.random.default_rng([pid, self.epoch])
            seeds = np.unique(rng.integers(0, n, size=per_pool))
            r = self.lookup_batch(pid, seeds, deadline_s=30.0)
            if not r.ok:
                h.update(f"{pid}:{r.status}".encode())
                continue
            h.update(np.ascontiguousarray(r.acting).tobytes())
            h.update(np.ascontiguousarray(r.acting_primary).tobytes())
        return h.hexdigest()

    def provenance(self) -> dict:
        with self._events_lock:
            events = list(self.fallback_events)
        return {
            "backend": "host-degraded" if self._degraded_left else
                       "device",
            "device_loss_fallbacks": sum(
                1 for e in events if not e.startswith("recovered")),
            "fallback_events": events[-8:],
        }

    def status(self) -> dict:
        # counter fields are the process-wide `serve` group; epoch,
        # queue and provenance are this service's own
        d = dump()
        stall = d["swap_stall_seconds"]
        req = d["request_seconds"]
        fill = d["batch_fill_hist"]
        wl = obs.group_view("workload")
        from ceph_tpu_torch.parallel.sharded import last_mesh_provenance

        mesh = self._active.state.mesh
        out = {
            "epoch": self.epoch,
            "pools": sorted(self._active.m.pools),
            "queue_depth": len(self._q),
            "paused": self._paused,
            "provenance": self.provenance(),
            "queries": d["queries"],
            "queries_shed": d["queries_shed"],
            "queries_expired": d["queries_expired"],
            "degraded_answered": d["degraded_answered"],
            "degraded_batches_left": self._degraded_left,
            "batches": d["batches"],
            "epoch_swaps": d["epoch_swaps"],
            "swap_rejected": d["swap_rejected"],
            "swap_delta_applies": d["swap_delta_applies"],
            "swap_full_restages": d["swap_full_restages"],
            "swap_stall_p99_s": stall["p99"],
            "structural_swap_stalls": d["structural_swap_stalls"],
            "bulk_blocks": d["bulk_blocks"],
            "bulk_lookups": d["bulk_lookups"],
            "request_p50_s": req["p50"],
            "request_p99_s": req["p99"],
            "batch_fill_p50": fill["p50"],
            "batch_fill_p99": fill["p99"],
            # the serving buffer's mesh (requested vs actual)
            "mesh": {
                "devices": mesh.size if mesh is not None else 1,
                "provenance": last_mesh_provenance(),
            },
            "health": health.status(),
            "slo": self.slo.status(),
            # the client-visible story the lifetime workload model tells
            # (sim/workload.py, when a chaos harness runs the simulator
            # in this process)
            "workload": {
                "degraded_reads_served": wl.get("degraded_reads", 0),
                "at_risk_hits": wl.get("at_risk_hits", 0),
            },
            "config": {
                "window_s": self.config.window_s,
                "block": self.config.block,
                "fill": self.config.fill,
                "max_queue": self.config.max_queue,
                "deadline_s": self.config.deadline_s,
                "bulk_max": self.config.bulk_max,
            },
        }
        if self.resumed_from is not None:
            out["resumed_from"] = self.resumed_from
        return out

    def close(self) -> None:
        """Stop accepting, answer everything pending, final checkpoint."""
        with self._q_cv:
            self._stop = True
            self._q_cv.notify_all()
        self._thread.join(timeout=10)
        self._checkpoint()
        with _services_lock:
            if _SERVICES.get(self.name) is self:
                del _SERVICES[self.name]

    def __enter__(self) -> "PlacementService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _merged_source(sources: set) -> str:
    """A bulk reply's source: the one its parts share, "mixed" when the
    device and the host oracle both answered, "" when nothing was
    mapped."""
    return sources.pop() if len(sources) == 1 else (
        "mixed" if sources else "")


def _merge(n: int, replies: list, epoch: int) -> BulkReply:
    """Scatter per-group bulk replies ((lane indices, BulkReply)) back to
    input order, rows at the widest group's width."""
    W = max((r.up.shape[1] for _, r in replies if r.up is not None),
            default=0)
    statuses = np.zeros(n, np.uint8)
    up, upp, act, actp = _empty_rows(n, W)
    errors: list[str] = []
    for idx, r in replies:
        statuses[idx] = r.statuses
        if r.up is not None:
            w = r.up.shape[1]
            up[idx, :w] = r.up
            upp[idx] = r.up_primary
            act[idx, :w] = r.acting
            actp[idx] = r.acting_primary
        if r.error:
            errors.append(r.error)
        epoch = max(epoch, r.epoch)
    return BulkReply(statuses, epoch=epoch, source=_merged_source(
                         {r.source for _, r in replies if r.source}),
                     up=up, up_primary=upp, acting=act,
                     acting_primary=actp, error="; ".join(errors)[:200])
