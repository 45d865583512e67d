"""Multi-replica serving front: N `PlacementService` replicas behind a
consistent-hash router.

The port of `ceph_tpu/serve/front.py`; the replicas share one device.

The rateless-codes load-balancing paper (PAPERS.md) frames the problem:
with work fanned out over replicas, one straggler — a replica staging
an epoch, or one hit by an injected stall — dominates the client tail
unless the router can shift its share to the others.  The front does
three things about it:

- **rendezvous-hash routing** — every lane (pool, seed) ranks all
  replicas by a seeded hash and goes to its argmax.  Excluding a
  replica remaps ONLY the lanes that replica owned (the defining
  rendezvous property): the rest of the traffic keeps its placement
  and its warm caches;
- **staggered epoch fan-out** — `apply`/`adopt_map` walk the replicas
  ONE at a time, marking the staging replica excluded-from-routing
  while it stages, so never two replicas stage the same epoch at once
  and the remaining replicas keep answering on the previous epoch
  (replicas briefly diverge by one epoch, by design — each reply
  carries its epoch);
- **slowest-replica shedding** — a per-replica EWMA of per-lane reply
  latency; a replica whose EWMA breaches `SHED_FACTOR` times the
  fastest gets excluded for `SHED_PROBE_S`, then probed again.  An
  injected stall (`serve_dispatch.<replica name>`) is absorbed after
  one slow block instead of taxing every block's p99.

All replicas serve the same map; answers are bit-identical whichever
replica answers (the placement pipeline is deterministic), so routing
is a latency decision, never a correctness one.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np

from ceph_tpu_torch import obs
from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.osd.incremental import Incremental
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.serve.service import (
    STATUS_CODES,
    BulkReply,
    PlacementService,
    Reply,
    ServeConfig,
    _SERVICES,
    _services_lock,
)
from ceph_tpu_torch.utils import knobs
from ceph_tpu_torch.utils.perf_counters import counters_attr

_log = logging.getLogger("ceph_tpu_torch.serve")

# the front's keys of the JAX package's `serve` perf group
_L = obs.logger_for("serve")
_L.add_u64("front_blocks", "bulk blocks routed through a ServeFront")
_L.add_u64("front_shed_routes",
           "lanes remapped away from an excluded (staging or shed) "
           "replica by the rendezvous exclusion property — every other "
           "lane kept its placement")
_L.add_u64("front_replica_sheds",
           "slowest-replica shed transitions: a replica's per-lane "
           "latency EWMA breached SHED_FACTOR x the fastest and it "
           "left the routing set for a probe interval")
_L.add_u64("front_staggered_swaps",
           "epoch fan-outs completed by a front (replicas staged "
           "strictly one at a time, each excluded from routing while "
           "staging)")
_L.add_quantile("front_block_seconds",
                "client-visible latency of one bulk block through the "
                "front (route + replica sub-blocks + merge)")
__getattr__ = counters_attr("serve", __name__, (
    "front_blocks", "front_shed_routes", "front_replica_sheds",
    "front_staggered_swaps"))


def _inc(name: str, n: int = 1) -> None:
    _L.inc(name, int(n))


# a replica is shed when its per-lane latency EWMA exceeds SHED_FACTOR
# times the fastest replica's; it rejoins after SHED_PROBE_S (one slow
# probe block re-sheds it, so a stuck replica costs one block per probe
# interval, not every block)
SHED_FACTOR = 4.0
SHED_PROBE_S = 0.25
_EWMA_ALPHA = 0.3


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — the per-(lane, replica) rendezvous rank."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class ServeFront:
    """N placement-service replicas behind one rendezvous-hash front.

    The client surface mirrors the bulk protocol edge
    (`query_block`/`submit_many`/`lookup`); epoch swaps fan out
    staggered (`apply`/`adopt_map`).  Replica count comes from
    `CEPH_TPU_SERVE_REPLICAS` when not given; `device` is the replicas'
    (`PlacementService`'s)."""

    def __init__(self, m: OSDMap, replicas: int | None = None,
                 config: ServeConfig | None = None,
                 name: str = "front", device=None):
        if replicas is None:
            replicas = int(knobs.get("CEPH_TPU_SERVE_REPLICAS", "2"))
        if replicas < 1:
            raise ValueError("a front needs at least one replica")
        self.name = name
        self.config = config or ServeConfig.from_env()
        self.replicas = [
            PlacementService(m, config=self.config,
                             name=f"{name}.r{i}", device=device)
            for i in range(replicas)
        ]
        n = len(self.replicas)
        self._salts = _mix64(np.arange(1, n + 1, dtype=np.uint64)
                             * np.uint64(0xD6E8FEB86659FD93))
        self._apply_lock = threading.Lock()
        self._route_lock = threading.Lock()
        self._staging = [False] * n
        self._shed_until = [0.0] * n
        self._lat_ewma = [0.0] * n  # per-lane reply seconds
        with _services_lock:
            _SERVICES[name] = self

    # -- routing -----------------------------------------------------------

    def _rank(self, pool: int, seeds: np.ndarray) -> np.ndarray:
        """[n_lanes, n_replicas] rendezvous ranks."""
        base = (seeds.astype(np.uint64)
                ^ (np.uint64(pool & 0xFFFFFFFF) << np.uint64(32)))
        return _mix64(base[:, None] ^ self._salts[None, :])

    def _eligible(self, now: float) -> list[int]:
        with self._route_lock:
            el = [i for i in range(len(self.replicas))
                  if not self._staging[i]
                  and self._shed_until[i] <= now]
        # every replica excluded (all staging/shed at once) falls back
        # to full membership: routing degrades, never deadlocks
        return el or list(range(len(self.replicas)))

    def _owners(self, pool: int, seeds: np.ndarray,
                eligible: list[int]) -> np.ndarray:
        """Per-lane owning replica index.  Lanes whose full-membership
        argmax is excluded remap to their argmax over the eligible set
        (the rendezvous exclusion property: nobody else moves)."""
        rank = self._rank(pool, seeds)
        owners = np.argmax(rank, axis=1)
        if len(eligible) != len(self.replicas):
            moved = ~np.isin(owners, eligible)
            if moved.any():
                el = np.asarray(eligible)
                sub = rank[np.ix_(moved.nonzero()[0], el)]
                owners[moved] = el[np.argmax(sub, axis=1)]
                _inc("front_shed_routes", int(moved.sum()))
        return owners

    def _observe_replica(self, i: int, dt: float, lanes: int,
                         now: float) -> None:
        """EWMA update + shed decision for one replica's sub-block."""
        per_lane = dt / max(lanes, 1)
        with self._route_lock:
            e = self._lat_ewma[i]
            e = per_lane if e == 0.0 else (
                (1.0 - _EWMA_ALPHA) * e + _EWMA_ALPHA * per_lane)
            self._lat_ewma[i] = e
            peers = [v for j, v in enumerate(self._lat_ewma)
                     if j != i and v > 0.0]
            if peers and e > SHED_FACTOR * min(peers) \
                    and self._shed_until[i] <= now:
                self._shed_until[i] = now + SHED_PROBE_S
                _inc("front_replica_sheds")
                _log.info("front %s: replica %d shed (%.0fus/lane vs "
                          "best %.0fus)", self.name, i, e * 1e6,
                          min(peers) * 1e6)

    # -- client surface ----------------------------------------------------

    @property
    def epoch(self) -> int:
        return max(r.epoch for r in self.replicas)

    def query_block(self, pool: int, seeds,
                    deadline_s: float | None = None) -> BulkReply:
        """One bulk block fanned over the replicas by rendezvous hash;
        per-lane statuses merge back in input order."""
        seeds = np.ascontiguousarray(
            np.asarray(seeds, np.uint32).ravel())
        n = len(seeds)
        if n == 0:
            return BulkReply(np.zeros(0, np.uint8), epoch=self.epoch)
        t0 = time.perf_counter()
        eligible = self._eligible(t0)
        owners = self._owners(pool, seeds, eligible)
        statuses = np.zeros(n, np.uint8)
        up = upp = act = actp = None
        source = ""
        errors: list[str] = []
        epoch = 0
        with obs.span("serve.front", lookups=n, pool=pool,
                      replicas=len(eligible)):
            for i in eligible:
                mask = owners == i
                lanes = int(mask.sum())
                if not lanes:
                    continue
                t_r = time.perf_counter()
                r = self.replicas[i].query_block(
                    pool, seeds[mask], deadline_s)
                self._observe_replica(
                    i, time.perf_counter() - t_r, lanes, t0)
                statuses[mask] = r.statuses
                if r.up is not None:
                    if up is None:
                        w = r.up.shape[1]
                        up = np.full((n, w), ITEM_NONE, np.int32)
                        upp = np.full(n, -1, np.int32)
                        act = np.full((n, w), ITEM_NONE, np.int32)
                        actp = np.full(n, -1, np.int32)
                    up[mask] = r.up
                    upp[mask] = r.up_primary
                    act[mask] = r.acting
                    actp[mask] = r.acting_primary
                source = source or r.source
                if r.error:
                    errors.append(r.error)
                epoch = max(epoch, r.epoch)
        _inc("front_blocks")
        _L.observe("front_block_seconds", time.perf_counter() - t0)
        return BulkReply(statuses, epoch=epoch or self.epoch,
                         source=source, up=up, up_primary=upp,
                         acting=act, acting_primary=actp,
                         error="; ".join(errors)[:200])

    def submit_many(self, pools, seeds,
                    deadline_s: float | None = None) -> BulkReply:
        """Mixed-pool bulk submit through the front: group by pool,
        route each group, scatter back (same shape as the service's
        own submit_many, one routing decision per pool group)."""
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
        order = np.argsort(pools_a, kind="stable")
        cuts = np.flatnonzero(np.diff(pools_a[order])) + 1
        statuses = np.zeros(n, np.uint8)
        W = 0
        parts: list[tuple[np.ndarray, BulkReply]] = []
        for idx in np.split(order, cuts):
            r = self.query_block(int(pools_a[idx[0]]), seeds[idx],
                                 deadline_s)
            parts.append((idx, r))
            if r.up is not None:
                W = max(W, r.up.shape[1])
        up = np.full((n, W), ITEM_NONE, np.int32)
        upp = np.full(n, -1, np.int32)
        act = np.full((n, W), ITEM_NONE, np.int32)
        actp = np.full(n, -1, np.int32)
        epoch = 0
        for idx, r in parts:
            statuses[idx] = r.statuses
            if r.up is not None:
                w = r.up.shape[1]
                up[idx, :w] = r.up
                upp[idx] = r.up_primary
                act[idx, :w] = r.acting
                actp[idx] = r.acting_primary
            epoch = max(epoch, r.epoch)
        return BulkReply(statuses, epoch=epoch or self.epoch,
                         up=up, up_primary=upp, acting=act,
                         acting_primary=actp)

    def lookup(self, pool: int, seed: int,
               deadline_s: float | None = None) -> Reply:
        """Scalar path: one lane through the same routing."""
        now = time.perf_counter()
        eligible = self._eligible(now)
        owner = int(self._owners(
            pool, np.asarray([seed], np.uint32), eligible)[0])
        return self.replicas[owner].lookup(pool, seed, deadline_s)

    # -- epoch fan-out -----------------------------------------------------

    def _fan_out(self, stage_one) -> dict:
        """Staggered epoch fan-out: replicas stage strictly one at a
        time, the staging replica excluded from routing for the
        duration — the rest keep answering on the previous epoch, so
        a structural epoch costs the front NO reader stall and at most
        1/N of its capacity at any moment."""
        with self._apply_lock:
            results = []
            for i, rep in enumerate(self.replicas):
                with self._route_lock:
                    self._staging[i] = True
                try:
                    results.append(stage_one(rep))
                finally:
                    with self._route_lock:
                        self._staging[i] = False
            _inc("front_staggered_swaps")
            ok = all(r.get("ok") for r in results)
            return {"ok": ok, "epoch": self.epoch,
                    "replicas": results}

    def apply(self, inc: Incremental) -> dict:
        return self._fan_out(lambda rep: rep.apply(inc))

    def adopt_map(self, m: OSDMap, reason: str = "") -> dict:
        return self._fan_out(
            lambda rep: rep.adopt_map(m, reason=reason))

    # -- introspection / lifecycle ----------------------------------------

    def status(self) -> dict:
        d = _L.dump()
        fb = d["front_block_seconds"]
        with self._route_lock:
            shed = [i for i, t in enumerate(self._shed_until)
                    if t > time.perf_counter()]
            staging = [i for i, s in enumerate(self._staging) if s]
            ewma = [round(v * 1e6, 1) for v in self._lat_ewma]
        return {
            "replicas": len(self.replicas),
            "epochs": [r.epoch for r in self.replicas],
            "staging": staging,
            "shed": shed,
            "lat_ewma_us_per_lane": ewma,
            "front_blocks": d.get("front_blocks", 0),
            "front_shed_routes": d.get("front_shed_routes", 0),
            "front_replica_sheds": d.get("front_replica_sheds", 0),
            "front_staggered_swaps": d.get("front_staggered_swaps", 0),
            "front_block_p50_s": fb.get("p50"),
            "front_block_p99_s": fb.get("p99"),
        }

    def close(self) -> None:
        for r in self.replicas:
            r.close()
        with _services_lock:
            if _SERVICES.get(self.name) is self:
                del _SERVICES[self.name]

    def __enter__(self) -> "ServeFront":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
