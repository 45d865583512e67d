"""Chaos-client harness: lifetime-engine churn against a live service.

The port of `ceph_tpu/serve/chaos.py`, over the port's `LifetimeSim`
(backend "torch" on the service's device) and `WorkloadGen`.

The PR 10 lifetime engine (`sim/lifetime.py`) is a ready-made hostile
control plane: every epoch it evolves one cluster through a seeded
failure/churn/growth event as a real `Incremental` chain link.  This
harness points that churn at a live `PlacementService` — after every
sim epoch the evolved map swaps into the service — while seeded client
threads keep a query load running.  When the scenario runs the client
workload generator (`workload=1`, the default here), those threads
shape their traffic with the same Zipf/diurnal formulas from
`sim/workload.py` the simulator scores — hot pools, power-law PG keys,
a diurnal batch curve — and the default scenario is correlated
(`correlated=1`): cascading domain outages and repeat-offender
flappers drive the churn the clients ride through.  Measured, from
the client side:

    p50/p99 request latency UNDER control-plane churn, QPS, shed and
    expired counts, and the never-dropped proof (every submitted
    request got exactly one reply).

This is the contention the online-EC SSD-array study (PAPERS.md) calls
out: the interesting behavior only appears when control-plane work and
client traffic compete for the same resources.  Every adopted epoch
stages a fresh ClusterState on the service's staging stream, off the
reader path; the client tail is the witness.

Used by `python -m ceph_tpu_torch.cli.serve chaos`.
"""

from __future__ import annotations

import copy
import threading
import time

import numpy as np

from ceph_tpu_torch.obs import health, timeline
from ceph_tpu_torch.serve import service
from ceph_tpu_torch.serve.service import PlacementService, ServeConfig

DEFAULT_CHAOS_SCENARIO = (
    "hosts=4,osds_per_host=3,racks=2,pgs=64,ec=,size=3,"
    "balance_every=8,balance_max=2,spotcheck_every=0,"
    "checkpoint_every=0,seed=23,p_split=0,p_pool_create=0,"
    "p_expand=0,p_remove=0,workload=1,wl_sample=64,"
    "correlated=1,flappers=2"
)


class _Client:
    """One seeded query-load thread through the full client path,
    latencies collected for the percentile summary.

    With a workload generator attached (scenario `workload=1`), the
    thread shapes its traffic with the SAME formulas the simulator
    scores (sim/workload.py): pools picked by the `(rank+1)^-hot_pool`
    Zipf rank weights, PG seeds by the `floor(n·u^zipf_a)` hot-key
    power law, a seeded read/write mix, and a per-iteration batch that
    rides the diurnal curve — so the degraded reads and SLO burn the
    service reports happen under the simulator's own correlated
    scenario, not a uniform stand-in.  Without one, the legacy uniform
    pool/seed draw is unchanged."""

    def __init__(self, svc: PlacementService, seed: int,
                 batch: int, stop: threading.Event, wl=None):
        self.svc = svc
        self.rng = np.random.default_rng([seed, 0x5e4e])
        self.batch = batch
        self.stop = stop
        self.wl = wl
        self.ticks = 0
        self.latencies: list[float] = []
        self.submitted = 0
        self.replied = 0
        self.reads = 0
        self.by_status: dict[str, int] = {}
        self.thread = threading.Thread(
            target=self._run, name=f"serve-client-{seed}", daemon=True)

    def _draw(self, pools: list[int], n_for) -> tuple[int, np.ndarray]:
        """One iteration's (pool, seeds) draw in the active traffic
        model; `n_for(pid)` defers the pg_num read until the pool is
        chosen (the active map can swap between iterations)."""
        wl = self.wl
        if wl is None:
            pid = int(pools[int(self.rng.integers(len(pools)))])
            seeds = self.rng.integers(
                0, n_for(pid), size=self.batch).astype(np.uint32)
            return pid, seeds
        from ceph_tpu_torch.sim.workload import (
            pool_rank_weights,
            zipf_pg_seeds,
        )

        cum = np.cumsum(pool_rank_weights(len(pools), wl.hot_pool))
        j = int(np.searchsorted(cum, self.rng.random() * cum[-1],
                                side="right"))
        pid = int(pools[min(j, len(pools) - 1)])
        # diurnal modulation: the tick index walks the same triangle
        # curve the simulator's QPS follows, scaled to the batch size
        eff = self.batch
        if wl.base_qps > 0:
            eff = max(1, int(self.batch * wl.qps(self.ticks)
                             / wl.base_qps))
        seeds = zipf_pg_seeds(
            self.rng.random(eff), n_for(pid), wl.zipf_a
        ).astype(np.uint32)
        self.reads += int(
            (self.rng.random(eff) < wl.read_fraction).sum())
        return pid, seeds

    def _run(self) -> None:
        svc = self.svc
        while not self.stop.is_set():
            pools = sorted(svc._active.m.pools)
            pid, seeds = self._draw(
                pools, lambda p: svc._active.m.pools[p].pg_num)
            self.ticks += 1
            t0 = time.perf_counter()
            self.submitted += len(seeds)
            r = svc.lookup_batch(pid, seeds)
            self.replied += len(seeds)
            self.by_status[r.status] = \
                self.by_status.get(r.status, 0) + len(seeds)
            if r.ok:
                self.latencies.append(time.perf_counter() - t0)


def _pct(vals: list[float], q: float) -> float | None:
    if not vals:
        return None
    return round(float(np.percentile(np.asarray(vals), q)), 6)


def run_chaos(scenario: str | None = None, epochs: int | None = None,
              config: ServeConfig | None = None,
              checkpoint: str | None = None, resume: bool = False,
              clients: int = 2, client_batch: int = 256,
              settle_s: float = 0.02,
              background_every: int = 0, device=None) -> dict:
    """Run lifetime churn against a live service under client load.

    With `resume=True` the service restores its checkpointed epoch
    FIRST and the summary records `resumed_epoch` + `sample_digest`
    before any new churn — the restart-answers-identically witness the
    kill test compares against the host oracle of the checkpoint.

    `background_every=N` runs one CONTINUOUS-BALANCING round
    (`PlacementService.background_balance`: a whole-plan device-loop
    upmap optimization, applied as a value-only overlay epoch) after
    every Nth churn epoch — between swaps, never on the query path —
    and records the rounds' wall-time distribution beside the client
    tail, the live proof that background balancing leaves p99
    bounded.  `device` is the simulator's and the service's (None: the
    card; "cpu" runs the rule's plain version)."""
    from ceph_tpu_torch.sim.lifetime import LifetimeSim, Scenario

    sc = Scenario.parse(scenario if scenario is not None
                        else DEFAULT_CHAOS_SCENARIO)
    if epochs is not None:
        sc.epochs = epochs
    # workload-shaped clients (ROADMAP item 3): when the scenario runs
    # the client workload generator, the chaos threads draw from the
    # same Zipf/diurnal formulas — a parameter-only WorkloadGen (no
    # tallies booked) keeps one source of truth for the shape
    wl = None
    if sc.workload:
        from ceph_tpu_torch.sim.workload import WorkloadGen

        wl = WorkloadGen(
            seed=sc.seed, base_qps=sc.base_qps,
            read_fraction=sc.read_fraction, zipf_a=sc.zipf_a,
            hot_pool=sc.hot_pool, diurnal_amp=sc.diurnal_amp,
            diurnal_period=sc.diurnal_period, obj_kb=sc.obj_kb,
            sample=sc.wl_sample, interval_s=sc.interval_s)
    # the serve perf group is process-global; snapshot it so THIS run's
    # shed/expired/degraded tallies are deltas, not whatever an earlier
    # service in the same process (e.g. bench phase A/B) accumulated
    base = service.dump()
    out: dict = {"scenario": sc.spec()}
    sim = None
    if resume:
        # restart path: prove the resumed epoch answers before churning
        svc = PlacementService(config=config, checkpoint=checkpoint,
                               resume=True, device=device)
        out["resumed_epoch"] = svc.epoch
        out["sample_digest"] = svc.sample_digest()
    else:
        sim = LifetimeSim(sc, backend="torch", device=device)
        svc = PlacementService(copy.deepcopy(sim.m), config=config,
                               checkpoint=checkpoint, device=device)
    stop = threading.Event()
    pool_threads = [
        _Client(svc, i, client_batch, stop, wl=wl)
        for i in range(clients)
    ]
    t0 = time.perf_counter()
    swaps_ok = swaps_rejected = 0
    bg_rounds: list[dict] = []
    try:
        for c in pool_threads:
            c.thread.start()
        if sim is not None:
            for ep in range(sc.epochs):
                step = sim.step()
                r = svc.adopt_map(sim.m, reason=step["event"])
                if r["ok"]:
                    swaps_ok += 1
                else:
                    swaps_rejected += 1
                # let at least one client batch land per epoch so
                # every epoch's map actually served traffic
                time.sleep(settle_s)
                if background_every and \
                        (ep + 1) % background_every == 0:
                    # a live background balancing round between
                    # swaps, with the clients still querying
                    bg_rounds.append(svc.background_balance())
            # post-churn grace: the control plane goes quiet and
            # the clients get the final map to themselves, so the
            # summary always carries served-ok samples.  If churn
            # left the SLO story mid-episode (nothing scored yet, a
            # burn open, or breaches still in the fast window),
            # hold the quiet load — bounded — until the engine sees
            # a clean fast window: the raise->clear transition is
            # part of the recorded trajectory, not a truncated
            # cliffhanger
            def _episode_open() -> bool:
                if not health.enabled():
                    return False
                st = svc.slo.status()
                return (svc.slo.samples == 0 or st["burning"]
                        or st["fast_burn"] > 0)

            grace_end = time.perf_counter() + max(10 * settle_s, 0.3)
            slo_end = time.perf_counter() + 30.0
            while time.perf_counter() < grace_end or (
                    _episode_open()
                    and time.perf_counter() < slo_end):
                time.sleep(settle_s)
        else:
            # resumed service: a short verification load, no churn
            time.sleep(max(10 * settle_s, 0.2))
    finally:
        stop.set()
        for c in pool_threads:
            c.thread.join(timeout=30)
    wall = time.perf_counter() - t0
    lat = [v for c in pool_threads for v in c.latencies]
    submitted = sum(c.submitted for c in pool_threads)
    replied = sum(c.replied for c in pool_threads)
    by_status: dict[str, int] = {}
    for c in pool_threads:
        for k, v in c.by_status.items():
            by_status[k] = by_status.get(k, 0) + v
    st = svc.status()

    def delta(key: str) -> int:
        v = st.get(key)
        prev = base.get(key, 0)
        return (v - prev) if isinstance(v, int) \
            and isinstance(prev, int) else v

    out.update({
        "epochs": 0 if sim is None else sim.steps,
        "final_epoch": svc.epoch,
        "wall_s": round(wall, 3),
        "traffic": "workload" if wl is not None else "uniform",
        "client_read_mix": round(
            sum(c.reads for c in pool_threads) / submitted, 3
        ) if wl is not None and submitted else None,
        "submitted": submitted,
        "replied": replied,
        "dropped": submitted - replied,  # must be 0: never-dropped proof
        "answered_ok": by_status.get("ok", 0),
        "by_status": by_status,
        "qps": round(by_status.get("ok", 0) / wall, 1) if wall else 0.0,
        "p50_s": _pct(lat, 50),
        "p99_s": _pct(lat, 99),
        "swaps_ok": swaps_ok,
        "swaps_rejected": swaps_rejected,
        # process-wide quantile (phase A's µs-scale flips share it); the
        # u64 tallies are this run's deltas
        "swap_stall_p99_s": st.get("swap_stall_p99_s"),
        "structural_swap_stalls": delta("structural_swap_stalls"),
        # micro-batch fill as a distribution, not just the lifetime
        # average: under-filled windows (the dispatcher outrunning the
        # producers — the bulk path's failure mode) show at p50/p99
        "batch_fill_p50": st.get("batch_fill_p50"),
        "batch_fill_p99": st.get("batch_fill_p99"),
        "degraded_answered": delta("degraded_answered"),
        "queries_shed": delta("queries_shed"),
        "queries_expired": delta("queries_expired"),
        "provenance": svc.provenance(),
        # the recorded-trajectory story: the burn engine's verdict plus
        # the serve-series extract the timeline kept through the churn
        "slo": svc.slo.status(),
        "health": health.summary(),
        "timeline_samples": timeline.next_index("serve"),
    })
    if bg_rounds:
        # the live background-balancing story: every round ran between
        # swaps with the clients querying; the client p50/p99 above IS
        # the bounded-tail witness (adopt_map resets the overlay each
        # churn epoch, so rounds keep finding work)
        out["background"] = {
            "rounds": len(bg_rounds),
            "applied": sum(1 for b in bg_rounds if b["ok"]),
            "changes": sum(b["num_changed"] for b in bg_rounds),
            "round_p50_ms": _pct(
                [b["round_s"] * 1e3 for b in bg_rounds], 50),
            "round_p99_ms": _pct(
                [b["round_s"] * 1e3 for b in bg_rounds], 99),
        }
    if sim is not None:
        out["sim_digest"] = sim.digest
        out["sim_violations"] = len(sim.violations)
        out["sample_digest"] = svc.sample_digest()
        if sim.workload is not None:
            # the simulator's client-visible story, surfaced beside the
            # service's own tallies (serve status carries the same
            # counters — one narrative, two reporters)
            wl = sim.workload.summary(sim.sim_seconds)
            out["degraded_reads_served"] = wl["degraded_reads"]
            out["at_risk_hits"] = wl["at_risk_hits"]
            out["backlog_hits"] = wl["backlog_hits"]
        if sim.recovery is not None:
            out["recovery_backlog_gb"] = \
                sim.recovery.summary()["backlog_gb"]
    svc.close()
    return out
