"""Seeded client workload generator for the lifetime simulator.

The port of `ceph_tpu/sim/workload.py`.  Client traffic whose
object→PG→OSD path rides the placement rows the accounting pass already
produced (no second mapping):

- **QPS curve.**  Epoch `e` serves `base_qps · diurnal(e)` requests per
  simulated second, where `diurnal` is a triangle day curve of amplitude
  `diurnal_amp` and period `diurnal_period` epochs (exact float
  arithmetic).
- **Skew.**  Requests split across pools by a Zipf-like rank weight
  (`(rank+1)^-hot_pool`, hottest pool first) and across PGs inside a
  pool by a power-law hot-key draw (`pg = floor(n · u^zipf_a)`), both
  from `numpy.random.default_rng([seed, epoch, pid, 0x77])` on the host:
  per-epoch streams, so the trajectory is resume-exact.
- **Mapping.**  A fixed-size sample (`wl_sample` draws, each standing for
  `requests // sample` real requests) gathers the pool's rows on their
  device: reads hit the primary (first live lane), writes every live
  replica lane; the per-OSD client byte histogram and the degraded-read /
  at-risk-hit / backlog-hit tallies reduce there, all int64.
- **Contention.**  Per-OSD client bytes are charged against the same
  `osd_mbps · interval_s` epoch capacity the recovery queue drains from:
  clients first, recovery the remainder.

Two executors of each formula: torch ops on the rows' device
(`workload_pool_torch`, `contention_torch`) and the JAX package's numpy
mirror (`workload_pool_np`, `contention_np`, copied verbatim) for the
"ref" backend.

It books the JAX package's `workload` perf group, plus
`device_traffic` (torch-op traffic passes run); `COUNTERS` reads its
counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch import obs
from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.recovery.queue import primary_slots
from ceph_tpu_torch.utils.perf_counters import counters_attr

WL_KEYS = ("requests", "reads", "writes", "degraded_reads",
           "at_risk_hits", "backlog_hits", "unserved")

_L = obs.logger_for("workload")
_L.add_u64("requests", "modeled client requests (reads + writes)")
_L.add_u64("reads", "read requests (primary-served)")
_L.add_u64("writes", "write requests (all live replica lanes)")
_L.add_u64("degraded_reads",
           "reads served degraded: up set below pool size with >=1 "
           "live replica")
_L.add_u64("at_risk_hits",
           "requests that landed on at-risk PGs (below tolerance)")
_L.add_u64("backlog_hits",
           "requests that landed on PGs carrying recovery backlog")
_L.add_u64("unserved",
           "requests whose PG had no live replica at all")
_L.add_u64("throttled_bytes",
           "client bytes beyond the per-OSD epoch capacity")
_L.add_u64("contended_osd_epochs",
           "OSD-epochs whose full bandwidth capacity was consumed by "
           "client traffic (recovery starved)")
_L.add_avg("qps", "modeled client QPS (one observation per epoch)")
_L.add_quantile("step_seconds",
                "wall time of one epoch's workload pass (all pools: "
                "draws + launches + scalar fetch, or the numpy mirror)")
_L.add_u64("device_traffic", "workload_pool_torch calls")
__getattr__ = counters_attr("workload", __name__, WL_KEYS + (
    "throttled_bytes", "contended_osd_epochs", "device_traffic"))


def zipf_pg_seeds(u: np.ndarray, n: int, zipf_a: float) -> np.ndarray:
    """The hot-key power-law PG draw: `floor(n · u^a)` clamped to
    [0, n)."""
    return np.minimum((n * np.power(u, zipf_a)).astype(np.int64), n - 1)


def pool_rank_weights(k: int, hot_pool: float) -> list[float]:
    """Zipf-like rank weights across `k` pools (`(rank+1)^-hot_pool`,
    hottest first), a plain Python list summed left to right."""
    return [(i + 1) ** -hot_pool for i in range(k)]


def workload_pool_np(rows, backlog, seeds, read, *, wq: int,
                     obj_bytes: int, DV: int, size: int, tol: int):
    """The authoritative per-pool traffic formula, numpy executor
    (exact int64).  Returns (client_bytes[DV], scalars dict)."""
    rows = np.asarray(rows)
    seeds = np.asarray(seeds, np.int64)
    read = np.asarray(read, bool)
    backlog = (np.zeros(rows.shape[0], np.int64) if backlog is None
               else np.asarray(backlog, np.int64))
    r = rows[seeds]
    valid = (r != ITEM_NONE) & (r >= 0)
    occ = valid.sum(axis=1)
    degraded = occ < size
    at_risk = occ < size - tol
    unserved = occ == 0
    degraded_read = read & degraded & (occ > 0)
    backlog_hit = backlog[seeds] > 0
    first = np.argmax(valid, axis=1)
    prim = r[np.arange(r.shape[0]), first].astype(np.int64)
    prim = np.where(valid.any(axis=1) & (prim >= 0) & (prim < DV),
                    prim, np.int64(DV))
    hist = np.zeros(DV + 1, np.int64)
    np.add.at(hist, np.where(read, prim, np.int64(DV)), 1)
    wl = valid & (r >= 0) & (r < DV) & ~read[:, None]
    np.add.at(hist, np.where(wl, r, DV).reshape(-1).astype(np.int64),
              wl.reshape(-1).astype(np.int64))
    # read lanes that fell in the DV drop bucket (no primary) were
    # counted there; slice it off
    client = hist[:DV] * np.int64(obj_bytes) * np.int64(wq)
    S = int(seeds.shape[0])
    scalars = {
        "requests": S * wq,
        "reads": int(read.sum()) * wq,
        "writes": int((~read).sum()) * wq,
        "degraded_reads": int(degraded_read.sum()) * wq,
        "at_risk_hits": int(at_risk.sum()) * wq,
        "backlog_hits": int(backlog_hit.sum()) * wq,
        "unserved": int(unserved.sum()) * wq,
    }
    return client, scalars


def workload_pool_torch(rows, backlog, seeds, read, *, wq: int,
                        obj_bytes: int, DV: int, size: int, tol: int):
    """`workload_pool_np` as torch ops on the rows' device (int64 end to
    end).  `seeds` int64 [S] and `read` bool [S] on that device, `backlog`
    int64 [N] or None.  Returns (client_bytes int64 [DV], scalars int64
    [7] in WL_KEYS order), both on the device."""
    _L.inc("device_traffic")
    dev = rows.device
    r = rows[seeds]
    valid = (r != ITEM_NONE) & (r >= 0)
    occ = valid.sum(1)
    degraded = occ < size
    at_risk = occ < size - tol
    unserved = occ == 0
    degraded_read = read & degraded & (occ > 0)
    if backlog is None:
        backlog_hit = torch.zeros_like(read)
    else:
        backlog_hit = backlog[seeds] > 0
    prim = primary_slots(r, DV)
    hist = torch.zeros(DV + 1, dtype=torch.int64, device=dev)
    hist.index_add_(0, torch.where(read, prim, DV),
                    torch.ones_like(prim))
    wl = valid & (r < DV) & ~read[:, None]
    hist.index_add_(0, torch.where(wl, r.long(), DV).reshape(-1),
                    wl.reshape(-1).long())
    client = hist[:DV] * obj_bytes * wq
    S = seeds.shape[0]
    scalars = torch.stack([
        torch.full((), S, dtype=torch.int64, device=dev),
        read.sum(), (~read).sum(), degraded_read.sum(), at_risk.sum(),
        backlog_hit.sum(), unserved.sum(),
    ]) * wq
    return client, scalars


def contention_np(client_total: np.ndarray, cap_bytes: int):
    """Charge client bytes against the per-OSD epoch capacity: returns
    (cap_remaining[DV], throttled_bytes, contended_osds), exact int64,
    the numpy executor."""
    client_total = np.asarray(client_total, np.int64)
    cap0 = np.full(client_total.shape[0], np.int64(cap_bytes), np.int64)
    rem = np.maximum(cap0 - client_total, 0)
    throttled = int(np.maximum(client_total - cap0, 0).sum())
    contended = int(((rem == 0) & (client_total > 0)).sum())
    return rem, throttled, contended


def contention_torch(client_total: torch.Tensor, cap_bytes: int):
    """contention_np as torch ops on the client vector's device; the two
    scalars come back in one fetch."""
    rem = (cap_bytes - client_total).clamp(min=0)
    throttled, contended = torch.stack([
        (client_total - cap_bytes).clamp(min=0).sum(),
        ((rem == 0) & (client_total > 0)).sum(),
    ]).tolist()
    return rem, int(throttled), int(contended)


class WorkloadGen:
    """Seeded client traffic model (module docstring).  The engine
    drives the per-epoch loop; this class owns the draws, the executors
    and the cumulative tallies."""

    def __init__(self, *, seed: int, base_qps: float,
                 read_fraction: float, zipf_a: float, hot_pool: float,
                 diurnal_amp: float, diurnal_period: int,
                 obj_kb: int, sample: int, interval_s: float):
        self.seed = seed
        self.base_qps = base_qps
        self.read_fraction = read_fraction
        self.zipf_a = zipf_a
        self.hot_pool = hot_pool
        self.diurnal_amp = diurnal_amp
        self.diurnal_period = max(int(diurnal_period), 1)
        self.obj_bytes = int(obj_kb) * 1024
        self.sample = int(sample)
        self.interval_s = interval_s
        self.totals = {k: 0 for k in WL_KEYS}
        self.totals["throttled_bytes"] = 0
        self.totals["contended_osd_epochs"] = 0

    # -- draws -------------------------------------------------------------

    def qps(self, e: int) -> float:
        """Piecewise-linear diurnal curve (exact float arithmetic)."""
        phase = (e % self.diurnal_period) / self.diurnal_period
        tri = 1.0 - 2.0 * abs(2.0 * phase - 1.0)  # [-1, 1] triangle
        return self.base_qps * (1.0 + self.diurnal_amp * tri)

    def epoch_requests(self, e: int) -> int:
        return int(self.qps(e) * self.interval_s)

    def pool_requests(self, e: int, pids: list[int]) -> dict[int, int]:
        """Zipf-rank split of the epoch's requests across pools (pool
        rank = position in sorted pid order: oldest pool hottest)."""
        R = self.epoch_requests(e)
        w = pool_rank_weights(len(pids), self.hot_pool)
        tot = sum(w)
        return {pid: int(R * wi / tot) for pid, wi in zip(pids, w)}

    def draws(self, e: int, pid: int, n: int):
        """The epoch's seeded sample for one pool: hot-key power-law
        PG seeds + the read/write mix."""
        rng = np.random.default_rng([self.seed, e, pid, 0x77])
        u = rng.random(self.sample)
        seeds = zipf_pg_seeds(u, n, self.zipf_a)
        read = rng.random(self.sample) < self.read_fraction
        return seeds, read

    # -- executors ---------------------------------------------------------

    def step_pool_device(self, e: int, pid: int, rows, backlog, *,
                         n: int, size: int, tol: int, DV: int,
                         wq: int):
        """One pool's traffic as torch ops on the rows' device: the
        sample's seeds and read mask go up, the seven scalars come back;
        the client vector stays on the device."""
        seeds, read = self.draws(e, pid, n)
        dev = rows.device
        client, scal = workload_pool_torch(
            rows, backlog, torch.from_numpy(seeds).to(dev),
            torch.from_numpy(read).to(dev), wq=wq,
            obj_bytes=self.obj_bytes, DV=DV, size=size, tol=tol)
        scalars = dict(zip(WL_KEYS, (int(v) for v in scal.tolist())))
        return client, scalars

    def step_pool_host(self, e: int, pid: int, rows, backlog, *,
                       n: int, size: int, tol: int, DV: int, wq: int):
        seeds, read = self.draws(e, pid, n)
        return workload_pool_np(
            np.asarray(rows),
            None if backlog is None else np.asarray(backlog),
            seeds, read, wq=wq, obj_bytes=self.obj_bytes, DV=DV,
            size=size, tol=tol)

    # -- accounting --------------------------------------------------------

    def book(self, scalars: dict) -> None:
        for k in WL_KEYS:
            self.totals[k] += scalars[k]
            _L.inc(k, int(scalars[k]))

    def book_contention(self, throttled: int, contended: int) -> None:
        self.totals["throttled_bytes"] += throttled
        self.totals["contended_osd_epochs"] += contended
        _L.inc("throttled_bytes", int(throttled))
        _L.inc("contended_osd_epochs", int(contended))

    def observe_epoch(self, qps: float, wall_s: float) -> None:
        _L.observe("qps", qps)
        _L.observe("step_seconds", wall_s)

    def state(self) -> dict:
        return {"totals": dict(self.totals)}

    def restore(self, st: dict) -> None:
        self.totals = dict(st["totals"])

    def summary(self, sim_seconds: float) -> dict:
        out = {
            "requests": self.totals["requests"],
            "served_qps": round(
                self.totals["requests"] / sim_seconds, 1
            ) if sim_seconds else 0.0,
            "reads": self.totals["reads"],
            "writes": self.totals["writes"],
            "degraded_reads": self.totals["degraded_reads"],
            "at_risk_hits": self.totals["at_risk_hits"],
            "backlog_hits": self.totals["backlog_hits"],
            "unserved": self.totals["unserved"],
            "throttled_gb": round(
                self.totals["throttled_bytes"] / 1e9, 3),
            "contended_osd_epochs": self.totals["contended_osd_epochs"],
        }
        return out
