"""Recovery data plane: a device-resident backlog/contention queue.

The port of `ceph_tpu/recovery/queue.py`.  Recovery work is queued per
PG, drained by per-OSD resources (bandwidth and concurrent-recovery
slots, the `osd_max_backfills` shape), at-risk PGs first, and unfinished
work carries across epochs as backlog ("Understanding System
Characteristics of Online Erasure Coding on Scalable, Distributed and
Large-Scale SSD Array Systems", PAPERS.md).

The model, exact in int64 bytes and int64 microseconds, so the torch ops
and the numpy mirror give bit-identical digests:

- **Enqueue.**  Each epoch, every moved-in replica lane of a PG queues
  `shard_bytes = pg_gb·1e9 / size` of recovery work onto that PG's
  backlog.
- **Drain.**  An epoch lasts `interval_s`.  Each OSD contributes
  `osd_mbps·interval_s` bytes of epoch capacity, shared by client
  traffic (subtracted first when the workload generator runs) and
  recovery.  An OSD runs at most `max_backfills` concurrent PG
  recoveries, each at the per-stream rate below, so its drain this epoch
  is `min(streams · stream_bytes, capacity)`.  PGs queue on their
  primary (first live lane); at-risk PGs drain first (class 0), the
  rest share the remaining slots and capacity (class 1); within a class
  the OSD's allotment splits evenly.
- **Pipelined repair (RapidRAID).**  An EC repair stream chains encode
  and transfer.  Serially the stages sum, `rate = 1 / (1/encode +
  1/transfer)`; with `pipeline_repair=1` the stream runs at the
  bottleneck stage, `min(encode, transfer)`.  The encode rate is
  `ec_gbps`, the EC engine's measured encode GB/s (the scenario's
  default, 1.6, is the JAX package's TPU figure, kept for digest
  parity).
- **Risk integration.**  A PG whose backlog fully drains mid-epoch
  contributes `backlog / share · interval_s` of at-risk time; one still
  queued (or with nothing queued to fix it) the whole epoch.
- **Conservation.**  Every epoch, per pool, `prev_backlog + enqueued ==
  drained + new_backlog` in exact int64; the lifetime simulator checks it
  as an invariant.

Two executors of one formula: `drain_pool_torch` (torch ops on the
rows' device: int64 gathers, masks and `index_add_` into [DV + 1]
buffers whose spare slot DV takes the PGs without a primary) and
`drain_pool_np`, the JAX package's numpy mirror copied verbatim, which
serves the "ref" backend.  The backlog vectors live on the state's
device epoch to epoch; the numpy mirror is fetched only when a caller
reads it (checkpoint, the durability pass, the summary).

It books the JAX package's `recovery` perf group, plus `device_drains`
(torch-op drains run); `COUNTERS` reads its counts.
"""

from __future__ import annotations

import base64

import numpy as np
import torch

from ceph_tpu_torch import obs
from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.utils.perf_counters import counters_attr

_L = obs.logger_for("recovery")
_L.add_u64("enqueued_bytes",
           "recovery bytes queued by moved-in replica lanes")
_L.add_u64("drained_bytes",
           "recovery bytes drained by per-OSD slot-limited streams")
_L.add_u64("completed_pgs",
           "PG recoveries that fully drained within an epoch")
_L.add_u64("queued_pg_epochs",
           "PG-epochs spent with a nonzero recovery backlog")
_L.add_u64("fallbacks",
           "recovery drains degraded to the host mirror after a device "
           "loss (always 0: the port has no host degradation)")
_L.add_u64("conservation_violations",
           "epochs where prev_backlog + enqueued != drained + backlog "
           "(also booked as a sim invariant violation)")
_L.add_avg("backlog_bytes",
           "end-of-epoch total recovery backlog (one observation per "
           "epoch)")
_L.add_avg("streams",
           "concurrent recovery streams granted per epoch")
_L.add_quantile("drain_seconds",
                "wall time of one epoch's recovery drain (all pools: "
                "launch + scalar fetch, or the numpy mirror)")
_L.add_u64("device_drains",
           "drain_pool_torch calls (one per pool-epoch with work)")
__getattr__ = counters_attr("recovery", __name__, (
    "enqueued_bytes", "drained_bytes", "completed_pgs", "queued_pg_epochs",
    "fallbacks", "conservation_violations", "device_drains"))


def stream_bytes_per_epoch(recovery_mbps: float, t_us: int,
                           ec_gbps: float = 0.0,
                           pipelined: bool = False) -> int:
    """Bytes one recovery stream moves in one epoch.  Replicated pools
    copy at the transfer rate; EC repair chains encode->transfer —
    serial stages sum (harmonic rate), pipelined (RapidRAID) runs at
    the bottleneck stage."""
    xfer = int(recovery_mbps * 1e6)
    if ec_gbps > 0:
        enc = int(ec_gbps * 1e9)
        rate = min(enc, xfer) if pipelined else (
            (enc * xfer) // (enc + xfer))
    else:
        rate = xfer
    return (rate * t_us) // 1_000_000


DRAIN_KEYS = ("enqueued", "drained", "backlog", "risk_us", "completed",
              "queued", "streams")


def drain_pool_np(backlog, moved, rows, cap, slots, *, shard_bytes: int,
                  stream_bytes: int, t_us: int, n: int, size: int,
                  tol: int):
    """The authoritative drain formula, numpy executor (exact int64).
    Returns (new_backlog, new_cap, new_slots, scalars dict)."""
    rows = np.asarray(rows)
    N, _ = rows.shape
    DV = int(cap.shape[0])
    backlog = np.asarray(backlog, np.int64)
    moved = (np.zeros(N, np.int64) if moved is None
             else np.asarray(moved, np.int64))
    cap = np.asarray(cap, np.int64).copy()
    slots = np.asarray(slots, np.int64).copy()
    real = np.arange(N) < n
    valid = (rows != ITEM_NONE) & (rows >= 0)
    occ = valid.sum(axis=1)
    enq = np.where(real, moved * np.int64(shard_bytes), np.int64(0))
    b0 = backlog + enq
    at_risk = real & (occ < size - tol)
    queued = real & (b0 > 0)
    first = np.argmax(valid, axis=1)
    prim = rows[np.arange(N), first].astype(np.int64)
    prim = np.where(valid.any(axis=1) & (prim >= 0) & (prim < DV),
                    prim, np.int64(DV))
    drain = np.zeros(N, np.int64)
    share_all = np.zeros(N, np.int64)
    streams_total = 0
    for cls in (queued & at_risk, queued & ~at_risk):
        n_o = np.zeros(DV + 1, np.int64)
        np.add.at(n_o, prim, cls.astype(np.int64))
        n_o = n_o[:DV]
        streams = np.minimum(n_o, slots)
        allot = np.minimum(streams * np.int64(stream_bytes), cap)
        share_o = np.where(n_o > 0, allot // np.maximum(n_o, 1),
                           np.int64(0))
        share = np.where(cls, np.append(share_o, 0)[prim], np.int64(0))
        d = np.minimum(b0, share)
        drained_o = np.zeros(DV + 1, np.int64)
        np.add.at(drained_o, prim, d)
        cap = cap - drained_o[:DV]
        slots = np.maximum(slots - streams, 0)
        drain = drain + d
        share_all = share_all + share
        streams_total += int(streams.sum())
    b_after = b0 - drain
    completed = queued & (b_after == 0)
    num = np.minimum(b0, share_all) * np.int64(t_us)
    risk_t = np.where(completed & (share_all > 0),
                      num // np.maximum(share_all, 1), np.int64(t_us))
    risk_us = int(np.where(at_risk, risk_t, np.int64(0)).sum())
    scalars = {
        "enqueued": int(enq.sum()),
        "drained": int(drain.sum()),
        "backlog": int((b_after * real).sum()),
        "risk_us": risk_us,
        "completed": int(completed.sum()),
        "queued": int(queued.sum()),
        "streams": streams_total,
    }
    return b_after, cap, slots, scalars


def primary_slots(rows: torch.Tensor, DV: int) -> torch.Tensor:
    """Each row's primary (first live lane) as an int64 index into a
    [DV + 1] buffer: DV (the spare slot) where the row has no live lane
    or its primary is past the vectors.  The first live lane is the least
    lane index of the occupied ones: argmax's first-maximum rule, with
    no argmax over a bool tensor."""
    valid = (rows != ITEM_NONE) & (rows >= 0)
    W = rows.shape[1]
    lane = torch.arange(W, device=rows.device)
    first = torch.where(valid, lane, W).amin(1).clamp(max=W - 1)
    prim = rows.gather(1, first[:, None])[:, 0].long()
    return torch.where(valid.any(1) & (prim >= 0) & (prim < DV), prim, DV)


def drain_pool_torch(backlog, moved, rows, cap, slots, *, shard_bytes: int,
                     stream_bytes: int, t_us: int, n: int, size: int,
                     tol: int):
    """`drain_pool_np` as torch ops on the rows' device (int64 end to
    end).  `moved` may be None (nothing moved).  Returns (new_backlog,
    new_cap, new_slots, scalars int64 [7] in DRAIN_KEYS order, still on
    the device).  No input is written: every output is a new tensor."""
    _L.inc("device_drains")
    dev = rows.device
    N = rows.shape[0]
    DV = cap.shape[0]
    real = torch.arange(N, device=dev) < n
    valid = (rows != ITEM_NONE) & (rows >= 0)
    occ = valid.sum(1)
    if moved is None:
        enq = torch.zeros(N, dtype=torch.int64, device=dev)
    else:
        enq = torch.where(real, moved.long() * shard_bytes, 0)
    b0 = backlog + enq
    at_risk = real & (occ < size - tol)
    queued = real & (b0 > 0)
    prim = primary_slots(rows, DV)
    zero1 = torch.zeros(1, dtype=torch.int64, device=dev)
    drain = torch.zeros(N, dtype=torch.int64, device=dev)
    share_all = torch.zeros(N, dtype=torch.int64, device=dev)
    streams_total = torch.zeros((), dtype=torch.int64, device=dev)
    for cls in (queued & at_risk, queued & ~at_risk):
        n_o = torch.zeros(DV + 1, dtype=torch.int64, device=dev).index_add_(
            0, prim, cls.long())[:DV]
        streams = torch.minimum(n_o, slots)
        allot = torch.minimum(streams * stream_bytes, cap)
        share_o = torch.where(n_o > 0, allot // n_o.clamp(min=1), 0)
        share = torch.where(cls, torch.cat([share_o, zero1])[prim], 0)
        d = torch.minimum(b0, share)
        drained_o = torch.zeros(DV + 1, dtype=torch.int64,
                                device=dev).index_add_(0, prim, d)
        cap = cap - drained_o[:DV]
        slots = (slots - streams).clamp(min=0)
        drain = drain + d
        share_all = share_all + share
        streams_total = streams_total + streams.sum()
    b_after = b0 - drain
    completed = queued & (b_after == 0)
    num = torch.minimum(b0, share_all) * t_us
    risk_t = torch.where(completed & (share_all > 0),
                         num // share_all.clamp(min=1), t_us)
    scalars = torch.stack([
        enq.sum(), drain.sum(),
        torch.where(real, b_after, 0).sum(),
        torch.where(at_risk, risk_t, 0).sum(),
        completed.sum(), queued.sum(), streams_total,
    ])
    return b_after, cap, slots, scalars


class RecoveryQueue:
    """Per-pool recovery backlogs + cumulative accounting.

    Master state: the per-pool int64 backlog vectors.  On the torch
    backend they live on `device` epoch to epoch (`_dev`); the numpy
    mirror (`backlog`) is fetched from them when a caller reads it
    (`host_backlog`, `pg_undrained`, `state`, `summary`).  The engine
    drives the per-epoch loop; this class owns the state, the executors
    and the totals."""

    def __init__(self, *, pg_gb: float, recovery_mbps: float,
                 interval_s: float, max_backfills: int, osd_mbps: float,
                 pipeline_repair: int, ec_gbps: float, device=None):
        self.pg_gb = pg_gb
        self.recovery_mbps = recovery_mbps
        self.t_us = int(round(interval_s * 1e6))
        self.max_backfills = int(max_backfills)
        self.cap_epoch_bytes = (
            int(osd_mbps * 1e6) * self.t_us) // 1_000_000
        self.pipeline_repair = int(pipeline_repair)
        self.ec_gbps = ec_gbps
        self.device = device
        self.backlog: dict[int, np.ndarray] = {}   # pid -> int64 mirror
        self._dev: dict[int, torch.Tensor] = {}    # pid -> device vector
        self._stale: set[int] = set()  # mirrors behind their device copy
        self.prev_total: dict[int, int] = {}
        self.totals = {"enqueued": 0, "drained": 0, "completed": 0,
                       "risk_us": 0, "queued_pg_epochs": 0}
        self.backlog_peak = 0   # max END-of-epoch backlog (carried)
        self.queue_peak = 0     # max pre-drain queue depth in an epoch
        self._epoch_queue = 0
        self.fallback_epochs = 0
        self.conservation_violations = 0

    # -- rates -------------------------------------------------------------

    def shard_bytes(self, size: int) -> int:
        return int(self.pg_gb * 1e9) // max(int(size), 1)

    def stream_bytes(self, is_erasure: bool) -> int:
        return stream_bytes_per_epoch(
            self.recovery_mbps, self.t_us,
            ec_gbps=self.ec_gbps if is_erasure else 0.0,
            pipelined=bool(self.pipeline_repair))

    # -- state -------------------------------------------------------------

    def host_backlog(self, pid: int) -> np.ndarray | None:
        """The pool's backlog mirror, fetched from the device copy when
        a drain changed it."""
        if pid in self._stale:
            self.backlog[pid] = self._dev[pid].cpu().numpy()
            self._stale.discard(pid)
        return self.backlog.get(pid)

    def ensure(self, pid: int, N: int) -> None:
        """The pool's backlog at row-count N.  A pg_num split keeps the
        parent seeds' backlog (children start empty); any resize drops
        the device copy (uploaded again on use).  A device copy of size N
        is left where it is: nothing is fetched."""
        d = self._dev.get(pid)
        if d is not None and d.shape[0] == N:
            return
        b = self.host_backlog(pid)
        if b is None or b.shape[0] != N:
            nb = np.zeros(N, np.int64)
            if b is not None:
                k = min(N, b.shape[0])
                nb[:k] = b[:k]
                self._dev.pop(pid, None)
            self.backlog[pid] = b = nb
            self.prev_total.setdefault(pid, int(b.sum()))

    def drop(self, pid: int) -> None:
        self.backlog.pop(pid, None)
        self._dev.pop(pid, None)
        self._stale.discard(pid)
        self.prev_total.pop(pid, None)

    def device_backlog(self, pid: int) -> torch.Tensor:
        d = self._dev.get(pid)
        if d is None:
            d = self._dev[pid] = torch.from_numpy(
                self.backlog[pid].copy()).to(self.device)
        return d

    def total_backlog(self) -> int:
        return sum(int(self.host_backlog(pid).sum())
                   for pid in list(self.backlog))

    def pg_undrained(self, pid: int, n: int) -> np.ndarray:
        """Bool [n]: PGs still carrying recovery backlog (valid after the
        epoch's drain).  The lifetime engine's durability pass keys wound
        healing off this."""
        b = self.host_backlog(pid)
        if b is None:
            return np.zeros(n, bool)
        if b.shape[0] < n:
            out = np.zeros(n, bool)
            out[:b.shape[0]] = b > 0
            return out
        return b[:n] > 0

    # -- the drain ---------------------------------------------------------

    def drain_device(self, pid: int, moved, rows, cap, slots, *,
                     n: int, size: int, tol: int, is_erasure: bool):
        """One pool's drain as torch ops on the rows' device: the backlog
        stays resident, only the seven scalars are fetched.  Returns
        (new_cap, new_slots, scalars)."""
        self.ensure(pid, int(rows.shape[0]))
        b_after, cap, slots, scal = drain_pool_torch(
            self.device_backlog(pid), moved, rows, cap, slots,
            shard_bytes=self.shard_bytes(size),
            stream_bytes=self.stream_bytes(is_erasure),
            t_us=self.t_us, n=n, size=size, tol=tol)
        self._dev[pid] = b_after
        self._stale.add(pid)
        scalars = dict(zip(DRAIN_KEYS, (int(v) for v in scal.tolist())))
        return cap, slots, scalars

    def drain_host(self, pid: int, moved, rows, cap, slots, *, n: int,
                   size: int, tol: int, is_erasure: bool):
        """The numpy executor over the host mirror (the "ref" backend)."""
        rows = np.asarray(rows)
        self.ensure(pid, int(rows.shape[0]))
        if moved is not None:
            moved = np.asarray(moved)
        b_after, cap, slots, scalars = drain_pool_np(
            self.host_backlog(pid), moved, rows, cap, slots,
            shard_bytes=self.shard_bytes(size),
            stream_bytes=self.stream_bytes(is_erasure),
            t_us=self.t_us, n=n, size=size, tol=tol)
        self.backlog[pid] = b_after
        self._dev.pop(pid, None)
        self._stale.discard(pid)
        return cap, slots, scalars

    def book(self, pid: int, scalars: dict) -> bool:
        """Fold one pool-epoch's scalars into totals/counters and check
        byte conservation.  Returns True when conserved."""
        prev = self.prev_total.get(pid, 0)
        conserved = (prev + scalars["enqueued"]
                     == scalars["drained"] + scalars["backlog"])
        self._epoch_queue += prev + scalars["enqueued"]
        self.prev_total[pid] = scalars["backlog"]
        self.totals["enqueued"] += scalars["enqueued"]
        self.totals["drained"] += scalars["drained"]
        self.totals["completed"] += scalars["completed"]
        self.totals["risk_us"] += scalars["risk_us"]
        self.totals["queued_pg_epochs"] += scalars["queued"]
        _L.inc("enqueued_bytes", int(scalars["enqueued"]))
        _L.inc("drained_bytes", int(scalars["drained"]))
        _L.inc("completed_pgs", int(scalars["completed"]))
        _L.inc("queued_pg_epochs", int(scalars["queued"]))
        _L.observe("streams", scalars["streams"])
        if not conserved:
            _L.inc("conservation_violations")
            self.conservation_violations += 1
        return conserved

    def end_epoch(self) -> int:
        total = sum(self.prev_total.values())
        self.backlog_peak = max(self.backlog_peak, total)
        self.queue_peak = max(self.queue_peak, self._epoch_queue)
        self._epoch_queue = 0
        _L.observe("backlog_bytes", total)
        return total

    # -- checkpoint --------------------------------------------------------

    def state(self) -> dict:
        return {
            "backlog": {
                str(pid): base64.b64encode(np.ascontiguousarray(
                    self.host_backlog(pid)).tobytes()).decode()
                for pid in list(self.backlog)
            },
            "totals": dict(self.totals),
            "backlog_peak": self.backlog_peak,
            "queue_peak": self.queue_peak,
            "fallback_epochs": self.fallback_epochs,
            "conservation_violations": self.conservation_violations,
        }

    def restore(self, st: dict) -> None:
        self.backlog = {
            int(pid): np.frombuffer(
                base64.b64decode(b64), np.int64).copy()
            for pid, b64 in (st.get("backlog") or {}).items()
        }
        self._dev = {}
        self._stale = set()
        self.prev_total = {pid: int(b.sum())
                           for pid, b in self.backlog.items()}
        self.totals = dict(st["totals"])
        self.backlog_peak = int(st["backlog_peak"])
        self.queue_peak = int(st.get("queue_peak", 0))
        self.fallback_epochs = int(st.get("fallback_epochs", 0))
        self.conservation_violations = int(
            st.get("conservation_violations", 0))

    def summary(self) -> dict:
        total = self.total_backlog()
        return {
            "model": "queue",
            "pipelined_repair": bool(self.pipeline_repair),
            "enqueued_gb": round(self.totals["enqueued"] / 1e9, 3),
            "drained_gb": round(self.totals["drained"] / 1e9, 3),
            "backlog_gb": round(total / 1e9, 3),
            "backlog_peak_gb": round(self.backlog_peak / 1e9, 3),
            "queue_peak_gb": round(self.queue_peak / 1e9, 3),
            "completed_pgs": self.totals["completed"],
            "queued_pg_epochs": self.totals["queued_pg_epochs"],
            "at_risk_pg_seconds": round(
                self.totals["risk_us"] / 1e6, 3),
            "conservation_violations": self.conservation_violations,
            "fallback_epochs": self.fallback_epochs,
        }
