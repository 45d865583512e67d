"""Failure / recovery simulation over the batched placement pipeline.

The port of `ceph_tpu/sim/failure.py`.  The reference's failure handling
is declarative: heartbeats mark OSDs down (reference src/osd/OSD.cc:5327
handle_osd_ping, :5698 heartbeat_check), the monitor publishes a new
epoch, and recovery IS the difference between the old and new up/acting
sets per PG (peering/backfill, reference src/osd/PeeringState.cc; pg_temp
keeps serving from the old acting set during backfill, reference
src/osd/OSDMap.cc:2592).

So failure simulation is: flip OSD state, re-map every PG, and diff.
`ClusterSim` does that on the card (backend "torch", alias "jax"): each
epoch maps every pool through a fresh `PoolMapper` (one rule-kernel launch
per 2^24 PGs), keeps the rows as tensors on the card, and diffs them
there (`diff_mappings`), fetching only the report's counts.  Backend
"ref" is the host oracle (`OSDMap.pg_to_up_acting_osds`, PG by PG) with
numpy rows.  `thrash` is the OSDThrasher-style randomized fault injector
(the qa harness pattern, reference qa/tasks/ceph_manager.py:185).

A device loss while a pool maps (an error `runtime.faults.looks_like_
device_loss` accepts, such as the `map_batch=lost` fault point) follows
`runtime.faults.degrade_or_raise`: on a run placed on the host
(`device="cpu"`) that pool maps through the host oracle, bit-exact with
the device pipeline, and the descent is recorded in `fallback_events`,
`provenance()` and the `runtime` group's `device_loss_fallbacks`, as in
the JAX package; on a card it raises, as does every other error.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import PgId
from ceph_tpu_torch.runtime import faults
from ceph_tpu_torch.utils import knobs
from ceph_tpu_torch.utils.dout import subsys_logger

_log = subsys_logger("sim")

BACKENDS = {"torch": "torch", "jax": "torch", "ref": "ref"}


@dataclass
class MovementReport:
    """Diff of two cluster mappings (per pool)."""

    total_pgs: int = 0
    pgs_remapped: int = 0  # up set changed
    pgs_primary_changed: int = 0
    replicas_moved: int = 0  # osds that entered a pg's up set
    degraded_pgs: int = 0  # up set smaller than pool size
    moved_fraction: float = 0.0
    # EC-aware risk accounting (the lifetime sim's): PGs whose up set has
    # lost more chunks than the pool tolerates, and the integral of that
    # count over simulated time
    pgs_at_risk: int = 0
    at_risk_pg_seconds: float = 0.0

    def merge(self, other: "MovementReport") -> None:
        self.total_pgs += other.total_pgs
        self.pgs_remapped += other.pgs_remapped
        self.pgs_primary_changed += other.pgs_primary_changed
        self.replicas_moved += other.replicas_moved
        self.degraded_pgs += other.degraded_pgs
        self.pgs_at_risk += other.pgs_at_risk
        self.at_risk_pg_seconds += other.at_risk_pg_seconds
        if self.total_pgs:
            self.moved_fraction = self.pgs_remapped / self.total_pgs


def _map_ref(m: OSDMap, pid: int) -> tuple:
    """Host reference mapper for one pool: numpy (up, up_primary, acting,
    acting_primary), rows pool.size wide."""
    pool = m.pools[pid]
    n, W = pool.pg_num, pool.size
    up = np.full((n, W), ITEM_NONE, np.int32)
    upp = np.full(n, -1, np.int32)
    acting = np.full((n, W), ITEM_NONE, np.int32)
    actp = np.full(n, -1, np.int32)
    for ps in range(n):
        u, up_pr, a, a_pr = m.pg_to_up_acting_osds(PgId(pid, ps))
        up[ps, : len(u)] = u
        acting[ps, : len(a)] = a
        upp[ps], actp[ps] = up_pr, a_pr
    return (up, upp, acting, actp)


def _map_all(m: OSDMap, backend: str, device=None,
             events: list[str] | None = None) -> dict[int, tuple]:
    """Every pool's (up, up_primary, acting, acting_primary): int32
    tensors on `device` for "torch", numpy for "ref" and for a pool
    whose device pass was lost (recorded in `events`)."""
    from ceph_tpu_torch.osd.pipeline import PoolMapper

    out = {}
    for pid in sorted(m.pools):
        if BACKENDS[backend] == "torch":
            try:
                out[pid] = PoolMapper(m, pid,
                                      device=device).map_all_tensors()
                continue
            except Exception as e:
                # on the host, degrade: the host mapper is bit-exact with
                # the device pipeline, so the placements are identical
                faults.degrade_or_raise(e, device)
                _log(1, f"device lost mapping pool {pid} ({e}); "
                        "degrading to host mapper")
                if events is not None:
                    events.append(
                        f"pool {pid} epoch {m.epoch}: {e} -> ref")
        out[pid] = _map_ref(m, pid)
    return out


def _compact(up: torch.Tensor) -> torch.Tensor:
    """Each row's non-NONE entries first, in order, NONE after."""
    none = up == ITEM_NONE
    order = torch.sort(none.to(torch.int8), dim=1, stable=True).indices
    return torch.gather(up, 1, order)


def _diff_pool(up1, upp1, up2, upp2, size: int) -> torch.Tensor:
    """One pool's [remapped, primary changed, replicas moved, degraded]
    counts: the JAX loop's per-PG list semantics as tensor ops."""
    w = max(up1.shape[1], up2.shape[1])

    def pad(up):
        up = up.long()
        fill = torch.full((up.shape[0], w - up.shape[1]), ITEM_NONE,
                          dtype=up.dtype, device=up.device)
        return torch.cat([up, fill], 1)

    a, b = _compact(pad(up1)), _compact(pad(up2))
    remapped = (a != b).any(1)
    b_ok = b != ITEM_NONE
    in_a = (b[:, :, None] == a[:, None, :]).any(2)
    # len(set(b) - set(a)): each value of b once, at its first position
    col = torch.arange(w, device=b.device)
    earlier = ((b[:, :, None] == b[:, None, :])
               & (col[None, :] < col[:, None])[None]).any(2)
    moved = (b_ok & ~in_a & ~earlier).sum(1)
    return torch.stack([
        remapped.sum(),
        (upp1.long() != upp2.long()).sum(),
        moved.sum(),
        (b_ok.sum(1) < size).sum(),
    ])


def diff_mappings(
    before: dict[int, tuple], after: dict[int, tuple], pools: dict
) -> MovementReport:
    """Per PG: the up set's non-NONE list changed (order counts), the
    OSDs that entered it (len(set(after) - set(before))), a changed
    up_primary, and an up set shorter than the pool size (degraded).
    Rows may be numpy or tensors; tensors are diffed on their device and
    only the counts come back."""
    rep = MovementReport()
    for pid, (up1, upp1, _, _) in before.items():
        up2, upp2, _, _ = after[pid]
        t = [torch.as_tensor(v) for v in (up1, upp1, up2, upp2)]
        counts = _diff_pool(*t, pools[pid].size).tolist()
        rep.total_pgs += int(t[0].shape[0])
        rep.pgs_remapped += counts[0]
        rep.pgs_primary_changed += counts[1]
        rep.replicas_moved += counts[2]
        rep.degraded_pgs += counts[3]
    if rep.total_pgs:
        rep.moved_fraction = rep.pgs_remapped / rep.total_pgs
    return rep


class ClusterSim:
    """Stateful failure simulator: apply events, measure movement.

    backend: "torch" (alias "jax"): every epoch maps on `device` (None:
    the card) and `current` holds the rows as tensors there; "ref": the
    host oracle, numpy rows.

    diagnostics: run the placement diagnostics after every epoch
    (`PoolMapper.diagnose`, the rule kernel's diagnostics variant) and
    book the per-epoch retry / bad-mapping accounting in `diag_history`
    and, as source "sim", in `obs.placement`.  Defaults to
    CEPH_TPU_PLACEMENT_DIAG=1 in the environment.  On the "ref" backend
    the accounting is the host's bad-mapping count of the rows already
    mapped (no retry visibility), as in the JAX package."""

    def __init__(self, m: OSDMap, backend: str = "torch",
                 diagnostics: bool | None = None, device=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: torch (jax), "
                             "or ref")
        self.m = m
        self.backend = backend
        self.device = (resolve_device(device)
                       if BACKENDS[backend] == "torch" else None)
        self.epoch = m.epoch
        if diagnostics is None:
            diagnostics = knobs.get("CEPH_TPU_PLACEMENT_DIAG", "0") == "1"
        self.diagnostics = diagnostics
        self.diag_history: list[tuple[str, dict]] = []
        # provenance of degraded mapping passes (device loss -> ref)
        self.fallback_events: list[str] = []
        self.current = _map_all(m, backend, self.device,
                                self.fallback_events)
        self.history: list[tuple[str, MovementReport]] = []
        if self.diagnostics:
            self._diagnose_epoch("init")

    def _diagnose_epoch(self, label: str) -> dict:
        """Per-epoch decision accounting over every pool."""
        from ceph_tpu_torch.obs import placement
        from ceph_tpu_torch.osd.pipeline import PoolMapper

        agg: dict = {"epoch": int(self.epoch), "label": label}
        for pid in sorted(self.m.pools):
            s = None
            if BACKENDS[self.backend] == "torch":
                try:
                    s = PoolMapper(self.m, pid, device=self.device
                                   ).diagnose(record=False)
                except Exception as e:
                    faults.degrade_or_raise(e, self.device, book=False)
                    _log(1, f"device lost diagnosing pool {pid} ({e}); "
                            "host bad-mapping counts only")
            if s is None:
                up = self.current[pid][0]
                occupied = (np.asarray(up) != ITEM_NONE).sum(axis=1)
                s = {"pgs": int(up.shape[0]),
                     "bad_mappings": int(
                         (occupied < self.m.pools[pid].size).sum()),
                     "diag_exact": False}
            placement.fold_summary(agg, s)
        placement.record("sim", agg)
        self.diag_history.append((label, agg))
        return agg

    def provenance(self) -> dict:
        """Which backend produced the placements, and every degradation
        that happened along the way."""
        return {
            "backend": self.backend,
            "device_loss_fallbacks": len(self.fallback_events),
            "fallback_events": list(self.fallback_events),
        }

    def _step(self, label: str) -> MovementReport:
        self.epoch += 1
        self.m.epoch = self.epoch
        new = _map_all(self.m, self.backend, self.device,
                       self.fallback_events)
        rep = diff_mappings(self.current, new, self.m.pools)
        self.current = new
        self.history.append((label, rep))
        if self.diagnostics:
            self._diagnose_epoch(label)
        return rep

    # -- events ------------------------------------------------------------
    def fail_osd(self, osd: int, out: bool = True) -> MovementReport:
        """down (+out): the heartbeat-timeout → mark-down → mark-out path."""
        self.m.mark_down(osd)
        if out:
            self.m.mark_out(osd)
        return self._step(f"fail osd.{osd}")

    def revive_osd(self, osd: int) -> MovementReport:
        self.m.mark_up_in(osd)
        return self._step(f"revive osd.{osd}")

    def reweight_osd(self, osd: int, weight: float) -> MovementReport:
        self.m.osd_weight[osd] = int(weight * 0x10000)
        return self._step(f"reweight osd.{osd} {weight}")

    def set_pg_temp(
        self, pg: PgId, acting: list[int], primary: int = -1
    ) -> MovementReport:
        """Serve from the old acting set during backfill."""
        self.m.pg_temp[pg] = list(acting)
        if primary >= 0:
            self.m.primary_temp[pg] = primary
        return self._step(f"pg_temp {pg}")

    def balance(self, **kw) -> MovementReport:
        from ceph_tpu_torch.balancer import calc_pg_upmaps

        on_card = BACKENDS[self.backend] == "torch"
        kw.setdefault("use_tpu", on_card)
        if on_card:
            kw.setdefault("device", self.device)
        calc_pg_upmaps(self.m, **kw)
        return self._step("balance")

    # -- thrasher ----------------------------------------------------------
    def thrash(
        self,
        rounds: int,
        rng: np.random.Generator | None = None,
        p_fail: float = 0.5,
    ) -> list[MovementReport]:
        """OSDThrasher pattern: random kill/revive rounds; every PG must
        stay mapped (no PG falls off the cluster while >= size OSDs up).
        The up-OSD floor is the largest pool's size.  The generator is
        consumed in the JAX package's order (rng.random() only when an
        OSD is down), so a seed gives its events."""
        rng = rng or np.random.default_rng(0)
        floor = max(
            (p.size for p in self.m.pools.values()), default=3
        )
        downed: list[int] = []
        reports = []
        for _ in range(rounds):
            up_osds = [
                o for o in range(self.m.max_osd)
                if self.m.is_up(o)
            ]
            if downed and (
                rng.random() > p_fail or len(up_osds) <= floor
            ):
                osd = downed.pop(int(rng.integers(len(downed))))
                reports.append(self.revive_osd(osd))
            elif len(up_osds) > floor:
                osd = int(up_osds[int(rng.integers(len(up_osds)))])
                downed.append(osd)
                reports.append(self.fail_osd(osd))
        return reports
