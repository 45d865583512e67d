"""Membership-state backends for the upmap balancer's greedy loop.

The port of `ceph_tpu/balancer/state.py`.  The reference optimizer
(`OSDMap::calc_pg_upmaps`, reference src/osd/OSDMap.cc:4634-5208) keeps a
`map<osd, set<pg>>` of its OWN bookkeeping: it never remaps after a
change, and membership evolves only by the discard/add pairs the greedy
applies.  That bookkeeping is the state interface here:

- SetState: dict-of-sets, the reference's semantics (small maps).  Every
  change attempt copies the whole table, as the reference's
  `temp_pgs_by_osd` does.
- DeviceState: the 10M-PG/10k-OSD form.  Per-PG membership rows stay on
  the mapper's device (one [pg_num, W] int32 tensor per pool); the host
  keeps only the O(OSDs) count vector.  A change attempt is a small delta
  dict; `pgs_of` is a masked `torch.nonzero` that brings back only the
  matching PG indices.  Deviation totals are summed in ascending-osd
  order (the reference iterates a sorted std::map,
  src/osd/OSDMap.cc:4707).
- FlatDeviceState: every selected pool's rows in one [N, Wmax] tensor,
  the operand of the device_loop plan.

The JAX package's PG-axis mesh is not ported: there is one device.

Each exposes:
    deviations() -> (dev: {osd: float}, sum_sq: float, max_abs: float)
    pgs_of(osd)  -> ascending list[PgId] of current members
    begin() -> txn;  txn.move(pg, frm, to);  txn.deviations();  commit(txn)

`move(pg, a, b)` = the reference's paired
`temp[a].discard(pg); temp[b].add(pg)`.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch import obs
from ceph_tpu_torch.core import reduce
from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.osd.types import PgId

_L = obs.logger_for("balancer")
_L.add_u64("pgs_of_queries", "device membership queries (masked nonzero)")
_L.add_time_avg("pgs_of_seconds", "device membership query wall time")
_L.add_u64("txn_commits", "membership transactions committed")


class SetState:
    """dict-of-sets bookkeeping (the reference's small-scale backend)."""

    def __init__(self, pgs_by_osd: dict[int, set],
                 osd_weight: dict[int, float], pgs_per_weight: float):
        self.pbo = {o: s for o, s in pgs_by_osd.items() if o in osd_weight}
        for o in osd_weight:
            self.pbo.setdefault(o, set())
        self.osd_weight = osd_weight
        self.ppw = pgs_per_weight

    def _dev(self, pbo):
        # both backends sum d^2 in ascending-osd order with np.sum (the
        # reference iterates a sorted std::map, src/osd/OSDMap.cc:4707),
        # so near-tie stddev comparisons decide alike
        dev = {
            osd: len(pbo.get(osd, ())) - w * self.ppw
            for osd, w in self.osd_weight.items()
        }
        vals = np.asarray([dev[o] for o in sorted(dev)], np.float64)
        return dev, float(np.sum(vals * vals)), float(
            np.max(np.abs(vals), initial=0.0)
        )

    def deviations(self):
        return self._dev(self.pbo)

    def counts_np(self, n: int) -> np.ndarray:
        """Dense per-OSD membership counts int64[n]: the candidate-batch
        scorer's base vector (the numbers _dev derives deviations
        from)."""
        counts = np.zeros(n, np.int64)
        for osd, pgs in self.pbo.items():
            if 0 <= osd < n:
                counts[osd] = len(pgs)
        return counts

    def pgs_of(self, osd):
        return sorted(self.pbo.get(osd, ()))

    def begin(self):
        return _SetTxn(self)

    def commit(self, txn: "_SetTxn"):
        _L.inc("txn_commits")
        self.pbo = txn.temp


class _SetTxn:
    def __init__(self, st: SetState):
        self.st = st
        self.temp = {o: set(s) for o, s in st.pbo.items()}

    def move(self, pg, frm, to):
        self.temp.setdefault(frm, set()).discard(pg)
        self.temp.setdefault(to, set()).add(pg)

    def deviations(self):
        return self.st._dev(self.temp)


class DeviceState:
    """Membership rows on the device + the O(OSDs) count vector on the host.

    rows[pool] is the balancer's bookkeeping of which OSDs hold each PG,
    started from the pipeline's overlay-free `up` rows with the few
    upmap-carrying PGs scattered in from the host pipeline, then evolved
    by `move` as the reference evolves its sets (never remapped).

    `cache` (a caller-owned dict pool -> PoolMapper) reuses the per-pool
    mapper across successive balancer runs: its tables depend only on
    the CRUSH structure and bucket weights, fixed across a rebalance;
    `refresh_dev` re-reads the per-OSD vectors from `m` on every build."""

    def __init__(self, m, osd_weight: dict[int, float],
                 pgs_per_weight: float, only_pools=None, device=None,
                 cache: dict | None = None, rows_source=None):
        from ceph_tpu_torch.osd.pipeline import PoolMapper, overlay_fixup_rows

        self.osd_weight = dict(osd_weight)
        self.ppw = pgs_per_weight
        self._weight_osds = np.asarray(sorted(self.osd_weight), np.int64)
        self._weight_vec = np.asarray(
            [self.osd_weight[o] for o in self._weight_osds], np.float64
        )
        self.max_osd = int(m.max_osd)
        self.rows: dict[int, torch.Tensor] = {}
        self.pg_num: dict[int, int] = {}
        counts = torch.zeros(self.max_osd, dtype=torch.int64, device=device)
        for pid in sorted(m.pools):
            if only_pools and pid not in only_pools:
                continue
            # mapped WITHOUT overlay tensors; the few upmap-carrying PGs
            # get the host pipeline's rows scattered in.  Membership is
            # content-based, so primary reordering does not matter here.
            n = m.pools[pid].pg_num
            rows = rows_source(pid) if rows_source is not None else None
            if rows is None:
                if cache is not None and pid in cache:
                    pm = cache[pid]
                    pm.refresh_dev()
                else:
                    pm = PoolMapper(m, pid, device, overlays=False)
                    if cache is not None:
                        cache[pid] = pm
                n = pm.spec.pg_num
                with obs.span("balancer.map_pool", pool=pid, pgs=n):
                    rows = pm.map_all_device()
                seeds, fix_rows = overlay_fixup_rows(m, pid,
                                                     int(rows.shape[1]))
                if len(seeds):
                    rows[torch.from_numpy(seeds).to(rows.device)] = \
                        torch.from_numpy(fix_rows).to(rows.device)
            else:
                # a copy: `commit` writes the rows in place, and the
                # source's rows (a ClusterState's cache) stay as they are
                rows = torch.as_tensor(rows, device=device).clone()
            self.rows[pid] = rows
            self.pg_num[pid] = n
            counts += reduce.osd_histogram(rows[:n], self.max_osd,
                                           dtype=torch.int64)
        self.counts = counts.cpu().numpy().copy()  # O(OSDs); writable
        self._pgs_cache: dict[int, list] = {}

    # -- deviations ------------------------------------------------------
    def _dev_from_counts(self, counts: np.ndarray):
        # ascending-osd np.sum: the order and method of SetState._dev
        d = counts[self._weight_osds].astype(np.float64) \
            - self._weight_vec * self.ppw
        dev = {int(o): float(x) for o, x in zip(self._weight_osds, d)}
        return dev, float(np.sum(d * d)), float(
            np.max(np.abs(d), initial=0.0))

    def deviations(self):
        return self._dev_from_counts(self.counts)

    def counts_np(self, n: int) -> np.ndarray:
        """Dense per-OSD membership counts int64[n] (the host copy of the
        rows' histogram, bounded by max_osd)."""
        out = np.zeros(n, np.int64)
        k = min(n, len(self.counts))
        out[:k] = self.counts[:k]
        return out

    # -- membership query ------------------------------------------------
    def pgs_of(self, osd):
        """The PGs whose row holds `osd`, ascending (`torch.nonzero`
        returns indices in ascending order, as `jnp.nonzero` does)."""
        if osd in self._pgs_cache:
            return list(self._pgs_cache[osd])
        out: list[PgId] = []
        _L.inc("pgs_of_queries")
        with obs.span("balancer.pgs_of", osd=osd), _L.time("pgs_of_seconds"):
            for pid in sorted(self.rows):
                rows = self.rows[pid][:self.pg_num[pid]]
                idx = torch.nonzero((rows == osd).any(1))[:, 0].cpu()
                out.extend(PgId(pid, s) for s in idx.tolist())
        self._pgs_cache[osd] = out
        return list(out)

    # -- transactions ----------------------------------------------------
    def begin(self):
        return _DeviceTxn(self)

    def commit(self, txn: "_DeviceTxn"):
        _L.inc("txn_commits")
        for (pid, seed), swaps in txn.ops.items():
            row = self.rows[pid][seed]
            for frm, to in swaps:
                row = torch.where(row == frm, to, row)
            self.rows[pid][seed] = row
        for osd, delta in txn.delta.items():
            if 0 <= osd < self.max_osd:
                self.counts[osd] += delta
        touched = set(txn.delta)
        self._pgs_cache = {
            o: v for o, v in self._pgs_cache.items() if o not in touched
        }


class FlatDeviceState:
    """Every selected pool's membership rows in ONE [N, Wmax] int32
    tensor: the operand layout of the device_loop plan.

    Built from a DeviceState (so the rows come from where the "device"
    backend's do: rows_source, the per-pool mapper cache, the overlay
    fixups), then flattened: narrower pools pad their slot axis with
    ITEM_NONE.  The host keeps only O(pools) metadata (offsets, pool
    ids) for the one readback at the end of a plan."""

    def __init__(self, st: DeviceState):
        self.st = st
        self.pools: list[int] = sorted(st.rows)
        self.W = max(
            (int(st.rows[p].shape[1]) for p in self.pools), default=1
        )
        parts, pidx, offs = [], [], [0]
        for i, pid in enumerate(self.pools):
            n = st.pg_num[pid]
            rows = st.rows[pid][:n]
            if int(rows.shape[1]) < self.W:
                pad = torch.full((n, self.W - int(rows.shape[1])),
                                 ITEM_NONE, dtype=rows.dtype,
                                 device=rows.device)
                rows = torch.cat([rows, pad], 1)
            parts.append(rows)
            pidx.append(np.full(n, i, np.int32))
            offs.append(offs[-1] + n)
        self.n_total = int(offs[-1])
        self.rows = torch.cat(parts)
        self.pool_idx = np.concatenate(pidx)
        self.offsets = np.asarray(offs, np.int64)

    def locate(self, gidx: int) -> tuple[int, int]:
        """global PG index -> (pool_id, seed) for the readback."""
        pos = int(np.searchsorted(self.offsets, gidx, side="right")) - 1
        return self.pools[pos], int(gidx - self.offsets[pos])


class _DeviceTxn:
    def __init__(self, st: DeviceState):
        self.st = st
        self.delta: dict[int, int] = {}
        self.ops: dict[tuple[int, int], list[tuple[int, int]]] = {}

    def move(self, pg, frm, to):
        self.delta[frm] = self.delta.get(frm, 0) - 1
        self.delta[to] = self.delta.get(to, 0) + 1
        self.ops.setdefault((pg.pool, pg.seed), []).append((frm, to))

    def deviations(self):
        counts = self.st.counts.copy()
        for osd, d in self.delta.items():
            if 0 <= osd < self.st.max_osd:
                counts[osd] += d
        return self.st._dev_from_counts(counts)
