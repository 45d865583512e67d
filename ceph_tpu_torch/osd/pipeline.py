"""Batched PG→OSD pipeline: every PG of a pool through the placement stack.

The port of `ceph_tpu/osd/pipeline_jax.py` (reference src/osd/OSDMap.cc:
2435-2715):

    ps ──stable_mod──► pps ──crush_rule kernel──► raw ──upmap──► up ──►
        primary affinity ──► (up, up_primary) ──pg_temp──► (acting, acting_primary)

The rule runs in the hand-written kernel (`crush/csrc/crush_rule.cu`) on
the card, or in its plain version on the CPU (`crush.mapper.map_rule`).
Everything after it is torch ops on [N, W] rows (W = the pool's padded
width), the same on both devices, computed as `compile_pipeline` computes
it.  The sparse overrides (pg_upmap, pg_upmap_items, pg_temp,
primary_temp) become dense per-PG tensors, uploaded once per mapper.

Results equal `OSDMap.pg_to_up_acting_osds` of the JAX package for every
PG, padded to the width with ITEM_NONE (tests/test_torch_pipeline.py).

`PoolMapper.diagnose` runs stages 1-2 through the rule kernel's
diagnostics variant (`crush.mapper.diag_rule`) and reduces its decision
planes on the device to the JAX package's placement-diagnostics summary.

The mapper books the JAX package's `pipeline` perf group (`pgs_mapped`,
`map_block_seconds`: the host time of one block's enqueue) and spans
(`pipeline.map_block`, `pipeline.diagnose`, `pipeline.fetch`).  Every
lane is exact, so `unresolved_pgs` and `rescue_invocations` stay 0: the
kernel has no fast window to rescue from.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ceph_tpu_torch import obs
from ceph_tpu_torch.core import reduce
from ceph_tpu_torch.core.intmath import pg_mask_for, stable_mod
from ceph_tpu_torch.core.rjenkins import M32, crush_hash32_2
from ceph_tpu_torch.crush.mapper import (
    BLOCK,
    compile_rule,
    diag_rule,
    find_rule,
    map_rule,
)
from ceph_tpu_torch.crush.soa import build_arrays, to_device
from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.osd.osdmap import (
    DEFAULT_PRIMARY_AFFINITY,
    MAX_PRIMARY_AFFINITY,
    OSDMap,
)
from ceph_tpu_torch.osd.types import FLAG_HASHPSPOOL, PgId

_L = obs.logger_for("pipeline")
_L.add_u64("pgs_mapped",
           "placement seeds mapped through the batched pipeline")
_L.add_u64("unresolved_pgs",
           "fast-window inconclusive lanes (exact-loop rescued)")
_L.add_u64("rescue_invocations", "loop-kernel rescue passes")
_L.add_quantile("map_block_seconds",
                "per-block map_block dispatch wall-time distribution "
                "(host enqueue time of the block's kernel launches and "
                "torch ops; p50/p99 in the dump)")


@dataclass(frozen=True)
class PoolSpec:
    """The per-pool parameters of the pipeline."""

    pool_id: int
    size: int
    pg_num: int
    pgp_num: int
    can_shift: bool  # replicated pools compact; EC pools are positional
    hashpspool: bool
    ruleno: int
    max_osd: int  # OSDMap::max_osd (exists/upmap id bound)
    out_width: int  # padded output width (>= size)

    @classmethod
    def for_pool(
        cls, m: OSDMap, pool_id: int, extra_width: int = 0
    ) -> "PoolSpec":
        pool = m.pools[pool_id]
        ruleno = find_rule(
            m.crush, pool.crush_rule, int(pool.type), pool.size
        )
        return cls(
            pool_id=pool_id,
            size=pool.size,
            pg_num=pool.pg_num,
            pgp_num=pool.pgp_num,
            can_shift=pool.can_shift_osds(),
            hashpspool=bool(pool.flags & FLAG_HASHPSPOOL),
            ruleno=ruleno,
            max_osd=m.max_osd,
            out_width=max(pool.size, extra_width),
        )


@dataclass
class Overlays:
    """Dense per-PG override arrays for one pool ([N = pg_num] rows).
    A pool without an override has None in its fields."""

    upmap_full: np.ndarray | None = None  # [N, Wu] i32, NONE-padded
    upmap_len: np.ndarray | None = None  # [N] i32 (0 = no entry)
    upmap_pairs: np.ndarray | None = None  # [N, P, 2] i32, NONE-padded
    temp: np.ndarray | None = None  # [N, Wt] i32, NONE-padded
    temp_len: np.ndarray | None = None  # [N] i32 (-1 = no entry)
    primary_temp: np.ndarray | None = None  # [N] i32 (-1 = none)

    @property
    def any(self) -> bool:
        return any(v is not None for v in vars(self).values())

    @property
    def extra_width(self) -> int:
        w = 0
        if self.upmap_full is not None:
            w = max(w, self.upmap_full.shape[1])
        if self.temp is not None:
            w = max(w, self.temp.shape[1])
        return w


def build_overlays(m: OSDMap, pool_id: int) -> Overlays:
    """Freeze the sparse override dicts into dense per-PG arrays."""
    pool = m.pools[pool_id]
    n = pool.pg_num
    ov = Overlays()

    full = {
        pg.seed: v
        for pg, v in m.pg_upmap.items()
        if pg.pool == pool_id and pg.seed < n
    }
    if full:
        w = max(len(v) for v in full.values())
        ov.upmap_full = np.full((n, w), ITEM_NONE, np.int32)
        ov.upmap_len = np.zeros(n, np.int32)
        for s, v in full.items():
            ov.upmap_full[s, : len(v)] = v
            ov.upmap_len[s] = len(v)

    items = {
        pg.seed: v
        for pg, v in m.pg_upmap_items.items()
        if pg.pool == pool_id and pg.seed < n
    }
    if items:
        p = max(len(v) for v in items.values())
        ov.upmap_pairs = np.full((n, p, 2), ITEM_NONE, np.int32)
        for s, v in items.items():
            for j, (frm, to) in enumerate(v):
                ov.upmap_pairs[s, j] = (frm, to)

    temps = {
        pg.seed: v
        for pg, v in m.pg_temp.items()
        if pg.pool == pool_id and pg.seed < n
    }
    if temps:
        w = max((len(v) for v in temps.values()), default=1) or 1
        ov.temp = np.full((n, w), ITEM_NONE, np.int32)
        ov.temp_len = np.full(n, -1, np.int32)
        for s, v in temps.items():
            ov.temp[s, : len(v)] = v
            ov.temp_len[s] = len(v)

    prim = {
        pg.seed: v
        for pg, v in m.primary_temp.items()
        if pg.pool == pool_id and pg.seed < n
    }
    if prim:
        ov.primary_temp = np.full(n, -1, np.int32)
        for s, v in prim.items():
            ov.primary_temp[s] = v
    return ov


def _pad_lanes(v: torch.Tensor, width: int) -> torch.Tensor:
    n = v.shape[1]
    if n >= width:
        return v[:, :width]
    pad = torch.full((v.shape[0], width - n), ITEM_NONE, dtype=v.dtype,
                     device=v.device)
    return torch.cat([v, pad], 1)


def _compact(v: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Stable left-compaction of the kept lanes of each row, NONE-padded
    (the vector `erase` loops of reference src/osd/OSDMap.cc:2416-2427,
    2516-2522).  The dropped lanes go to a spare column."""
    N, W = v.shape
    idx = keep.long().cumsum(1) - 1
    out = torch.full((N, W + 1), ITEM_NONE, dtype=v.dtype, device=v.device)
    out.scatter_(1, torch.where(keep, idx, W),
                 torch.where(keep, v, ITEM_NONE))
    return out[:, :W]


def _first_index(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first true lane of each row, or the width if none."""
    col = torch.arange(mask.shape[1], device=mask.device)
    return torch.where(mask, col, mask.shape[1]).amin(1)


def _pick(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return v.gather(1, i.clamp(0, v.shape[1] - 1)[:, None])[:, 0]


def first_not_none(v: torch.Tensor) -> torch.Tensor:
    """_pick_primary (reference src/osd/OSDMap.cc:2455-2463)."""
    i = _first_index(v != ITEM_NONE)
    return torch.where(i < v.shape[1], _pick(v, i), -1)


class PoolMapper:
    """Batched mapper for one pool of one OSDMap, on one device.

    Usage:
        pm = PoolMapper(osdmap, pool_id)            # on the card
        up, up_primary, acting, acting_primary = pm.map_all()

    `device=None` means the card (`device.resolve_device`): without one
    the constructor raises, unless the caller passes device="cpu", which
    runs the rule's plain version.  The map's CRUSH arrays, the per-OSD
    vectors and the overlays are uploaded once here; `refresh_dev`
    re-reads the per-OSD vectors after the map's OSD state changes.
    With `overlays=False` no overlay is frozen or uploaded: the mapper
    maps the map as if it had none (the balancer's and `map_all_device`'s
    form; callers scatter in `overlay_fixup_rows`).

    `state` (an `osd.state.ClusterState` of `m`) makes the mapper the
    state's: it runs on the state's device, takes the state's tables of
    its choose_args group and reads the state's per-OSD vectors, and
    uploads nothing of its own; `refresh_dev` rebinds the vectors.  It
    always runs the primary-affinity stage (on an all-default vector it
    changes nothing), so a first affinity delta is an operand update.
    """

    def __init__(self, m: OSDMap, pool_id: int, device=None,
                 overlays: bool = True, state=None):
        self._state = state
        self.device = (state.device if state is not None
                       else resolve_device(device))
        self.m = m
        self.pool_id = pool_id
        if state is not None:
            self.arrays = state.arrays_for(pool_id)
        else:
            ca = m.crush.choose_args.get(pool_id,
                                         m.crush.choose_args.get(-1))
            self.arrays = build_arrays(m.crush, ca)
        self.ov = build_overlays(m, pool_id) if overlays else Overlays()
        self.spec = PoolSpec.for_pool(
            m, pool_id, extra_width=self.ov.extra_width
        )
        self.prog = (compile_rule(self.arrays, self.spec.ruleno,
                                  self.spec.size)
                     if self.spec.ruleno >= 0 else None)
        self.tables = (state.device_tables_for(pool_id)
                       if state is not None
                       else to_device(self.arrays, self.device))
        self._ov = {k: torch.from_numpy(v).long().to(self.device)
                    for k, v in vars(self.ov).items() if v is not None}
        self.with_primary_affinity = (m.osd_primary_affinity is not None
                                      or state is not None)
        self.refresh_dev()

    def refresh_dev(self) -> None:
        """(Re)upload the padded per-OSD vectors from the map's current
        osd state, weight and primary affinity; a state's mapper rebinds
        the state's vectors instead."""
        if self._state is not None:
            self.dev = self._state.vectors
            return
        dv = self.m.frozen_vectors()
        DV = max(self.arrays.max_devices, self.m.max_osd, 1)

        def put(v, fill, dtype):
            v = np.asarray(v)[:DV]
            v = np.concatenate([v, np.full(DV - len(v), fill, v.dtype)])
            return torch.from_numpy(v).to(dtype).to(self.device)

        self.dev = {
            "exists": put(dv["exists"], False, torch.bool),
            "up": put(dv["up"], False, torch.bool),
            "weight": put(dv["weight"].astype(np.int64), 0, torch.long),
            "primary_affinity": put(
                dv["primary_affinity"].astype(np.int64),
                DEFAULT_PRIMARY_AFFINITY, torch.long),
        }

    def _seeds(self, ps) -> torch.Tensor:
        ps = torch.as_tensor(np.asarray(ps, np.int64)).to(self.device)
        if self.ov.any and ps.numel() and not (
                0 <= int(ps.min()) and int(ps.max()) < self.spec.pg_num):
            raise ValueError(f"placement seeds outside [0, "
                             f"{self.spec.pg_num}) with overlays")
        return ps

    def _osd_ok(self, v: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
        """valid OSDMap id with tbl true (exists()/is_up() lookups)."""
        return ((v >= 0) & (v < self.spec.max_osd)
                & tbl[v.clamp(0, tbl.numel() - 1)])

    def placement_seeds(self, ps: torch.Tensor) -> torch.Tensor:
        """Stage 1: the seeds fed to CRUSH, u32 values in int64
        (reference src/osd/osd_types.cc:1798-1814)."""
        spec = self.spec
        ps2 = stable_mod(ps.long() & M32, spec.pgp_num,
                         pg_mask_for(spec.pgp_num))
        pid = spec.pool_id & M32
        if spec.hashpspool:
            return crush_hash32_2(ps2, pid)
        return (ps2 + pid) & M32

    def rule_weights(self) -> torch.Tensor:
        """The OSD reweights the rule reads (the first max_devices)."""
        return self.dev["weight"][:self.arrays.max_devices]

    def _raw(self, ps: torch.Tensor):
        """Stages 1-2 and _remove_nonexistent_osds: (pps, raw [N, W])."""
        W = self.spec.out_width
        pps = self.placement_seeds(ps)
        # -- stage 2: CRUSH (reference src/osd/OSDMap.cc:2444-2447)
        if self.prog is None:
            raw = torch.full((ps.numel(), W), ITEM_NONE, dtype=torch.long,
                             device=ps.device)
        else:
            raw = _pad_lanes(map_rule(self.tables, self.prog, pps,
                                      self.rule_weights()).long(), W)
        # -- _remove_nonexistent_osds (reference src/osd/OSDMap.cc:2412)
        ok = self._osd_ok(raw, self.dev["exists"])
        if self.spec.can_shift:
            raw = _compact(raw, ok)
        else:
            raw = torch.where(ok | (raw == ITEM_NONE), raw, ITEM_NONE)
        return pps, raw

    def _up(self, ps: torch.Tensor, ov: dict):
        """Stages 1-5: (up, up_primary) tensors for seeds ps, with the
        upmap overlays of `ov` (the mapper's dense overlays at ps)."""
        spec = self.spec
        W = spec.out_width
        lane = torch.arange(W, device=ps.device)
        weight = self.dev["weight"]
        upb = self.dev["up"]
        pps, raw = self._raw(ps)

        # -- stage 3: upmap (reference src/osd/OSDMap.cc:2465-2509)
        def marked_out(v):
            """the reject guard: valid id AND weight 0 (OSDMap.cc:2472,2496)."""
            return ((v != ITEM_NONE) & (v >= 0) & (v < spec.max_osd)
                    & (weight[v.clamp(0, weight.numel() - 1)] == 0))

        # a pg_upmap entry with an out target aborts the whole _apply_upmap
        # (the early `return` at reference src/osd/OSDMap.cc:2474), skipping
        # pg_upmap_items as well
        aborted = torch.zeros_like(ps, dtype=torch.bool)
        if "upmap_full" in ov:
            row, rl = ov["upmap_full"], ov["upmap_len"]
            lane_u = torch.arange(row.shape[1], device=ps.device)
            bad = (marked_out(row) & (lane_u < rl[:, None])).any(1)
            aborted = (rl > 0) & bad
            ok = (rl > 0) & ~bad
            repl = torch.where(lane < rl[:, None], _pad_lanes(row, W),
                               ITEM_NONE)
            raw = torch.where(ok[:, None], repl, raw)
        if "upmap_pairs" in ov:
            pairs = ov["upmap_pairs"]
            for j in range(pairs.shape[1]):
                frm, to = pairs[:, j, 0], pairs[:, j, 1]
                present = (raw == to[:, None]).any(1)
                match = (raw == frm[:, None]) & ~marked_out(to)[:, None]
                pos = _first_index(match)
                do = (frm != ITEM_NONE) & ~present & (pos < W) & ~aborted
                raw = torch.where(do[:, None] & (lane == pos[:, None]),
                                  to[:, None], raw)

        # -- stage 4: raw → up (reference src/osd/OSDMap.cc:2512-2535)
        alive = self._osd_ok(raw, upb)
        if spec.can_shift:
            up = _compact(raw, alive)
        else:
            up = torch.where(alive, raw, ITEM_NONE)
        up_primary = first_not_none(up)

        # -- stage 5: primary affinity (reference src/osd/OSDMap.cc:2537)
        if self.with_primary_affinity:
            aff = self.dev["primary_affinity"]
            nonnone = up != ITEM_NONE
            a = aff[up.clamp(0, aff.numel() - 1)]
            gate = (nonnone & (a != DEFAULT_PRIMARY_AFFINITY)).any(1)
            h = crush_hash32_2(pps[:, None], up) >> 16
            accepted = nonnone & ~((a < MAX_PRIMARY_AFFINITY) & (h >= a))
            first_acc = _first_index(accepted)
            first_any = _first_index(nonnone)
            pos = torch.where(first_acc < W, first_acc,
                              torch.where(first_any < W, first_any, -1))
            do = gate & (pos >= 0)
            new_primary = torch.where(do, _pick(up, pos), up_primary)
            if spec.can_shift:
                prev = torch.cat([up[:, :1], up[:, :-1]], 1)
                shifted = torch.where((lane > 0) & (lane <= pos[:, None]),
                                      prev, up)
                shifted[:, 0] = new_primary
                up = torch.where((do & (pos > 0))[:, None], shifted, up)
            up_primary = new_primary
        return up, up_primary

    def _rows(self, ps: torch.Tensor):
        """(up, up_primary, acting, acting_primary) tensors for seeds ps."""
        spec = self.spec
        W = spec.out_width
        lane = torch.arange(W, device=ps.device)
        upb = self.dev["up"]
        ov = {k: v[ps] for k, v in self._ov.items()}
        up, up_primary = self._up(ps, ov)

        # -- pg_temp / primary_temp (reference src/osd/OSDMap.cc:2592)
        acting, acting_primary = up, up_primary
        pt = ov.get("primary_temp")
        if pt is None:
            pt = torch.full_like(up_primary, -1)
        if "temp" in ov:
            trow = _pad_lanes(ov["temp"], W)
            tlen = ov["temp_len"]
            in_row = lane < tlen[:, None]
            t_alive = self._osd_ok(trow, upb) & in_row
            if spec.can_shift:
                filt = _compact(trow, t_alive)
                t_n = t_alive.sum(1)
            else:
                filt = torch.where(t_alive, trow, ITEM_NONE)
                t_n = tlen.clamp(min=0)
            t_primary = torch.where(pt >= 0, pt, first_not_none(filt))
            use_temp = (tlen >= 0) & (t_n > 0)
            acting = torch.where(use_temp[:, None], filt, up)
            acting_primary = torch.where(
                use_temp, t_primary, torch.where(pt >= 0, pt, up_primary))
        else:
            acting_primary = torch.where(pt >= 0, pt, up_primary)
        return up, up_primary, acting, acting_primary

    def _map_block(self, ps: torch.Tensor, **span_args):
        """_rows(ps) as one accounted block (dispatch only: no host
        sync inside the span)."""
        n = ps.numel()
        with obs.span("pipeline.map_block", pgs=n, **span_args), \
                _L.time("map_block_seconds"):
            out = tuple(t.to(torch.int32) for t in self._rows(ps))
        _L.inc("pgs_mapped", n)
        return out

    def map_batch(self, ps):
        """Map a batch of placement seeds.  Returns numpy int32
        (up[N,W], up_primary[N], acting[N,W], acting_primary[N])."""
        return obs.timed_fetch(_L, "result", self._map_block(self._seeds(ps)))

    def map_all(self):
        """`map_batch` of every PG of the pool."""
        return tuple(t.cpu().numpy() for t in self.map_all_tensors())

    def map_all_tensors(self):
        """(up, up_primary, acting, acting_primary) of every PG of the
        pool, int32 tensors left on the mapper's device."""
        ps = torch.arange(self.spec.pg_num, device=self.device)
        return self._map_block(ps, device_resident=True)

    def map_all_device(self) -> torch.Tensor:
        """`up` rows [pg_num, W] of every PG of the pool, as an int32
        tensor left on the mapper's device, without the overlays: a
        mapper that froze some raises (build it with overlays=False;
        callers scatter in `overlay_fixup_rows`, as the JAX package's
        callers do)."""
        if self.ov.any:
            raise ValueError("map_all_device is an overlay-free path: "
                             "build the PoolMapper with overlays=False")
        ps = torch.arange(self.spec.pg_num, device=self.device)
        with obs.span("pipeline.map_block", pgs=ps.numel(),
                      device_resident=True), _L.time("map_block_seconds"):
            up = self._up(ps, {})[0].to(torch.int32)
        _L.inc("pgs_mapped", ps.numel())
        return up

    def raw_rows(self, seeds) -> np.ndarray:
        """The rows before the overlays, [K, out_width] int32 numpy:
        equal to `OSDMap._pg_to_raw_osds` (descent + nonexistent-OSD
        removal), NONE-padded."""
        ps = self._seeds(seeds)
        with obs.span("pipeline.map_block", pgs=ps.numel(), raw=True):
            raw = self._raw(ps)[1].to(torch.int32)
        with obs.span("pipeline.fetch"):
            return raw.cpu().numpy()

    def diagnose(self, ps=None, source: str | None = None,
                 record: bool = True) -> dict:
        """Run the rule's diagnostics over the placement seeds of `ps`
        (default: every PG) and reduce the per-PG decision planes on the
        device into the JAX package's placement-diagnostics summary: the
        per-placement retry histogram (the reference collect_choose_tries
        shape), collision / out-of-weight-rejection / skip tallies, the
        bad mappings (CRUSH rows shorter than the pool size) and the
        placements that ran out of retries.  Only the O(tries bound)
        histogram and five sums are fetched, never the planes.  Every
        lane is exact: `diag_exact` is True and `unresolved` 0.

        The summary lands in `obs.placement` (source `source`, default
        "pool<id>") with this mapper's explainer unless record=False."""
        from ceph_tpu_torch.obs import placement

        PL = obs.logger_for("placement")

        if ps is None:
            ps = torch.arange(self.spec.pg_num, device=self.device)
        else:
            ps = self._seeds(ps)
        n = ps.numel()
        prog = self.prog
        bound = min(prog.diag_tries_bound if prog else 0,
                    len(placement.TRIES_BOUNDS) - 1)
        hist = torch.zeros(bound + 1, dtype=torch.long, device=self.device)
        sums = torch.zeros(5, dtype=torch.long, device=self.device)
        if prog is not None:
            retry = torch.from_numpy(prog.diag_retry_lanes).to(self.device)
            for i in range(0, n, BLOCK):
                with obs.span("pipeline.diagnose",
                              pgs=min(BLOCK, n - i)), \
                        PL.time("diagnose_seconds"):
                    pps = self.placement_seeds(ps[i:i + BLOCK])
                    _, dg = diag_rule(self.tables, prog, pps,
                                      self.rule_weights())
                hist += reduce.value_histogram(dg["tries"], bound)
                sums += torch.stack([
                    dg["coll"].long().sum(), dg["rej"].long().sum(),
                    dg["skip"].long().sum(), dg["bad"].long().sum(),
                    ((dg["tries"] < 0) & retry).sum()])
        else:  # no rule: every PG trivially bad, nothing decided
            sums[3] = n
        with obs.span("pipeline.fetch"):
            hist_v = hist.cpu().tolist()
            coll, rej, skip, bad, exhausted = sums.cpu().tolist()
        summary = {
            "pgs": n,
            "pool_id": self.pool_id,
            "tries_histogram": hist_v,
            "tries_bound": bound,
            "diag_exact": True,
            "diag_lanes": prog.diag_lanes if prog else 0,
            "collisions": coll,
            "rejections": rej,
            "skips": skip,
            "bad_mappings": bad,
            "retry_exhausted": exhausted,
            "unresolved": 0,
        }
        if record:
            placement.record(source or f"pool{self.pool_id}", summary)
            placement.register_explainer(f"pool{self.pool_id}",
                                         self._explain_seed)
        return summary

    def _explain_seed(self, seed: int) -> dict:
        """Host-oracle replay of one placement seed of this pool (the
        `placement.explain("<pool>.<seed>")` payload)."""
        from ceph_tpu_torch.crush.explain import explain_pool_pg

        return explain_pool_pg(self.m, self.pool_id, seed)


def overlay_fixup_rows(m: OSDMap, pool_id: int, width: int):
    """Host-exact `up` rows for the PGs of `pool_id` that carry a
    pg_upmap / pg_upmap_items entry: (seeds int64[K], rows int32[K,
    width]), both empty when the pool has none.  The overlay-free paths
    (`map_all_device` of a mapper built with overlays=False, and the
    balancer's membership builds) scatter these few rows of the host
    pipeline in, equal to what the overlay stages compute."""
    n = m.pools[pool_id].pg_num
    seeds = sorted({
        pg.seed for pg in list(m.pg_upmap) + list(m.pg_upmap_items)
        if pg.pool == pool_id and pg.seed < n
    })
    rows = np.full((len(seeds), width), ITEM_NONE, np.int32)
    for i, s in enumerate(seeds):
        up, _, _, _ = m.pg_to_up_acting_osds(PgId(pool_id, s))
        rows[i, : min(len(up), width)] = up[:width]
    return np.asarray(seeds, np.int64), rows


def map_cluster(m: OSDMap, device=None) -> dict[int, tuple]:
    """Map every pool; returns {pool_id: (up, up_primary, acting,
    acting_primary)}, the batched equivalent of the osdmaptool
    --test-map-pgs loop (reference src/tools/osdmaptool.cc:630-755)."""
    return {pid: PoolMapper(m, pid, device=device).map_all()
            for pid in sorted(m.pools)}
