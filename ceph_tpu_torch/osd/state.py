"""One device-resident ClusterState: O(delta) Incremental apply on the card.

The port of `ceph_tpu/osd/state.py`.  One object owns a map's device
operands and is shared by the mapper, the balancer and the mgr:

- **the host truth**: the mutable `OSDMap`, advanced by
  `osd.incremental.apply_incremental` (the monitor's epoch chain);
- **device operands**: the per-OSD exists/up/weight/primary-affinity
  vectors (one padded set for every pool) and, per choose_args group, the
  map's `DeviceArrays` (the rule kernel's packed records and headers, and
  the padded fields its plain version reads), each uploaded once per
  structure;
- **result caches**: per-pool `up` rows on the device and the raw rows of
  the overlay-carrying PGs, tagged with version counters, so a consumer
  can tell that nothing feeding a pool's mapping changed without any
  device work.

`ClusterState.apply(inc)` classifies each epoch delta
(`classify_incremental`):

- **value-only deltas** (reweights, osd up/down/destroy, primary
  affinity, pg_upmap / pg_temp entries, choose_args weight changes in a
  structurally equal crush blob) change the device operands in O(delta):
  the four OSD vectors take one `index_copy_` each of a 32-lane block
  (lanes past the delta point at a spare slot, index DV, that no mapper
  reads), overlay entries are host-dict updates whose device cost is the
  O(overlay) fixup of the next `rows`, and choose_args changes re-upload
  the weight-set planes and the packed records of the cached tables.
- **structural changes** (bucket add/remove, pg_num splits, rule edits,
  max_osd growth) rebuild the operands, and `full_rebuilds` counts it.

Overlay fixups take the raw rows of the overlay PGs from the rule kernel
(`PoolMapper.raw_rows`, equal to `OSDMap._pg_to_raw_osds`), refetched only
when a descent input changed, and replay the cheap host steps (upmap, the
up filter, primary affinity) on those few rows.

It books the JAX package's `state` perf group (`COUNTERS` reads its
seven counts) and spans (`state.apply`, `state.rebuild`, `state.rows`,
`state.raw_fixup`).
CEPH_TPU_STATE_DELTA=0 in the environment makes every apply rebuild: the
A/B lever of the delta-versus-rebuild tests.

Not ported: the loop kernel's rescue-tier warm-up (the rule kernel is
exact and has no tiers) and the deferred re-key after a lost device (a
device error raises).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ceph_tpu_torch import obs
from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.osd.incremental import Incremental, apply_incremental
from ceph_tpu_torch.osd.osdmap import (
    DEFAULT_PRIMARY_AFFINITY,
    OSD_EXISTS,
    OSD_UP,
    OSDMap,
)
from ceph_tpu_torch.osd.types import PgId
from ceph_tpu_torch.parallel.sharded import mesh_for
from ceph_tpu_torch.runtime import faults
from ceph_tpu_torch.utils import knobs
from ceph_tpu_torch.utils.perf_counters import counters_attr

# the JAX package's `state` perf group (device_put_bytes: a delta counts
# its scatter block, a rebuild its vectors and tables; raw_refreshes: one
# rule launch each)
_L = obs.logger_for("state")
_L.add_u64("delta_applies",
           "value-only Incrementals applied in O(delta) on device "
           "(scatter into the resident operand tables, no re-key)")
_L.add_u64("full_rebuilds",
           "structural (or forced) rebuilds: CRUSH arrays rebuilt, "
           "operand tables re-uploaded, mappers reconstructed")
_L.add_u64("device_put_bytes",
           "host->device bytes moved by state maintenance (delta: the "
           "scatter index/value blocks; rebuild: the full tables)")
_L.add_u64("rows_served",
           "rows() calls answered from the version-tagged cache")
_L.add_u64("rows_remapped",
           "rows() calls that re-dispatched the pool mapping")
_L.add_u64("raw_refreshes",
           "raw-kernel refreshes of overlay-carrying PGs' descent rows")
_L.add_u64("value_forks",
           "value-only forks (shared structure, copied value operands)")
_L.add_quantile("apply_seconds", "ClusterState.apply wall time")
_KEYS = ("delta_applies", "full_rebuilds", "device_put_bytes",
         "rows_served", "rows_remapped", "raw_refreshes", "value_forks")
__getattr__ = counters_attr("state", __name__, _KEYS)

_DELTA_PAD = 32  # scatter index blocks pad to multiples of this
_HOST_UP_MEMO = 4096  # host_up's memo of host descents, cleared when full


def _inc(name: str, n: int = 1) -> None:
    _L.inc(name, int(n))


# ----------------------------------------------------------- classification


def _crush_value_delta(old, new) -> bool:
    """True when `new` differs from `old` only in choose_args weight-set
    VALUES (same buckets, rules, tunables, ids and shapes): the delta is
    a weight-set upload, not a re-key.  Any other difference is
    structural."""
    from ceph_tpu_torch.crush.soa import build_arrays

    try:
        a = build_arrays(old, None)
        b = build_arrays(new, None)
    except Exception:
        return False
    if a.tunables != b.tunables or a.rules != b.rules:
        return False
    for f in ("alg", "btype", "size", "bucket_weight", "items",
              "weights", "sum_weights", "straws", "node_weights",
              "num_nodes", "arg_ids"):
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            return False
    if sorted(old.choose_args) != sorted(new.choose_args):
        return False
    for key, ca_new in new.choose_args.items():
        ca_old = old.choose_args[key]
        if sorted(ca_old.ids) != sorted(ca_new.ids) or any(
                list(ca_old.ids[k]) != list(ca_new.ids[k])
                for k in ca_new.ids):
            return False
        if sorted(ca_old.weight_sets) != sorted(ca_new.weight_sets):
            return False
        for bid, rows in ca_new.weight_sets.items():
            rows_old = ca_old.weight_sets[bid]
            if len(rows) != len(rows_old) or any(
                    len(r) != len(ro) for r, ro in zip(rows, rows_old)):
                return False
    return True


def classify_incremental(inc: Incremental, m: OSDMap):
    """Classify one epoch delta against the current (pre-apply) map.

    Returns ("delta", info) for a value-only Incremental: the changed OSD
    ids (`osds`), whether the vectors change (`vec`), whether a descent
    input changed (`raw`), whether the choose_args planes changed
    (`pos_weights`), the pools whose upmap entries changed
    (`upmap_pools`) and the pools dropped (`dropped_pools`).  Returns
    ("rebuild", None) for a structural change."""
    if inc.fullmap or inc.new_max_osd >= 0:
        return "rebuild", None
    if any(pid in m.pools for pid in inc.new_pools):
        # changing an existing pool (pg_num split, size) re-keys it; a new
        # pool is value-only: its caches build on first use
        return "rebuild", None
    pos_weights = False
    if inc.crush:
        from ceph_tpu_torch.crush.codec import decode_crushmap

        try:
            new_crush = decode_crushmap(inc.crush)
        except Exception:
            return "rebuild", None
        if not _crush_value_delta(m.crush, new_crush):
            return "rebuild", None
        pos_weights = True
    # a first primary-affinity table (or a destroy resetting affinity) is
    # value-only: state-shared mappers always run the affinity stage
    osds = (set(inc.new_state) | set(inc.new_weight)
            | set(inc.new_primary_affinity) | set(inc.new_up_client))
    if any(o < 0 or o >= m.max_osd for o in osds):
        return "rebuild", None
    raw = bool(inc.new_weight) or bool(inc.new_up_client) or pos_weights
    for osd, s in inc.new_state.items():
        s = s or OSD_UP
        if s & OSD_EXISTS:
            # the EXISTS bit flips either way (destroy clears it, the XOR
            # of a revival sets it): the descent's nonexistent-OSD removal
            # changed, so the raw caches are stale
            raw = True
    pools = {pg.pool for src in (inc.new_pg_upmap, inc.old_pg_upmap,
                                 inc.new_pg_upmap_items,
                                 inc.old_pg_upmap_items) for pg in src}
    return "delta", {
        "osds": osds,
        "vec": bool(osds) or pos_weights,
        "raw": raw,
        "pos_weights": pos_weights,
        "upmap_pools": pools,
        "dropped_pools": set(inc.old_pools),
    }


def value_copy_map(m: OSDMap) -> OSDMap:
    """O(OSDs + entries) copy of a map that a value-only Incremental chain
    may then change: the crush tree and PgPool objects are shared (value
    deltas replace, never mutate, them), the per-OSD lists and overlay
    dicts are copied."""
    new = OSDMap.__new__(OSDMap)
    new.epoch = m.epoch
    new.crush = m.crush
    new.max_osd = m.max_osd
    new.osd_state = list(m.osd_state)
    new.osd_weight = list(m.osd_weight)
    new.osd_primary_affinity = (
        None if m.osd_primary_affinity is None
        else list(m.osd_primary_affinity))
    new.pools = dict(m.pools)
    new.pool_name = dict(m.pool_name)
    new.pool_max = m.pool_max
    new.pg_temp = dict(m.pg_temp)
    new.primary_temp = dict(m.primary_temp)
    new.pg_upmap = dict(m.pg_upmap)
    new.pg_upmap_items = dict(m.pg_upmap_items)
    new.erasure_code_profiles = {
        k: dict(v) for k, v in m.erasure_code_profiles.items()}
    wire = getattr(m, "wire", None)
    if wire is not None:
        new.wire = dict(wire)
    return new


def _u32_on(v: np.ndarray, device) -> torch.Tensor:
    """u32 values uploaded as their int32 bit patterns (4 bytes each),
    widened to int64 on the device."""
    t = torch.from_numpy(np.ascontiguousarray(v, np.uint32).view(np.int32))
    return t.to(device).long() & 0xFFFFFFFF


def _tables_nbytes(T) -> int:
    return sum(v.numel() * v.element_size() for v in vars(T).values()
               if isinstance(v, torch.Tensor))


# ------------------------------------------------------------- ClusterState


class ClusterState:
    """The device-resident cluster state (module docstring).

    - `mapper(pid)`: the overlay-free PoolMapper of a pool, sharing this
      state's tables and vectors;
    - `rows(pid)`: the pool's `up` rows on the device, overlay PGs
      corrected, with a structure key and a version tag;
    - `apply(inc)`: advance the host map and the device operands;
    - `fork(inc)`: a new state one value-only epoch ahead, sharing every
      table with this one.

    `device` (None: the card; "cpu" runs the rule's plain version) is
    where the operands live."""

    def __init__(self, m: OSDMap, device=None, mesh=None):
        # PG-axis device mesh: None resolves the CEPH_TPU_MESH_DEVICES
        # knob on a card (parallel.sharded.default_mesh); every mapper of
        # this state splits its launches over it (PoolMapper(mesh=...))
        self.device, self.mesh = mesh_for(device, mesh)
        self._pending_rebuild = False
        self.m = m
        self.delta_enabled = knobs.get("CEPH_TPU_STATE_DELTA", "1") != "0"
        self._vec_ver = 0
        self._raw_ver = 0
        self._overlay_ver: dict[int, int] = {}
        self.full_rebuilds = 0  # per instance (the group is per process)
        self.delta_applies = 0
        self._build()

    # -- build / rebuild ---------------------------------------------------

    def _build(self) -> None:
        with obs.span("state.rebuild", epoch=self.m.epoch):
            self._build_inner()

    def _build_inner(self) -> None:
        self._pending_rebuild = False
        _inc("full_rebuilds")
        self.full_rebuilds += 1
        self._arrays: dict = {}   # ca_key -> CrushArrays
        self._tables: dict = {}   # ca_key -> DeviceArrays
        self._mappers: dict = {}  # pid -> PoolMapper
        self._base: dict = {}     # pid -> (vec_ver, rows, skey)
        self._rows: dict = {}     # pid -> (tag, rows, skey)
        self._fix: dict = {}      # pid -> (fix_tag, {seed: row})
        self._raw: dict = {}      # pid -> (key, np rows)
        self._oracle: dict = {}   # (pid, seed) -> (raw_ver, raw, pps)
        self._vec_ver += 1
        self._raw_ver += 1
        for pid in list(self._overlay_ver):
            self._overlay_ver[pid] += 1
        self._upload_vectors()

    def _ca_key(self, pid: int):
        ca = self.m.crush.choose_args
        if pid in ca:
            return pid
        return -1 if -1 in ca else None

    def arrays_for(self, pid: int):
        """The CrushArrays of this pool's choose_args group, built once
        per group per structure."""
        from ceph_tpu_torch.crush.soa import build_arrays

        key = self._ca_key(pid)
        A = self._arrays.get(key)
        if A is None:
            A = self._arrays[key] = build_arrays(
                self.m.crush, self.m.crush.choose_args.get(key))
        return A

    def device_tables_for(self, pid: int):
        """The DeviceArrays of this pool's choose_args group, uploaded
        once per structure and shared by every pool of the group."""
        from ceph_tpu_torch.crush.soa import to_device

        key = self._ca_key(pid)
        T = self._tables.get(key)
        if T is None:
            T = self._tables[key] = to_device(self.arrays_for(pid),
                                              self.device)
            _inc("device_put_bytes", _tables_nbytes(T))
        return T

    @property
    def DV(self) -> int:
        """The per-OSD vectors' length: the next power of two of the
        device bound (floor 32).  The buffers hold one more slot, index
        DV, where a scatter block's unused lanes land."""
        n = max(self.m.crush.max_devices, self.m.max_osd, 1)
        return 1 << max(int(n - 1).bit_length(), 5)

    def _upload_vectors(self) -> None:
        dv = self.m.frozen_vectors()
        n = self.DV + 1

        def pad(v, fill):
            v = np.asarray(v)[:n]
            v = np.concatenate([v, np.full(n - v.shape[0], fill, v.dtype)])
            _inc("device_put_bytes", v.nbytes)
            return v

        self._vec_buf = {
            "exists": torch.from_numpy(pad(dv["exists"], False)).to(
                self.device),
            "up": torch.from_numpy(pad(dv["up"], False)).to(self.device),
            "weight": _u32_on(pad(dv["weight"], 0), self.device),
            "primary_affinity": _u32_on(
                pad(dv["primary_affinity"], DEFAULT_PRIMARY_AFFINITY),
                self.device),
        }

    @property
    def vectors(self) -> dict:
        """The four per-OSD vectors [DV] the mappers read: views of the
        [DV + 1] buffers without the spare slot."""
        DV = self.DV
        return {k: v[:DV] for k, v in self._vec_buf.items()}

    # -- mappers -----------------------------------------------------------

    def mapper(self, pid: int):
        """The shared overlay-free PoolMapper of one pool (overlay
        corrections ride `rows()`)."""
        from ceph_tpu_torch.osd.pipeline import PoolMapper

        if self._pending_rebuild:
            self._build()
        pm = self._mappers.get(pid)
        if pm is None:
            pm = self._mappers[pid] = PoolMapper(
                self.m, pid, overlays=False, state=self)
        return pm

    # -- rows --------------------------------------------------------------

    def rows_tag(self, pid: int):
        """Version tag of one pool's `up` rows: equal tags guarantee equal
        rows.  An overlay-free pool leaves the raw version out, so upmap
        churn elsewhere never invalidates it."""
        if self._overlay_seeds(pid):
            return (self._vec_ver, self._raw_ver,
                    self._overlay_ver.get(pid, 0))
        return (self._vec_ver, None, self._overlay_ver.get(pid, 0))

    def _overlay_seeds(self, pid: int) -> tuple:
        m = self.m
        n = m.pools[pid].pg_num
        return tuple(sorted({
            pg.seed for pg in list(m.pg_upmap) + list(m.pg_upmap_items)
            if pg.pool == pid and pg.seed < n
        }))

    def rows(self, pid: int):
        """`up` rows [pg_num, W] int32 of one pool on the state's device,
        overlay PGs corrected, with the structure key and version tag.  A
        call whose tag is unchanged does no device work."""
        if self._pending_rebuild:
            self._build()
        tag = self.rows_tag(pid)
        ent = self._rows.get(pid)
        if ent is not None and ent[0] == tag:
            _inc("rows_served")
            return ent[1], ent[2], tag
        with obs.span("state.rows", pool=pid):
            rows, skey = self._remap(pid)
        self._rows[pid] = (tag, rows, skey)
        _inc("rows_remapped")
        return rows, skey, tag

    def _remap(self, pid: int):
        pm = self.mapper(pid)
        pm.refresh_dev()
        base_ent = self._base.get(pid)
        if base_ent is not None and base_ent[0] == self._vec_ver:
            rows, skey = base_ent[1], base_ent[2]
        else:
            rows = pm.map_all_device()
            skey = (pm.spec, int(rows.shape[0]), int(rows.shape[1]),
                    self.DV)
            self._base[pid] = (self._vec_ver, rows, skey)
        fix = self._fixups(pid, pm, int(rows.shape[1]))
        if fix:
            seeds = sorted(fix)
            rows = rows.index_copy(
                0, torch.as_tensor(seeds, dtype=torch.long,
                                   device=rows.device),
                torch.from_numpy(np.stack([fix[s] for s in seeds])).to(
                    rows.device))
        return rows, skey

    def _fixups(self, pid: int, pm, width: int) -> dict:
        """{seed: host-exact up row} of the pool's upmap-carrying PGs: the
        raw rows from the kernel and the cheap host steps, cached until a
        version feeding them changes."""
        seeds = self._overlay_seeds(pid)
        if not seeds:
            return {}
        ftag = (self._vec_ver, self._raw_ver,
                self._overlay_ver.get(pid, 0))
        ent = self._fix.get(pid)
        if ent is not None and ent[0] == ftag:
            return ent[1]
        raw = self._raw_rows(pid, pm, seeds)
        fix = {
            int(s): self._up_from_raw(pid, int(s), raw[i], width)
            for i, s in enumerate(seeds)
        }
        self._fix[pid] = (ftag, fix)
        return fix

    def _raw_rows(self, pid: int, pm, seeds: tuple) -> np.ndarray:
        """Raw rows of the overlay seeds (one rule launch), refetched only
        when a descent input changed."""
        key = (self._raw_ver, seeds)
        ent = self._raw.get(pid)
        if ent is not None and ent[0] == key:
            return ent[1]
        with obs.span("state.raw_fixup", pool=pid, seeds=len(seeds)):
            rows = pm.raw_rows(np.asarray(seeds, np.int64))
        self._raw[pid] = (key, rows)
        _inc("raw_refreshes")
        return rows

    def _up_from_raw(self, pid: int, seed: int, raw_row, width: int):
        """The host tail of the placement pipeline on one raw row:
        _apply_upmap, _raw_to_up_osds, _pick_primary,
        _apply_primary_affinity (reference OSDMap.cc:2667-2715)."""
        m = self.m
        pool = m.pools[pid]
        pg = PgId(pid, seed)
        if pool.can_shift_osds():
            raw = [int(o) for o in raw_row if o != ITEM_NONE]
        else:
            raw = [int(o) for o in raw_row[:pool.size]]
        pps = pool.raw_pg_to_pps(pg)
        m._apply_upmap(pool, pg, raw)
        up = m._raw_to_up_osds(pool, raw)
        up_primary = m._pick_primary(up)
        m._apply_primary_affinity(pps, pool, up, up_primary)
        row = np.full(width, ITEM_NONE, np.int32)
        row[: min(len(up), width)] = up[:width]
        return row

    def host_up(self, pid: int, seed: int) -> list[int]:
        """One PG's host-exact `up` set.  Overlay seeds answer from the
        fixup rows; any other seed replays the host descent, memoised
        (at most 4096 entries) until a descent input changes."""
        fix = self._fix.get(pid)
        seeds = self._overlay_seeds(pid)
        if seed in seeds and fix is not None and fix[0] == (
                self._vec_ver, self._raw_ver,
                self._overlay_ver.get(pid, 0)):
            row = fix[1].get(seed)
            if row is not None:
                return [int(o) for o in row if o != ITEM_NONE]
        m = self.m
        pool = m.pools[pid]
        pg = PgId(pid, int(seed))
        ent = self._oracle.get((pid, seed))
        if ent is not None and ent[0] == self._raw_ver:
            raw, pps = list(ent[1]), ent[2]
        else:
            raw, pps = m._pg_to_raw_osds(pool, pg)
            if len(self._oracle) >= _HOST_UP_MEMO:
                self._oracle.clear()
            self._oracle[(pid, seed)] = (self._raw_ver, list(raw), pps)
        m._apply_upmap(pool, pg, raw)
        up = m._raw_to_up_osds(pool, raw)
        up_primary = m._pick_primary(up)
        m._apply_primary_affinity(pps, pool, up, up_primary)
        return up

    # -- apply -------------------------------------------------------------

    def apply(self, inc: Incremental) -> str:
        """Advance the host map and the device operands by one epoch
        delta.  Returns "delta" (value-only, O(delta) device work),
        "rebuild" (structural) or "forced_rebuild" (a value-only delta
        rebuilt because CEPH_TPU_STATE_DELTA=0, or after a lost device).
        A device loss during the device portion raises on a card.  On a
        state placed on the host it leaves the host map advanced and
        defers the re-key to the next rows()/mapper() access
        ("deferred"), as the JAX ClusterState does
        (`faults.degrade_or_raise`)."""
        with obs.span("state.apply", epoch=inc.epoch), \
                _L.time("apply_seconds"):
            return self._apply(inc)

    def _apply(self, inc: Incremental) -> str:
        kind, info = classify_incremental(inc, self.m)
        m2 = apply_incremental(self.m, inc)
        if m2 is not self.m:
            self.m = m2  # a full map decodes to a new map object
            kind = "rebuild"
        try:
            if kind == "rebuild":
                self._build()
                return "rebuild"
            if not self.delta_enabled or self._pending_rebuild:
                self._build()
                return "forced_rebuild"
            if self._apply_delta(info):
                return "rebuild"
        except Exception as e:
            faults.degrade_or_raise(e, self.device, book=False)
            self._pending_rebuild = True
            return "deferred"
        _inc("delta_applies")
        self.delta_applies += 1
        return "delta"

    def _apply_delta(self, info: dict) -> bool:
        """True when the weight-set update found the shapes changed and
        rebuilt instead (the caller reports "rebuild")."""
        if info["osds"]:
            self._scatter_vectors(sorted(info["osds"]))
        if info["pos_weights"] and self._update_pos_weights():
            return True
        if info["vec"]:
            self._vec_ver += 1
        if info["raw"]:
            self._raw_ver += 1
        for pid in info["upmap_pools"]:
            self._overlay_ver[pid] = self._overlay_ver.get(pid, 0) + 1
        for pid in info["dropped_pools"]:
            for cache in (self._mappers, self._base, self._rows,
                          self._fix, self._raw):
                cache.pop(pid, None)
        return False

    def _scatter_vectors(self, idx: list) -> None:
        """O(delta) update of the four per-OSD vectors: one 32-lane block
        per vector, its unused lanes at the spare slot DV."""
        m = self.m
        DV = self.DV
        if len(idx) > _DELTA_PAD or len(idx) * 2 >= DV:
            # a wide delta: one vector re-upload moves fewer bytes than
            # scatter blocks would
            self._upload_vectors()
            return
        pad = _DELTA_PAD
        ix = np.full(pad, DV, np.int32)
        ex = np.zeros(pad, bool)
        up = np.zeros(pad, bool)
        wt = np.zeros(pad, np.uint32)
        af = np.full(pad, DEFAULT_PRIMARY_AFFINITY, np.uint32)
        aff = m.osd_primary_affinity
        for i, o in enumerate(idx):
            st = m.osd_state[o]
            ix[i] = o
            ex[i] = bool(st & OSD_EXISTS)
            up[i] = bool(st & OSD_EXISTS) and bool(st & OSD_UP)
            wt[i] = m.osd_weight[o]
            af[i] = (aff[o] if aff is not None
                     else DEFAULT_PRIMARY_AFFINITY)
        _inc("device_put_bytes",
             ix.nbytes + ex.nbytes + up.nbytes + wt.nbytes + af.nbytes)
        dev = self.device
        at = torch.from_numpy(ix).to(dev).long()
        for name, vals in (("exists", torch.from_numpy(ex).to(dev)),
                           ("up", torch.from_numpy(up).to(dev)),
                           ("weight", _u32_on(wt, dev)),
                           ("primary_affinity", _u32_on(af, dev))):
            self._vec_buf[name].index_copy_(0, at, vals)

    def _update_pos_weights(self) -> bool:
        """choose_args value changes: rebuild the cached groups' arrays
        and upload their weight-set planes and packed records into the
        cached tables.  True when the shapes drifted and the state was
        rebuilt instead."""
        from ceph_tpu_torch.crush.soa import build_arrays, pack_buckets

        for ca_key in list(self._arrays):
            A2 = build_arrays(self.m.crush,
                              self.m.crush.choose_args.get(ca_key))
            old = self._arrays[ca_key]
            if (A2.pos_weights.shape != old.pos_weights.shape
                    or not np.array_equal(A2.arg_ids, old.arg_ids)):
                self._build()
                return True
            self._arrays[ca_key] = A2
        for ca_key, T in list(self._tables.items()):
            A2 = self._arrays[ca_key]
            pk = pack_buckets(A2)
            pos = torch.from_numpy(
                np.ascontiguousarray(A2.pos_weights).view(np.int32)).to(
                self.device)
            rec = torch.from_numpy(
                pk.records.view(np.int32).reshape(-1, 4)).to(self.device)
            _inc("device_put_bytes", pos.numel() * 4 + rec.numel() * 4)
            self._tables[ca_key] = dataclasses.replace(
                T, pos_weights=pos, records=rec)
        for pm in self._mappers.values():
            key = self._ca_key(pm.pool_id)
            pm.arrays = self._arrays.get(key, pm.arrays)
            pm.tables = self._tables.get(key, pm.tables)
        return False

    def rows_source_for(self, m2: OSDMap):
        """A per-pool device-rows provider valid for `m2`, the balancer's
        and the mgr's surface.  `m2` is typically a working copy of this
        state's map at the same epoch (a `Plan.osdmap`); the provider
        answers a pool only while that pool's mapping inputs still match.
        None when the maps differ wholesale (epoch or vectors)."""
        if m2 is not self.m and not (
                m2.epoch == self.m.epoch
                and m2.max_osd == self.m.max_osd
                and m2.osd_weight == self.m.osd_weight
                and m2.osd_state == self.m.osd_state
                and m2.osd_primary_affinity
                == self.m.osd_primary_affinity):
            return None

        def _entries(m, pid):
            return (
                {pg: tuple(v) for pg, v in m.pg_upmap.items()
                 if pg.pool == pid},
                {pg: tuple(v) for pg, v in m.pg_upmap_items.items()
                 if pg.pool == pid},
            )

        def src(pid: int):
            if pid not in self.m.pools or pid not in m2.pools:
                return None
            if (m2.pools[pid].pg_num != self.m.pools[pid].pg_num
                    or m2.pools[pid].size != self.m.pools[pid].size):
                return None
            if m2 is not self.m and \
                    _entries(m2, pid) != _entries(self.m, pid):
                return None
            rows, _, _ = self.rows(pid)
            return rows

        return src

    # -- forking -----------------------------------------------------------

    def state_tag(self) -> tuple:
        """Aggregate version tag: equal tags guarantee that no mapping
        input changed anywhere (vectors, descent inputs, any pool's
        overlays)."""
        return (self._vec_ver, self._raw_ver,
                sum(self._overlay_ver.values()))

    def fork(self, inc: Incremental) -> "ClusterState":
        """A new ClusterState one value-only epoch ahead, sharing every
        table with this one; this state is not changed (its vectors are
        copied on the device before the scatter).  Raises ValueError on a
        structural Incremental."""
        kind, info = classify_incremental(inc, self.m)
        if kind != "delta":
            raise ValueError("fork() takes value-only incrementals; "
                             "stage structural epochs via a fresh "
                             "ClusterState")
        new = ClusterState.__new__(ClusterState)
        new.device = self.device
        new.mesh = self.mesh
        new._pending_rebuild = False
        new.delta_enabled = self.delta_enabled
        new.full_rebuilds = 0
        new.delta_applies = 0
        new.m = value_copy_map(self.m)
        apply_incremental(new.m, inc)
        new._arrays = dict(self._arrays)
        new._tables = dict(self._tables)
        new._mappers = {}
        new._base = {}
        new._rows = {}
        new._fix = {}
        new._raw = {}
        new._oracle = {}
        new._vec_ver = self._vec_ver
        new._raw_ver = self._raw_ver
        new._overlay_ver = dict(self._overlay_ver)
        new._vec_buf = {k: v.clone() for k, v in self._vec_buf.items()}
        new._apply_delta(info)
        _inc("delta_applies")
        new.delta_applies += 1
        _inc("value_forks")
        return new

    # -- introspection -----------------------------------------------------

    def counters(self) -> dict:
        """The process-wide `state` counts (COUNTERS)."""
        return __getattr__("COUNTERS")


__all__ = [
    "COUNTERS",
    "ClusterState",
    "Incremental",
    "classify_incremental",
    "value_copy_map",
]
