"""OSDMap: the cluster-map model above CRUSH.

The port of `ceph_tpu/osd/osdmap.py`'s state (reference src/osd/OSDMap.{h,cc}):
per-OSD state/weight/primary-affinity vectors, pools, pg_temp/primary_temp,
pg_upmap/pg_upmap_items, their mutators, the map builders and the per-PG
host pipeline (`_pg_to_raw_osds` ... `pg_to_up_acting_osds`, reference
src/osd/OSDMap.cc:2435-2715) over the host oracle `crush/mapper_ref.py`,
which the CLIs' single-PG paths use.  The batched pipeline
(ceph_tpu_torch.osd.pipeline) consumes `frozen_vectors()`.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.crush import mapper_ref
from ceph_tpu_torch.crush.types import BucketAlg, CrushMap, ITEM_NONE, Tunables
from ceph_tpu_torch.osd.types import PgId, PgPool, PoolType

# osd_state flags (reference src/include/rados.h:125-132)
OSD_EXISTS = 1 << 0
OSD_UP = 1 << 1
OSD_AUTOOUT = 1 << 2
OSD_NEW = 1 << 3
OSD_DESTROYED = 1 << 7

IN_WEIGHT = 0x10000  # CEPH_OSD_IN (reference src/include/rados.h:142)
MAX_PRIMARY_AFFINITY = 0x10000  # reference src/include/rados.h:145
DEFAULT_PRIMARY_AFFINITY = 0x10000

# default bucket type hierarchy (reference src/osd/OSDMap.cc:4286-4305
# _build_crush_types): 0=osd .. 11=root
DEFAULT_TYPES = {
    0: "osd", 1: "host", 2: "chassis", 3: "rack", 4: "row", 5: "pdu",
    6: "pod", 7: "room", 8: "datacenter", 9: "zone", 10: "region", 11: "root",
}


class OSDMap:
    """Cluster map: CRUSH tree + per-OSD vectors + pools + overrides."""

    def __init__(self, crush: CrushMap | None = None):
        self.epoch = 1
        self.crush = crush or CrushMap()
        self.max_osd = 0
        self.osd_state: list[int] = []
        self.osd_weight: list[int] = []  # 16.16 in/out weight
        self.osd_primary_affinity: list[int] | None = None
        self.pools: dict[int, PgPool] = {}
        self.pool_name: dict[int, str] = {}
        self.pool_max = -1
        self.pg_temp: dict[PgId, list[int]] = {}
        self.primary_temp: dict[PgId, int] = {}
        self.pg_upmap: dict[PgId, list[int]] = {}
        self.pg_upmap_items: dict[PgId, list[tuple[int, int]]] = {}
        # EC profile registry (reference src/osd/OSDMap.h:598)
        self.erasure_code_profiles: dict[str, dict[str, str]] = {}

    # -- OSD state ---------------------------------------------------------
    def set_max_osd(self, n: int) -> None:
        while len(self.osd_state) < n:
            self.osd_state.append(0)
            self.osd_weight.append(0)
            if self.osd_primary_affinity is not None:
                self.osd_primary_affinity.append(DEFAULT_PRIMARY_AFFINITY)
        del self.osd_state[n:]
        del self.osd_weight[n:]
        if self.osd_primary_affinity is not None:
            del self.osd_primary_affinity[n:]
        self.max_osd = n

    def exists(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and bool(self.osd_state[osd] & OSD_EXISTS)

    def is_up(self, osd: int) -> bool:
        return self.exists(osd) and bool(self.osd_state[osd] & OSD_UP)

    def is_down(self, osd: int) -> bool:
        return not self.is_up(osd)

    def is_out(self, osd: int) -> bool:
        return not self.exists(osd) or self.osd_weight[osd] == 0

    def is_in(self, osd: int) -> bool:
        return not self.is_out(osd)

    def get_weightf(self, osd: int) -> float:
        return self.osd_weight[osd] / IN_WEIGHT

    def set_primary_affinity(self, osd: int, aff: int) -> None:
        if self.osd_primary_affinity is None:
            self.osd_primary_affinity = (
                [DEFAULT_PRIMARY_AFFINITY] * self.max_osd
            )
        self.osd_primary_affinity[osd] = aff

    def mark_up_in(self, osd: int) -> None:
        self.osd_state[osd] |= OSD_EXISTS | OSD_UP
        self.osd_weight[osd] = IN_WEIGHT

    def mark_down(self, osd: int) -> None:
        self.osd_state[osd] &= ~OSD_UP

    def mark_out(self, osd: int) -> None:
        self.osd_weight[osd] = 0

    # -- pools -------------------------------------------------------------
    def add_pool(self, name: str, pool: PgPool, pool_id: int | None = None) -> int:
        if pool_id is None:
            self.pool_max += 1
            pool_id = self.pool_max
        else:
            self.pool_max = max(self.pool_max, pool_id)
        self.pools[pool_id] = pool
        self.pool_name[pool_id] = name
        return pool_id

    def get_pg_pool(self, pool_id: int) -> PgPool | None:
        return self.pools.get(pool_id)

    # -- the 5-stage pipeline (host reference) -----------------------------
    def _pg_to_raw_osds(self, pool: PgPool, pg: PgId) -> tuple[list[int], int]:
        """reference src/osd/OSDMap.cc:2435-2453."""
        pps = pool.raw_pg_to_pps(pg)
        size = pool.size
        ruleno = mapper_ref.find_rule(
            self.crush, pool.crush_rule, int(pool.type), size
        )
        osds: list[int] = []
        if ruleno >= 0:
            # choose_args_get_with_fallback semantics (reference
            # src/crush/CrushWrapper.h:1451-1457): pool id, else -1
            ca = self.crush.choose_args.get(
                pg.pool, self.crush.choose_args.get(-1)
            )
            osds = mapper_ref.do_rule(
                self.crush, ruleno, pps, size, self.osd_weight,
                choose_args=ca,
            )
        self._remove_nonexistent_osds(pool, osds)
        return osds, pps

    def _remove_nonexistent_osds(self, pool: PgPool, osds: list[int]) -> None:
        """reference src/osd/OSDMap.cc:2412-2433."""
        if pool.can_shift_osds():
            osds[:] = [o for o in osds if self.exists(o)]
        else:
            for i, o in enumerate(osds):
                if not self.exists(o) and o != ITEM_NONE:
                    osds[i] = ITEM_NONE

    def _apply_upmap(self, pool: PgPool, raw_pg: PgId, raw: list[int]) -> None:
        """reference src/osd/OSDMap.cc:2465-2509."""
        pg = pool.raw_pg_to_pg(raw_pg)
        p = self.pg_upmap.get(pg)
        if p is not None:
            for osd in p:
                if (
                    osd != ITEM_NONE and 0 <= osd < self.max_osd
                    and self.osd_weight[osd] == 0
                ):
                    return  # reject explicit mapping with out target
            raw[:] = list(p)
        q = self.pg_upmap_items.get(pg)
        if q is not None:
            for frm, to in q:
                exists = False
                pos = -1
                for i, osd in enumerate(raw):
                    if osd == to:
                        exists = True
                        break
                    if osd == frm and pos < 0 and not (
                        to != ITEM_NONE and 0 <= to < self.max_osd
                        and self.osd_weight[to] == 0
                    ):
                        pos = i
                if not exists and pos >= 0:
                    raw[pos] = to

    def _raw_to_up_osds(self, pool: PgPool, raw: list[int]) -> list[int]:
        """reference src/osd/OSDMap.cc:2512-2535."""
        if pool.can_shift_osds():
            return [o for o in raw if self.exists(o) and not self.is_down(o)]
        return [
            o if (self.exists(o) and not self.is_down(o)) else ITEM_NONE
            for o in raw
        ]

    @staticmethod
    def _pick_primary(osds: list[int]) -> int:
        """reference src/osd/OSDMap.cc:2455-2463."""
        for o in osds:
            if o != ITEM_NONE:
                return o
        return -1

    def _apply_primary_affinity(
        self, seed: int, pool: PgPool, osds: list[int], primary: int
    ) -> int:
        """reference src/osd/OSDMap.cc:2537-2590.  Mutates osds (shift for
        replicated pools); returns the new primary."""
        pa = self.osd_primary_affinity
        if pa is None:
            return primary
        if not any(
            o != ITEM_NONE and pa[o] != DEFAULT_PRIMARY_AFFINITY for o in osds
        ):
            return primary
        pos = -1
        for i, o in enumerate(osds):
            if o == ITEM_NONE:
                continue
            a = pa[o]
            if a < MAX_PRIMARY_AFFINITY and (
                int(mapper_ref._h2(seed, o)) >> 16
            ) >= a:
                if pos < 0:
                    pos = i
            else:
                pos = i
                break
        if pos < 0:
            return primary
        primary = osds[pos]
        if pool.can_shift_osds() and pos > 0:
            for i in range(pos, 0, -1):
                osds[i] = osds[i - 1]
            osds[0] = primary
        return primary

    def _get_temp_osds(self, pool: PgPool, pg: PgId) -> tuple[list[int], int]:
        """reference src/osd/OSDMap.cc:2592-2623."""
        pg = pool.raw_pg_to_pg(pg)
        temp_pg: list[int] = []
        p = self.pg_temp.get(pg)
        if p is not None:
            for o in p:
                if not self.exists(o) or self.is_down(o):
                    if not pool.can_shift_osds():
                        temp_pg.append(ITEM_NONE)
                else:
                    temp_pg.append(o)
        temp_primary = self.primary_temp.get(pg, -1)
        if temp_primary == -1 and temp_pg:
            for o in temp_pg:
                if o != ITEM_NONE:
                    temp_primary = o
                    break
        return temp_pg, temp_primary

    def pg_to_raw_osds(self, pg: PgId) -> tuple[list[int], int]:
        pool = self.get_pg_pool(pg.pool)
        if pool is None:
            return [], -1
        raw, _ = self._pg_to_raw_osds(pool, pg)
        return raw, self._pick_primary(raw)

    def pg_to_raw_up(self, pg: PgId) -> tuple[list[int], int]:
        """reference src/osd/OSDMap.cc:2648-2664."""
        pool = self.get_pg_pool(pg.pool)
        if pool is None:
            return [], -1
        raw, pps = self._pg_to_raw_osds(pool, pg)
        self._apply_upmap(pool, pg, raw)
        up = self._raw_to_up_osds(pool, raw)
        primary = self._pick_primary(raw)
        primary = self._apply_primary_affinity(pps, pool, up, primary)
        return up, primary

    def _pg_to_up_acting_osds(
        self, pg: PgId, raw_pg_to_pg: bool = True
    ) -> tuple[list[int], int, list[int], int]:
        """reference src/osd/OSDMap.cc:2667-2715.  Returns
        (up, up_primary, acting, acting_primary)."""
        pool = self.get_pg_pool(pg.pool)
        if pool is None or (not raw_pg_to_pg and pg.seed >= pool.pg_num):
            return [], -1, [], -1
        acting, acting_primary = self._get_temp_osds(pool, pg)
        raw, pps = self._pg_to_raw_osds(pool, pg)
        self._apply_upmap(pool, pg, raw)
        up = self._raw_to_up_osds(pool, raw)
        up_primary = self._pick_primary(up)
        up_primary = self._apply_primary_affinity(pps, pool, up, up_primary)
        if not acting:
            acting = list(up)
            if acting_primary == -1:
                acting_primary = up_primary
        return up, up_primary, acting, acting_primary

    def pg_to_up_acting_osds(self, pg: PgId):
        return self._pg_to_up_acting_osds(pg, raw_pg_to_pg=False)

    # -- upmap hygiene -----------------------------------------------------
    def clean_pg_upmaps(self) -> tuple[list[PgId], dict[PgId, list]]:
        """Drop invalid/no-op pg_upmap{,_items} entries (reference
        OSDMap::check_pg_upmaps + clean_pg_upmaps, src/osd/OSDMap.cc:2003).
        Returns (cancelled pgs, simplified items).  Mutates self."""
        from ceph_tpu_torch.balancer.crush_analysis import (
            get_rule_weight_osd_map,
        )

        to_cancel: list[PgId] = []
        to_remap: dict[PgId, list] = {}
        rule_weight_cache: dict[int, dict[int, float]] = {}
        for pg in sorted(set(self.pg_upmap) | set(self.pg_upmap_items)):
            pool = self.get_pg_pool(pg.pool)
            if pool is None or pg.seed >= pool.pg_num:
                to_cancel.append(pg)
                continue
            raw, _ = self._pg_to_raw_osds(pool, pg)
            up = list(raw)
            self._apply_upmap(pool, pg, up)
            real = [o for o in up if o != ITEM_NONE]
            if len(real) != len(set(real)):  # duplicate targets
                to_cancel.append(pg)
                continue
            ruleno = mapper_ref.find_rule(
                self.crush, pool.crush_rule, int(pool.type), pool.size
            )
            wm = rule_weight_cache.get(ruleno)
            if wm is None and ruleno >= 0:
                wm = get_rule_weight_osd_map(self.crush, ruleno)
                rule_weight_cache[ruleno] = wm
            bad = False
            for osd in real:
                if wm is not None and osd not in wm:
                    bad = True  # moved out of the rule's crush tree
                    break
                if self.is_out(osd):
                    bad = True
                    break
            if bad:
                to_cancel.append(pg)
                continue
            p = self.pg_upmap.get(pg)
            if p is not None and list(raw) == list(p):
                to_cancel.append(pg)  # redundant full remap
                continue
            items = self.pg_upmap_items.get(pg)
            if items is not None:
                newmap = [
                    (frm, to)
                    for frm, to in items
                    if frm in raw
                    and not (
                        to != ITEM_NONE and 0 <= to < self.max_osd
                        and self.osd_weight[to] == 0
                    )
                ]
                if not newmap:
                    to_cancel.append(pg)
                elif newmap != list(items):
                    to_remap[pg] = newmap
        for pg in to_cancel:
            self.pg_upmap.pop(pg, None)
            self.pg_upmap_items.pop(pg, None)
        for pg, items in to_remap.items():
            self.pg_upmap_items[pg] = items
        return to_cancel, to_remap

    # -- freezing for the pipeline --------------------------------------------
    def frozen_vectors(self) -> dict[str, np.ndarray]:
        """Per-OSD state as dense arrays (consumed by osd/pipeline.py)."""
        n = self.max_osd
        state = np.asarray(self.osd_state, np.int32)
        weight = np.asarray(self.osd_weight, np.uint32)
        if self.osd_primary_affinity is None:
            aff = np.full(n, DEFAULT_PRIMARY_AFFINITY, np.uint32)
        else:
            aff = np.asarray(self.osd_primary_affinity, np.uint32)
        return {
            "exists": (state & OSD_EXISTS) != 0,
            "up": ((state & OSD_EXISTS) != 0) & ((state & OSD_UP) != 0),
            "weight": weight,
            "primary_affinity": aff,
        }


# -- builders --------------------------------------------------------------

def build_simple(
    n_osd: int,
    pg_bits: int = 6,
    pgp_bits: int = 6,
    default_pool: bool = True,
    chooseleaf_type: int = 1,
    tunables: Tunables | None = None,
    mark_up_in: bool = True,
) -> OSDMap:
    """OSDMap::build_simple semantics (reference src/osd/OSDMap.cc:4172-4270 +
    build_simple_crush_map :4307-4337): all OSDs at weight 1.0 under
    host "localhost" / rack "localrack" / root "default"; one replicated rule
    chooseleaf-firstn over `chooseleaf_type` (1=host); one "rbd" pool with
    poolbase<<pg_bits PGs."""
    crush = CrushMap(tunables)
    crush.type_names = dict(DEFAULT_TYPES)
    # bucket id order matches the reference builder: root -1 first, then
    # insert_item creates host -2 / rack -3 on the first device's walk
    root = crush.add_bucket(BucketAlg.STRAW2, 11, [], [], name="default")
    loc = {"host": "localhost", "rack": "localrack", "root": "default"}
    for o in range(n_osd):
        crush.insert_item(o, 1.0, f"osd.{o}", loc)
    crush.make_replicated_rule(root, chooseleaf_type)
    crush.rule_names[0] = "replicated_rule"

    m = OSDMap(crush)
    m.set_max_osd(n_osd)
    if mark_up_in:
        for o in range(n_osd):
            m.mark_up_in(o)
    if default_pool and n_osd:
        # pool id 1, as the reference's ++pool_max from 0 produces
        pool = PgPool(
            type=PoolType.REPLICATED, size=3, crush_rule=0,
            pg_num=n_osd << pg_bits, pgp_num=n_osd << min(pgp_bits, pg_bits),
        )
        m.pool_max = 0
        m.add_pool("rbd", pool, 1)
    return m


def build_hierarchical(
    n_host: int,
    osd_per_host: int,
    n_rack: int = 0,
    weight_fn=None,
    tunables: Tunables | None = None,
    pool: PgPool | None = None,
    pool_name: str = "rbd",
    chooseleaf_type: int = 1,
) -> OSDMap:
    """Synthesize a realistic multi-host (optionally multi-rack) map — the
    shape `osdmaptool --createsimple` + a crush built from conf produces
    (reference src/osd/OSDMap.cc:4339-4409 build_simple_crush_map_from_conf).
    weight_fn(osd_id) -> 16.16 device weight (default 1.0)."""
    crush = CrushMap(tunables)
    crush.type_names = dict(DEFAULT_TYPES)
    host_ids = []
    osd = 0
    for h in range(n_host):
        items = list(range(osd, osd + osd_per_host))
        ws = [
            IN_WEIGHT if weight_fn is None else int(weight_fn(i))
            for i in items
        ]
        hid = crush.add_bucket(
            BucketAlg.STRAW2, 1, items, ws, name=f"host{h}"
        )
        host_ids.append((hid, sum(ws)))
        osd += osd_per_host
    if n_rack:
        per = max(1, n_host // n_rack)
        top = []
        for r in range(n_rack):
            hs = host_ids[r * per : (r + 1) * per]
            if not hs:
                break
            rid = crush.add_bucket(
                BucketAlg.STRAW2, 3,
                [h for h, _ in hs], [w for _, w in hs], name=f"rack{r}",
            )
            top.append((rid, sum(w for _, w in hs)))
    else:
        top = host_ids
    root = crush.add_bucket(
        BucketAlg.STRAW2, 11,
        [b for b, _ in top], [w for _, w in top], name="default",
    )
    for o in range(osd):
        crush.item_names[o] = f"osd.{o}"
    crush.make_replicated_rule(root, chooseleaf_type)

    m = OSDMap(crush)
    m.set_max_osd(osd)
    for o in range(osd):
        m.mark_up_in(o)
    if pool is not None:
        m.add_pool(pool_name, pool)
    return m
