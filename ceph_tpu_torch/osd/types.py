"""PG / pool types: the seed math between objects and CRUSH inputs.
A copy of `ceph_tpu/osd/types.py`.

Covers the reference's pg_t and pg_pool_t placement-relevant surface
(reference src/osd/osd_types.{h,cc}): stable_mod folding of the placement
seed onto pg_num, and the pool-mixing pps ("placement seed") that feeds
crush_do_rule.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

from ceph_tpu_torch.core.intmath import pg_mask_for
from ceph_tpu_torch.core.rjenkins import crush_hash32_2, str_hash_rjenkins

CEPH_NOSNAP = (1 << 64) - 2


class PoolType(IntEnum):
    # reference src/osd/osd_types.h pg_pool_t::TYPE_*
    REPLICATED = 1
    ERASURE = 3


@dataclass(frozen=True, order=True)
class PgId:
    """pg_t: (pool, seed) (reference src/osd/osd_types.h struct pg_t)."""

    pool: int
    seed: int

    def __str__(self):
        return f"{self.pool}.{self.seed:x}"

    @classmethod
    def parse(cls, s: str) -> "PgId":
        p, ps = s.split(".")
        return cls(int(p), int(ps, 16))


FLAG_HASHPSPOOL = 1 << 0  # reference src/osd/osd_types.h pg_pool_t::FLAG_*
FLAG_FULL = 1 << 1
FLAG_EC_OVERWRITES = 1 << 12


@dataclass
class PgPool:
    """pg_pool_t placement surface (reference src/osd/osd_types.h:1310+)."""

    type: PoolType = PoolType.REPLICATED
    size: int = 3
    min_size: int = 2
    pg_num: int = 64
    pgp_num: int = 0  # 0 => same as pg_num
    crush_rule: int = 0
    flags: int = FLAG_HASHPSPOOL
    object_hash: int = 2  # CEPH_STR_HASH_RJENKINS
    erasure_code_profile: str = ""
    pg_num_pending: int = 0
    expected_num_objects: int = 0

    def __post_init__(self):
        if not self.pgp_num:
            self.pgp_num = self.pg_num

    @property
    def pg_num_mask(self) -> int:
        return pg_mask_for(self.pg_num)

    @property
    def pgp_num_mask(self) -> int:
        return pg_mask_for(self.pgp_num)

    def can_shift_osds(self) -> bool:
        """Replicated pools compact gaps; EC pools are positional
        (reference src/osd/osd_types.h can_shift_osds)."""
        return self.type == PoolType.REPLICATED

    def is_erasure(self) -> bool:
        return self.type == PoolType.ERASURE

    def is_replicated(self) -> bool:
        return self.type == PoolType.REPLICATED

    # -- seed math ---------------------------------------------------------
    def raw_pg_to_pg(self, pg: PgId) -> PgId:
        """fold full-precision ps onto pg_num (reference
        src/osd/osd_types.cc:1787-1791)."""
        lo = pg.seed & self.pg_num_mask
        seed = lo if lo < self.pg_num else pg.seed & (self.pg_num_mask >> 1)
        return PgId(pg.pool, seed)

    def raw_pg_to_pps(self, pg: PgId) -> int:
        """placement seed fed to CRUSH (reference
        src/osd/osd_types.cc:1798-1814)."""
        lo = pg.seed & self.pgp_num_mask
        ps = lo if lo < self.pgp_num else pg.seed & (self.pgp_num_mask >> 1)
        if self.flags & FLAG_HASHPSPOOL:
            return int(crush_hash32_2(ps, pg.pool & 0xFFFFFFFF))
        return ps + pg.pool

    def hash_key(self, key: str, ns: str = "") -> int:
        """object name (+namespace) -> 32-bit hash (reference
        src/osd/osd_types.cc:1766-1777)."""
        if self.object_hash != 2:  # CEPH_STR_HASH_RJENKINS
            raise NotImplementedError(
                f"object_hash {self.object_hash} (only rjenkins supported)"
            )
        if not ns:
            return str_hash_rjenkins(key.encode())
        return str_hash_rjenkins(ns.encode() + b"\x1f" + key.encode())

    def object_to_pg(self, key: str, ns: str = "") -> PgId:
        return PgId(-1, self.hash_key(key, ns))  # pool filled by caller
