"""Distribution scoring: the balancer's Eval / calc_eval.

The port of `ceph_tpu/mgr/eval.py` (reference pybind/mgr/balancer/
module.py: `Eval` :60-130, `calc_stats` :95-150, `calc_eval` :670-790):
per pool and per CRUSH root, the actual per-OSD distribution of PGs,
objects and bytes against the weight-proportional target, each (root,
metric) pair reduced to a score in [0, 1) (0 is a perfect distribution);
the overall score is the mean over roots and metrics.

The O(PGs) work runs on the device: each pool's `up` rows come from the
rule kernel (`PoolMapper.map_all_device`, or a shared
`osd.state.ClusterState`), and the per-OSD counts are reduced where the
rows are (`core.reduce`).  Only the O(OSDs) count vectors come to the
host, and every score is computed there with numpy and `math` in the JAX
package's order, so the scores are bit-identical to its.  The float64
weighted sums are exact while every per-OSD sum stays below 2^53;
`MappingState.pool_counts` checks that bound.

Object and byte stats have no daemon to come from here: `MappingState`
carries a per-PG stats table (`synthetic_pg_stats` makes one).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ceph_tpu_torch import obs
from ceph_tpu_torch.balancer.crush_analysis import (
    find_takes_by_rule,
    get_rule_weight_osd_map,
)
from ceph_tpu_torch.core import reduce
from ceph_tpu_torch.crush import mapper_ref
from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import PgId

_L = obs.logger_for("mgr")
_L.add_u64("evals", "calc_eval passes")
_L.add_u64("eval_pgs_mapped", "PGs mapped while building eval distributions")
_L.add_time_avg("eval_seconds", "wall time per calc_eval pass")
_L.add_avg("score", "eval score after each calc_eval (0 = perfect)")

METRICS = ("pgs", "objects", "bytes")
MAPPERS = ("torch", "jax", "host")  # "jax" is the JAX package's name
EXACT_SUM = 1 << 53  # float64 sums of integers are exact below this
_MISPLACED_CHUNK = 1 << 20  # PGs per device comparison block


def synthetic_pg_stats(
    m: OSDMap, objects_per_pg: int = 64, bytes_per_object: int = 4 << 20,
    seed: int = 0,
) -> dict[int, dict[str, np.ndarray]]:
    """Deterministic per-PG object/byte counts (the pg_dump stand-in),
    spread x0.5..x1.5 around the mean so the objects and bytes scores are
    not copies of the pgs score."""
    out: dict[int, dict[str, np.ndarray]] = {}
    for pid, pool in sorted(m.pools.items()):
        rng = np.random.default_rng(seed * 1_000_003 + pid)
        objs = rng.integers(
            objects_per_pg // 2, objects_per_pg * 3 // 2 + 1,
            size=pool.pg_num, dtype=np.int64,
        )
        out[pid] = {"objects": objs, "bytes": objs * bytes_per_object}
    return out


class MappingState:
    """What the balancer scores: an OSDMap, per-PG stats and the per-pool
    `up` rows, computed on first use (reference module.py
    `MappingState`).

    mapper: "torch" (alias "jax") maps each pool on `device` (None: the
    card; "cpu" runs the rule's plain version) and keeps the rows there:
    the counts and the misplacement reduce on the device.  The mapping is
    overlay-free, with the few upmap-carrying PGs' rows from the host
    pipeline scattered in.  "host" walks `OSDMap.pg_to_up_acting_osds`
    (small maps).  `state`: a shared `osd.state.ClusterState` whose rows
    answer the pools its map agrees on.
    """

    def __init__(self, osdmap: OSDMap, pg_stats=None, desc: str = "",
                 mapper: str = "torch", state=None, device=None,
                 mesh=None):
        if mapper not in MAPPERS:
            raise ValueError(f"unknown mapper {mapper!r} "
                             f"(one of {', '.join(MAPPERS)})")
        self.osdmap = osdmap
        self.desc = desc
        self.pg_stats = pg_stats or {}
        self.mapper = mapper
        self.state = state
        self.device = state.device if state is not None else device
        # the standalone mapping path splits over `mesh` (default: the
        # state's), as the state's own mappers do
        self.mesh = mesh if mesh is not None \
            else getattr(state, "mesh", None)
        self._up: dict[int, np.ndarray] = {}
        self._dev: dict[int, torch.Tensor] = {}

    @property
    def on_device(self) -> bool:
        return self.mapper != "host"

    def pool_up_device(self, pool_id: int) -> torch.Tensor:
        """[pg_num, W] int32 `up` rows on the device, overlay PGs fixed up
        from the host pipeline."""
        rows = self._dev.get(pool_id)
        if rows is not None:
            return rows
        if self.state is not None:
            src = self.state.rows_source_for(self.osdmap)
            rows = src(pool_id) if src is not None else None
            if rows is not None:
                self._dev[pool_id] = rows
                return rows
        from ceph_tpu_torch.osd.pipeline import PoolMapper, overlay_fixup_rows

        m = self.osdmap
        n = m.pools[pool_id].pg_num
        with obs.span("mgr.map_pool", pool=pool_id, pgs=n, mapper="torch"):
            pm = PoolMapper(m, pool_id, self.device, overlays=False,
                            mesh=self.mesh)
            rows = pm.map_all_device()
            seeds, fix = overlay_fixup_rows(m, pool_id, int(rows.shape[1]))
            if len(seeds):
                rows[torch.from_numpy(seeds).to(rows.device)] = \
                    torch.from_numpy(fix).to(rows.device)
        _L.inc("eval_pgs_mapped", n)
        self._dev[pool_id] = rows
        return rows

    def pool_up(self, pool_id: int) -> np.ndarray:
        """[pg_num, W] int32 `up` rows, ITEM_NONE padded, on the host."""
        rows = self._up.get(pool_id)
        if rows is not None:
            return rows
        m = self.osdmap
        pool = m.pools[pool_id]
        if self.on_device:
            rows = self.pool_up_device(pool_id).cpu().numpy()
        else:
            with obs.span("mgr.map_pool", pool=pool_id, pgs=pool.pg_num,
                          mapper=self.mapper):
                rows = np.full((pool.pg_num, pool.size), ITEM_NONE,
                               np.int32)
                for ps in range(pool.pg_num):
                    up, _, _, _ = m.pg_to_up_acting_osds(PgId(pool_id, ps))
                    rows[ps, : min(len(up), pool.size)] = up[: pool.size]
            _L.inc("eval_pgs_mapped", pool.pg_num)
        self._up[pool_id] = rows
        return rows

    def pool_counts(self, pool_id: int, o_pg: np.ndarray, b_pg: np.ndarray):
        """Per-OSD (pgs, objects, bytes) totals of one pool, reduced on the
        device from its rows; only the O(OSDs) vectors come to the host.
        The float64 sums are exact: each OSD's sum is at most its PG count
        times the largest per-PG weight, and that product must stay below
        2^53 (raises OverflowError otherwise)."""
        n_osd = max(int(self.osdmap.max_osd), 1)
        rows = self.pool_up_device(pool_id)
        with obs.span("mgr.pool_counts", pool=pool_id, osds=n_osd):
            c_pgs = reduce.osd_histogram(rows, n_osd,
                                         dtype=torch.int64).cpu().numpy()
            top = int(c_pgs.max(initial=0))
            for w in (o_pg, b_pg):
                w_max = int(np.max(w, initial=0))
                if top * w_max >= EXACT_SUM or int(np.min(w, initial=0)) < 0:
                    raise OverflowError(
                        f"pool {pool_id}: per-OSD sums up to {top} x {w_max} "
                        f"are not exact in float64")
            c_obj = reduce.weighted_osd_histogram(rows, o_pg, n_osd)
            c_byt = reduce.weighted_osd_histogram(rows, b_pg, n_osd)
            return c_pgs, c_obj.cpu().numpy(), c_byt.cpu().numpy()

    def misplaced_from(self, other: "MappingState") -> float:
        """Fraction of PG replica slots mapped differently than in `other`
        (the reference's calc_misplaced_from, with replica slots standing
        in for objects).  Valid rows carry no duplicate OSDs, so a lane
        that is not a member of the other row is a set difference.  With
        both states on the device the comparison runs there and only the
        count comes back."""
        moved = 0
        total = 0
        use_dev = self.on_device and other.on_device
        for pid, pool in sorted(self.osdmap.pools.items()):
            if pid not in other.osdmap.pools:
                continue
            n = pool.pg_num
            total += n * pool.size
            if use_dev:
                a = self.pool_up_device(pid)
                b = other.pool_up_device(pid)
                for i in range(0, n, _MISPLACED_CHUNK):
                    moved += int(reduce.misplaced_lanes(
                        a[i:i + _MISPLACED_CHUNK],
                        b[i:i + _MISPLACED_CHUNK]))
                continue
            CH = 16384
            a = np.asarray(self.pool_up(pid))
            b = np.asarray(other.pool_up(pid))
            for i in range(0, n, CH):
                aa, bb = a[i:i + CH], b[i:i + CH]
                member = (bb[:, :, None] == aa[:, None, :]).any(axis=2)
                moved += int(
                    (~member & (bb != ITEM_NONE) & (bb >= 0)).sum()
                )
        return moved / total if total else 0.0


@dataclass
class Eval:
    """Scored distributions (reference module.py:60-130)."""

    ms: MappingState
    pool_name: dict[int, str] = field(default_factory=dict)
    pool_id: dict[str, int] = field(default_factory=dict)
    pool_roots: dict[str, list[str]] = field(default_factory=dict)
    root_pools: dict[str, list[str]] = field(default_factory=dict)
    root_ids: dict[str, int] = field(default_factory=dict)
    # target_by_root[root] = {osd: normalized weight fraction}
    target_by_root: dict[str, dict[int, float]] = field(default_factory=dict)
    count_by_pool: dict = field(default_factory=dict)
    count_by_root: dict = field(default_factory=dict)
    actual_by_pool: dict = field(default_factory=dict)
    actual_by_root: dict = field(default_factory=dict)
    total_by_pool: dict = field(default_factory=dict)
    total_by_root: dict = field(default_factory=dict)
    stats_by_pool: dict = field(default_factory=dict)
    stats_by_root: dict = field(default_factory=dict)
    score_by_pool: dict[str, float] = field(default_factory=dict)
    score_by_root: dict[str, dict[str, float]] = field(default_factory=dict)
    score: float = 0.0

    def calc_stats(self, count, target, total):
        """reference module.py:95-150.  `count[t][osd]`, `target[osd]`
        (fractions summing to 1 per root), `total[t]`."""
        num = max(len(target), 1)
        r = {}
        for t in METRICS:
            if total[t] == 0:
                r[t] = {
                    "avg": 0, "stddev": 0, "sum_weight": 0, "score": 0,
                }
                continue
            avg = float(total[t]) / float(num)
            dev = 0.0
            # score in [0, 1): erf of the relative overfullness of each
            # overweighted device, weighted by its target share
            # (module.py:113-124)
            score = 0.0
            sum_weight = 0.0
            for k, v in count[t].items():
                if target.get(k):
                    adjusted = float(v) / target[k] / float(num)
                else:
                    adjusted = 0.0
                if adjusted > avg:
                    score += target[k] * math.erf(
                        ((adjusted - avg) / avg) / math.sqrt(2.0)
                    )
                    sum_weight += target[k]
                dev += (avg - adjusted) * (avg - adjusted)
            stddev = math.sqrt(dev / float(max(num - 1, 1)))
            score = score / max(sum_weight, 1)
            r[t] = {
                "avg": avg,
                "stddev": stddev,
                "sum_weight": sum_weight,
                "score": score,
            }
        return r

    def show(self, verbose: bool = False) -> str:
        ms = self.ms
        out = [f"[{ms.desc or 'current cluster'}] score {self.score:.6f}"]
        for root in sorted(self.score_by_root):
            s = self.score_by_root[root]
            out.append(
                f"  root {root!r:12} pools {self.root_pools.get(root)} "
                + " ".join(f"{t}={s[t]:.6f}" for t in METRICS)
            )
        if verbose:
            for pool in sorted(self.score_by_pool):
                out.append(
                    f"  pool {pool!r:12} score "
                    f"{self.score_by_pool[pool]:.6f}"
                )
            for root, tgt in sorted(self.target_by_root.items()):
                act = self.actual_by_root[root]["pgs"]
                for osd in sorted(tgt):
                    out.append(
                        f"    osd.{osd:<4} target {tgt[osd]:.4f} "
                        f"actual-pgs {act.get(osd, 0.0):.4f}"
                    )
        return "\n".join(out)


def calc_eval(ms: MappingState, pools: list[str] | None = None) -> Eval:
    """Build the scored distributions of `ms` (reference
    module.py:670-790 `calc_eval`).  `pools` restricts by pool name."""
    _L.inc("evals")
    with obs.span("mgr.calc_eval"), _L.time("eval_seconds"):
        pe = _calc_eval(ms, pools)
        _L.observe("score", pe.score)
        obs.counter("mgr.score", pe.score)
    return pe


def _calc_eval(ms: MappingState, pools: list[str] | None) -> Eval:
    m = ms.osdmap
    pe = Eval(ms)
    pool_rule: dict[str, int] = {}
    for pid, pool in sorted(m.pools.items()):
        name = m.pool_name.get(pid, f"pool{pid}")
        if pools and name not in pools:
            continue
        ruleno = mapper_ref.find_rule(
            m.crush, pool.crush_rule, int(pool.type), pool.size
        )
        if ruleno < 0:
            continue
        pe.pool_name[pid] = name
        pe.pool_id[name] = pid
        pool_rule[name] = ruleno
        pe.pool_roots[name] = []

    # roots and weight-proportional targets (adjusted = crush weight x
    # in/out reweight, the weights calc_pg_upmaps balances to)
    for name, ruleno in pool_rule.items():
        for take in find_takes_by_rule(m.crush, ruleno):
            root = m.crush.item_names.get(take, str(take))
            pe.root_ids[root] = take
            if root not in pe.pool_roots[name]:
                pe.pool_roots[name].append(root)
            pe.root_pools.setdefault(root, []).append(name)
            if root in pe.target_by_root:
                continue
            wmap = get_rule_weight_osd_map(m.crush, ruleno)
            adj = {
                osd: w * (m.get_weightf(osd) if osd < m.max_osd else 0.0)
                for osd, w in wmap.items()
            }
            s = sum(adj.values())
            pe.target_by_root[root] = {
                osd: (w / s if s > 0 else 0.0) for osd, w in adj.items()
            }

    # actual distributions: one mapping pass per pool
    for root in pe.target_by_root:
        pe.count_by_root[root] = {
            t: {osd: 0 for osd in pe.target_by_root[root]}
            for t in METRICS
        }
        pe.total_by_root[root] = {t: 0 for t in METRICS}
    for name, ruleno in pool_rule.items():
        pid = pe.pool_id[name]
        pool = m.pools[pid]
        n = pool.pg_num
        stats = ms.pg_stats.get(pid, {})
        objs = stats.get("objects")
        byts = stats.get("bytes")
        o_pg = (np.asarray(objs[:n], np.int64) if objs is not None
                else np.ones(n, np.int64))
        b_pg = (np.asarray(byts[:n], np.int64) if byts is not None
                else o_pg << 22)
        if ms.on_device:
            # the rows stay on the device; the O(OSDs) counts come back
            c_pgs, c_obj, c_byt = ms.pool_counts(pid, o_pg, b_pg)
        else:
            rows = np.asarray(ms.pool_up(pid))[:n]
            valid = (rows != ITEM_NONE) & (rows >= 0)
            row_idx = np.nonzero(valid)[0]
            osds = rows[valid].astype(np.int64)
            minlen = int(osds.max()) + 1 if osds.size else 1
            c_pgs = np.bincount(osds, minlength=minlen)
            c_obj = np.bincount(
                osds, weights=o_pg[row_idx].astype(np.float64),
                minlength=minlen,
            )
            c_byt = np.bincount(
                osds, weights=b_pg[row_idx].astype(np.float64),
                minlength=minlen,
            )
        present = np.nonzero(c_pgs)[0]
        cnt = {
            "pgs": {int(o): int(c_pgs[o]) for o in present},
            "objects": {int(o): int(round(c_obj[o])) for o in present},
            "bytes": {int(o): int(round(c_byt[o])) for o in present},
        }
        tot = {t: sum(cnt[t].values()) for t in METRICS}
        pe.count_by_pool[name] = cnt
        pe.total_by_pool[name] = tot
        pe.actual_by_pool[name] = {
            t: {
                osd: v / tot[t] if tot[t] else 0.0
                for osd, v in cnt[t].items()
            }
            for t in METRICS
        }
        for root in pe.pool_roots[name]:
            rc = pe.count_by_root[root]
            rt = pe.total_by_root[root]
            for t in METRICS:
                for osd, v in cnt[t].items():
                    if osd in rc[t]:
                        rc[t][osd] += v
                        rt[t] += v

    for root, rc in pe.count_by_root.items():
        rt = pe.total_by_root[root]
        pe.actual_by_root[root] = {
            t: {
                osd: v / rt[t] if rt[t] else 0.0
                for osd, v in rc[t].items()
            }
            for t in METRICS
        }
        pe.stats_by_root[root] = pe.calc_stats(
            rc, pe.target_by_root[root], rt
        )
        pe.score_by_root[root] = {
            t: pe.stats_by_root[root][t]["score"] for t in METRICS
        }

    for name in pool_rule:
        target = {}
        for root in pe.pool_roots[name]:
            target.update(pe.target_by_root[root])
        st = pe.calc_stats(
            pe.count_by_pool[name], target, pe.total_by_pool[name]
        )
        pe.stats_by_pool[name] = st
        pe.score_by_pool[name] = sum(
            st[t]["score"] for t in METRICS
        ) / 3.0

    # overall: mean over roots and metrics (module.py:786-790)
    pe.score = 0.0
    for root, vs in pe.score_by_root.items():
        pe.score += vs["pgs"] + vs["objects"] + vs["bytes"]
    if pe.score_by_root:
        pe.score /= 3 * len(pe.score_by_root)
    return pe
