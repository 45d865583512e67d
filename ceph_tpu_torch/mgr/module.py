"""Balancer module: modes, plans and weight-set writing.

The port of `ceph_tpu/mgr/module.py` (reference pybind/mgr/balancer/
module.py):

- `Plan` (:30-58): a named pending change set, an OSDMap Incremental in
  `upmap` mode, a compat weight-set (and reweight nudges) in
  `crush-compat` mode, with the MappingState it was computed against.
- `Balancer.do_upmap` (:964-1029): the pools in shuffled order, each
  through the greedy optimizer (`balancer.upmap.calc_pg_upmaps`) until
  `upmap_max_optimizations` changes are spent; the pg_upmap_items land in
  the plan's Incremental.  A ClusterState behind the MappingState gives
  the optimizer its rows (`rows_source_for`).
- `Balancer.do_crush_compat` (:1031-1190): per-bucket weight-set steps
  toward target/actual, renormalised per root, each re-scored through
  `calc_eval`, keeping the best and halving the step on bad or
  misplacing moves; the result is a real `CrushMap.choose_args[-1]`
  entry, which the rule kernel reads as weight-set position 0.
- `Balancer.execute` (:1192-1230): the plan's Incremental applied, to
  the ClusterState that owns the map when one is given (O(delta) on the
  device), else through `osd.incremental.apply_incremental`.  With
  CEPH_TPU_PLACEMENT_DIAG=1 in the environment it then diagnoses the
  plan's pools on the new map (`PoolMapper.diagnose`, the rule kernel's
  diagnostics variant) and books the summary under source "mgr.<plan>"
  in `obs.placement`.  On a state placed on the host a device loss there
  skips the accounting and does not fail the execute whose Incremental
  already landed (the JAX package's contract); on a card it raises, as
  does any other error (`runtime.faults.degrade_or_raise`).

Scores come from `mgr.eval.calc_eval`; return codes are the reference's
negative errnos.
"""

from __future__ import annotations

import copy
import errno
import logging

import numpy as np

from ceph_tpu_torch import obs
from ceph_tpu_torch.crush.codec import encode_crushmap
from ceph_tpu_torch.crush.types import ChooseArgs, CrushMap
from ceph_tpu_torch.mgr.eval import Eval, MappingState, calc_eval
from ceph_tpu_torch.osd.incremental import Incremental, apply_incremental
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.utils import knobs

_log = logging.getLogger("ceph_tpu_torch.mgr")

_L = obs.logger_for("mgr")
_L.add_u64("plans_computed", "optimization plans computed")
_L.add_u64("upmap_changes", "pg_upmap_items changes planned by do_upmap")
_L.add_u64("compat_iterations", "crush-compat weight-set iterations")
_L.add_u64("compat_bad_steps",
           "crush-compat iterations that worsened the score")
_L.add_time_avg("optimize_seconds", "wall time per optimize() call")

# module options and defaults (reference module.py MODULE_OPTIONS)
DEFAULT_OPTIONS: dict = {
    "mode": "upmap",
    "upmap_max_deviation": 5,        # osd_calc_pg_upmaps default
    "upmap_max_optimizations": 10,
    "crush_compat_max_iterations": 25,
    "crush_compat_step": 0.5,
    "crush_compat_metrics": "pgs,objects,bytes",
    "min_score": 0.0,
    "target_max_misplaced_ratio": 0.05,
    # sets | device | device_loop (balancer.state / balancer.upmap)
    "upmap_state_backend": "sets",
    # 0 = the reference's sequential greedy; N>0 = the candidate-batched
    # optimizer (device_loop: candidates per plan round, 16 when 0)
    "upmap_candidate_batch": 0,
}

MODES = ("none", "upmap", "crush-compat")


# -- compat weight-set <-> choose_args --------------------------------------

def get_compat_weight_set_weights(crush: CrushMap) -> dict[int, float]:
    """Per-OSD weights of the compat (-1) choose_args entry, position 0
    (reference module.py:90).  Without an entry, the current crush
    weights: what the mon's `crush weight-set create-compat` seeds."""
    ca = crush.choose_args.get(-1)
    ws: dict[int, float] = {}
    shadows = {
        sid for per in crush.class_bucket.values() for sid in per.values()
    }
    for bid, b in crush.buckets.items():
        if bid in shadows:
            continue
        row = None
        if ca is not None:
            rows = ca.weight_sets.get(bid)
            if rows:
                row = rows[0]
        if row is None:
            row = b.weights
        for it, w in zip(b.items, row):
            if it >= 0:
                ws[it] = w / 0x10000
    return ws


def compat_ws_to_choose_args(
    crush: CrushMap, ws: dict[int, float]
) -> ChooseArgs:
    """Per-OSD weight-set weights as a full per-bucket choose_args entry:
    device items take ws[osd], bucket items their subtree's weight-set
    sum (how the mon keeps compat weight-set internal nodes consistent,
    reference CrushWrapper::choose_args_adjust_item_weight)."""
    ca = ChooseArgs()
    memo: dict[int, float] = {}

    def wsum(item: int) -> float:
        if item >= 0:
            return float(ws.get(item, 0.0))
        if item in memo:
            return memo[item]
        memo[item] = 0.0  # cycle guard
        b = crush.buckets.get(item)
        if b is not None:
            memo[item] = sum(wsum(it) for it in b.items)
        return memo[item]

    for bid, b in crush.buckets.items():
        row = []
        for it, w in zip(b.items, b.weights):
            if it >= 0:
                row.append(int(round(ws.get(it, w / 0x10000) * 0x10000)))
            else:
                row.append(int(round(wsum(it) * 0x10000)))
        ca.weight_sets[bid] = [row]
    return ca


# -- plans ------------------------------------------------------------------

class Plan:
    """A named pending optimization (reference module.py:30-58)."""

    def __init__(self, name: str, mode: str, ms: MappingState,
                 pools: list[str] | None = None):
        self.name = name
        self.mode = mode
        self.initial = ms
        self.pools = list(pools or [])
        # the working map the optimizers change; `initial` stays as it is
        self.osdmap: OSDMap = copy.deepcopy(ms.osdmap)
        self.inc = Incremental(epoch=ms.osdmap.epoch + 1)
        self.compat_ws: dict[int, float] = {}
        self.osd_weights: dict[int, float] = {}
        # do_crush_compat's accepted state's Eval, so callers need not
        # map and score the final state again
        self.final_eval: Eval | None = None

    def final_state(self) -> MappingState:
        """MappingState of the plan applied, with the same pg_stats
        table: stats belong to PGs, only the mapping changes."""
        return MappingState(
            self.osdmap, self.initial.pg_stats,
            desc=f"plan {self.name} final", mapper=self.initial.mapper,
            device=self.initial.device,
        )

    def finalize_inc(self) -> Incremental:
        """Fill the Incremental for `execute`: the upmap items are
        recorded by do_upmap; a compat weight-set rides the new-crush
        blob (applied last, reference OSDMap.cc:2330-2341)."""
        if self.compat_ws:
            crush = self.osdmap.crush
            crush.choose_args[-1] = compat_ws_to_choose_args(
                crush, self.compat_ws
            )
            self.inc.crush = encode_crushmap(crush)
        for osd, w in self.osd_weights.items():
            self.inc.new_weight[osd] = int(round(w * 0x10000))
        return self.inc

    def show(self) -> str:
        out = [
            f"plan {self.name}",
            f"mode {self.mode}",
            f"pools {self.pools or 'all'}",
        ]
        if self.inc.new_pg_upmap_items or self.inc.old_pg_upmap_items:
            for pg in sorted(
                self.inc.new_pg_upmap_items, key=lambda p: (p.pool, p.seed)
            ):
                pairs = self.inc.new_pg_upmap_items[pg]
                out.append(
                    f"ceph osd pg-upmap-items {pg.pool}.{pg.seed:x} "
                    + " ".join(f"{a} {b}" for a, b in pairs)
                )
            for pg in sorted(
                self.inc.old_pg_upmap_items, key=lambda p: (p.pool, p.seed)
            ):
                out.append(f"ceph osd rm-pg-upmap-items {pg.pool}.{pg.seed:x}")
        if self.compat_ws:
            for osd in sorted(self.compat_ws):
                out.append(
                    f"ceph osd crush weight-set reweight-compat osd.{osd} "
                    f"{self.compat_ws[osd]:.6f}"
                )
        for osd in sorted(self.osd_weights):
            out.append(
                f"ceph osd reweight osd.{osd} {self.osd_weights[osd]:.6f}"
            )
        return "\n".join(out)


# -- the module -------------------------------------------------------------

class Balancer:
    """Mode dispatch and plan bookkeeping (reference module.py Module)."""

    def __init__(self, options: dict | None = None,
                 rng: np.random.Generator | None = None):
        self.options = dict(DEFAULT_OPTIONS)
        if options:
            self.options.update(options)
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.plans: dict[str, Plan] = {}
        self.last_eval: Eval | None = None

    def get_option(self, name: str):
        return self.options[name]

    # -- queries ----------------------------------------------------------
    def status(self) -> dict:
        return {
            "mode": self.get_option("mode"),
            "plans": sorted(self.plans),
            "last_score": (
                round(self.last_eval.score, 6) if self.last_eval else None
            ),
            "options": {
                k: v for k, v in self.options.items()
                if k in DEFAULT_OPTIONS
            },
        }

    def eval(self, ms: MappingState, pools: list[str] | None = None) -> Eval:
        pe = calc_eval(ms, pools)
        self.last_eval = pe
        return pe

    # -- planning ----------------------------------------------------------
    def plan_create(self, name: str, ms: MappingState,
                    pools: list[str] | None = None,
                    mode: str | None = None) -> Plan:
        mode = mode or self.get_option("mode")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        plan = Plan(name, mode, ms, pools)
        self.plans[name] = plan
        return plan

    def optimize(self, plan: Plan) -> tuple[int, str]:
        """Dispatch by mode (reference module.py:930-962)."""
        _L.inc("plans_computed")
        with obs.span("mgr.optimize", mode=plan.mode), \
                _L.time("optimize_seconds"):
            if plan.mode == "upmap":
                return self.do_upmap(plan)
            if plan.mode == "crush-compat":
                return self.do_crush_compat(plan)
            if plan.mode == "none":
                return -errno.ENOEXEC, "balancer mode is 'none'"
            return -errno.EINVAL, f"unrecognized mode {plan.mode!r}"

    # -- upmap mode --------------------------------------------------------
    def do_upmap(self, plan: Plan) -> tuple[int, str]:
        """reference module.py:964-1029."""
        from ceph_tpu_torch.balancer.upmap import calc_pg_upmaps

        max_optimizations = int(self.get_option("upmap_max_optimizations"))
        max_deviation = int(self.get_option("upmap_max_deviation"))
        m = plan.osdmap
        if plan.pools:
            pools = [p for p in plan.pools if p in m.pool_name.values()]
        else:
            pools = sorted(m.pool_name.values())
        if not pools:
            return -errno.ENOENT, "No pools available"
        # equal (in)attention across invocations (module.py:984)
        self.rng.shuffle(pools)
        by_name = {v: k for k, v in m.pool_name.items()}
        total_did = 0
        left = max_optimizations
        ms = plan.initial
        # a ClusterState behind the MappingState serves the membership
        # rows of the pools whose working-copy overlays still match
        rows_source = (ms.state.rows_source_for(m)
                       if ms.state is not None else None)
        for pool in pools:
            pid = by_name[pool]
            with obs.span("mgr.do_upmap_pool", pool=pid, left=left):
                res = calc_pg_upmaps(
                    m, max_deviation=max_deviation, max_iter=left,
                    only_pools={pid}, use_tpu=ms.on_device, rng=self.rng,
                    backend=self.get_option("upmap_state_backend"),
                    rows_source=rows_source,
                    candidate_batch=int(
                        self.get_option("upmap_candidate_batch")),
                    device=ms.device,
                )
            did = res.num_changed
            for pg, items in res.new_pg_upmap_items.items():
                plan.inc.new_pg_upmap_items[pg] = list(items)
                plan.inc.old_pg_upmap_items.discard(pg)
            for pg in res.old_pg_upmap_items:
                if pg in plan.inc.new_pg_upmap_items:
                    del plan.inc.new_pg_upmap_items[pg]
                plan.inc.old_pg_upmap_items.add(pg)
            total_did += did
            left -= did
            if left <= 0:
                break
        _L.inc("upmap_changes", total_did)
        _log.debug("do_upmap: %d changes over %d pools", total_did,
                   len(pools))
        if total_did == 0:
            return -errno.EALREADY, (
                "Unable to find further optimization, or pools' "
                "pg_num is decreasing, or distribution is already perfect"
            )
        return 0, ""

    # -- crush-compat mode -------------------------------------------------
    def do_crush_compat(self, plan: Plan) -> tuple[int, str]:
        """reference module.py:1031-1190."""
        max_iterations = int(self.get_option("crush_compat_max_iterations"))
        if max_iterations < 1:
            return -errno.EINVAL, '"crush_compat_max_iterations" must be >= 1'
        step = float(self.get_option("crush_compat_step"))
        if step <= 0 or step >= 1.0:
            return -errno.EINVAL, (
                '"crush_compat_step" must be in (0, 1)'
            )
        max_misplaced = float(self.get_option("target_max_misplaced_ratio"))
        min_score = float(self.get_option("min_score"))

        ms = plan.initial
        m = plan.osdmap
        pe = self.eval(ms, plan.pools)
        if pe.score <= min_score:
            if pe.score == 0:
                return -errno.EALREADY, "Distribution is perfect"
            return -errno.EALREADY, (
                f"score {pe.score:.6f} <= min_score {min_score:.6f}, "
                "will not optimize"
            )

        orig_osd_weight = {
            osd: ms.osdmap.get_weightf(osd)
            for osd in range(ms.osdmap.max_osd)
        }
        orig_choose_args = m.crush.choose_args.get(-1)
        orig_ws = get_compat_weight_set_weights(m.crush)
        orig_ws = {a: b for a, b in orig_ws.items() if a >= 0}

        # roots must not share devices (module.py:1060-1075)
        visited: dict[int, str] = {}
        overlap: dict[int, list[str]] = {}
        for root, wm in pe.target_by_root.items():
            for osd in wm:
                if osd in visited:
                    overlap.setdefault(osd, [visited[osd]]).append(root)
                visited[osd] = root
        if overlap:
            return -errno.EOPNOTSUPP, (
                f"Some osds belong to multiple subtrees: {overlap}"
            )

        metrics = str(self.get_option("crush_compat_metrics")).split(",")
        key = metrics[0]  # balancing by the first metric (module.py:1082)
        if key not in ("pgs", "objects", "bytes"):
            return -errno.EINVAL, (
                f"unknown metric type {key!r}"
            )

        roots = sorted(pe.target_by_root)
        best_ws = dict(orig_ws)
        best_ow = dict(orig_osd_weight)
        best_pe = pe
        left = max_iterations
        bad_steps = 0
        next_ws = dict(best_ws)
        next_ow = dict(best_ow)
        while left > 0:
            _L.inc("compat_iterations")
            self.rng.shuffle(roots)
            for root in roots:
                target = best_pe.target_by_root[root]
                actual = best_pe.actual_by_root[root][key]
                queue = sorted(
                    actual.keys(),
                    key=lambda osd: (-abs(target[osd] - actual[osd]), osd),
                )
                for osd in queue:
                    if orig_osd_weight.get(osd, 0) == 0:
                        continue  # skip out osds (module.py:1106)
                    deviation = target[osd] - actual[osd]
                    if deviation == 0:
                        break
                    weight = best_ws[osd]
                    ow = orig_osd_weight[osd]
                    if actual[osd] > 0:
                        calc_weight = target[osd] / actual[osd] * weight * ow
                    else:
                        # newly created osds absorb `step` of their
                        # target on the next iteration (module.py:1118)
                        calc_weight = target[osd]
                    new_weight = weight * (1.0 - step) + calc_weight * step
                    next_ws[osd] = new_weight
                    if ow < 1.0:
                        next_ow[osd] = min(
                            1.0, max(step + (1.0 - step) * ow, ow + 0.005)
                        )
                # normalise the weight-set sum back to the root's crush
                # weight (module.py:1135-1146)
                root_id = pe.root_ids[root]
                rb = m.crush.buckets.get(root_id)
                root_weight = (rb.weight / 0x10000) if rb else 0.0
                root_sum = sum(
                    b for a, b in next_ws.items() if a in target
                )
                if root_sum > 0 and root_weight > 0:
                    factor = root_sum / root_weight
                    for osd in actual:
                        next_ws[osd] = next_ws[osd] / factor

            # score the candidate weight-set
            plan.compat_ws = dict(next_ws)
            plan.osd_weights = {
                osd: w for osd, w in next_ow.items()
                if w != orig_osd_weight.get(osd)
            }
            m.crush.choose_args[-1] = compat_ws_to_choose_args(
                m.crush, next_ws
            )
            for osd, w in next_ow.items():
                m.osd_weight[osd] = int(round(w * 0x10000))
            next_ms = plan.final_state()
            next_pe = self.eval(next_ms, plan.pools)
            next_misplaced = next_ms.misplaced_from(ms)
            _log.debug("Step result score %.6f -> %.6f, misplacing %.4f",
                       best_pe.score, next_pe.score, next_misplaced)

            if next_misplaced > max_misplaced:
                if best_pe.score < pe.score:
                    break  # good enough; stop before misplacing more
                step /= 2.0
                next_ws = dict(best_ws)
                next_ow = dict(best_ow)
            elif next_pe.score > best_pe.score * 1.0001:
                # the score got worse (module.py:1168-1178)
                _L.inc("compat_bad_steps")
                bad_steps += 1
                if bad_steps < 5 and int(self.rng.integers(0, 100)) < 70:
                    pass  # take another step anyway
                else:
                    step /= 2.0
                    next_ws = dict(best_ws)
                    next_ow = dict(best_ow)
                    bad_steps = 0
            else:
                bad_steps = 0
                best_pe = next_pe
                best_ws = dict(next_ws)
                best_ow = dict(next_ow)
                if best_pe.score == 0:
                    break
            left -= 1

        # a small regression is allowed while phasing out reweights
        # (module.py:1183-1186)
        fudge = 0.001 if best_ow != orig_osd_weight else 0.0

        if best_pe.score < pe.score + fudge:
            plan.compat_ws = best_ws
            plan.osd_weights = {
                osd: w for osd, w in best_ow.items()
                if w != orig_osd_weight.get(osd)
            }
            # leave the working map in the best state, not the last tried
            m.crush.choose_args[-1] = compat_ws_to_choose_args(
                m.crush, best_ws
            )
            for osd, w in best_ow.items():
                m.osd_weight[osd] = int(round(w * 0x10000))
            plan.final_eval = best_pe
            _log.debug("do_crush_compat: score %.6f -> %.6f", pe.score,
                       best_pe.score)
            return 0, ""
        # failure: the working map must match the (empty) plan, not the
        # last rejected candidate: restore the weight-set and reweights
        plan.compat_ws = {}
        plan.osd_weights = {}
        if orig_choose_args is None:
            m.crush.choose_args.pop(-1, None)
        else:
            m.crush.choose_args[-1] = orig_choose_args
        for osd, w in orig_osd_weight.items():
            m.osd_weight[osd] = int(round(w * 0x10000))
        return -errno.EDOM, (
            "Unable to find further optimization, change balancer "
            "mode and retry might help"
        )

    # -- execution ---------------------------------------------------------
    def execute(self, plan: Plan, m: OSDMap,
                state=None) -> tuple[int, str]:
        """Apply the plan to `m` (reference module.py:1192-1230 issues
        mon commands; here the plan is an Incremental).  With `state`,
        the ClusterState that owns `m`, the delta lands on the device in
        O(delta): upmap plans become overlay fixups, compat weight-sets an
        upload of the weight-set planes, with no rebuild."""
        inc = plan.finalize_inc()
        if inc.epoch != m.epoch + 1:
            return -errno.ESTALE, (
                f"plan epoch {inc.epoch} != map epoch {m.epoch}+1 "
                "(map changed since the plan was computed)"
            )
        with obs.span("mgr.execute", plan=plan.name, mode=plan.mode):
            if state is not None and state.m is m:
                state.apply(inc)
            else:
                apply_incremental(m, inc)
        self._diagnose_executed(plan, m, state)
        return 0, ""

    def _diagnose_executed(self, plan: Plan, m: OSDMap, state=None) -> None:
        """Post-execute decision accounting (CEPH_TPU_PLACEMENT_DIAG=1):
        the diagnostics of the plan's pools on the map the plan just
        produced, booked under source "mgr.<plan>" (the JAX package's
        `_diagnose_executed`).  On the state's device and tables when the
        state owns `m`, else on the plan's device.  On the host a device
        loss skips the accounting (the execute already landed); on a
        card it raises, as does any other error."""
        if knobs.get("CEPH_TPU_PLACEMENT_DIAG", "0") != "1":
            return
        from ceph_tpu_torch.obs import placement
        from ceph_tpu_torch.osd.pipeline import PoolMapper
        from ceph_tpu_torch.runtime import faults

        own = state is not None and state.m is m
        by_name = {v: k for k, v in m.pool_name.items()}
        pids = sorted(
            by_name[p] for p in (plan.pools or m.pool_name.values())
            if p in by_name
        )
        agg: dict = {"epoch": int(m.epoch), "mode": plan.mode}
        for pid in pids:
            pm = (PoolMapper(m, pid, state=state) if own
                  else PoolMapper(m, pid, device=plan.initial.device))
            # on the host, diagnostics never fail an execute whose
            # incremental already landed (as ClusterSim._diagnose_epoch)
            try:
                placement.fold_summary(agg, pm.diagnose(record=False))
            except Exception as e:
                faults.degrade_or_raise(e, pm.device, book=False)
                _log.warning("device lost diagnosing pool %d (%s); "
                             "skipping placement accounting", pid, e)
                return
        placement.record(f"mgr.{plan.name}", agg)
