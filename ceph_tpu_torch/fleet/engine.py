"""Fleet engine: N independent clusters, one stacked stats call per epoch.

The port of `ceph_tpu/fleet/engine.py` (`FleetSim`).  A fleet epoch
runs every live member's `_step_begin` (the chaos event), then reduces
the epoch stats of every device member's changed pools through ONE
`lifetime._stats_lanes` call over a leading lane axis (`_plan_pool` /
`_commit_pool` are the solo engine's own read and write halves, and its
solo stats are the L = 1 case of the same function, so each member's
SHA-256 replay digest equals a solo run's of the same scenario), then
every member's `_step_finish` (recovery drain, workload, durability
ledger, digest line).

Exactness of the stacking: the lanes are copied into one [L, Nmax, Wmax]
block filled with ITEM_NONE, every `core.reduce` reduction ignores
ITEM_NONE lanes, and `real = arange(Nmax) < min(n, N_i)` masks the
padded rows, so no padded element reaches a sum; each lane's per-PG
moved counts come back at its own row count.

Differences from the JAX engine, by design:
- No host degradation: a device error, or an injected
  `epoch_apply=lost`, raises out of `step()` (the port's `LifetimeSim`
  does the same).
- A lane whose rows' version tag did not change replays its stats from
  the member's cache and rides no stats call (the JAX engine rides it as
  a discarded self-compare to keep its compiled structure fixed; the
  port compiles nothing), so a fleet epoch with no changed tag makes no
  stats call.  `warm()` has nothing to warm.
- `trace_once`'s compile fields read 0, as the port's lifetime ones do.

The whole stack checkpoints atomically into ONE file (every member's
`_state()` slice plus the pinned member list, the JAX package's layout);
resume refuses any drift in cluster count, order, any member's spec or
backend (jax and torch are one backend) with a per-cluster diff.

`obs.health` and the timeline's "sim" series are process-global and
interleave member samples (observation runs after the digest update, so
this cannot move a digest).

`CEPH_TPU_FLEET_STACK=0` in the environment solo-steps every member;
`CEPH_TPU_FLEET_CHECKPOINT_EVERY` (default 50) sets the checkpoint
cadence in fleet epochs.
"""

from __future__ import annotations

import time

from ceph_tpu_torch import obs
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.fleet import pareto as pareto_mod
from ceph_tpu_torch.fleet.spec import FleetMember, parse_fleet
from ceph_tpu_torch.runtime import Checkpoint, faults
from ceph_tpu_torch.sim import lifetime
from ceph_tpu_torch.sim.lifetime import BACKENDS, LifetimeSim
from ceph_tpu_torch.utils import knobs
from ceph_tpu_torch.utils.perf_counters import counters_attr

# The JAX package's `fleet` perf group (`host_lanes` the pools a member
# accounted itself, "ref" members or every member with
# CEPH_TPU_FLEET_STACK=0; no `steady_compiles`: the port compiles
# nothing, and COUNTERS reads it as 0), plus the port's `stats_calls`
# (the stacked `_stats_lanes` calls), `cached_lanes` (the tag-equal
# lanes replayed without one) and `solo_lanes` (as host_lanes, the name
# the port's tests read).
_L = obs.logger_for("fleet")
_L.add_u64("epochs", "fleet epoch batches stepped")
_L.add_u64("cluster_epochs", "member cluster-epochs advanced")
_L.add_u64("stacked_lanes",
           "pool lanes accounted through the ONE stacked stats call")
_L.add_u64("host_lanes",
           "pool lanes accounted by a member itself (ref members, or "
           "CEPH_TPU_FLEET_STACK=0)")
_L.add_u64("structural_epochs",
           "fleet epochs that changed a member's pool structure")
_L.add_u64("steady_epochs", "fleet epochs with unchanged structure")
_L.add_u64("checkpoints", "fleet stack checkpoints flushed")
_L.add_time_avg("epoch_seconds", "one fleet epoch batch wall time")
_L.add_u64("stats_calls", "stacked _stats_lanes calls")
_L.add_u64("cached_lanes",
           "tag-equal pool lanes replayed without a stats call")
_L.add_u64("solo_lanes", "pool lanes a member accounted itself")
__getattr__ = counters_attr("fleet", __name__, (
    "epochs", "cluster_epochs", "stats_calls", "stacked_lanes",
    "cached_lanes", "solo_lanes", "structural_epochs", "steady_epochs",
    "steady_compiles", "checkpoints"))


def _inc(name: str, n: int = 1) -> None:
    _L.inc(name, int(n))


def _spec_diff(have: str, want: str) -> list[str]:
    """Per-field diff of two Scenario.spec() strings (field order is
    fixed by the dataclass, so a dict compare is complete)."""
    ha = dict(it.split("=", 1) for it in have.split(",") if "=" in it)
    wa = dict(it.split("=", 1) for it in want.split(",") if "=" in it)
    out = []
    for k in list(ha) + [k for k in wa if k not in ha]:
        if ha.get(k) != wa.get(k):
            out.append(f"{k}: checkpoint {ha.get(k)!r} != "
                       f"requested {wa.get(k)!r}")
    if not out and have != want:
        out.append(f"spec: checkpoint {have!r} != requested {want!r}")
    return out


class FleetSim:
    """N pinned clusters advanced in lockstep, the device members' stats
    through one stacked call per fleet epoch.

    device: where the device members run (None: the card; "cpu" runs the
    plain versions).  balancer_backend: the upmap state backend every
    device member's balancer rounds use (the JAX engine's default,
    "device_loop")."""

    def __init__(self, members: list[FleetMember], checkpoint=None,
                 resume: bool = False, device=None,
                 balancer_backend: str | None = "device_loop"):
        if not members:
            raise ValueError("fleet has no members")
        self.members = list(members)
        on_device = [BACKENDS.get(m.backend) == "torch"
                     for m in self.members]
        self.device = resolve_device(device) if any(on_device) else None
        self.balancer_backend = balancer_backend
        self.stack = knobs.get("CEPH_TPU_FLEET_STACK", "1") != "0"
        self.checkpoint_every = int(
            knobs.get("CEPH_TPU_FLEET_CHECKPOINT_EVERY", "50"))
        self.steps = 0
        self.structural_epochs = 0
        self.steady_epochs = 0
        self.steady_compiles = 0
        self.steady_pipe_misses = 0
        self.total_compiles = 0
        self.resumed_from: int | None = None
        self._cluster_epochs = 0
        self._cluster_epochs_this_proc = 0
        self._wall_this_proc = 0.0
        self._prev_sig = None

        self.ck = Checkpoint(checkpoint, resume=resume) \
            if checkpoint else None
        state = (self.ck.data.get("fleet")
                 if (self.ck is not None and resume) else None)
        if resume and state is None:
            raise ValueError(
                f"--resume: checkpoint {checkpoint!r} has no fleet "
                "state to resume from")
        slices: list[dict | None] = [None] * len(self.members)
        if state is not None:
            self._validate_resume(state)
            self.steps = int(state["epoch"])
            self.resumed_from = self.steps
            c = state.get("counters") or {}
            self.structural_epochs = int(c.get("structural_epochs", 0))
            self.steady_epochs = int(c.get("steady_epochs", 0))
            self.steady_compiles = int(c.get("steady_compiles", 0))
            self.steady_pipe_misses = int(
                c.get("steady_pipe_misses", 0))
            self.total_compiles = int(c.get("total_compiles", 0))
            self._cluster_epochs = int(c.get("cluster_epochs", 0))
            slices = list(state["clusters"])
        self.engines: list[LifetimeSim] = []
        for m, dev_member, sl in zip(self.members, on_device, slices):
            sim = LifetimeSim(m.scenario, backend=m.backend,
                              device=self.device if dev_member else None,
                              restore_state=sl)
            if dev_member and balancer_backend:
                sim.balancer_options = {
                    "upmap_state_backend": balancer_backend}
            self.engines.append(sim)

    @classmethod
    def from_spec(cls, spec: str, **kw) -> "FleetSim":
        return cls(parse_fleet(spec), **kw)

    # -- checkpoint/resume -------------------------------------------------

    def _validate_resume(self, state: dict) -> None:
        want = [(m.scenario.spec(), m.backend) for m in self.members]
        have = [(c["scenario"], c["backend"])
                for c in state.get("members", [])]
        diffs = []
        if len(have) != len(want):
            diffs.append(f"cluster count: checkpoint {len(have)} != "
                         f"requested {len(want)}")
        for i in range(min(len(have), len(want))):
            hs, hb = have[i]
            ws, wb = want[i]
            for line in _spec_diff(hs, ws):
                diffs.append(f"cluster {i}: {line}")
            if BACKENDS.get(hb, hb) != BACKENDS.get(wb, wb):
                diffs.append(f"cluster {i}: backend: checkpoint "
                             f"{hb!r} != requested {wb!r}")
        if diffs:
            raise ValueError(
                "fleet checkpoint does not match the requested fleet "
                "(count, order, and every member's pinned spec must be "
                "identical):\n  " + "\n  ".join(diffs))

    def _state(self) -> dict:
        return {
            "epoch": self.steps,
            "members": [{"index": m.index,
                         "scenario": m.scenario.spec(),
                         "backend": m.backend}
                        for m in self.members],
            "clusters": [sim._state() for sim in self.engines],
            "counters": {
                "structural_epochs": self.structural_epochs,
                "steady_epochs": self.steady_epochs,
                "steady_compiles": self.steady_compiles,
                "steady_pipe_misses": self.steady_pipe_misses,
                "total_compiles": self.total_compiles,
                "cluster_epochs": self._cluster_epochs,
            },
        }

    def checkpoint(self) -> None:
        if self.ck is None:
            return
        self.ck.progress("fleet", self._state())
        _inc("checkpoints")
        obs.instant("fleet.checkpoint", epoch=self.steps)

    # -- stepping ----------------------------------------------------------

    def live(self) -> list[LifetimeSim]:
        return [s for s in self.engines
                if s.steps < s.scenario.epochs]

    def warm(self) -> None:
        """The JAX engine's warm-up dispatch of its stacked executable.
        The port compiles nothing per shape, so there is nothing to warm:
        kept for the JAX call sequence, it does no work."""

    def _account(self, ctxs: list) -> dict:
        """Account every begun member's epoch: "ref" members (and every
        member when unstacked) through their own `_account_epoch`, the
        device members' changed pools through one `_stats_lanes` call.
        Returns {id(sim): (stats, skeys)}."""
        plans: dict[int, tuple] = {}
        lanes: list[tuple] = []  # (sim, lane) in call order
        stacked_sims = []
        for sim, ctx in ctxs:
            e = ctx["e"]
            if not (self.stack and sim.state is not None):
                st, sk = sim._account_epoch(e)
                plans[id(sim)] = (st, set(sk))
                _inc("solo_lanes", len(st))
                _inc("host_lanes", len(st))
                continue
            stacked_sims.append(sim)
            stats: dict[int, dict] = {}
            skeys: set = set()
            for pid in sorted(sim.m.pools):
                # an injected device loss raises out of step()
                faults.check("epoch_apply", qual=str(e))
                lane, skey = sim._plan_pool(pid)
                skeys.add(skey)
                if lane["cached"] is not None:
                    stats[pid] = sim._commit_pool(lane, None, None)
                    _inc("cached_lanes")
                else:
                    stats[pid] = None
                    lanes.append((sim, lane))
            plans[id(sim)] = (stats, skeys)
        if lanes:
            out, moved = lifetime._stats_lanes(
                [lane["prev"] for _, lane in lanes],
                [lane["rows"] for _, lane in lanes],
                [lane["n"] for _, lane in lanes],
                [lane["size"] for _, lane in lanes],
                [lane["tol"] for _, lane in lanes])
            rows_np = obs.timed_fetch(_L, "stack_stats", out)
            _inc("stats_calls")
            _inc("stacked_lanes", len(lanes))
            for (sim, lane), row, mv in zip(lanes, rows_np.tolist(), moved):
                plans[id(sim)][0][lane["pid"]] = sim._commit_pool(
                    lane, row, mv)
        for sim in stacked_sims:
            sim._prune_removed_pools()
        return {k: (st, frozenset(sk)) for k, (st, sk) in plans.items()}

    def step(self) -> list[dict]:
        """One fleet epoch: every live member advances one lifetime
        epoch; the stacked accounting is one stats call.  Returns the
        per-member step records (in member order)."""
        live = self.live()
        if not live:
            return []
        t0 = time.perf_counter()
        fspan = obs.span("fleet.epoch", epoch=self.steps + 1,
                         clusters=len(live))
        fspan.__enter__()
        ctxs: list[tuple] = []   # begun, not yet finished
        recs = []
        try:
            for sim in live:
                ctxs.append((sim, sim._step_begin(None)))
            plans = self._account(ctxs)
            for sim, ctx in list(ctxs):
                stats, skeys = plans[id(sim)]
                rec = sim._step_finish(ctx, stats, skeys)
                ctxs.remove((sim, ctx))   # its span is closed now
                recs.append(rec)
        except BaseException:
            for _, ctx in ctxs:
                ctx["span"].__exit__(None, None, None)
            raise
        finally:
            fspan.__exit__(None, None, None)
        compiles = 0  # the port compiles nothing per shape
        sig = tuple((id(sim), plans[id(sim)][1]) for sim in live)
        structural = (any(r["structural"] for r in recs)
                      or self._prev_sig is None
                      or sig != self._prev_sig)
        self._prev_sig = sig
        self.total_compiles += compiles
        if structural:
            self.structural_epochs += 1
            _inc("structural_epochs")
        else:
            self.steady_epochs += 1
            self.steady_compiles += compiles
            _inc("steady_epochs")
        self.steps += 1
        self._cluster_epochs += len(live)
        self._cluster_epochs_this_proc += len(live)
        wall = time.perf_counter() - t0
        self._wall_this_proc += wall
        _inc("epochs")
        _inc("cluster_epochs", len(live))
        _L.observe("epoch_seconds", wall)
        if (self.ck is not None and self.checkpoint_every
                and self.steps % self.checkpoint_every == 0):
            self.checkpoint()
        return recs

    def run(self, epochs: int | None = None,
            stop_after: int | None = None) -> dict:
        total = epochs if epochs is not None \
            else max(m.scenario.epochs for m in self.members)
        while self.steps < total and self.live():
            if stop_after is not None and self.steps >= stop_after:
                break
            self.step()
        self.checkpoint()
        return self.summary()

    # -- reporting ---------------------------------------------------------

    def digests(self) -> list[str]:
        return [sim.digest for sim in self.engines]

    def points(self) -> list[pareto_mod.Point]:
        """Per-member pareto points with front/dominated accounting
        resolved (feeds `pareto.triage_table`)."""
        pts = [pareto_mod.Point.from_summary(
            m.index, m.scenario.spec(), sim.summary())
            for m, sim in zip(self.members, self.engines)]
        pareto_mod.pareto_front(pts)
        return pts

    def summary(self) -> dict:
        member_rows = []
        points = []
        for m, sim in zip(self.members, self.engines):
            s = sim.summary()
            p = pareto_mod.Point.from_summary(
                m.index, m.scenario.spec(), s)
            points.append(p)
            member_rows.append({
                "index": m.index,
                "scenario": m.scenario.spec(),
                "backend": m.backend,
                "epochs": sim.steps,
                "digest": sim.digest,
                "steady_compiles": sim.steady_compiles,
                "invariant_violations": len(sim.violations),
                "pg_lost": sim.pg_lost_total,
                "pareto": dict(p.values),
            })
        front, dominated = pareto_mod.pareto_front(points)
        wall = self._wall_this_proc
        out = {
            "clusters": len(self.engines),
            "fleet_epochs": self.steps,
            "cluster_epochs": self._cluster_epochs,
            "stacked": self.stack,
            "balancer_backend": self.balancer_backend,
            "trace_once": {
                "structural_epochs": self.structural_epochs,
                "steady_epochs": self.steady_epochs,
                "steady_compiles": self.steady_compiles,
                "steady_pipe_misses": self.steady_pipe_misses,
                "total_compiles": self.total_compiles,
            },
            "wall_s": round(wall, 3),
            "cluster_epochs_per_sec": round(
                self._cluster_epochs_this_proc / wall, 2
            ) if wall else 0.0,
            "members": member_rows,
            "pareto": {
                "front": [dict(p.values, index=p.index)
                          for p in front],
                "front_size": len(front),
                "dominated": [{"index": p.index,
                               "dominated_by": p.dominated_by}
                              for p in dominated],
            },
        }
        if self.resumed_from is not None:
            out["resumed_from"] = self.resumed_from
        return out
