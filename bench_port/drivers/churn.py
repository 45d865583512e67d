"""OSDMap epochs under failure churn: apply, then every PG's `up` rows.

Each operation is one epoch: `ClusterState.apply(inc)` of the next
Incremental of a cycle, then `ClusterState.rows(pool)`, which remaps
every PG of the pool on the card.  The cycle's steps (the traffic's
`cycle`) act on a host and a set of OSDs drawn from the seed:

- `host_down`: the host's OSDs marked down;
- `host_out`: the same OSDs marked out (reweight 0);
- `reweight`: `reweight_osds` other OSDs reweighted to `reweight_to`
  (16.16, truncated as `ceph osd reweight` truncates);
- `restore`: the host's OSDs up and in, the reweights back to 1.0.

The check holds the rows of the window's last full cycle, every PG, and
a seeded sample of `check_sample_pgs` PGs of every epoch, to the plain
reference (`reference/placement.py`), which advances its own map state
from the same deltas.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from bench_port import system
from bench_port.harness import Parts
from bench_port.reference.placement import MapState, PoolReference

IN = 0x10000


def cycle_deltas(cfg: dict, params: dict, seed: int) -> list[dict]:
    """The cycle's deltas, as plain dicts, for this seed."""
    rng = np.random.default_rng([seed, 0x636875726E])
    per_host = cfg["osds_per_host"]
    racks = cfg["racks"]
    # hosts under the root: a map with racks holds racks * (hosts // racks)
    in_tree = racks * (cfg["hosts"] // racks) if racks else cfg["hosts"]
    host = int(rng.integers(0, in_tree))
    osds = list(range(host * per_host, (host + 1) * per_host))
    others = np.setdiff1d(np.arange(in_tree * per_host), osds)
    rw = sorted(int(o) for o in rng.choice(others, params["reweight_osds"],
                                           replace=False))
    w = int(params["reweight_to"] * IN)
    steps = {
        "host_down": {"down": osds},
        "host_out": {"weight": {o: 0 for o in osds}},
        "reweight": {"weight": {o: w for o in rw}},
        "restore": {"up": osds,
                    "weight": {**{o: IN for o in osds},
                               **{o: IN for o in rw}}},
    }
    return [steps[s] for s in params["cycle"]]


class PortPlacement:
    """The port: one ClusterState and its pool's rows."""

    def __init__(self, cfg: dict, device):
        self.state = system.cluster_state(cfg, device)

    def prepare(self, delta: dict):
        return system.incremental(self.state.m.epoch + 1, delta)

    def apply(self, inc) -> None:
        self.state.apply(inc)

    def rows(self) -> torch.Tensor:
        return self.state.rows(0)[0]


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.params = ctx.cell.traffic["params"]
        self.device = torch.device(ctx.device)
        self.pg_num = self.cfg["pool"]["pg_num"]
        self.parts = Parts()

    def setup(self) -> None:
        self.deltas = cycle_deltas(self.cfg, self.params, self.ctx.seed)
        with self.parts("state"):
            self.prog = (self.ctx.program(self.cfg, self.device)
                         if self.ctx.program else
                         PortPlacement(self.cfg, self.device))
        rng = np.random.default_rng([self.ctx.seed, 0x73616D706C65])
        n = min(self.params["check_sample_pgs"], self.pg_num)
        self.sample = torch.from_numpy(np.sort(rng.choice(
            self.pg_num, n, replace=False))).to(self.device)
        # every shape of the window: the first rows, and one whole cycle
        # (each step's scatter and remap, the sample's gather), which ends
        # where it began
        with self.parts("first_rows"):
            self.prog.rows()
        with self.parts("warm_cycle"):
            for d in self.deltas:
                self.prog.apply(self.prog.prepare(d))
                self.prog.rows().index_select(0, self.sample)
        self.samples: list = []
        self.last = collections.deque(maxlen=len(self.deltas))
        self.rows_ = None

    def prepare(self, i: int):
        return self.prog.prepare(self.deltas[i % len(self.deltas)])

    def op(self, inc, span) -> None:
        with span("bench.apply"):
            self.prog.apply(inc)
        with span("bench.rows"):
            self.rows_ = self.prog.rows()

    def after(self, i: int, inc) -> None:
        self.samples.append(self.rows_.index_select(0, self.sample))
        self.last.append((i, self.rows_))
        self.rows_ = None

    def units(self, inc) -> int:
        return self.pg_num

    def end_to_end(self, w) -> dict:
        from bench_port.harness import p95

        return {"pg_mappings_per_s": w.units / w.seconds,
                "epoch_p95_ms": p95(w.latency_ms)}

    def release(self) -> None:
        self.prog = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_rows(self, keep_down: bool = False):
        """[(rows, draws)] of each phase of the cycle: the state after its
        i-th delta, from the base state."""
        ref = PoolReference(self.cfg, self.device)
        state = MapState(ref.tree.n_devices, self.device)
        out = []
        for d in self.deltas:
            state.apply(d)
            out.append(ref.rows(state, keep_down))
        self.draws = [d for _, d in out]
        return out

    def check(self) -> list:
        phases = self.reference_rows()
        k = len(self.deltas)
        sampled = sum(
            int((s.long() != phases[i % k][0][self.sample]).any(1).sum())
            for i, s in enumerate(self.samples))
        full = sum(int((r.long() != phases[i % k][0]).any(1).sum())
                   for i, r in self.last)
        return [("rows_mismatched_last_cycle", full, 0),
                ("rows_mismatched_sampled", sampled, 0)]

    def trace_info(self, first: int, last: int) -> dict:
        """The draws of each traced epoch (its phase's, counted by the
        reference), its PGs, and the bytes an epoch's launch must move:
        the int32 `up` rows written, the per-OSD vectors read (exists, up:
        1 byte; reweight, primary affinity: 4 bytes an OSD)."""
        k = len(self.deltas)
        devices = self.cfg["hosts"] * self.cfg["osds_per_host"]
        return {"draws": [self.draws[i % k] for i in range(first, last)],
                "pgs": self.pg_num,
                "bytes": 4 * self.pg_num * self.cfg["pool"]["size"]
                + 10 * devices}
