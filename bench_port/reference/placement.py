"""Every PG's `up` row after each epoch, worked out without the program.

The map's per-OSD state (the up bit and the 16.16 reweight) is advanced
here from the same epoch deltas the benchmark hands the program, as
plain dicts: {"down": [osd], "up": [osd], "weight": {osd: w}}.  An
OSD that is down is left out of `up` (a replicated pool closes the gap,
an erasure pool leaves ITEM_NONE in its place: OSDMap::_raw_to_up_osds);
an OSD of reweight w < 1 is refused by CRUSH's is_out.  Every OSD of the
benchmark's maps exists, and the pools carry no upmap, pg_temp or primary
affinity, so these are the only stages after the rule.

`PoolReference` maps every PG once in the base state, where every OSD is
in at reweight 1.0, and keeps those raw rows.  In that state no is_out
refuses a device, so every device the walk tries ends in the PG's row;
a PG whose base row holds none of the OSDs whose reweight differs in a
later state walks exactly as it did in the base state there.  So the raw
rows of a state are the base rows with only the PGs that hold such an
OSD walked again.  The CPU tests hold this against a full walk.
"""

from __future__ import annotations

import torch

from . import crush

BLOCK = 1 << 19  # PGs walked at once


class MapState:
    """The up bits and reweights of the map's devices, on a device."""

    def __init__(self, n: int, device):
        self.up = torch.ones(n, dtype=torch.bool, device=device)
        self.weight = torch.full((n,), crush.IN_WEIGHT, dtype=torch.long,
                                 device=device)

    def apply(self, delta: dict) -> None:
        for o in delta.get("down", ()):
            self.up[o] = False
        for o in delta.get("up", ()):
            self.up[o] = True
        for o, w in delta.get("weight", {}).items():
            self.weight[int(o)] = int(w)


def up_rows(raw: torch.Tensor, up: torch.Tensor, shift: bool,
            keep_down: bool = False) -> torch.Tensor:
    """The `up` rows [N, W] of raw rows: down OSDs left out (a replicated
    pool shifts the rest left), ITEM_NONE-padded.  keep_down skips the
    filter (the churn cells' control)."""
    real = raw != crush.ITEM_NONE
    alive = real & (keep_down | up[raw.clamp(0, up.numel() - 1)])
    if not shift:
        return torch.where(alive, raw, crush.ITEM_NONE)
    order = torch.argsort((~alive).to(torch.int8), dim=1, stable=True)
    packed = raw.gather(1, order)
    n_alive = alive.sum(1, keepdim=True)
    lane = torch.arange(raw.shape[1], device=raw.device)
    return torch.where(lane < n_alive, packed, crush.ITEM_NONE)


class PoolReference:
    """The rows of one pool of a configuration's map, state by state."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.tree = crush.hierarchy(cfg["hosts"], cfg["osds_per_host"],
                                    cfg["racks"]).to(self.device)
        pool = cfg["pool"]
        self.pg_num = pool["pg_num"]
        self.walk_args = dict(
            pool_id=0, pgp_num=pool["pg_num"], size=pool["size"],
            ftype=1, indep=pool["type"] == "erasure")
        self.shift = pool["type"] == "replicated"
        self.base_raw = None
        self.base_draws = None

    def walk(self, ps: torch.Tensor, weight: torch.Tensor):
        raws, draws = [], []
        for i in range(0, ps.numel(), BLOCK):
            r, d = crush.place_raw(self.tree, ps[i:i + BLOCK], weight,
                                   **self.walk_args)
            raws.append(r)
            draws.append(d)
        if not raws:
            w = self.walk_args["size"]
            return (torch.empty((0, w), dtype=torch.long,
                                device=self.device),
                    torch.empty(0, dtype=torch.long, device=self.device))
        return torch.cat(raws), torch.cat(draws)

    def base(self):
        if self.base_raw is None:
            ps = torch.arange(self.pg_num, device=self.device)
            weight = torch.full((self.tree.n_devices,), crush.IN_WEIGHT,
                                dtype=torch.long, device=self.device)
            self.base_raw, self.base_draws = self.walk(ps, weight)
        return self.base_raw, self.base_draws

    def raw(self, state: MapState):
        """(raw rows [pg_num, W], draws [pg_num]) in `state`."""
        raw, draws = self.base()
        changed = (state.weight != crush.IN_WEIGHT).nonzero()[:, 0]
        if changed.numel() == 0:
            return raw, draws
        hit = torch.isin(raw, changed).any(1).nonzero()[:, 0]
        r, d = self.walk(hit, state.weight)
        return raw.index_copy(0, hit, r), draws.index_copy(0, hit, d)

    def rows(self, state: MapState, keep_down: bool = False):
        """(up rows [pg_num, W] int64, total draws) in `state`."""
        raw, draws = self.raw(state)
        return (up_rows(raw, state.up, self.shift, keep_down),
                int(draws.sum()))
