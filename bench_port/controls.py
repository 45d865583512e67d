"""The controls: the plain reference put in the program's place, with one
guarantee of the configuration broken, as a later change might be
tempted to break it.  Each must come out as not correct.

- churn cells (`PlacementKeepsDown`): the `up` rows served without the
  up filter, so a down OSD stays in them: the rule's raw rows, one stage
  less of work;
- `c5_ec84.write` (`EncodeTwoParity`): two parity rows computed and each
  written twice, half the GF work: the code then survives two losses,
  not the profile's m = 4;
- `c5_ec84.degraded_read` (`DecodePlanByCount`): one decode plan kept for
  each number of lost data chunks, whichever pattern came first: any 8
  survivors no longer give back the data.

`control.py` runs them; the tests run them at a small size.
"""

from __future__ import annotations

import torch

from bench_port.reference import gf
from bench_port.reference.placement import MapState, PoolReference


class PlacementKeepsDown:
    def __init__(self, cfg: dict, device):
        self.ref = PoolReference(cfg, device)
        self.state = MapState(self.ref.tree.n_devices, device)

    def prepare(self, delta: dict) -> dict:
        return delta

    def apply(self, delta: dict) -> None:
        self.state.apply(delta)

    def rows(self) -> torch.Tensor:
        return self.ref.rows(self.state, keep_down=True)[0].to(torch.int32)


class _Reference:
    def __init__(self, cfg: dict, device):
        self.k = int(cfg["ec_profile"]["k"])
        self.m = int(cfg["ec_profile"]["m"])
        self.C = gf.reed_sol_van(self.k, self.m)

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        return torch.cat([data, gf.apply(self.C, data)], 1)


class EncodeTwoParity(_Reference):
    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device)
        self.C = self.C.copy()
        self.C[2:] = self.C[[i % 2 for i in range(2, self.m)]]


class DecodePlanByCount(_Reference):
    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device)
        self.plans: dict = {}

    def decode(self, want: set, chunks: dict, length: int) -> dict:
        use = sorted(chunks)[:self.k]
        missing = sorted(set(want) - set(chunks))
        R = self.plans.setdefault(len(missing),
                                  gf.recover(self.C, use, missing))
        rebuilt = gf.apply(R, torch.stack([chunks[i] for i in use], 1))
        out = dict(chunks)
        for row, i in enumerate(missing):
            out[i] = rebuilt[:, row]
        return out


CONTROLS = {"churn": PlacementKeepsDown, "ec_write": EncodeTwoParity,
            "ec_degraded_read": DecodePlanByCount}
