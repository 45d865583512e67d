"""Fleet simulation: N independent clusters, one stacked stats call per
epoch.

The port of `ceph_tpu/fleet/`.  `spec` expands one sweep-grammar string
into pinned members, `engine` evolves them in lockstep with per-member
digests equal to solo `LifetimeSim` runs (and to the JAX package's), and
`pareto` reduces the outcomes into a non-dominated front.
"""

from ceph_tpu_torch.fleet.engine import FleetSim
from ceph_tpu_torch.fleet.pareto import Point, pareto_front, triage_table
from ceph_tpu_torch.fleet.spec import (
    FLEET_KNOBS,
    SWEEP_AXES,
    FleetMember,
    parse_fleet,
)

__all__ = [
    "FLEET_KNOBS",
    "SWEEP_AXES",
    "FleetMember",
    "FleetSim",
    "Point",
    "pareto_front",
    "parse_fleet",
    "triage_table",
]
