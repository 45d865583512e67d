"""Cluster simulation: failure what-ifs (`failure.py`) and the lifetime
chaos simulator (`lifetime.py`) with its client workload
(`workload.py`)."""

from ceph_tpu_torch.sim.failure import ClusterSim, MovementReport
from ceph_tpu_torch.sim.lifetime import (
    LifetimeSim,
    Scenario,
    check_pg_temp_invariants,
    check_rows_invariants,
)

__all__ = [
    "ClusterSim",
    "LifetimeSim",
    "MovementReport",
    "Scenario",
    "check_pg_temp_invariants",
    "check_rows_invariants",
]
