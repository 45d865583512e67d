"""Cluster simulation: failure what-ifs (`failure.py`).  The lifetime
simulator, recovery queue and workload generator are not ported yet."""

from ceph_tpu_torch.sim.failure import ClusterSim, MovementReport

__all__ = ["ClusterSim", "MovementReport"]
