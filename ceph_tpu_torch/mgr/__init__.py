"""mgr: the manager-module layer over the placement stack.

The port of `ceph_tpu/mgr/`: the reference mgr balancer's scoring
(`Eval`, `calc_eval`), its `Plan` objects and its two modes, `upmap`
(pg_upmap_items through the greedy optimizer) and `crush-compat`
(per-bucket choose_args weight-sets), with the O(PGs) scoring work on the
rule kernel and the device reductions.
"""

from ceph_tpu_torch.mgr.eval import (
    Eval,
    MappingState,
    calc_eval,
    synthetic_pg_stats,
)
from ceph_tpu_torch.mgr.module import Balancer, Plan, compat_ws_to_choose_args

__all__ = [
    "Balancer",
    "Eval",
    "MappingState",
    "Plan",
    "calc_eval",
    "compat_ws_to_choose_args",
    "synthetic_pg_stats",
]
