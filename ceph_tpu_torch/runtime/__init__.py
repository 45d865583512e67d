"""Runtime robustness layer: deterministic fault points (`faults`) and
the atomic checkpoint store (`scheduler.Checkpoint`).

The port of the parts of `ceph_tpu/runtime/` the lifetime simulator
uses.  The backend ladder, the preflight probe and the stage scheduler
are not ported: the port runs on the card unless asked for the CPU
(`ceph_tpu_torch.device.resolve_device`), and a device error raises.
"""

from __future__ import annotations

from ceph_tpu_torch.runtime import faults
from ceph_tpu_torch.runtime.faults import DeviceLostError, FaultInjected
from ceph_tpu_torch.runtime.scheduler import Checkpoint

__all__ = [
    "Checkpoint",
    "DeviceLostError",
    "FaultInjected",
    "faults",
]
