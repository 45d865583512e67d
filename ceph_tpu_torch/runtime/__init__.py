"""Runtime robustness layer: how every entry point gets a backend.

The port of `ceph_tpu/runtime/`:

    from ceph_tpu_torch import runtime

    info = runtime.acquire_backend()        # preflight + ladder
    info.provenance()                       # a JSON-ready record

- `preflight`: watchdogged child-process probe of the card (a hung CUDA
  init costs the timeout, not the run), failure diagnosis (a process
  holding `/dev/nvidia*`, `CUDA_VISIBLE_DEVICES`), the kernels' prebuild.
- `ladder`: the cuda -> cpu -> native ladder with bounded retries,
  exponential backoff with jitter, and full provenance (backend,
  fallback_reason, attempts, init_seconds) in the `runtime` perf group.
  The default ladder is the card alone: a lower rung runs only when
  named, and its descent is recorded.
- `scheduler`: deadline-budgeted priority stage scheduler with atomic
  checkpoint/resume and per-stage watchdogs.
- `faults`: deterministic fault injection (CEPH_TPU_FAULTS), so every
  retry, degradation and resume path runs in fast CPU-only tests.

Importing this package imports no torch: a probe child fires its fault
point before torch loads.
"""

from __future__ import annotations

from ceph_tpu_torch.runtime import faults
from ceph_tpu_torch.runtime.faults import DeviceLostError, FaultInjected
from ceph_tpu_torch.runtime.ladder import (
    BackendInfo,
    RequiredBackendError,
    acquire_backend,
    default_ladder,
    last_provenance,
)
from ceph_tpu_torch.runtime.preflight import (
    ProbeResult,
    diagnose_init_failure,
    prewarm_compile_cache,
    probe,
)
from ceph_tpu_torch.runtime.scheduler import (
    Checkpoint,
    Stage,
    StageHandle,
    StageScheduler,
)

__all__ = [
    "BackendInfo",
    "Checkpoint",
    "DeviceLostError",
    "FaultInjected",
    "ProbeResult",
    "RequiredBackendError",
    "Stage",
    "StageHandle",
    "StageScheduler",
    "acquire_backend",
    "default_ladder",
    "diagnose_init_failure",
    "faults",
    "last_provenance",
    "prewarm_compile_cache",
    "probe",
]
