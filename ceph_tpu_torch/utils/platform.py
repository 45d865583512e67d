"""Runtime platform guard: the cheap, cached ladder walk of library code.

The port of `ceph_tpu/utils/platform.py`.  `device.resolve_device(None)`
calls `ensure_backend()` before the first device use of an entry point,
so every default-device entry point's acquisition lands in
`runtime.last_provenance()` and the `runtime` perf group.  Entry points
that can afford a watchdogged child (chip_smoke.py, long-running CLIs)
call `runtime.acquire_backend()` directly; this is the in-process path.

**Difference by design:** the JAX guard appends `cpu` to the ladder so a
dead accelerator always falls back to the host.  This one walks
`default_ladder()` as it stands (`["cuda"]` unless `CEPH_TPU_LADDER`
names more rungs), so without a card it raises `RequiredBackendError`.
`device="cpu"` remains the caller's way to ask for the host.
"""

from __future__ import annotations

_checked: str | None = None


def ensure_backend() -> str:
    """The usable backend name ("cuda", or a lower rung the ladder
    names).  Cached: the ladder walk happens once per process."""
    global _checked
    if _checked is not None:
        return _checked
    from ceph_tpu_torch import runtime

    # in-process (watchdog=False): library code must not fork; the
    # native rung has no torch device, so it is not a rung here.
    # attempts=1: an in-process init failure is a CUDA error, not a
    # transient flake
    ladder = [r for r in runtime.default_ladder() if r != "native"]
    info = runtime.acquire_backend(ladder=ladder or ["cuda"],
                                   watchdog=False, attempts=1)
    _checked = info.backend
    return _checked
