"""Deterministic fault injection: named fault points armed by env or API.

The port of `ceph_tpu/runtime/faults.py`.  The reference exercises its
failure paths with the qa thrasher (reference
qa/tasks/ceph_manager.py:185 OSDThrasher), randomized kills against a
live cluster.  This module is the deterministic counterpart: named fault
points compiled into the lifetime simulator's step, accounting and
recovery paths, armed by env var or API, so every kill / resume branch
runs in fast CPU-only tests.

Spec syntax (env `CEPH_TPU_FAULTS`, comma-separated):

    point[.qualifier]=action[:arg][@pP][xN]

    CEPH_TPU_FAULTS="lifetime_step.8=exit:9"   # die at epoch 8's start
    CEPH_TPU_FAULTS="epoch_apply=lost x1"      # device loss, once
    CEPH_TPU_FAULTS="epoch_apply=lost@p0.3x2"  # flaky: each hit fires
                                               # with prob 0.3, 2 firings

Actions:

    hang:<secs>   sleep that long
    stall:<secs>  sleep that long, then continue
    fail[:why]    raise FaultInjected(why)
    lost[:why]    raise DeviceLostError(why).  The JAX package degrades
                  to its host mapper on it; the port's placement service
                  answers the batch it hits EFAULT and records the loss
                  (`serve/service.py`), and everywhere else in the port
                  it raises out of the caller
    exit[:code]   os._exit(code): a SIGKILL-grade death (no atexit, no
                  finally) for checkpoint/resume tests
    overrun:<s>   sleep

`xN` arms the fault for the first N hits only (default: every hit).
`@pP` fires each hit with probability P, drawn from a
`numpy.random.default_rng` seeded from the spec item itself, so the same
armed spec gives the same fire/skip sequence in every process.  A skipped
hit consumes no `xN` budget, and when both a qualified and a bare fault
are armed the most specific match decides alone.

Every firing books `faults_fired` in the JAX package's `runtime` perf
group (declared at the first firing, as there; `COUNTERS` reads it),
emits a `fault.fired` instant and logs at runtime level 1.
"""

from __future__ import annotations

import os
import re
import threading
import time

from ceph_tpu_torch.utils import knobs
from ceph_tpu_torch.utils.dout import subsys_logger
from ceph_tpu_torch.utils.perf_counters import counters_attr, logger_for

ENV_VAR = "CEPH_TPU_FAULTS"
_log = subsys_logger("runtime")

# The declared fault points, as in the JAX package.  The port's lifetime
# simulator checks `lifetime_step`, `epoch_apply`, `recovery_step` and
# `hazard_decay`, the placement service `serve_dispatch` and
# `epoch_swap`; the others belong to modules not ported yet.
FAULT_POINTS: dict[str, str] = {
    "init": "backend preflight probe (qualifier: platform rung)",
    "map_batch": "mid-batch device dispatch in the mapping pipeline",
    "stage": "scheduler stage body start (qualifier: stage name)",
    "stage_end": "after a stage checkpoints (qualifier: stage name)",
    "epoch_apply": "lifetime-sim per-pool device accounting dispatch "
                   "(qualifier: epoch number)",
    "lifetime_step": "lifetime-sim step start, before the epoch's "
                     "Incremental is built (qualifier: epoch number)",
    "recovery_step": "lifetime-sim recovery-queue drain, before the "
                     "epoch's backlog is touched (qualifier: epoch "
                     "number)",
    "hazard_decay": "lifetime-sim correlated-hazard decay step, before "
                    "the epoch's windows advance (qualifier: epoch "
                    "number; `fail`/`exit` here kills a run "
                    "mid-cascade)",
    "serve_dispatch": "placement-service micro-batch device dispatch "
                      "(qualifier: batch sequence number)",
    "epoch_swap": "placement-service epoch-swap staging, before the "
                  "new buffer is built (qualifier: target epoch)",
}

__getattr__ = counters_attr("runtime", __name__, ("faults_fired",))

_lock = threading.Lock()


class FaultInjected(RuntimeError):
    """An armed `fail` fault point fired."""


class DeviceLostError(RuntimeError):
    """The device disappeared mid-operation (the injected shape of a
    transport loss)."""


# substrings of transport-loss messages (the JAX package's list)
_DEVICE_LOSS_MARKERS = (
    "device lost", "data loss", "unavailable", "transport",
    "socket closed", "connection reset", "device halted", "chip reboot",
)


def looks_like_device_loss(exc: BaseException) -> bool:
    """True when a raised exception is plausibly the device dying: an
    injected DeviceLostError, or a torch runtime error whose message
    matches a known transport-loss shape.  The port degrades nowhere:
    the placement service answers a lost dispatch EFAULT and records
    the loss only where this is true (the rule kernel's own errors, a
    builtin RuntimeError from its wrapper, answer EFAULT unrecorded);
    the port's other callers raise."""
    if isinstance(exc, DeviceLostError):
        return True
    mod = type(exc).__module__ or ""
    if not mod.startswith("torch"):
        return False
    msg = str(exc).lower()
    return any(m in msg for m in _DEVICE_LOSS_MARKERS)


class _Fault:
    __slots__ = ("action", "arg", "remaining", "p", "key", "_rng")

    def __init__(self, action: str, arg: str, remaining: int,
                 p: float = 1.0, key: str = ""):
        self.action = action
        self.arg = arg
        self.remaining = remaining  # <0 = unlimited
        self.p = p  # firing probability per hit (1.0 = always)
        self.key = key  # the armed point[.qual], part of the rng seed
        self._rng = None

    def draw(self) -> bool:
        """Deterministic per-hit firing decision for `@pP` faults: the
        rng seeds from the fault's full spec item, point included."""
        if self.p >= 1.0:
            return True
        if self._rng is None:
            import zlib

            import numpy as np

            seed = zlib.crc32(
                f"{self.key}={self.action}:{self.arg}@p{self.p}".encode()
            )
            self._rng = np.random.default_rng(seed)
        return float(self._rng.random()) < self.p


_armed: dict[str, _Fault] = {}

_P_RE = re.compile(r"@p([0-9.]+)$")


def _parse_one(item: str) -> tuple[str, _Fault]:
    point, _, act = item.partition("=")
    point, act = point.strip(), act.strip()
    if not point or not act:
        raise ValueError(f"bad fault spec item {item!r}")
    remaining = -1
    if "x" in act:
        head, _, cnt = act.rpartition("x")
        if cnt.strip().isdigit():
            act, remaining = head.strip(), int(cnt)
    p = 1.0
    m = _P_RE.search(act)
    if m is not None:
        try:
            p = float(m.group(1))
        except ValueError:
            raise ValueError(f"bad fault probability in {item!r}")
        if not 0.0 < p <= 1.0:
            raise ValueError(f"fault probability {p} not in (0, 1] "
                             f"in {item!r}")
        act = act[: m.start()].strip()
    action, _, arg = act.partition(":")
    action = action.strip()
    if action not in ("hang", "stall", "fail", "lost", "exit", "overrun"):
        raise ValueError(f"unknown fault action {action!r} in {item!r}")
    return point, _Fault(action, arg.strip(), remaining, p, key=point)


def configure(spec: str | None) -> None:
    """Replace the armed-fault table from a spec string ("" or None
    disarms everything)."""
    with _lock:
        _armed.clear()
        for item in (spec or "").split(","):
            item = item.strip()
            if not item:
                continue
            point, f = _parse_one(item)
            _armed[point] = f


def arm(point: str, action: str, arg: str = "", count: int = -1,
        p: float = 1.0) -> None:
    """API-side arming (tests that do not want to change the env)."""
    with _lock:
        _armed[point] = _Fault(action, arg, count, p, key=point)


def disarm(point: str) -> None:
    """Remove one armed fault (the counterpart of `arm`)."""
    with _lock:
        _armed.pop(point, None)


def disarm_all() -> None:
    with _lock:
        _armed.clear()


def _take(point: str, qual: str | None) -> tuple[str, _Fault] | None:
    """Find the most specific armed fault for point[.qual] and consume
    one firing from its budget."""
    with _lock:
        for key in ((f"{point}.{qual}",) if qual else ()) + (point,):
            f = _armed.get(key)
            if f is None or f.remaining == 0:
                continue
            if not f.draw():
                # probabilistic skip: no budget consumed, and the most
                # specific match decides alone (no fall-through)
                return None
            if f.remaining > 0:
                f.remaining -= 1
            return key, f
    return None


def check(point: str, qual: str | None = None) -> None:
    """Execute the fault point.  No-op unless a matching fault is armed."""
    hit = _take(point, qual)
    if hit is None:
        return
    key, f = hit
    from ceph_tpu_torch.obs import trace

    _rt_counters().inc("faults_fired")
    trace.instant("fault.fired", point=key, action=f.action)
    _log(1, f"fault point {key} fired: {f.action}:{f.arg}")
    if f.action in ("hang", "stall", "overrun"):
        time.sleep(float(f.arg or 1.0))
    elif f.action == "fail":
        raise FaultInjected(f.arg or f"injected failure at {key}")
    elif f.action == "lost":
        raise DeviceLostError(f.arg or f"injected device loss at {key}")
    elif f.action == "exit":
        os._exit(int(f.arg or 1))


def active() -> dict[str, str]:
    """The armed table, for provenance records ({point: "action:arg"})."""
    with _lock:
        return {
            k: f"{f.action}:{f.arg}"
            + (f"@p{f.p:g}" if f.p < 1.0 else "")
            + (f" x{f.remaining}" if f.remaining >= 0 else "")
            for k, f in _armed.items()
        }


def _rt_counters():
    L = logger_for("runtime")
    L.add_u64("faults_fired", "armed fault points that fired")
    return L


# arm from the environment at import: a subprocess inherits the spec
configure(knobs.get("CEPH_TPU_FAULTS"))
