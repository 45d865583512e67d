"""Backend ladder: acquire the backend an entry point runs on, with
provenance.

The port of `ceph_tpu/runtime/ladder.py`.  The policy every entry point
goes through instead of an ad-hoc `torch.cuda.is_available()`:

    info = acquire_backend()             # the default ladder: ["cuda"]
    info.backend                         # what we actually got
    info.provenance()                    # JSON-ready record

Each rung is probed (watchdogged child process for entry points,
in-process for library paths) with bounded retries and exponential
backoff with deterministic jitter; the first healthy rung is activated
in-process, and the whole history (attempts, per-attempt failures,
init seconds, the diagnosis of why earlier rungs failed) is recorded in
the returned `BackendInfo`, the `runtime` perf group and
`last_provenance()`.

Rungs:

    "cuda"    the card (the port's only default)
    "cpu"     torch on the host: the kernels' plain versions
    "native"  no torch at all: callers select the C++ host engines;
              a terminal rung that always succeeds

**Difference by design.**  The JAX default ladder is
`["auto", "cpu", "native"]`: it descends to the CPU unasked.  The
port's default is `["cuda"]`, so a missing card raises
`RequiredBackendError`.  A lower rung is used only when the caller
names it (`ladder=` or `CEPH_TPU_LADDER`), and then the descent is in
the provenance, in `fallbacks`, in a dout line and in a
`RuntimeWarning`.  `require=` is the hard gate: when the acquired
backend does not satisfy it, RequiredBackendError is raised instead of
degrading.
"""

from __future__ import annotations

import os
import random
import time
import warnings
from dataclasses import dataclass, field

from ceph_tpu_torch.runtime import preflight
from ceph_tpu_torch.utils import knobs
from ceph_tpu_torch.utils.dout import subsys_logger

_log = subsys_logger("runtime")

DEFAULT_ATTEMPTS = int(knobs.get("CEPH_TPU_INIT_ATTEMPTS", "2"))
BACKOFF_BASE_S = float(knobs.get("CEPH_TPU_INIT_BACKOFF", "1.0"))
BACKOFF_MAX_S = 8.0


class RequiredBackendError(RuntimeError):
    """The required backend could not be acquired (hard gate, no
    degradation)."""


@dataclass
class BackendInfo:
    """Provenance of one backend acquisition."""

    backend: str  # "cuda" | "cpu" | "native"
    device: str = ""
    n_devices: int = 0
    attempts: int = 0  # total probe attempts across all rungs
    init_seconds: float = 0.0
    fallback_reason: str | None = None  # None = first rung succeeded
    rungs_tried: list[str] = field(default_factory=list)
    failures: list[str] = field(default_factory=list)
    diagnosis: list[str] = field(default_factory=list)
    compile_cache: str | None = None

    def provenance(self) -> dict:
        """The record a run embeds (the JAX keys)."""
        out = {
            "backend": self.backend,
            "device": self.device,
            "n_devices": self.n_devices,
            "attempts": self.attempts,
            "init_seconds": round(self.init_seconds, 2),
            "fallback_reason": self.fallback_reason,
        }
        if len(self.rungs_tried) > 1:
            out["rungs_tried"] = self.rungs_tried
        if self.failures:
            out["failures"] = self.failures
        if self.diagnosis:
            out["diagnosis"] = self.diagnosis
        return out


_last: BackendInfo | None = None


def last_provenance() -> dict | None:
    """Provenance of the most recent acquisition in this process (the
    admin socket's `runtime` command reads this)."""
    return _last.provenance() if _last is not None else None


def default_ladder() -> list[str]:
    """From CEPH_TPU_LADDER if set; else the card alone."""
    env = knobs.get("CEPH_TPU_LADDER")
    if env:
        return [r.strip() for r in env.split(",") if r.strip()]
    return ["cuda"]


def _counters():
    from ceph_tpu_torch.utils.perf_counters import logger_for

    L = logger_for("runtime")
    L.add_u64("init_attempts", "backend probe attempts")
    L.add_u64("init_failures", "backend probe failures")
    L.add_u64("fallbacks", "degradation ladder descents")
    L.add_time_avg("init_seconds", "backend acquisition wall time")
    return L


def _backoff_sleep(attempt: int, rung: str, sleep=time.sleep) -> float:
    """Exponential backoff with deterministic jitter (seeded per rung
    and attempt: reproducible runs, but concurrent workers probing the
    same card do not stampede in lockstep)."""
    base = min(BACKOFF_BASE_S * (2 ** attempt), BACKOFF_MAX_S)
    jit = random.Random(f"{rung}:{attempt}:{os.getpid()}").uniform(0, base / 4)
    delay = base + jit
    sleep(delay)
    return delay


def _activate(rung: str) -> None:
    """Point this process at the verified rung: CUDA initialised and its
    current device selected (torch's int64 is native, so there is no x64
    switch to flip)."""
    if rung == "cuda":
        import torch

        torch.cuda.init()
        torch.cuda.set_device(torch.cuda.current_device())


def acquire_backend(
    ladder: list[str] | None = None,
    require: str | None = None,
    watchdog: bool = True,
    timeout_s: float | None = None,
    attempts: int = DEFAULT_ATTEMPTS,
    prewarm_cache: bool = False,
    sleep=time.sleep,
) -> BackendInfo:
    """Walk the ladder; return provenance for the first rung that
    initialises.

    watchdog=True probes each rung in a killable child process (entry
    points: a hung CUDA init costs timeout_s, not the run); False
    probes in-process (library paths that must not fork).  `require`
    hard-gates the result: if the acquired backend does not match,
    raise instead of degrading.
    """
    from ceph_tpu_torch.obs import trace

    global _last
    ladder = list(ladder or default_ladder())
    timeout_s = preflight.DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
    L = _counters()
    info = BackendInfo(backend="none")
    t_all = time.perf_counter()
    with trace.span("runtime.acquire_backend", ladder=",".join(ladder)):
        for rung_i, rung in enumerate(ladder):
            info.rungs_tried.append(rung)
            if rung == "native":
                info.backend = "native"
                info.device = "host (no torch)"
                break
            res = None
            for att in range(max(1, attempts)):
                info.attempts += 1
                L.inc("init_attempts")
                res = preflight.probe(rung, timeout_s, watchdog=watchdog)
                if res.ok:
                    break
                L.inc("init_failures")
                info.failures.append(f"{rung}[{att}]: {res.error}")
                info.diagnosis.extend(
                    d for d in res.diagnosis if d not in info.diagnosis)
                _log(1, f"probe {rung} attempt {att + 1} failed: "
                        f"{res.error}")
                if res.timed_out or att + 1 >= max(1, attempts):
                    # a watchdog-killed hang does not resolve by retrying
                    # at once; move down the ladder instead
                    break
                _backoff_sleep(att, rung, sleep=sleep)
            if res is not None and res.ok:
                _activate(rung)
                info.backend = res.backend or rung
                info.device = res.device
                info.n_devices = res.n_devices
                break
            if rung_i + 1 < len(ladder):
                L.inc("fallbacks")
                if info.fallback_reason is None:
                    info.fallback_reason = (
                        f"{rung}: {res.error if res else 'not probed'}")
    info.init_seconds = time.perf_counter() - t_all
    L.observe("init_seconds", info.init_seconds)
    if info.backend == "none":
        raise RequiredBackendError(
            "no rung of the ladder "
            f"{ladder} initialized: {'; '.join(info.failures)}")
    if require and info.backend != require:
        raise RequiredBackendError(
            f"required backend {require!r} unavailable, got "
            f"{info.backend!r} ({info.fallback_reason})")
    if prewarm_cache and info.backend == "cuda":
        info.compile_cache = preflight.prewarm_compile_cache()
    if info.fallback_reason:
        # the descent is never quiet: provenance, `fallbacks`, this
        # dout line and a warning
        _log(1, f"backend ladder descended to {info.backend}: "
                f"{info.fallback_reason}")
        warnings.warn(
            f"backend {info.rungs_tried[0]!r} unavailable "
            f"({info.fallback_reason}); running on {info.backend}",
            RuntimeWarning, stacklevel=2)
    if info.backend != "native":
        # prime the library-path guard: one acquisition per process, so
        # a later ensure_backend() does not probe a rung the ladder
        # already steered away from
        from ceph_tpu_torch.utils import platform as _platform_guard

        _platform_guard._checked = info.backend
    _last = info
    trace.instant("runtime.acquired", backend=info.backend,
                  attempts=info.attempts)
    _log(5, f"acquired backend={info.backend} device={info.device!r} "
            f"attempts={info.attempts} "
            f"fallback={info.fallback_reason or 'none'}")
    return info
