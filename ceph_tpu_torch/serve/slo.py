"""Serve SLO burn-rate engine: declared objectives over the timeline.

The port of `ceph_tpu/serve/slo.py`, over the port's `obs.health`.

The rateless-codes load-balancing literature frames a QPS target as a
promise about the *tail history*, not the mean snapshot — so the serve
layer declares objectives (p99 latency, error ratio, shed ratio) and
this engine watches the per-dispatch-window samples the service records
on the "serve" timeline, multiwindow-burn-rate style (the SRE-workbook
fast/slow pattern):

- each sample either breaches an objective or not (windowed p99 from
  the request-latency histogram delta, error/shed ratios from counter
  deltas);
- a **fast** window (last `FAST` samples) catches an active burn, a
  **slow** window (last `SLOW`) keeps one blip from paging;
- the burn raises the `SLO_BURN` health check when both windows exceed
  their thresholds, and clears it only after a full fast window of
  clean samples — so a structural swap that blows p99 is a recorded
  raise->clear transition on the timeline, not a lost transient.

Objectives come from the environment (`CEPH_TPU_SLO_P99_MS`,
`CEPH_TPU_SLO_ERROR_PCT`, `CEPH_TPU_SLO_SHED_PCT`); everything here is
host-side observation only.  It books the JAX package's `slo` perf
group; `COUNTERS` reads it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ceph_tpu_torch.obs import health
from ceph_tpu_torch.utils import knobs
from ceph_tpu_torch.utils.perf_counters import counters_attr, logger_for

_L = logger_for("slo")
_L.add_u64("slo_samples", "dispatch-window samples scored against the SLO")
_L.add_u64("slo_breaches", "samples that breached at least one objective")
_L.add_u64("burns_raised", "SLO_BURN raise transitions")
_L.add_u64("burns_cleared", "SLO_BURN clear transitions")
__getattr__ = counters_attr("slo", __name__, (
    "slo_samples", "slo_breaches", "burns_raised", "burns_cleared"))


def _inc(name: str) -> None:
    _L.inc(name)


@dataclass(frozen=True)
class Objectives:
    """The declared serve SLO; ratios are fractions (0..1)."""

    p99_s: float
    error_ratio: float
    shed_ratio: float

    @classmethod
    def from_env(cls) -> "Objectives":
        return cls(
            p99_s=float(knobs.get("CEPH_TPU_SLO_P99_MS", "250")) / 1e3,
            error_ratio=float(
                knobs.get("CEPH_TPU_SLO_ERROR_PCT", "1")) / 100.0,
            shed_ratio=float(
                knobs.get("CEPH_TPU_SLO_SHED_PCT", "5")) / 100.0,
        )

    def as_dict(self) -> dict:
        return {"p99_ms": round(self.p99_s * 1e3, 3),
                "error_pct": round(self.error_ratio * 100, 3),
                "shed_pct": round(self.shed_ratio * 100, 3)}


class SloEngine:
    """Scores per-window samples and drives the SLO_BURN health check."""

    FAST = 8         # samples in the fast window
    SLOW = 48        # samples in the slow window (ring size)
    RAISE_FAST = 0.5   # breach fraction of the fast window to raise...
    RAISE_SLOW = 1.0 / 12.0  # ...with at least this much slow-window burn

    def __init__(self, objectives: Objectives | None = None):
        self.obj = objectives or Objectives.from_env()
        self._ring: list[bool] = []
        self.burning = False
        self.burns_raised = 0
        self.burns_cleared = 0
        self.burn_seconds = 0.0
        self._last_t: float | None = None
        self.samples = 0
        self.breaches = 0

    def observe(self, *, p99_s: float | None, queries: int, errors: int,
                shed: int, wall_t: float | None = None) -> dict:
        """Score one dispatch-window sample (all deltas/values host-side,
        already computed by the caller).  Returns the scored sample."""
        now = time.monotonic() if wall_t is None else wall_t
        total = max(1, queries)
        reasons = []
        if p99_s is not None and p99_s > self.obj.p99_s:
            reasons.append("p99")
        if errors / total > self.obj.error_ratio:
            reasons.append("errors")
        if shed / total > self.obj.shed_ratio:
            reasons.append("shed")
        breach = bool(reasons)
        self.samples += 1
        _inc("slo_samples")
        if breach:
            self.breaches += 1
            _inc("slo_breaches")
        self._ring.append(breach)
        del self._ring[:-self.SLOW]
        fast_burn = self._burn(self.FAST)
        slow_burn = self._burn(self.SLOW)
        if self.burning and self._last_t is not None:
            self.burn_seconds += max(0.0, now - self._last_t)
        self._last_t = now
        if (not self.burning and len(self._ring) >= 2
                and fast_burn >= self.RAISE_FAST
                and slow_burn >= self.RAISE_SLOW):
            self.burning = True
            self.burns_raised += 1
            _inc("burns_raised")
            health.raise_check(
                "SLO_BURN", health.WARN,
                f"serve SLO burning ({'+'.join(reasons)}): "
                f"fast={fast_burn:.2f} slow={slow_burn:.2f}",
                detail=(f"objectives={self.obj.as_dict()}",))
        elif self.burning and fast_burn == 0.0:
            self.burning = False
            self.burns_cleared += 1
            _inc("burns_cleared")
            health.clear("SLO_BURN")
        return {"breach": breach, "reasons": reasons, "burning": self.burning,
                "fast_burn": round(fast_burn, 4),
                "slow_burn": round(slow_burn, 4)}

    def _burn(self, window: int) -> float:
        w = self._ring[-window:]
        return (sum(w) / len(w)) if w else 0.0

    def status(self) -> dict:
        return {
            "objectives": self.obj.as_dict(),
            "burning": self.burning,
            "burns_raised": self.burns_raised,
            "burns_cleared": self.burns_cleared,
            "burn_minutes": round(self.burn_seconds / 60.0, 4),
            "fast_burn": round(self._burn(self.FAST), 4),
            "slow_burn": round(self._burn(self.SLOW), 4),
            "samples": self.samples,
            "breaches": self.breaches,
        }
