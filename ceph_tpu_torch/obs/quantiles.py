"""Log-bucketed latency quantiles: the estimator and a histogram.

The port of `ceph_tpu/obs/quantiles.py` (`estimate`, `summarize`, the
bounds), with `Quantile`, the port's stand-in for the JAX perf
registry's `quantile` counter kind (`utils/perf_counters.py`), which the
port has not ported: observations land in log-spaced buckets
(`DEFAULT_BOUNDS`: 1 us to 100 s, 4 buckets per decade, or bounds the
counter declares), and p50/p90/p99 are estimated when the histogram is
dumped, by walking the cumulative counts and interpolating geometrically
inside the landing bucket; the tracked min/max make the open-ended first
and overflow buckets exact at the ends.  The estimate's error is bounded
by the bucket ratio (10^(1/4), about 1.78x, worst case).

`Quantile.dump()` has the JAX counter's dump layout (bounds, buckets,
sum, count, min, max, p50, p90, p99).
"""

from __future__ import annotations

import threading

# 1 µs .. 100 s, 4 buckets per decade: 33 bounds -> 34 buckets.  Spans
# everything between a single device enqueue and a deadline-killed stage.
DEFAULT_BOUNDS: tuple[float, ...] = tuple(
    10.0 ** (-6 + i / 4) for i in range(33)
)

#: the quantiles every `quantile`-kind counter reports in its dump
REPORTED = (("p50", 0.50), ("p90", 0.90), ("p99", 0.99))


def _interpolate(bounds, i: int, cum: float, n: float, rank: float,
                 vmin: float | None, vmax: float | None) -> float:
    """Position of `rank` inside landing bucket i (see module doc)."""
    if i == 0:
        lo = vmin if vmin is not None else bounds[0] / 10.0
        hi = bounds[0]
    elif i == len(bounds):
        lo = bounds[-1]
        hi = vmax if vmax is not None else bounds[-1] * 10.0
    else:
        lo, hi = bounds[i - 1], bounds[i]
    if vmin is not None:
        lo = max(lo, min(vmin, hi))
    if vmax is not None:
        hi = min(hi, max(vmax, lo))
    frac = (rank - cum) / n
    if lo > 0 and hi > lo:
        return lo * (hi / lo) ** frac  # log-linear: see module doc
    return lo + (hi - lo) * frac


def estimate(
    bounds, buckets, q: float,
    vmin: float | None = None, vmax: float | None = None,
) -> float:
    """Estimate the q-quantile (0 < q < 1) of a histogram.

    `bounds[i]` is the inclusive upper edge of bucket i; the final
    bucket (`buckets[len(bounds)]`) is the overflow.  `vmin`/`vmax`
    (tracked by the counter) tighten the open-ended first and last
    buckets; without them the bucket edges bound the estimate.
    """
    total = sum(buckets)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0.0
    for i, n in enumerate(buckets):
        if n == 0:
            continue
        if cum + n >= rank:
            return _interpolate(bounds, i, cum, n, rank, vmin, vmax)
        cum += n
    # rank beyond the last populated bucket (fp rounding): the maximum
    return vmax if vmax is not None else (bounds[-1] if bounds else 0.0)


def summarize(bounds, buckets, vmin=None, vmax=None) -> dict[str, float]:
    """The {p50, p90, p99} record embedded in a quantile counter dump.

    Single cumulative walk resolving every reported rank in ascending
    order — dumps run this over dozens of quantile counters per bench
    stage, so one pass per counter, not one per quantile.  Must stay
    value-equivalent to per-quantile `estimate()` calls
    (tests/test_torch_serve_slo.py pins the equivalence)."""
    total = sum(buckets)
    if total <= 0:
        return {name: 0.0 for name, _ in REPORTED}
    out: dict[str, float] = {}
    ranks = sorted(((q * total, name) for name, q in REPORTED))
    r = 0  # next unresolved rank
    cum = 0.0
    for i, n in enumerate(buckets):
        if n == 0:
            continue
        while r < len(ranks) and cum + n >= ranks[r][0]:
            rank, name = ranks[r]
            out[name] = _interpolate(bounds, i, cum, n, rank, vmin, vmax)
            r += 1
        if r == len(ranks):
            return out
        cum += n
    # ranks beyond the last populated bucket (fp rounding): the maximum
    tail = vmax if vmax is not None else (bounds[-1] if bounds else 0.0)
    for rank, name in ranks[r:]:
        out[name] = tail
    return out


class Quantile:
    """One `quantile` counter: a bucketed histogram of observations with
    dump-time p50/p90/p99.  Thread-safe."""

    def __init__(self, bounds=None):
        self.bounds = list(DEFAULT_BOUNDS if bounds is None else bounds)
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.buckets = [0] * (len(self.bounds) + 1)
            self.sum = 0.0
            self.count = 0
            self.vmin = float("inf")
            self.vmax = float("-inf")

    def observe(self, v: float) -> None:
        """Add one observation: bucket i is the first whose bound is at
        least v (the last bucket is the overflow)."""
        with self._lock:
            i = 0
            while i < len(self.bounds) and v > self.bounds[i]:
                i += 1
            self.buckets[i] += 1
            self.vmin = min(self.vmin, v)
            self.vmax = max(self.vmax, v)
            self.sum += v
            self.count += 1

    def dump(self) -> dict:
        with self._lock:
            vmin = self.vmin if self.count else None
            vmax = self.vmax if self.count else None
            return {
                "bounds": list(self.bounds),
                "buckets": list(self.buckets),
                "sum": self.sum,
                "count": self.count,
                "min": 0.0 if vmin is None else vmin,
                "max": 0.0 if vmax is None else vmax,
                **summarize(self.bounds, self.buckets, vmin, vmax),
            }
