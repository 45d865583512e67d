"""Bounded time-series flight recorder: numpy rings, 2-tier retention.

The port of `ceph_tpu/obs/timeline.py`.  Named series ("sim",
"balancer") of small float samples go into fixed-capacity numpy ring
buffers:

- tier 0 holds the newest `CEPH_TPU_TIMELINE_CAP` raw samples;
- samples evicted from tier 0 fold into a downsample accumulator that
  emits one averaged tier-1 sample per `TIER1_FACTOR` evictions into a
  second ring of the same capacity, so memory is fixed while the
  recorded horizon is `cap * (1 + TIER1_FACTOR)` samples deep.

Sample indices increase monotonically per series for the life of the
process and across checkpoint/resume: `state()`/`restore()` round-trip a
series as JSON-safe lists (the JAX package's layout), so a resumed run
continues the same recording.

Recording is host-only observation of plain floats the caller already
holds; `CEPH_TPU_TIMELINE_CAP=0` turns it off and changes no digest.
It books the JAX package's `timeline` perf group (`COUNTERS` reads
it); `prometheus_gauges()` is the JAX exposition of the newest samples.
"""

from __future__ import annotations

import threading

import numpy as np

from ceph_tpu_torch.obs.prometheus import escape_label
from ceph_tpu_torch.utils import knobs
from ceph_tpu_torch.utils.perf_counters import counters_attr, logger_for

TIER1_FACTOR = 8  # tier-0 evictions averaged into one tier-1 sample

_L = logger_for("timeline")
_L.add_u64("samples", "timeline samples recorded across all series")
_L.add_u64("downsamples", "tier-1 samples emitted by eviction folding")
_L.add_u64("restores", "series restored from checkpoint state")
__getattr__ = counters_attr("timeline", __name__, (
    "samples", "downsamples", "restores"))

_lock = threading.Lock()
_SERIES: dict[str, "_Series"] = {}


def cap() -> int:
    """Per-series tier-0 ring capacity; 0 disables recording."""
    try:
        return max(0, int(knobs.get("CEPH_TPU_TIMELINE_CAP", "512")))
    except ValueError:
        return 512


def enabled() -> bool:
    return cap() > 0


class _Series:
    """One named series: tier-0 ring + tier-1 downsample ring."""

    def __init__(self, capacity: int):
        self.cap = capacity
        self.n = 0  # samples ever recorded (== next index)
        self.idx = np.zeros(capacity, np.int64)
        self.fields: dict[str, np.ndarray] = {}
        self.t1_n = 0
        self.t1_idx = np.zeros(capacity, np.int64)
        self.t1_fields: dict[str, np.ndarray] = {}
        self._acc: dict[str, float] = {}
        self._acc_n = 0
        self._acc_first = 0

    def _ring(self, tier: dict[str, np.ndarray], name: str) -> np.ndarray:
        r = tier.get(name)
        if r is None:
            r = tier[name] = np.zeros(self.cap, np.float64)
        return r

    def _fold(self, index: int, values: dict[str, float]) -> bool:
        if self._acc_n == 0:
            self._acc_first = index
        for name, v in values.items():
            self._acc[name] = self._acc.get(name, 0.0) + v
        self._acc_n += 1
        if self._acc_n < TIER1_FACTOR:
            return False
        pos = self.t1_n % self.cap
        self.t1_idx[pos] = self._acc_first
        for name in self._acc:
            self._ring(self.t1_fields, name)[pos] = (
                self._acc[name] / TIER1_FACTOR)
        self.t1_n += 1
        self._acc = {}
        self._acc_n = 0
        return True

    def sample(self, values: dict[str, float]) -> int:
        pos = self.n % self.cap
        if self.n >= self.cap:  # evict the slot we are about to reuse
            self._fold(int(self.idx[pos]),
                       {f: float(r[pos]) for f, r in self.fields.items()})
        self.idx[pos] = self.n
        for name, r in self.fields.items():
            r[pos] = 0.0  # a field absent from this sample reads as 0
        for name, v in values.items():
            self._ring(self.fields, name)[pos] = float(v)
        self.n += 1
        return self.n - 1

    def _window(self, n: int, idx: np.ndarray,
                fields: dict[str, np.ndarray]) -> dict:
        valid = min(n, self.cap)
        order = [(n - valid + k) % self.cap for k in range(valid)]
        return {
            "index": [int(idx[p]) for p in order],
            "fields": {name: [float(r[p]) for p in order]
                       for name, r in sorted(fields.items())},
        }

    def dump(self) -> dict:
        out = {"cap": self.cap, "count": self.n,
               "tier0": self._window(self.n, self.idx, self.fields),
               "tier1": self._window(self.t1_n, self.t1_idx, self.t1_fields)}
        out["tier1"]["factor"] = TIER1_FACTOR
        return out

    def state(self) -> dict:
        st = self.dump()
        st["acc"] = {"n": self._acc_n, "first": self._acc_first,
                     "sums": dict(self._acc)}
        st["t1_count"] = self.t1_n
        return st

    def restore(self, st: dict) -> None:
        for n_key, idx_attr, f_attr, tier in (
                ("count", "idx", "fields", st.get("tier0") or {}),
                ("t1_count", "t1_idx", "t1_fields", st.get("tier1") or {})):
            n = int(st.get(n_key, 0))
            index = list(tier.get("index") or [])[-self.cap:]
            base = len(list(tier.get("index") or [])) - len(index)
            idx = getattr(self, idx_attr)
            rings = getattr(self, f_attr)
            for k, i in enumerate(index):
                idx[(n - len(index) + k) % self.cap] = int(i)
            for name, vals in (tier.get("fields") or {}).items():
                r = self._ring(rings, name)
                vals = list(vals)[base:][-self.cap:]
                for k, v in enumerate(vals):
                    r[(n - len(vals) + k) % self.cap] = float(v)
            if n_key == "count":
                self.n = n
            else:
                self.t1_n = n
        acc = st.get("acc") or {}
        self._acc_n = int(acc.get("n", 0))
        self._acc_first = int(acc.get("first", 0))
        self._acc = {k: float(v) for k, v in (acc.get("sums") or {}).items()}


def sample(series: str, values: dict[str, float]) -> int:
    """Record one sample; returns its monotonic index (-1 when recording
    is off, CEPH_TPU_TIMELINE_CAP=0)."""
    c = cap()
    if c <= 0:
        return -1
    with _lock:
        s = _SERIES.get(series)
        if s is None:
            s = _SERIES[series] = _Series(c)
        before = s.t1_n
        i = s.sample(values)
        emitted = s.t1_n - before
    _L.inc("samples")
    if emitted:
        _L.inc("downsamples", emitted)
    return i


def next_index(series: str) -> int:
    """The index the next sample in `series` will get (0 when unknown)."""
    with _lock:
        s = _SERIES.get(series)
        return s.n if s is not None else 0


def last(series: str) -> tuple[int, dict[str, float]]:
    """(index, values) of the newest sample; (-1, {}) when empty."""
    with _lock:
        s = _SERIES.get(series)
        if s is None or s.n == 0:
            return -1, {}
        pos = (s.n - 1) % s.cap
        return int(s.idx[pos]), {name: float(r[pos])
                                 for name, r in sorted(s.fields.items())}


def dump(series: str | None = None) -> dict:
    """JSON view (chronological) of one series or all of them."""
    with _lock:
        if series is not None:
            s = _SERIES.get(series)
            return s.dump() if s is not None else {}
        return {name: s.dump() for name, s in sorted(_SERIES.items())}


def state(series: str) -> dict:
    """JSON-safe checkpoint payload for one series ({} when empty)."""
    with _lock:
        s = _SERIES.get(series)
        return s.state() if s is not None else {}


def restore(series: str, st: dict) -> None:
    """Rebuild a series from `state()` output so resumed runs continue
    the same monotonic index sequence."""
    if not st or cap() <= 0:
        return
    with _lock:
        s = _SERIES[series] = _Series(cap())
        s.restore(st)
    _L.inc("restores")


def reset() -> None:
    with _lock:
        _SERIES.clear()


def prometheus_gauges() -> str:
    """Per-series sample totals plus the newest value of every field."""
    with _lock:
        names = sorted(_SERIES)
        if not names:
            return ""
        counts = {name: _SERIES[name].n for name in names}
    lines = [
        "# HELP ceph_tpu_timeline_samples samples recorded per series",
        "# TYPE ceph_tpu_timeline_samples gauge",
    ]
    for name in names:
        lines.append(
            f'ceph_tpu_timeline_samples{{series="{escape_label(name)}"}} '
            f"{counts[name]}"
        )
    lines += [
        "# HELP ceph_tpu_timeline_last newest sample value per series/field",
        "# TYPE ceph_tpu_timeline_last gauge",
    ]
    for name in names:
        i, vals = last(name)
        if i < 0:
            continue
        for field, v in vals.items():
            lines.append(
                f'ceph_tpu_timeline_last{{series="{escape_label(name)}",'
                f'field="{escape_label(field)}"}} {v!r}'
            )
    return "\n".join(lines) + "\n"
