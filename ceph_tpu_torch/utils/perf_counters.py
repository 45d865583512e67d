"""Perf counters — in-process metrics, dumpable as JSON.

The port of `ceph_tpu/utils/perf_counters.py`, with its names, kinds,
errors and perf-dump layout.  It mirrors the reference's per-daemon
counter surface (reference src/common/perf_counters.h: u64 counters, u64
averages (sum+count pairs), time averages, histograms; exposed by `ceph
daemon <sock> perf dump` via the admin socket, reference
src/common/admin_socket.cc).  Here: a registry of named counters with the
same shapes, a `dump()` that matches the perf-dump JSON layout, and a
`logger_for` helper the hot paths use.  One kind is not the reference's:
`quantile` — a log-bucketed timing histogram whose dump carries
estimated p50/p90/p99 (ceph_tpu_torch.obs.quantiles).

Declarations are idempotent (re-declaring a key with the same kind keeps
the live counter — hot paths declare at import time and may be reloaded),
and updates to undeclared keys raise `UndeclaredCounterError` naming the
group and key instead of a bare KeyError.

`perf reset` semantics: `reset_values()` zeroes every counter but keeps
the declarations (the reference's `perf reset all`); `reset()` (test
isolation) does the same — declarations are made at import time by
module globals, so they are never dropped, only zeroed.

`group_view(name)` is a plain dict snapshot of one group's values (the
`COUNTERS` attribute of the port modules that book into a group).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable

KINDS = ("u64", "avg", "time_avg", "histogram", "quantile")


class UndeclaredCounterError(KeyError):
    """An inc/set/observe hit a key that was never declared."""


class CounterKindError(ValueError):
    """A declaration or update conflicts with the counter's kind."""


@dataclass
class _Counter:
    kind: str  # u64 | avg | time_avg | histogram | quantile
    value: int = 0
    sum: float = 0.0
    count: int = 0
    buckets: list[int] = field(default_factory=list)
    bucket_bounds: list[float] = field(default_factory=list)
    desc: str = ""
    # quantile kind only: observed extrema tighten the open-ended first
    # and overflow buckets of the dump-time estimate
    vmin: float = float("inf")
    vmax: float = float("-inf")
    # a view's source (add_view): read() gives the value, zero() resets it
    read: Callable | None = None
    zero: Callable | None = None


class _Timer:
    """Prebuilt timing context manager — `time()` sits inside the code
    being measured, so it must not allocate a type object per call."""

    __slots__ = ("pc", "key", "t0")

    def __init__(self, pc: "PerfCounters", key: str):
        self.pc = pc
        self.key = key

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.pc.observe(self.key, time.perf_counter() - self.t0)
        return False


class PerfCounters:
    """One named group of counters (a daemon's `logger` equivalent)."""

    def __init__(self, name: str):
        self.name = name
        self._c: dict[str, _Counter] = {}
        self._lock = threading.Lock()

    # -- declaration -------------------------------------------------------
    def _declare(
        self, key: str, kind: str, desc: str,
        bounds: list[float] | None = None,
    ) -> _Counter:
        with self._lock:
            c = self._c.get(key)
            if c is not None:
                if c.kind != kind:
                    raise CounterKindError(
                        f"perf counter '{self.name}.{key}' already declared "
                        f"as {c.kind}, cannot redeclare as {kind}"
                    )
                if bounds is not None and list(bounds) != c.bucket_bounds:
                    raise CounterKindError(
                        f"perf counter '{self.name}.{key}' already declared "
                        f"with bounds {c.bucket_bounds}, cannot redeclare "
                        f"with {bounds}"
                    )
                if desc:
                    c.desc = desc
                return c  # idempotent: keep the live counter + its values
            c = _Counter(kind, desc=desc)
            if bounds is not None:
                # under the lock: a half-initialized histogram must never
                # be observable
                c.bucket_bounds = list(bounds)
                c.buckets = [0] * (len(bounds) + 1)
            self._c[key] = c
            return c

    def add_u64(self, key: str, desc: str = "") -> None:
        self._declare(key, "u64", desc)

    def add_avg(self, key: str, desc: str = "") -> None:
        self._declare(key, "avg", desc)

    def add_time_avg(self, key: str, desc: str = "") -> None:
        self._declare(key, "time_avg", desc)

    def add_histogram(
        self, key: str, bounds: list[float], desc: str = ""
    ) -> None:
        self._declare(key, "histogram", desc, bounds=bounds)

    def add_quantile(
        self, key: str, desc: str = "", bounds: list[float] | None = None
    ) -> None:
        """A log-bucketed timing histogram whose dump carries estimated
        p50/p90/p99 (see ceph_tpu_torch.obs.quantiles).  Default bounds cover
        1 µs .. 100 s at 4 buckets/decade; observe seconds into it
        (observe()/time() both work)."""
        if bounds is None:
            # lazy: perf_counters must not import the obs package at
            # module load (obs imports this module)
            from ceph_tpu_torch.obs.quantiles import DEFAULT_BOUNDS

            bounds = list(DEFAULT_BOUNDS)
        self._declare(key, "quantile", desc, bounds=bounds)

    def add_view(self, key: str, kind: str, read: Callable,
                 zero: Callable, desc: str = "") -> None:
        """A u64 or time_avg whose value is kept elsewhere: `read()` gives
        it at dump time (an int, or a time_avg's (count, sum)), `zero()`
        resets it with the group.  Updates through the group raise: the
        owner books it (the kernel registry's launch counts)."""
        if kind not in ("u64", "time_avg"):
            raise CounterKindError(f"a view is u64 or time_avg, not {kind}")
        c = self._declare(key, kind, desc)
        with self._lock:
            c.read, c.zero = read, zero

    def _get(self, key: str) -> _Counter:
        try:
            return self._c[key]
        except KeyError:
            raise UndeclaredCounterError(
                f"perf counter '{self.name}.{key}' is not declared "
                "(declare it first with add_u64/add_avg/add_time_avg/"
                "add_histogram/add_quantile)"
            ) from None

    def _view_error(self, key: str) -> CounterKindError:
        return CounterKindError(
            f"perf counter '{self.name}.{key}' is a view; its owner "
            "books it")

    # -- updates -----------------------------------------------------------
    def inc(self, key: str, n: int = 1) -> None:
        with self._lock:
            c = self._get(key)
            if c.kind != "u64":
                raise CounterKindError(
                    f"perf counter '{self.name}.{key}' is {c.kind}; "
                    "inc() needs a u64 (use observe() instead)"
                )
            if c.read is not None:
                raise self._view_error(key)
            c.value += n

    def set(self, key: str, v: int) -> None:
        with self._lock:
            c = self._get(key)
            if c.kind != "u64":
                raise CounterKindError(
                    f"perf counter '{self.name}.{key}' is {c.kind}; "
                    "set() needs a u64"
                )
            if c.read is not None:
                raise self._view_error(key)
            c.value = v

    def observe(self, key: str, v: float) -> None:
        with self._lock:
            c = self._get(key)
            if c.kind == "u64":
                raise CounterKindError(
                    f"perf counter '{self.name}.{key}' is u64; observe() "
                    "needs avg/time_avg/histogram/quantile (use inc())"
                )
            if c.read is not None:
                raise self._view_error(key)
            if c.kind in ("histogram", "quantile"):
                i = 0
                while i < len(c.bucket_bounds) and v > c.bucket_bounds[i]:
                    i += 1
                c.buckets[i] += 1
                if c.kind == "quantile":
                    if v < c.vmin:
                        c.vmin = v
                    if v > c.vmax:
                        c.vmax = v
            c.sum += v
            c.count += 1

    def merge_histogram(self, key: str, counts: list[int],
                        values: list[float] | None = None) -> None:
        """Fold a precomputed histogram into a histogram counter:
        `counts[i]` observations of `values[i]` (default: value == i —
        the integer-bounds shape the placement choose_tries counter
        uses, where device-reduced retry histograms arrive already
        bucketed).  Exact when each value equals a declared bound; one
        call per device fetch instead of O(observations) observe()s."""
        with self._lock:
            c = self._get(key)
            if c.kind != "histogram":
                raise CounterKindError(
                    f"perf counter '{self.name}.{key}' is {c.kind}; "
                    "merge_histogram() needs a histogram"
                )
            for i, n in enumerate(counts):
                if not n:
                    continue
                v = values[i] if values is not None else float(i)
                j = 0
                while j < len(c.bucket_bounds) and v > c.bucket_bounds[j]:
                    j += 1
                c.buckets[j] += int(n)
                c.sum += v * int(n)
                c.count += int(n)

    def time(self, key: str) -> "_Timer":
        """Context manager recording elapsed seconds into a time_avg."""
        return _Timer(self, key)

    # -- dump (perf-dump JSON layout) ---------------------------------------
    def dump(self) -> dict:
        """Values in the reference perf-dump shape: u64 as bare ints, avg
        as {avgcount, sum}, time_avg as {avgcount, sum, avgtime},
        histogram as bounds+buckets+sum+count."""
        out: dict = {}
        with self._lock:
            for key, c in self._c.items():
                if c.kind == "u64":
                    out[key] = c.value if c.read is None else c.read()
                elif c.kind == "avg":
                    out[key] = {"avgcount": c.count, "sum": c.sum}
                elif c.kind == "time_avg":
                    count, total = ((c.count, c.sum) if c.read is None
                                    else c.read())
                    out[key] = {
                        "avgcount": count,
                        "sum": total,
                        "avgtime": total / count if count else 0.0,
                    }
                elif c.kind == "histogram":
                    out[key] = {
                        "bounds": c.bucket_bounds,
                        "buckets": list(c.buckets),
                        "sum": c.sum,
                        "count": c.count,
                    }
                else:  # quantile: histogram shape + dump-time estimates
                    from ceph_tpu_torch.obs.quantiles import summarize

                    vmin = c.vmin if c.count else None
                    vmax = c.vmax if c.count else None
                    out[key] = {
                        "bounds": c.bucket_bounds,
                        "buckets": list(c.buckets),
                        "sum": c.sum,
                        "count": c.count,
                        "min": 0.0 if vmin is None else vmin,
                        "max": 0.0 if vmax is None else vmax,
                        **summarize(
                            c.bucket_bounds, c.buckets, vmin, vmax
                        ),
                    }
        return out

    def schema(self) -> dict:
        """The `perf schema` shape: kind + description per key."""
        with self._lock:
            return {
                key: {"type": c.kind, "description": c.desc}
                for key, c in self._c.items()
            }

    def reset_values(self) -> None:
        """Zero every counter, keep the declarations (`perf reset all`)."""
        with self._lock:
            for c in self._c.values():
                if c.zero is not None:
                    c.zero()
                c.value = 0
                c.sum = 0.0
                c.count = 0
                c.buckets = [0] * len(c.buckets)
                c.vmin = float("inf")
                c.vmax = float("-inf")


_registry: dict[str, PerfCounters] = {}
_registry_lock = threading.Lock()


def logger_for(name: str) -> PerfCounters:
    with _registry_lock:
        pc = _registry.get(name)
        if pc is None:
            pc = _registry[name] = PerfCounters(name)
        return pc


def perf_dump() -> dict:
    """All groups — the `ceph daemon ... perf dump` shape."""
    with _registry_lock:
        return {name: pc.dump() for name, pc in sorted(_registry.items())}


def perf_schema() -> dict:
    """All groups' declarations — the `perf schema` shape."""
    with _registry_lock:
        return {name: pc.schema() for name, pc in sorted(_registry.items())}


def reset_values() -> None:
    """Zero every counter in every group, keeping declarations."""
    with _registry_lock:
        for pc in _registry.values():
            pc.reset_values()


def reset() -> None:
    """Test isolation: zero every counter in every group.

    Deliberately does NOT drop the registry dict: hot-path modules bind
    `logger_for(...)` to a module global at import time, and import-time
    declarations cannot re-run — dropping the dict would orphan those
    live groups, silently removing them from every later perf dump.
    Declarations are idempotent, so a test re-declaring its keys on a
    zeroed group gets exactly the clean slate it wants."""
    reset_values()


def group_view(name: str) -> dict:
    """A snapshot of group `name`'s values in the perf-dump layout ({}
    for a group nothing has declared yet).  Reading it never creates the
    group, so a lazily declared group (`runtime`) stays out of
    `perf_dump()` until its first update, as in the JAX package."""
    with _registry_lock:
        pc = _registry.get(name)
    return pc.dump() if pc is not None else {}


def counters_attr(group: str, module: str, keys: tuple[str, ...]):
    """A module `__getattr__` answering `COUNTERS` with the values of
    `keys` in `group` (0 for a key not declared yet): the read view a
    port module keeps in place of the counts dict it booked before its
    counters became the group's."""

    def __getattr__(name: str):
        if name == "COUNTERS":
            values = group_view(group)
            return {k: values.get(k, 0) for k in keys}
        raise AttributeError(f"module {module!r} has no attribute {name!r}")

    return __getattr__
