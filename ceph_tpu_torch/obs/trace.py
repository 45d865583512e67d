"""Span tracer — nested, thread-safe, exported as Chrome trace-event JSON.

The port of `ceph_tpu/obs/trace.py`: the same events, gate, ring and
file.  Spans time the host: a span around a kernel launch measures its
enqueue, never the card's work (nothing here synchronises the device).

While a torch profiler records, each span is also a `record_function`
range of the same name, so the profiler's trace holds the port's spans
(`user_annotation` events, nested as called) on the clock of the kernels
they launch: what the card did can be put down to the span that asked
for it.  Whether a profiler records is checked at every call (a lookup
of torch, never an import of it); with it off and no trace file, a span
is the shared no-op and costs no `record_function` (about 15 µs a call
even with the profiler off).

The reference inspects live daemons through the admin socket; for *time*
questions it leans on external tracing (src/common/tracer.cc wraps
Jaeger spans around op paths).  Here the same role is played by a
process-local tracer that records complete ("ph":"X") trace events and
writes a Chrome trace-event file readable by Perfetto / chrome://tracing.

Env-gated: set `CEPH_TPU_TRACE=/path/trace.json` before the process
starts (or call `set_trace_path` at runtime).  When disabled, `span()`
returns a shared no-op context manager — the hot paths pay two dict
lookups and torch's profiler check (about 0.2 µs) and nothing else.
The in-memory buffer is a ring of the most recent
`CEPH_TPU_TRACE_MAX_EVENTS` events (default 1M) so a long-lived traced
process stays bounded; the flush records how many fell off.

Nesting is the trace-event model's: complete events on the same thread
nest by time containment, so `with span("outer"): with span("inner"):`
renders as a two-deep flame in Perfetto.  Thread safety: each event is
appended under a lock; per-thread ordering comes from the tid field.

The file is written by `flush()` — called automatically at interpreter
exit and opportunistically by long-running programs (a `Checkpoint`
flush writes it too), so a SIGKILLed run still leaves the spans recorded
so far.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from collections import deque

from ceph_tpu_torch.utils import knobs

_lock = threading.Lock()
_flush_lock = threading.Lock()  # serializes writers of <path>.tmp
# Bounded: a long-lived traced process (admin-socket server under
# CEPH_TPU_TRACE) must not accumulate events forever.  Ring semantics —
# the most recent events win, and the flush records how many fell off.
_DEFAULT_MAX_EVENTS = 1_000_000


def _max_events() -> int:
    try:
        n = int(knobs.get("CEPH_TPU_TRACE_MAX_EVENTS", ""))
    except ValueError:
        return _DEFAULT_MAX_EVENTS  # a bad tuning var must not traceback
    return n if n > 0 else _DEFAULT_MAX_EVENTS


_events: deque = deque(maxlen=_max_events())
_dropped = 0
_path: str | None = knobs.get("CEPH_TPU_TRACE") or None
# trace timestamps are µs from this origin (perf_counter is monotonic;
# the absolute epoch is recorded in metadata for cross-log correlation)
_t0 = time.perf_counter()
_epoch = time.time()


def enabled() -> bool:
    return _path is not None


def trace_path() -> str | None:
    return _path


def set_trace_path(path: str | None) -> None:
    """Enable (or disable with None) tracing at runtime; events recorded
    so far are kept."""
    global _path
    _path = path


def _now_us() -> float:
    return (time.perf_counter() - _t0) * 1e6


def _append(ev: dict) -> None:
    global _dropped
    with _lock:
        if len(_events) == _events.maxlen:
            _dropped += 1
        _events.append(ev)


class _NullSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "t0")

    def __init__(self, name: str, cat: str, args: dict):
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self.t0 = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        ev = {
            "ph": "X",
            "name": self.name,
            "cat": self.cat,
            "ts": self.t0,
            "dur": _now_us() - self.t0,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if self.args:
            ev["args"] = self.args
        if exc_type is not None:
            ev.setdefault("args", {})["error"] = exc_type.__name__
        _append(ev)
        return False


class _Range:
    """A span while a torch profiler records: a `record_function` range
    around the span's Chrome event (or around `_NULL`)."""

    __slots__ = ("rf", "inner")

    def __init__(self, rf, inner):
        self.rf = rf
        self.inner = inner

    def __enter__(self):
        self.rf.__enter__()
        return self.inner.__enter__()

    def __exit__(self, *exc):
        self.inner.__exit__(*exc)
        self.rf.__exit__(*exc)
        return False


def span(name: str, cat: str = "ceph_tpu", **args):
    """`with span("pipeline.map_block", pgs=65536): ...`"""
    inner = _NULL if _path is None else _Span(name, cat, args)
    torch = sys.modules.get("torch")
    if torch is not None and torch._C._autograd._profiler_enabled():
        return _Range(torch.profiler.record_function(name), inner)
    return inner


def instant(name: str, cat: str = "ceph_tpu", **args) -> None:
    """A zero-duration marker ("ph":"i")."""
    if _path is None:
        return
    ev = {
        "ph": "i",
        "s": "t",
        "name": name,
        "cat": cat,
        "ts": _now_us(),
        "pid": os.getpid(),
        "tid": threading.get_ident(),
    }
    if args:
        ev["args"] = args
    _append(ev)


def counter(name: str, value: float, cat: str = "ceph_tpu") -> None:
    """A counter-track sample ("ph":"C") — e.g. the balancer's deviation
    trajectory renders as a stepped line in Perfetto."""
    if _path is None:
        return
    _append({
        "ph": "C",
        "name": name,
        "cat": cat,
        "ts": _now_us(),
        "pid": os.getpid(),
        "args": {"value": value},
    })


def n_events() -> int:
    with _lock:
        return len(_events)


def clear() -> None:
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0


def flush(path: str | None = None) -> str | None:
    """Write the Chrome trace-event file; returns the path written (None
    if tracing is disabled or nothing was recorded).  Safe to call
    repeatedly — each call rewrites the full event list, so the last
    flush before a kill wins."""
    path = path or _path
    if path is None:
        return None
    # _flush_lock serializes whole flushes — concurrent callers (the
    # admin-socket thread's "trace flush" racing a checkpoint's flush)
    # must neither interleave writes into the shared tmp file nor let a
    # stale snapshot overwrite a newer one, so the snapshot is taken
    # inside it.  Span recording only needs _lock and continues meanwhile.
    with _flush_lock:
        with _lock:
            if not _events:
                return None
            doc = {
                "traceEvents": list(_events),
                "displayTimeUnit": "ms",
                "otherData": {
                    "epoch_s": _epoch,
                    "producer": "ceph_tpu_torch.obs.trace",
                },
            }
            if _dropped:
                doc["otherData"]["dropped_events"] = _dropped
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    return path


def _flush_at_exit() -> None:
    try:
        flush()
    except OSError:
        pass  # a bad CEPH_TPU_TRACE path must not traceback at exit


atexit.register(_flush_at_exit)
