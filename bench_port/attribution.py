"""The traced window put down to the program's own spans.

While the profiler records, the port's spans (`ceph_tpu_torch.obs`
spans: `state.apply`, `state.rows`, `ec.encode_batch`, `ec.concat`, ...)
are `record_function` ranges of its trace, nested inside the
benchmark's `bench.*` ranges and on the clock of the device's work.
On the loop's host thread (the `tid` of `bench.window`) this module
cuts the window into stretches, each with the stack of spans the host
was in, outermost first, and books two things to those stacks:

- idle time: each stretch of the window in which the device ran nothing
  (the complement of the union of its intervals, exactly as
  `trace.read` computes `busy_s`) goes to the stacks the host was in
  over it, by interval intersection, so the pieces sum to the window's
  idle time;
- device time: each device interval (kernel, copy, fill) goes to the
  stack the host was in when it launched it: the interval's
  `correlation` joined to the runtime or driver call with the same
  correlation, at that call's host timestamp.  Device work with no such
  call is booked as unlinked.

Both rest on the profiler's mapping of the device's clock onto the
host's.  No device interval can start before the call that launched it,
so the least lead from a call to its interval (`min_lead_us`) reads
that mapping: negative, the device's intervals sit early by at least
that much, and idle time at the end of a stretch is booked to the next.

The readers of `metrics/` take their numbers from `of(readings)`.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from bench_port.trace import DEVICE_CATS

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# a device-time reading whose unlinked work exceeds this share of it is
# no reading
UNLINKED_MAX = 0.01


@dataclass
class Attribution:
    """idle / device: {stack of span names, outermost first: seconds};
    unlinked_s: device seconds with no launch call; seen: every span
    name on the loop's thread in the window; min_lead_us: the least
    time from a launch call's start to its device interval's (None
    with none linked)."""

    idle: dict = field(default_factory=dict)
    device: dict = field(default_factory=dict)
    unlinked_s: float = 0.0
    seen: frozenset = frozenset()
    min_lead_us: float | None = None

    def idle_in(self, names) -> float | None:
        """Idle seconds with the host inside any of `names`, at any
        depth; None when none of them ran in the window."""
        if not self.seen & set(names):
            return None
        return sum(s for st, s in self.idle.items() if set(st) & set(names))

    def device_in(self, names) -> float | None:
        """Device seconds of the work launched inside any of `names`;
        None when there is none, or the unlinked work is over
        `UNLINKED_MAX` of it."""
        s = sum(v for st, v in self.device.items() if set(st) & set(names))
        if s <= 0 or self.unlinked_s > UNLINKED_MAX * s:
            return None
        return s

    def idle_by_innermost(self) -> dict:
        """{innermost span: idle seconds}; "bench.loop" for the stretches
        in no span (the closed loop's own code)."""
        out: dict[str, float] = {}
        for st, s in self.idle.items():
            key = st[-1] if st else "bench.loop"
            out[key] = out.get(key, 0.0) + s
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _window(events: list):
    win = [e for e in events if e.get("name") == "bench.window"
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    return w0, w0 + float(win[0]["dur"]), win[0].get("tid")


def idle_intervals(events: list, w0: float, w1: float) -> list:
    """[(a, b)] in which no device interval ran, inside [w0, w1]: the
    gaps `trace.read` books, by the same union."""
    kernels = sorted(
        (float(e["ts"]), float(e.get("dur", 0.0))) for e in events
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X")
    out, cursor = [], w0
    for ts, dur in kernels:
        ts, end = max(ts, w0), min(ts + dur, w1)
        if end <= ts:
            continue
        if ts > cursor:
            out.append((cursor, ts))
        cursor = max(cursor, end)
    if w1 > cursor:
        out.append((cursor, w1))
    return out


def segments(events: list, tid, w0: float, w1: float) -> list:
    """[(a, b, stack)] covering [w0, w1] in order: the names of the
    `user_annotation` ranges of thread `tid` (but `bench.window`) holding
    [a, b), outermost first.  A range that outlasts the one it started
    in (the clock's rounding) is cut at its end."""
    spans = sorted(
        ((max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1),
          e["name"]) for e in events
         if e.get("ph") == "X" and e.get("cat") == "user_annotation"
         and e.get("tid") == tid and e.get("name") != "bench.window"),
        key=lambda s: (s[0], -s[1]))
    out: list = []
    open_: list = []  # [(end, name)], innermost last
    cursor = w0

    def to(t: float) -> None:
        nonlocal cursor
        while open_ and open_[-1][0] <= t:
            end = open_[-1][0]
            if end > cursor:
                out.append((cursor, end, tuple(n for _, n in open_)))
                cursor = end
            open_.pop()
        if t > cursor:
            out.append((cursor, t, tuple(n for _, n in open_)))
            cursor = t

    for a, b, name in spans:
        if b <= a:
            continue
        to(a)
        if open_:
            b = min(b, open_[-1][0])
        open_.append((b, name))
    to(w1)
    return out


def attribute(events: list) -> Attribution | None:
    """The attribution of a list of Chrome trace events (None without a
    `bench.window`)."""
    win = _window(events)
    if win is None:
        return None
    w0, w1, tid = win
    segs = segments(events, tid, w0, w1)
    seen = frozenset(n for _, _, st in segs for n in st)
    idle: dict = {}
    j = 0
    for a, b in idle_intervals(events, w0, w1):
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                st = segs[k][2]
                idle[st] = idle.get(st, 0.0) + (hi - lo) * 1e-6
            k += 1

    starts = [s[0] for s in segs]
    launched: dict = {}  # correlation: its call's start and stack
    for e in events:
        if e.get("cat") not in LAUNCH_CATS or e.get("ph") != "X":
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        ts = float(e["ts"])
        i = bisect.bisect_right(starts, ts) - 1
        inside = (e.get("tid") == tid and i >= 0
                  and segs[i][0] <= ts < segs[i][1])
        launched[corr] = (ts, segs[i][2] if inside else ())
    device: dict = {}
    unlinked = 0.0
    lead = None
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        dur = float(e.get("dur", 0.0)) * 1e-6
        call = launched.get((e.get("args") or {}).get("correlation"))
        if call is None:
            unlinked += dur
            continue
        device[call[1]] = device.get(call[1], 0.0) + dur
        d = float(e["ts"]) - call[0]
        lead = d if lead is None else min(lead, d)
    return Attribution(idle, device, unlinked, seen, lead)


def of(r) -> Attribution | None:
    """The attribution of a reading's events: `r.events`, the
    profiler's Chrome events the reading was made from (`attribute.py`
    sets it; readings without it read nothing)."""
    events = getattr(r, "events", None)
    return attribute(events) if events else None
