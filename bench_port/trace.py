"""What the traced part of a window says: the device's work and its idle
gaps, from the profiler's trace.

The profiler's trace (its Chrome export) holds the device's kernels,
copies and fills with their start and length, and the benchmark's own
spans (`record_function` ranges named `bench.*`) on the same clock.  The
traced window is the `bench.window` range.  Device time is the union of
the device's intervals inside it; an idle gap is a stretch of it where
the device ran nothing, named after the innermost benchmark span the
host was in at the gap's middle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclass
class Readings:
    """What a per-layer reader is given.

    - kernels: [(name, start_us, dur_us)] of the traced window's device
      work, in start order;
    - busy_s, window_s: the union of that work, and the window's length;
    - gaps: {span name: idle seconds};
    - spans: {span name: [host seconds of each call]} over the whole window;
    - ops: operations in the window; traced: (first, last + 1) of its
      traced part, traced_ops their number;
    - info: the driver's `trace_info` of the traced operations;
    - cell: the harness's Cell."""

    kernels: list = field(default_factory=list)
    busy_s: float = 0.0
    window_s: float = 0.0
    gaps: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    ops: int = 0
    traced: tuple = (0, 0)
    traced_ops: int = 0
    info: dict = field(default_factory=dict)
    cell: object = None

    def device_seconds(self, match=None) -> float:
        """Seconds of device work whose name contains `match` (all: None)."""
        return sum(d for n, _, d in self.kernels
                   if match is None or match in n) * 1e-6

    def idle_share(self):
        """%, of the traced window, in which the device ran nothing."""
        if self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def launches(self, match: str) -> int:
        return sum(1 for n, _, _ in self.kernels if match in n)

    def breakdown(self) -> dict:
        by_name: dict[str, float] = {}
        for n, _, d in self.kernels:
            key = short_name(n)
            by_name[key] = by_name.get(key, 0.0) + d * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def short_name(name: str) -> str:
    """A kernel's name without its parameter list."""
    n = name.replace("(anonymous namespace)::", "")
    return n.split("(")[0].strip()[:120] or name[:120]


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def read(events: list, n_chips: int = 1) -> Readings:
    """Readings of a list of Chrome trace events."""
    # the host's range (a kernel-side copy of it, cat gpu_user_annotation,
    # spans only the device work inside it)
    win = [e for e in events if e.get("name") == "bench.window"
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
        return Readings()
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    # the profiler runs only around the traced operations (the card idle
    # before and after them), so all its device work is theirs: the
    # device's clock, mapped onto the host's, may place the first kernel a
    # little before the window opens
    kernels = sorted(
        ((e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
         for e in events
         if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"),
        key=lambda k: k[1])
    spans = sorted(
        ((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
         for e in events
         if e.get("ph") == "X" and e.get("cat") == "user_annotation"
         and str(e.get("name", "")).startswith("bench.")
         and e["name"] != "bench.window"),
        key=lambda s: s[1])
    starts = [s[1] for s in spans]
    busy = 0.0
    gaps: dict[str, float] = {}
    cursor = w0

    def gap(a: float, b: float) -> None:
        if b <= a:
            return
        mid = (a + b) / 2
        # the spans are the benchmark's calls, one after another (nested
        # at most a few deep): the innermost holding mid started last
        i = bisect.bisect_right(starts, mid) - 1
        name = "bench.loop"
        for s in spans[max(0, i - 3):i + 1][::-1]:
            if s[1] <= mid < s[2]:
                name = s[0]
                break
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6

    for _, ts, dur in kernels:
        ts, end = max(ts, w0), min(ts + dur, w1)
        if end <= ts:
            continue
        if ts > cursor:
            gap(cursor, ts)
            busy += end - ts
        elif end > cursor:
            busy += end - cursor
        cursor = max(cursor, end)
    gap(cursor, w1)
    return Readings(kernels=kernels, busy_s=busy * 1e-6 / n_chips,
                    window_s=(w1 - w0) * 1e-6, gaps=gaps)


def read_profile(prof, n_chips: int = 1) -> Readings:
    return read(_events(prof), n_chips)
