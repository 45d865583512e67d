"""The benchmark's run of one cell: set-up, the measured window, the check.

Everything a cell needs is found by name: the cell in BENCHMARK.json,
its traffic in `traffic/<cell>.json` (its configuration, its driver kind
and the driver's parameters), the configuration's file as
BENCHMARK.json names it, the driver in `drivers/<kind>.py` and each
per-layer metric's reader in `metrics/<metric>.py`.  A cell, a traffic
mix or a metric is added by adding files and entries; nothing here names
one.

A driver is a class `Driver(ctx)` with:

- `setup()`: build the program's state and the cell's inputs from the
  seed, and run every shape the window will use once, timing its parts
  in `parts` (a `Parts`);
- `prepare(i)`: the i-th operation's inputs, made before its clock
  starts; `op(item, span)`: the operation, into the program; `after(i,
  item)`: keep what the check needs, after the operation completed;
  `units(item)`: the work it did, in the unit of the cell's rate;
- `release()`: free the program's state, keeping its outputs;
- `check() -> [(name, value, limit)]`: the comparison with the plain
  reference (correct when every value is at most its limit);
- `end_to_end(window)`: the cell's end-to-end metrics but `setup_s`;
- `trace_info(first, last)`: what the per-layer readers need of the
  traced operations (bounds, bytes).

Each operation is timed on the card's clock: CUDA events recorded on the
stream before the call and after it, the second waited for before the
next operation starts (one operation in flight).  The rate is the work
of the whole window over the host clock's window.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ceph_tpu")
# the traced part of a --trace 1 window: it starts a quarter into the
# window and lasts this long (or until the window ends)
TRACE_SECONDS = 3.0
TRACE_MIN_OPS = 16


def checkout_caches() -> None:
    """Point every build and kernel cache the program or torch may write
    at a fixed directory inside the checkout (before torch is imported)."""
    import os

    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


class Parts:
    """Seconds of each named part of a driver's set-up (`with parts(n):`),
    printed on standard error."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    def __call__(self, name: str):
        return _Part(self, name)


class _Part:
    def __init__(self, parts: Parts, name: str):
        self.parts, self.name = parts, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.parts.seconds[self.name] = time.perf_counter() - self.t0
        return False


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def p95(values) -> float:
    """The 95th percentile of every sample, by nearest rank."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


@dataclass
class Cell:
    name: str
    workload: dict
    traffic: dict
    config: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, name: str, root: Path = ROOT) -> "Cell":
        bench = json.loads((root / "BENCHMARK.json").read_text())
        wl = next((w for w in bench["workloads"] if w["name"] == name), None)
        if wl is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
        traffic = json.loads(
            (root / "bench_port" / "traffic" / f"{name}.json").read_text())
        if traffic["config"] != wl["config"]:
            raise SystemExit(f"traffic/{name}.json names configuration "
                             f"{traffic['config']!r}, BENCHMARK.json "
                             f"{wl['config']!r}")
        config = json.loads((root / entry["file"]).read_text())

        def mine(metric):
            return name in metric.get("workloads", [name])
        return cls(name, wl, traffic, config,
                   [m for m in bench["end_to_end"] if mine(m)],
                   [m for m in bench["per_layer"] if mine(m)])


class Spans:
    """Host-clock spans of the benchmark's own calls into the program.

    Off, a span is a shared no-op.  On, each span's seconds are kept by
    name, and while the profiler runs the span is also a
    `record_function` range, so the trace places it beside the device's
    work."""

    def __init__(self, on: bool):
        self.on = on
        self.profiling = False
        self.seconds: dict[str, list] = collections.defaultdict(list)

    def __call__(self, name: str):
        if not self.on:
            return _NOOP
        return _Span(self, name)


class _Noop:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name, self.rf = spans, name, None

    def __enter__(self):
        if self.spans.profiling:
            import torch

            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.seconds[self.name].append(time.perf_counter() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


@dataclass
class Ctx:
    """What a driver is given: the cell, the seed and the device."""

    cell: Cell
    seed: int
    device: object
    program: object = None  # None: the port; else a stand-in (controls)

    @property
    def config(self) -> dict:
        return self.cell.config


def make_driver(ctx: Ctx):
    kind = ctx.cell.traffic["driver"]
    mod = load_module(HERE / "drivers" / f"{kind}.py",
                      f"bench_port.drivers.{kind}")
    return mod.Driver(ctx)


class Clock:
    """Times one operation: CUDA events on a card, the host clock on the
    CPU (the CPU tests)."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.e0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self, span) -> float:
        """Wait for the operation; its milliseconds."""
        if self.cuda:
            self.e1.record()
            with span("bench.sync"):
                self.e1.synchronize()
            return self.e0.elapsed_time(self.e1)
        return (time.perf_counter() - self.t0) * 1e3


@dataclass
class Window:
    ops: int = 0
    failed: int = 0
    units: int = 0
    seconds: float = 0.0
    latency_ms: list = field(default_factory=list)
    traced: tuple | None = None  # (first op, last op + 1)
    profile: object = None
    spans: Spans | None = None


def run_window(drv, device, seconds: float, trace: bool,
               max_ops: int | None = None) -> Window:
    """Closed loop for `seconds` (or `max_ops` operations), one operation
    in flight."""
    import torch

    w = Window(spans=Spans(trace))
    span = w.spans
    clock = Clock(device)
    prof = None
    t_start = time.perf_counter()
    deadline = t_start + seconds
    trace_at = t_start + seconds / 4
    first_error = None

    def end_trace():
        rf.__exit__(None, None, None)
        _stop_profile(prof, device)
        span.profiling = False
        w.traced, w.profile = (traced_from, w.ops), prof

    while True:
        now = time.perf_counter()
        if now >= deadline or (max_ops is not None and w.ops >= max_ops):
            break
        if trace and prof is None and w.traced is None and now >= trace_at:
            prof = _start_profile(device)
            span.profiling = True
            rf = torch.profiler.record_function("bench.window")
            rf.__enter__()
            traced_from, prof_t0 = w.ops, time.perf_counter()
            print(f"profiler start {prof_t0 - now:.3f} s", file=sys.stderr)
        elif (prof is not None and now - prof_t0 >= TRACE_SECONDS
              and w.ops - traced_from >= TRACE_MIN_OPS):
            end_trace()
            prof = None
        item = drv.prepare(w.ops)
        clock.start()
        try:
            drv.op(item, span)
            w.latency_ms.append(clock.stop(span))
        except Exception as e:  # a failed operation is counted, not fatal
            w.failed += 1
            first_error = first_error or e
            if w.failed >= 10:
                break
        else:
            drv.after(w.ops, item)
            w.units += drv.units(item)
        w.ops += 1
    w.seconds = time.perf_counter() - t_start
    if prof is not None:
        end_trace()
    if first_error is not None:
        import traceback

        traceback.print_exception(first_error, file=sys.stderr)
    return w


def _start_profile(device):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def warm_profiler(device) -> float:
    """Start and stop the profiler once on a small op, so that the
    window's trace does not pay the profiler's first start; its seconds."""
    import torch

    t0 = time.perf_counter()
    prof = _start_profile(device)
    torch.ones(1, device=device).add_(1)
    _stop_profile(prof, device)
    return time.perf_counter() - t0


def _stop_profile(prof, device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)


def per_layer(cell: Cell, drv, w: Window, n_chips: int) -> tuple:
    """(metrics, device extras, breakdown) of a traced run."""
    from bench_port import trace as tr

    if w.profile is None:  # the window ended before its traced part began
        return {}, {"busy_s": 0.0, "window_s": 0.0}, None
    rd = tr.read_profile(w.profile, n_chips)
    rd.spans = w.spans.seconds
    rd.ops = w.ops
    rd.traced = w.traced
    rd.traced_ops = w.traced[1] - w.traced[0]
    rd.info = drv.trace_info(*w.traced)
    rd.cell = cell
    out = {}
    for m in cell.per_layer:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             f"bench_port.metrics.{m['name']}")
        v = reader.read(rd)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"busy_s": rd.busy_s, "window_s": rd.window_s}
    return out, device, rd.breakdown()


def loaded_forbidden() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    cell = Cell.load(a.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{a.workload} needs {chips} CUDA device(s); this process "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    drv = make_driver(Ctx(cell, a.seed, torch.device("cuda", 0)))
    before = time.perf_counter() - t0
    drv.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    parts = {"imports": before, **drv.parts.seconds}
    print("setup parts " + json.dumps({k: round(v, 3)
                                       for k, v in parts.items()}),
          file=sys.stderr)

    if a.trace:
        print(f"profiler warm-up {warm_profiler('cuda'):.3f} s",
              file=sys.stderr)
    w = run_window(drv, "cuda", a.seconds, bool(a.trace))
    peak = torch.cuda.max_memory_allocated()
    drv.release()
    checks = drv.check()
    correct = w.failed == 0 and w.ops > 0 and all(
        v <= lim for _, v, lim in checks)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": w.ops, "failed": w.failed}
    if a.trace:
        metrics, extra, breakdown = per_layer(cell, drv, w, chips)
        device.update(extra)
    else:
        e2e = {"setup_s": setup_s, **drv.end_to_end(w)}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
        breakdown = None
    result.update(metrics=metrics, device=device)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}

    bad = loaded_forbidden()
    if bad:
        print(f"modules loaded that the benchmark must not load: {bad}",
              file=sys.stderr)
        return 3
    for n, v, lim in checks:
        print(f"check {n} {v} limit {lim}", file=sys.stderr)
    print(json.dumps(result))
    return 0
