"""Kernel registry — one record for each of the port's hand-written kernels.

The port of `ceph_tpu/obs/executables.py`.  Where the JAX package keeps
a record for each compiled executable of its trace-once caches, the
port's unit of performance is a hand kernel that nvcc builds from one
source (`ceph_tpu_torch/build.py`): `gf_matmul`, `crush_rule`,
`crush_rule_diag`, `upmap_loop` and `pipeline`.  Each wrapper registers its kernel at import (through
`obs.cuda_accounting.LaunchAccount`); the registry only observes.  A
record holds:

- the source, its hash (the name of its built library) and, once built,
  its `build.ptxas_report` rows (registers, stack, spills, static shared
  memory) and the nvcc seconds of this process's build (None when the
  library was built already);
- the launches, the host's enqueue seconds and their quantile (p50 /
  p90 / p99, `obs.quantiles`), booked once a launch under one lock (the
  wrapper's perf group reads its launch keys from here);
- the bytes and operations one launch moves, as the wrapper reckons them
  from the last launch's shape when a dump asks (`work`), in place of
  XLA's cost analysis;
- launches timed on the card by a caller that waited for them
  (`note_timed`: CUDA events in `chip_smoke.py`), from which `dump`
  derives the achieved GB/s and operations/s.  Enqueue times never
  stand in for the card's: a launch returns before the kernel ends.

`dump(analyze=False)` reads nothing but the records (the admin socket's
`perf dump` path); `analyze=True` adds the source hash and the ptxas
rows, read from the build directory (no device work).  `reset()` zeroes
the records and keeps them: the wrappers hold them from import on.
"""

from __future__ import annotations

import threading
import time

from ceph_tpu_torch.obs import quantiles, trace

_REG: dict[str, "KernelRecord"] = {}
_LOCK = threading.Lock()


class KernelRecord:
    """Metadata and launch accounting for one hand kernel.  A launch is
    booked here once, under one lock; the wrapper's perf group reads
    its `<kernel>_launches` and `_launch_seconds` from this record."""

    def __init__(self, name: str, source: str, work=None):
        self.name = name
        self.source = source  # path under the package, e.g. ec/csrc/x.cu
        # work(shape) -> (bytes, operations) of one launch of that shape,
        # reckoned when a dump asks, from the last launch's shape
        self.work = work
        self._lock = threading.Lock()
        # the enqueue seconds' quantile, updated and read under _lock
        self.enqueue = quantiles.Quantile()
        self._zero()

    def _zero(self) -> None:
        self.zero_launches()
        self.timed_seconds = 0.0
        self.timed_bytes = 0
        self.timed_ops = 0
        self.timed_launches = 0

    def zero_launches(self) -> None:
        """Zero the launch count, its seconds and their quantile (the
        wrapper's `launches = 0`, and the perf group's reset)."""
        with self._lock:
            self.launches = 0
            self.launch_seconds = 0.0
            self.last_shape = None
            self.last_end = None  # perf_counter() at the last launch's end
            self.enqueue.reset_unlocked()

    def note_launch(self, dt: float, end: float, shape=None) -> None:
        """Book one launch: its host enqueue seconds `dt`, ending at
        perf_counter() `end`, and its shape for `work`."""
        with self._lock:
            self.launches += 1
            self.launch_seconds += dt
            self.enqueue.add(dt)
            self.last_shape = shape
            self.last_end = end

    def launch_count(self) -> int:
        return self.launches

    def launch_time(self) -> tuple[int, float]:
        """(launches, their enqueue seconds): a time_avg's count and sum."""
        with self._lock:
            return self.launches, self.launch_seconds

    def note_timed(self, seconds: float, nbytes: int = 0, ops: int = 0,
                   launches: int = 1) -> None:
        """Book launches whose completion the caller timed on the card."""
        with self._lock:
            self.timed_seconds += seconds
            self.timed_bytes += nbytes
            self.timed_ops += ops
            self.timed_launches += launches

    def build_seconds(self) -> float | None:
        from ceph_tpu_torch import build

        return build.BUILD_SECONDS.get(self.source)

    def analyze(self) -> dict:
        """Source hash and ptxas rows (files of the build directory)."""
        from ceph_tpu_torch import build

        out = {"source_hash": build.source_hash(self.source)}
        if build.built(self.source):
            out["ptxas"] = build.ptxas_report(self.source)
        else:
            out["ptxas"] = None  # not built on this host yet
        return out

    def summary(self, analyze: bool = False) -> dict:
        with self._lock:
            out = {
                "kernel": self.name,
                "source": self.source,
                "launches": self.launches,
                "launch_seconds": round(self.launch_seconds, 6),
            }
            shape, end = self.last_shape, self.last_end
            out["enqueue_seconds"] = self.enqueue.dump_unlocked()
            timed = (self.timed_seconds, self.timed_bytes, self.timed_ops,
                     self.timed_launches)
        nbytes, ops = (self.work(shape) if shape is not None
                       and self.work is not None else (0, 0))
        out["bytes_per_launch"] = nbytes
        out["ops_per_launch"] = ops
        out["last_use_unix"] = (None if end is None else round(
            time.time() - (time.perf_counter() - end), 1))
        out["build_seconds"] = self.build_seconds()
        if analyze:
            out.update(self.analyze())
        seconds, nbytes, ops, n = timed
        if n and seconds > 0:
            roof = {"timed_launches": n, "timed_avg_s": seconds / n}
            if nbytes:
                roof["achieved_gbps"] = round(nbytes / seconds / 1e9, 3)
            if ops:
                roof["achieved_gops"] = round(ops / seconds / 1e9, 3)
            out["roofline"] = roof
        return out


def register(name: str, source: str, work=None) -> KernelRecord:
    """Create (or return) the record of kernel `name` built from
    `source`, whose launches' bytes and operations `work(shape)`
    reckons."""
    with _LOCK:
        rec = _REG.get(name)
        if rec is None:
            rec = _REG[name] = KernelRecord(name, source, work)
        elif rec.source != source:
            raise ValueError(f"kernel {name!r} registered from "
                             f"{rec.source}, not {source}")
        elif work is not None:
            rec.work = work
        return rec


def dump(analyze: bool = True, budget_s: float = 10.0) -> dict:
    """The `executables` section: every record, plus the totals.  With
    `analyze`, each record's source hash and ptxas rows until `budget_s`
    of wall clock is spent (later records go without)."""
    with _LOCK:
        recs = list(_REG.values())
    entries = []
    t0 = time.perf_counter()
    with trace.span("obs.exec_analyze", entries=len(recs)):
        for rec in recs:
            more = analyze and time.perf_counter() - t0 < budget_s
            entries.append(rec.summary(analyze=more))
    return {
        "entries": entries,
        "kernels": len(entries),
        "launches": sum(e["launches"] for e in entries),
        "total_build_seconds": round(sum(
            e["build_seconds"] or 0.0 for e in entries), 3),
    }


def prometheus_gauges() -> str:
    """Registry series appended to the metrics exposition: the JAX
    package's three, one label value per kernel."""
    with _LOCK:
        recs = sorted(_REG.values(), key=lambda r: r.name)
    if not recs:
        return ""
    lines = []
    for metric, help_, mtype, value in (
        ("ceph_tpu_executables_registered",
         "hand kernels registered (one per built source)",
         "gauge", lambda r: "1"),
        ("ceph_tpu_executables_compile_seconds_total",
         "nvcc wall seconds of this process's build, per kernel",
         "counter", lambda r: repr(round(r.build_seconds() or 0.0, 4))),
        ("ceph_tpu_executables_dispatches_total",
         "kernel launches, per kernel",
         "counter", lambda r: str(r.launches)),
    ):
        lines.append(f"# HELP {metric} {help_}")
        lines.append(f"# TYPE {metric} {mtype}")
        for r in recs:
            lines.append(f'{metric}{{cache="{r.name}"}} {value(r)}')
    return "\n".join(lines) + "\n"


def records(name: str | None = None) -> list[KernelRecord]:
    """Live records, optionally only kernel `name`'s."""
    with _LOCK:
        return [r for r in _REG.values() if name is None or r.name == name]


def record(name: str) -> KernelRecord:
    with _LOCK:
        return _REG[name]


def reset() -> None:
    """Test isolation: zero every record's accounting, keep the records
    (the wrappers registered them at import and hold them)."""
    with _LOCK:
        recs = list(_REG.values())
    for rec in recs:
        rec._zero()
