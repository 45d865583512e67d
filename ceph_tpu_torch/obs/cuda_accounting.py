"""Launch accounting for the hand kernels: build vs launch vs fetch.

The port of `ceph_tpu/obs/jax_accounting.py`.  The JAX package splits a
jitted entry point's first call (trace + compile) from its later
dispatches (`JitAccount`); the port compiles nothing at call time.  A
kernel is built once by nvcc (`build.py`) and then launched.
`LaunchAccount` books each launch once, into the kernel's record of the
kernel registry (`obs.executables`): the count, the host wall time of
its enqueue and the launch's shape, from which the record reckons the
bytes and operations a launch moves when `cache dump` asks.  The
wrapper's perf group reads from that record

    <key>_launches        u64       launches of the kernel
    <key>_launch_seconds  time_avg  host wall time of one launch's enqueue

and books itself

    <key>_build_seconds   time_avg  the first call's build and load (nvcc
                                    when this process builds the library)

A launch returns before the kernel ends: enqueue time is all it
measures, and nothing here waits for the card.  `timed_fetch` is the
one place that does: it copies a result to the host (which waits for
the work that produces it) and books

    <key>_fetch_seconds   time_avg  device-to-host copy plus completion

and its distribution into `<key>_fetch_hist`.

Nothing is compiled, so the JAX keys `*_compiles`, `*_cache_hits`,
`*_retraces`, `*_compile_seconds`, `*_dispatch_seconds` and
`*_dispatch_hist` have no counterpart: `ABSENT` / `absent_by_design`
and `ADDED` list, group by group, the JAX keys the port leaves out and
the keys it adds.
"""

from __future__ import annotations

import functools
import threading
import time

import numpy as np

from ceph_tpu_torch.obs import executables, trace
from ceph_tpu_torch.utils.perf_counters import PerfCounters

# The port's perf groups against the JAX package's, by design.  Absent:
# every key a JitAccount books (one of JIT_SUFFIXES after one of the JAX
# package's JitAccount keys: the port compiles nothing at call time) and
# the other compile and cache keys.  Added: the launch accounts
# of the hand kernels, and counts of the port's own device calls.
JIT_KEYS = ("gf", "gf_batch", "fast", "loop", "diag", "scatter",
            "stack_stats", "epoch_stats", "traffic", "drain", "cand_score",
            "device_loop", "shard_stats", "shard_step")
JIT_SUFFIXES = ("_compiles", "_cache_hits", "_retraces",
                "_compile_seconds", "_dispatch_seconds", "_dispatch_hist")
_JIT_ACCOUNT_KEYS = frozenset(k + s for k in JIT_KEYS for s in JIT_SUFFIXES)
ABSENT: dict[str, tuple[str, ...]] = {
    "ec": ("pipe_cache_hits", "pipe_cache_misses"),
    "pipeline": ("pipe_cache_hits", "pipe_cache_misses"),
    "fleet": ("steady_compiles",),
    "serve": ("prewarmed_structures",),
}
ADDED: dict[str, tuple[str, ...]] = {
    "ec": ("gf_matmul_launches", "gf_matmul_launch_seconds",
           "gf_matmul_build_seconds"),
    "pipeline": ("crush_rule_launches", "crush_rule_launch_seconds",
                 "crush_rule_build_seconds", "crush_rule_diag_launches",
                 "crush_rule_diag_launch_seconds",
                 "crush_rule_diag_build_seconds"),
    # the plan kernel's launch account, and the device_loop plan's host
    # reads (one a plan on a card; one a round and the readback on the
    # CPU)
    "balancer": ("upmap_loop_launches", "upmap_loop_launch_seconds",
                 "upmap_loop_build_seconds", "plan_host_syncs"),
    # the epoch-stats torch-ops calls
    "sim": ("stats_calls",),
    "recovery": ("device_drains",),
    "workload": ("device_traffic",),
    # the stacked stats calls; host_lanes split into lanes replayed from
    # the stats cache and lanes a member stepped itself
    "fleet": ("stats_calls", "cached_lanes", "solo_lanes"),
}


def absent_by_design(group: str, key: str) -> bool:
    """True for a JAX key of `group` the port does not book."""
    return key in ABSENT.get(group, ()) or key in _JIT_ACCOUNT_KEYS


class LaunchAccount:
    """The launch accounting of one hand kernel: its record in the kernel
    registry, under `key`, which `logger` reads its launch keys from.
    `work(shape)` gives the bytes and operations of a launch of that
    shape."""

    def __init__(self, logger: PerfCounters, key: str, source: str,
                 span: str | None = None, work=None):
        self.log = logger
        self.key = key
        self.record = rec = executables.register(key, source, work)
        self.span = f"{span or f'{logger.name}.{key}'}.launch"
        self._loaded = False
        self._load_lock = threading.Lock()
        logger.add_view(f"{key}_launches", "u64", rec.launch_count,
                        rec.zero_launches, "kernel launches")
        logger.add_view(f"{key}_launch_seconds", "time_avg",
                        rec.launch_time, rec.zero_launches,
                        "host wall time of one launch's enqueue")
        logger.add_time_avg(f"{key}_build_seconds",
                            "first call's kernel build (nvcc) and load")

    def load(self, loader):
        """`loader()` (the wrapper's library load, which builds the
        kernel when this host has not), its first call's wall time booked
        as `<key>_build_seconds`."""
        if self._loaded:
            return loader()
        with self._load_lock:
            t0 = time.perf_counter()
            lib = loader()
            if not self._loaded:
                self.log.observe(f"{self.key}_build_seconds",
                                 time.perf_counter() - t0)
                self._loaded = True
        return lib

    def launch(self, fn, *args, shape=None):
        """rc = fn(*args), the kernel's C launch, timed on the host; a
        launch that returns 0 is booked, with `shape` for `work`."""
        with trace.span(self.span):
            t0 = time.perf_counter()
            rc = fn(*args)
            t1 = time.perf_counter()
        if rc == 0:
            self.record.note_launch(t1 - t0, t1, shape)
        return rc

    def entry(self, fn):
        """`fn` (the kernel's Python wrapper) as a KernelEntry whose
        `launches` is this kernel's registry count."""
        return KernelEntry(fn, self.record)


class KernelEntry:
    """A kernel's wrapper: calls through to it, and its `launches`
    attribute reads (and, for a caller counting from 0, zeroes) the
    kernel's count in the registry: one number, which the perf group's
    `<key>_launches` reads too."""

    def __init__(self, fn, record: executables.KernelRecord):
        functools.update_wrapper(self, fn)
        self.fn = fn
        self.record = record

    def __call__(self, *args, **kw):
        return self.fn(*args, **kw)

    @property
    def launches(self) -> int:
        return self.record.launches

    @launches.setter
    def launches(self, n: int) -> None:
        if n != 0:
            raise ValueError("a kernel's launches can only be set to 0")
        self.record.zero_launches()


def timed_fetch(logger: PerfCounters, key: str, x):
    """x (a tensor, or a tuple or list of tensors) copied to the host as
    numpy, the copy (which also waits for the work producing x) booked
    into <key>_fetch_seconds and its distribution into the
    <key>_fetch_hist quantile counter."""
    name = f"{key}_fetch_seconds"
    hist = f"{key}_fetch_hist"
    # declare-on-first-use: declares are idempotent
    logger.add_time_avg(name, "device->host transfer wall time")
    logger.add_quantile(hist, "device->host transfer time distribution")
    with trace.span(f"{logger.name}.{key}.fetch"):
        t0 = time.perf_counter()
        if isinstance(x, (tuple, list)):
            out = tuple(np.asarray(t.cpu()) for t in x)
        else:
            out = np.asarray(x.cpu())
        dt = time.perf_counter() - t0
    logger.observe(name, dt)
    logger.observe(hist, dt)
    return out
