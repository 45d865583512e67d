"""Observability layer: spans + perf counters + launch accounting.

The port of `ceph_tpu/obs`, with its import surface:

    from ceph_tpu_torch import obs

    L = obs.logger_for("pipeline")        # perf-counter group
    L.add_u64("pgs_mapped")
    with obs.span("pipeline.map_block", pgs=n):
        ...
        L.inc("pgs_mapped", n)

The pieces (each usable alone):

- `trace`: nested, thread-safe span tracer, env-gated via
  `CEPH_TPU_TRACE=<path>`, exported as Chrome trace-event JSON (open in
  Perfetto).  Spans time the host; none waits for the card.
- `perf_counters` (ceph_tpu_torch.utils): the reference's perf-dump
  registry (u64 / avg / time_avg / histogram / quantile), with the JAX
  package's groups and keys, exposed by
  `python -m ceph_tpu_torch.cli.daemon perf dump|metrics` and, for live
  processes, the env-gated admin socket (`CEPH_TPU_ADMIN_SOCKET`).
- `cuda_accounting`: each hand kernel's launches, enqueue time and
  first-call build (`LaunchAccount`), and device-to-host fetch time
  (`timed_fetch`); `executables` is the registry of those kernels.
- `placement`, `health`, `timeline`, `quantiles`: the placement-decision
  records, the cluster health checks, the time-series recorder and the
  latency quantiles.

`jit_counters` is not ported: the port compiles nothing at call time.
Importing this package starts the admin-socket server only when
`CEPH_TPU_ADMIN_SOCKET` is set.
"""

from __future__ import annotations

from ceph_tpu_torch.obs import executables, placement, quantiles, spans, trace
from ceph_tpu_torch.obs import health, timeline  # noqa: E402 (trace first)
from ceph_tpu_torch.obs.admin_socket import maybe_start_from_env
from ceph_tpu_torch.obs.cuda_accounting import LaunchAccount, timed_fetch
from ceph_tpu_torch.obs.trace import (
    counter,
    flush,
    instant,
    set_trace_path,
    span,
    trace_path,
)
from ceph_tpu_torch.utils.perf_counters import (
    UndeclaredCounterError,
    group_view,
    logger_for,
    perf_dump,
    perf_schema,
    reset_values,
)


def prometheus_text() -> str:
    """Prometheus text exposition of the whole perf registry, plus the
    kernel-registry gauges (per-kernel launches and nvcc seconds), the
    placement-diagnostics per-source gauges, the health-check gauges,
    and the timeline latest-sample gauges."""
    from ceph_tpu_torch.obs.prometheus import prometheus_text as _render

    return (_render(perf_dump()) + executables.prometheus_gauges()
            + placement.prometheus_gauges() + health.prometheus_gauges()
            + timeline.prometheus_gauges())


maybe_start_from_env()

__all__ = [
    "LaunchAccount",
    "UndeclaredCounterError",
    "counter",
    "executables",
    "flush",
    "group_view",
    "health",
    "instant",
    "logger_for",
    "perf_dump",
    "perf_schema",
    "placement",
    "prometheus_text",
    "quantiles",
    "reset_values",
    "set_trace_path",
    "span",
    "spans",
    "timed_fetch",
    "timeline",
    "trace",
    "trace_path",
]
