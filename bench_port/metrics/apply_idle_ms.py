"""apply_idle_ms: milliseconds an epoch that the card was idle while the
host was inside the program's `state.apply` span (at any depth):
`ClusterState.apply`'s advance of the host map and its scatter, as far as
the card waits for them.  From the profiler's trace (`attribution.py`)."""

from bench_port import attribution


def read(r):
    a = attribution.of(r)
    s = a.idle_in({"state.apply"}) if a is not None else None
    return 1e3 * s / r.traced_ops if s is not None and r.traced_ops else None
