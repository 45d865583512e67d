"""rows_idle_ms: milliseconds an epoch that the card was idle while the
host was inside the program's `state.rows` span (at any depth): the part
of `ClusterState.rows`'s host path that the pipeline kernel does not
hide.  From the profiler's trace (`attribution.py`)."""

from bench_port import attribution


def read(r):
    a = attribution.of(r)
    s = a.idle_in({"state.rows"}) if a is not None else None
    return 1e3 * s / r.traced_ops if s is not None and r.traced_ops else None
