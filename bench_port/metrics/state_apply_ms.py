"""state_apply_ms: host milliseconds of `ClusterState.apply`, per epoch.

The benchmark's `bench.apply` span, over every epoch of the window."""


def read(r):
    s = r.spans.get("bench.apply")
    return 1e3 * sum(s) / len(s) if s else None
