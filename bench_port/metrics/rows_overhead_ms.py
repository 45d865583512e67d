"""rows_overhead_ms: what an epoch's `ClusterState.rows` costs beyond the
pipeline kernel, in milliseconds.

Over the traced epochs: the host time of `rows()` and of the wait for the
card after it (the spans `bench.rows` and `bench.sync`), less the
pipeline kernel's device time, per epoch."""


def read(r):
    a, b = r.traced
    rows = r.spans.get("bench.rows", [])[a:b]
    sync = r.spans.get("bench.sync", [])[a:b]
    n = r.launches("pipeline_kernel")
    if not rows or len(rows) != len(sync) or n != len(rows):
        return None
    host = sum(rows) + sum(sync)
    return (host - r.device_seconds("pipeline_kernel")) / n * 1e3
