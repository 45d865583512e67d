"""pipeline_kernel_ms: device milliseconds of one pipeline kernel launch
(`osd/csrc/pipeline.cu`), from the profiler's trace."""


def read(r):
    n = r.launches("pipeline_kernel")
    return 1e3 * r.device_seconds("pipeline_kernel") / n if n else None
