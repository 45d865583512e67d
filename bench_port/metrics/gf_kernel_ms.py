"""gf_kernel_ms: device milliseconds of one GF(2^8) kernel launch
(`ec/csrc/gf_matmul.cu`), from the profiler's trace."""


def read(r):
    n = r.launches("gf_matmul_kernel")
    return 1e3 * r.device_seconds("gf_matmul_kernel") / n if n else None
