"""ec_copy_ms: device milliseconds per call of everything but the GF
kernel (the entry point's copies, stacks and fills), from the trace."""


def read(r):
    if not r.traced_ops or not r.launches("gf_matmul_kernel"):
        return None
    other = r.device_seconds() - r.device_seconds("gf_matmul_kernel")
    return 1e3 * other / r.traced_ops
