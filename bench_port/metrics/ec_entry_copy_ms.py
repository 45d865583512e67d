"""ec_entry_copy_ms: device milliseconds a call of the work launched
inside the program's `ec.concat` or `ec.stack` span: `encode_batch`'s join
of data and parity, `decode_batch`'s stack of the survivors.  From the
profiler's trace, each device interval joined to its launch call
(`attribution.py`); none where the device work with no launch call is
over 1 % of it."""

from bench_port import attribution


def read(r):
    a = attribution.of(r)
    s = a.device_in({"ec.concat", "ec.stack"}) if a is not None else None
    return 1e3 * s / r.traced_ops if s is not None and r.traced_ops else None
