"""ec_entry_idle_ms: milliseconds a call that the card was idle while the
host was inside the program's `ec.encode_batch` or `ec.decode_batch`
span (at any depth): the entries' checks, plan lookup and launches, as
far as the card waits for them.  From the profiler's trace
(`attribution.py`)."""

from bench_port import attribution


def read(r):
    a = attribution.of(r)
    s = (a.idle_in({"ec.encode_batch", "ec.decode_batch"})
         if a is not None else None)
    return 1e3 * s / r.traced_ops if s is not None and r.traced_ops else None
