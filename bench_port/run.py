"""Run one cell of the port's benchmark and print its result line.

    python bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, this folder and
the port (`ceph_tpu_torch`).  It needs the CUDA devices the cell asks
for, and exits with a non-zero code and no result without them.  The
last line of standard output is the result: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), `device`, with --trace 1 `breakdown`, and last
`checks`, each number compared with its limit (also the last lines of
standard error).  Every build and kernel cache stays inside the checkout.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port import harness  # noqa: E402

if __name__ == "__main__":
    harness.checkout_caches()
    sys.exit(harness.main(sys.argv[1:], T0))
