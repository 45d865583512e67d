"""psim — toy placement simulator (reference src/tools/psim.cc:1-117):
build a simple map, map a grid of objects across pools, histogram the
placements, print per-OSD counts.

The port of `ceph_tpu/cli/psim.py`, with its stdout:

    python -m ceph_tpu_torch.cli.psim [n_osd] [--device DEV]

Every pool maps through `PoolMapper` on the card (the rule kernel)
unless `--device cpu` is given.
"""

from __future__ import annotations

import sys

import numpy as np

from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.osd.osdmap import build_simple
from ceph_tpu_torch.osd.pipeline import PoolMapper


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    n_osd = int(args[0]) if args else 40
    m = build_simple(n_osd, pg_bits=4, pgp_bits=4)
    count = np.zeros(m.max_osd, np.int64)
    first = np.zeros(m.max_osd, np.int64)
    for pid in sorted(m.pools):
        up, upp, acting, actp = PoolMapper(m, pid, device=device).map_all()
        for row in acting:
            osds = [o for o in row if o != ITEM_NONE]
            for o in osds:
                count[o] += 1
            if osds:
                first[osds[0]] += 1
    for i in range(m.max_osd):
        print(f"osd.{i}\t{count[i]}\t{first[i]}")
    print(f"avg {count.mean():.2f} stddev {count.std():.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
