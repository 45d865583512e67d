#!/usr/bin/env python3
"""Time the device_loop plan kernel of several trees, in turns, on one card.

    python3 upmap_loop_ab.py TREE [TREE ...]

Each TREE is a directory that holds a `ceph_tpu_torch` package with the
plan kernel (`balancer/csrc/upmap_loop.cu`): a checkout, or a `git
archive` of one unpacked.  In the order given, a child process per tree
imports that tree's package, builds BASELINE config 5 (10M PGs / 10k
OSDs, hosts of 8 under racks of 16 hosts, 2 % of the OSDs reweighted to
0.85 by default_rng(5): chip_smoke.py's rebalance map) and config 2
(100k PGs / 1024 OSDs), runs `calc_pg_upmaps(backend="device_loop",
candidate_batch=16, max_deviation=5, max_iter=10)` on the card with the
plan's operands recorded, and times the kernel's launch on those
operands with CUDA events: RUNS launches back to back (the host's
enqueue of one overlaps the card's work on the one before) in each of 5
batches after a warm one, the median of the batches' means.
The same operands are timed again with one candidate a round (`_b1`:
one change a round, so as many rounds as changes).  It prints the
card's name and power limit, then one JSON line per child: the tree,
the ms of each config, the plan's rounds and changes, and the launch
plan (registers, blocks per SM).  Give the trees as parent, change,
change, parent to see the spread beside the difference.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RUNS = 10  # launches back to back in a timed batch (5 batches)

CHILD = r"""
import json, statistics, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from ceph_tpu_torch.balancer import calc_pg_upmaps, upmap
from ceph_tpu_torch.osd.osdmap import build_hierarchical
from ceph_tpu_torch.osd.types import PgPool, PoolType

RUNS = int(sys.argv[2])
BATCHES = 5
assert upmap.__file__.startswith(sys.argv[1]), upmap.__file__


def config(n_pgs, n_osds):
    n_host = n_osds // 8
    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                  pg_num=n_pgs, pgp_num=n_pgs)
    m = build_hierarchical(n_host, 8, n_rack=max(1, n_host // 16), pool=pool)
    rng = np.random.default_rng(5)
    for o in rng.choice(n_osds, max(1, n_osds // 50), replace=False):
        m.osd_weight[int(o)] = int(0x10000 * 0.85)
    return m


out = {"tree": sys.argv[1]}
dev = torch.device("cuda")
for name, shape in (("config5", (10_000_000, 10_000)),
                    ("config2", (100_000, 1024))):
    seen, real = [], upmap.loop_plan

    def spy(*args):
        seen.append(args)
        return real(*args)

    upmap.loop_plan = spy
    calc_pg_upmaps(config(*shape), max_deviation=5, max_iter=10,
                   rng=np.random.default_rng(100), device=dev,
                   backend="device_loop", candidate_batch=16)
    upmap.loop_plan = real
    (args,) = seen
    # the plan as run (16 candidates a round), then the same operands with
    # one candidate a round (one change a round: a round's fixed part)
    for key, a in ((name, args), (f"{name}_b1", args[:10] + (1,) + args[11:])):
        plan = upmap._loop_kernel(*a)
        upmap.upmap_loop_cuda(*a)
        times = []
        for _ in range(BATCHES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(RUNS):
                upmap.upmap_loop_cuda(*a)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / RUNS)
        out[key] = {"ms": statistics.median(times), "batch_ms": times,
                    "rounds": int(plan[6]), "changes": len(plan[0])}
out["launch_plan"] = vars(upmap.loop_launch_plan(torch.cuda.current_device()))
print(json.dumps(out), flush=True)
"""


def main() -> int:
    trees = [str(Path(t).resolve()) for t in sys.argv[1:]]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        print("upmap_loop_ab: no card (nvidia-smi failed)", file=sys.stderr)
        return 1
    print(smi.stdout.strip(), flush=True)
    for tree in trees:
        rc = subprocess.run([sys.executable, "-c", CHILD, tree, str(RUNS)],
                            cwd=tree).returncode
        if rc != 0:
            print(json.dumps({"tree": tree, "rc": rc}), flush=True)
            return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
