#!/usr/bin/env python3
"""Time the device_loop plan kernel of several trees, in turns, on one card.

    python3 upmap_loop_ab.py TREE [TREE ...]

Each TREE is a directory that holds a `ceph_tpu_torch` package with the
plan kernel (`balancer/csrc/upmap_loop.cu`): a checkout, or a `git
archive` of one unpacked.  In the order given, a child process per tree
imports that tree's package, builds the plans' operands and times the
kernel's launch on them with CUDA events: RUNS launches back to back
(the host's enqueue of one overlaps the card's work on the one before)
in each of 5 batches after a warm one, the median of the batches' means.

The plans, each run by `calc_pg_upmaps(backend="device_loop",
candidate_batch=16, max_deviation=5)` on the card with its operands
recorded:
- config5: BASELINE config 5 (10M PGs / 10k OSDs, hosts of 8 under racks
  of 16 hosts, 2 % of the OSDs reweighted to 0.85 by default_rng(5):
  chip_smoke.py's rebalance map), max_iter 10;
- config2: config 2 (100k PGs / 1024 OSDs) built the same way;
- fleet, fleet_ec: a fleet member of chip_smoke.py's FLEET_MAIN (1024
  OSDs, 128 hosts of 8 under 8 racks; 32768 size-3 PGs and 8192 EC 4+2
  PGs, `sim.lifetime.build_cluster`), one plan per pool as the mgr
  balancer runs it (`only_pools`, max_iter 8, upmap_max_optimizations).
Each is timed as run (16 candidates a round) and with one candidate a
round (`_b1`: one change a round, so as many rounds as changes).  Every
kernel plan is held, output for output, to the plain version
`_loop_plan` on the same operands, and each plan's digest is printed;
the script fails if a tree's kernel differs from its plain version or
two trees' plans differ.  Last, the "device" backend's candidate
scoring (`_score_math`, torch ops) on config 2's first batch of 16 is
timed alone, beside the bytes it must move (counts, targets and weights
of every OSD and the candidates' slots read once, a delta written for
each) over 3.35 TB/s.

It prints the card's name and power limit, then one JSON line per child:
the tree, each plan's ms, rounds, changes and digest, the scoring's ms
and bound, and the launch plan (registers, blocks per SM).  Give the
trees as parent, change, change, parent to see the spread beside the
difference.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RUNS = 10  # launches back to back in a timed batch (5 batches)

CHILD = r"""
import hashlib, json, statistics, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from ceph_tpu_torch.balancer import calc_pg_upmaps, upmap
from ceph_tpu_torch.osd.osdmap import build_hierarchical
from ceph_tpu_torch.osd.types import PgPool, PoolType
from ceph_tpu_torch.sim.lifetime import Scenario, build_cluster

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


def fleet_member():
    return build_cluster(Scenario.parse(
        "hosts=128,osds_per_host=8,racks=8,pgs=32768,ec=4+2,ec_pgs=8192,"
        "seed=3"))


def digest(out):
    cpg, cfrm, cto, crnd, crows, n_rej, rounds, counts = out
    data = [[int(x) for x in np.asarray(a).reshape(-1)]
            for a in (cpg, cfrm, cto, crnd, crows, counts)]
    return hashlib.sha256(json.dumps(
        [data, int(n_rej), int(rounds)]).encode()).hexdigest()[:16]


out = {"tree": sys.argv[1], "equal": True}
dev = torch.device("cuda")
fleet = fleet_member()
plans = (("config5", lambda: config(10_000_000, 10_000), 10, None),
         ("config2", lambda: config(100_000, 1024), 10, None),
         ("fleet", lambda: fleet, 8, {0}),
         ("fleet_ec", lambda: fleet, 8, {1}))
for name, make, max_iter, pools in plans:
    seen, real = [], upmap.loop_plan

    def spy(*args):
        seen.append(args)
        return real(*args)

    upmap.loop_plan = spy
    calc_pg_upmaps(make(), max_deviation=5, max_iter=max_iter,
                   only_pools=pools, rng=np.random.default_rng(100),
                   device=dev, backend="device_loop", candidate_batch=16)
    upmap.loop_plan = real
    (args,) = seen
    # the plan as run (16 candidates a round), then the same operands with
    # one candidate a round (one change a round: a round's fixed part)
    for key, a in ((name, args), (f"{name}_b1", args[:10] + (1,) + args[11:])):
        plan = upmap._loop_kernel(*a)
        plain = upmap._loop_plan(*a)
        equal = all(np.array_equal(np.asarray(x), np.asarray(y))
                    for x, y in zip(plan, plain))
        out["equal"] &= equal
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
                    "rounds": int(plan[6]), "changes": len(plan[0]),
                    "pgs": int(a[0].shape[0]), "w": int(a[0].shape[1]),
                    "digest": digest(plan), "equal_plain": equal}
# the "device" backend's candidate scoring (torch ops, `_score_math`) on
# config 2's first batch of 16, timed alone beside the bytes it must move
# (each input read once, the output written once)
calls, score = [], upmap._score_math


def score_spy(xp, *a):
    if xp is torch:
        calls.append(a)
    return score(xp, *a)


upmap._score_math = score_spy
calc_pg_upmaps(config(100_000, 1024), max_deviation=5, max_iter=10,
               rng=np.random.default_rng(100), device=dev, backend="device",
               candidate_batch=16)
upmap._score_math = score
counts, target, inw, osd, sgn, dv = calls[0]
score(torch, *calls[0])
times = []
for _ in range(BATCHES):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(RUNS):
        score(torch, *calls[0])
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / RUNS)
nbytes = 3 * 8 * dv + osd.numel() * 16 + osd.shape[0] * 8
out["score_math"] = {"ms": statistics.median(times), "batch_ms": times,
                     "candidates": int(osd.shape[0]),
                     "slots": int(osd.shape[1]), "osds": int(dv),
                     "bytes": int(nbytes), "bound_ms": nbytes / 3.35e9}
out["launch_plan"] = vars(upmap.loop_launch_plan(torch.cuda.current_device()))
print(json.dumps(out), flush=True)
sys.exit(0 if out["equal"] else 1)
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
    digests = {}
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", CHILD, tree, str(RUNS)],
                              cwd=tree, capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        print(proc.stdout.strip(), flush=True)
        if proc.returncode != 0:
            print(json.dumps({"tree": tree, "rc": proc.returncode}),
                  flush=True)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        digests[tree] = {k: v["digest"] for k, v in row.items()
                         if isinstance(v, dict) and "digest" in v}
    if len({json.dumps(d, sort_keys=True) for d in digests.values()}) > 1:
        print("upmap_loop_ab: the trees' plans differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
