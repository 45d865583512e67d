#!/usr/bin/env python3
"""Time the placement pipeline kernel of several trees, in turns, on one card.

    python3 pipeline_ab.py TREE [TREE ...]

Each TREE is a directory that holds a `ceph_tpu_torch` package with the
pipeline kernel (`osd/csrc/pipeline.cu`): a checkout, or a `git archive`
of one unpacked (into a gitignored directory such as `ab_trees/`).  In the
order given, a child process per tree imports that tree's package and
times the kernel's launch (`pipeline_cuda`) on these shapes:

- config5_64, config5_512, config5_8192: the first 64, 512 and 8192 PGs
  of BASELINE config 5 (10M PGs / 10k OSDs, hosts of 8 under racks of 16
  hosts, as chip_smoke.py builds it), mode "rows" (map_batch's): a
  micro-batch and serving's bulk sub-block;
- fleet, fleet_ec: a fleet member of chip_smoke.py's FLEET_MAIN (1024
  OSDs, 128 hosts of 8 under 8 racks; its 32768 size-3 PGs and its 8192
  EC 4+2 PGs, `sim.lifetime.build_cluster`), mode "up";
- config2: config 2 (100k PGs / 1024 OSDs), mode "rows" (map_all's);
- config5: all of config 5, mode "up" (map_all_device's).

A timed batch is RUNS[shape] launches back to back behind a sleep kernel
that holds the stream while the host enqueues them, CUDA events around
the launches (the card's time, not the host's gaps), the L2 flushed
before the batch (so the map is cold for its first launch only, as on a
path that maps again and again); the shape's ms is the median over 5
batches of the batch's mean.  Then `map_batch`'s host wall (synchronised,
median of 50) on 64 and 8192 random seeds of config 5, and the host wall
(synchronised, median of 7, the L2 flushed before each) of the entry
points that launch the kernel on all of a pool: config 5's
`map_all_device`, config 2's `map_all`, a ClusterState remap of config 5
(its cached rows dropped) and config 5's `ShardedClusterMapper.map_stats`
on one block.

Each child also reports the group each launch ran with
(`pipeline.group_size`; 1 where the tree has none), each pipeline
instantiation's registers and local bytes (`pipeline.launch_plan`), and
the registers (ptxas) and SASS sha256 (cuobjdump -sass) of the rule
kernel, the diagnostics kernel and the pipeline kernel of one lane a PG
(`pipeline_kernel`, or its template's G = 1 instance).  Every output's
sha256 is printed; the script fails unless every tree gives the same
outputs and the same rule and diagnostics SASS (a change to the pipeline
kernel leaves those two kernels as they were), and says whether the
one-lane pipeline kernels' SASS agree (`pipeline_g1_sass_equal`).

It prints the card's name and power limit, then one JSON line per child
and a last line with each shape's ms by tree, and writes them to
chiprun_out/pipeline_ab.json.  Give the trees as parent, change, change,
parent to see the spread beside the difference.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

CHILD = r"""
import hashlib, json, re, statistics, subprocess, sys, time
from pathlib import Path
import numpy as np
import torch
tree = Path(sys.argv[1])
sys.path.insert(0, str(tree))
from ceph_tpu_torch import build
from ceph_tpu_torch.osd import pipeline
from ceph_tpu_torch.osd.osdmap import build_hierarchical
from ceph_tpu_torch.osd.pipeline import PoolMapper
from ceph_tpu_torch.osd.state import ClusterState
from ceph_tpu_torch.osd.types import PgPool, PoolType
from ceph_tpu_torch.parallel.sharded import ShardedClusterMapper, make_mesh
from ceph_tpu_torch.sim.lifetime import Scenario, build_cluster
assert Path(pipeline.__file__).resolve().is_relative_to(tree.resolve())

RUNS = {"config5_64": 40, "config5_512": 40, "config5_8192": 20,
        "fleet": 20, "fleet_ec": 20, "config2": 10, "config5": 2}
BATCHES = 5
dev = torch.device("cuda")
flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
clock = float(subprocess.run(
    ["nvidia-smi", "--query-gpu=clocks.max.sm",
     "--format=csv,noheader,nounits"], capture_output=True, text=True,
    check=True).stdout.split()[0]) * 1e6


def config(n_pgs, n_osds):
    n_host = n_osds // 8
    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                  pg_num=n_pgs, pgp_num=n_pgs)
    return build_hierarchical(n_host, 8, n_rack=max(1, n_host // 16),
                              pool=pool)


def sha(outs):
    h = hashlib.sha256()
    for t in outs if isinstance(outs, (tuple, list)) else (outs,):
        t = t.cpu().numpy() if isinstance(t, torch.Tensor) else t
        h.update(np.ascontiguousarray(t).tobytes())
    return h.hexdigest()[:16]


def batch_ms(fn, runs):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2 * enqueue_s * clock) + 200_000
    out = []
    for _ in range(BATCHES):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / runs)
    return out


def group_of(n):
    return pipeline.group_size(n) if hasattr(pipeline, "group_size") else 1


c5 = PoolMapper(config(10_000_000, 10_000), 0, device=dev)
c2 = PoolMapper(config(100_000, 1024), 0, device=dev)
fleet = build_cluster(Scenario.parse(
    "hosts=128,osds_per_host=8,racks=8,pgs=32768,ec=4+2,ec_pgs=8192,"
    "seed=3"))
shapes = {"config5_64": (c5, 64, "rows"), "config5_512": (c5, 512, "rows"),
          "config5_8192": (c5, 8192, "rows"),
          "fleet": (PoolMapper(fleet, 0, device=dev), 32768, "up"),
          "fleet_ec": (PoolMapper(fleet, 1, device=dev), 8192, "up"),
          "config2": (c2, 100_000, "rows"),
          "config5": (c5, 10_000_000, "up")}
out = {"tree": str(tree), "shapes": {}}
for name, (pm, n, mode) in shapes.items():
    assert n <= pm.spec.pg_num, name
    ps = torch.arange(n, device=dev)
    fn = lambda pm=pm, ps=ps, mode=mode: pipeline.pipeline_cuda(pm, ps, mode)
    times = batch_ms(fn, RUNS[name])
    out["shapes"][name] = {"pgs": n, "mode": mode, "group": group_of(n),
                           "ms": statistics.median(times),
                           "batch_ms": times, "runs": RUNS[name],
                           "sha256": sha(fn())}
out["map_batch"] = {}
for n in (64, 8192):
    seeds = np.random.default_rng(12).integers(
        0, c5.spec.pg_num, n).astype(np.uint32)
    rows = c5.map_batch(seeds)
    walls = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c5.map_batch(seeds)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["map_batch"][str(n)] = {
        "lanes": n, "group": group_of(n),
        "wall_ms": statistics.median(walls),
        "sha256": hashlib.sha256(b"".join(
            np.ascontiguousarray(r).tobytes() for r in rows)).hexdigest()[:16]}
st = ClusterState(c5.m, device=dev)


def remap():
    st._base.clear()
    return st._remap(0)[0]


scm = ShardedClusterMapper(c5.m, 0, make_mesh(1))
entries = {"config5_map_all_device": c5.map_all_device,
           "config2_map_all": c2.map_all,
           "config5_state_remap": remap,
           "config5_map_stats": lambda: scm.map_stats()["up"]}
out["entry"] = {}
for name, fn in entries.items():
    got = fn()
    walls = []
    for _ in range(7):
        flush.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["entry"][name] = {"wall_ms": statistics.median(walls),
                          "walls_ms": walls, "sha256": sha(got)}
groups = getattr(pipeline, "GROUPS", (1,))
out["pipeline_plans"] = {
    g: {k: v for k, v in vars(
        pipeline.launch_plan(0, g) if g > 1 else pipeline.launch_plan(0)
    ).items() if k in ("registers", "local_bytes", "threads",
                       "blocks_per_sm")} for g in groups}
insn = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?);")
cuobjdump = str(Path(build.nvcc()).parent / "cuobjdump")
# the pipeline kernel of one lane a PG: pipeline_kernel, or its template's
# G = 1 instance (mangled pipeline_kernelILi1E...)
for src, kernel in (("crush/csrc/crush_rule.cu", "crush_rule_kernel"),
                    ("crush/csrc/crush_rule_diag.cu", "crush_rule_diag"),
                    ("osd/csrc/pipeline.cu", r"pipeline_kernel(E|ILi1E)")):
    lib = build.build(src)
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    h = hashlib.sha256()
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        if re.search(kernel, fn.splitlines()[0]):
            for m in insn.finditer(fn):
                h.update(m.group(1).encode() + b"\n")
    out[src] = {"sass_sha256": h.hexdigest()[:16],
                "ptxas": build.ptxas_report(src)}
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
        print("pipeline_ab: no card (nvidia-smi failed)", file=sys.stderr)
        return 1
    card = smi.stdout.strip()
    print(card, flush=True)
    rows = []
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", CHILD, tree], cwd=tree,
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(json.dumps({"tree": tree, "rc": proc.returncode}),
                  flush=True)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        rows.append(row)

    def same(key) -> bool:
        return len({json.dumps(key(r), sort_keys=True) for r in rows}) == 1

    summary = {
        "card": card, "trees": trees,
        "ms": {name: [r["shapes"][name]["ms"] for r in rows]
               for name in rows[0]["shapes"]},
        "group": {name: [r["shapes"][name]["group"] for r in rows]
                  for name in rows[0]["shapes"]},
        "map_batch_wall_ms": {n: [r["map_batch"][n]["wall_ms"]
                                  for r in rows]
                              for n in rows[0]["map_batch"]},
        "entry_wall_ms": {k: [r["entry"][k]["wall_ms"] for r in rows]
                          for k in rows[0]["entry"]},
        "outputs_equal": same(lambda r: [
            {k: v["sha256"] for k, v in r[part].items()}
            for part in ("shapes", "map_batch", "entry")]),
        "rule_and_diag_sass_equal": same(lambda r: [
            r[src]["sass_sha256"] for src in (
                "crush/csrc/crush_rule.cu", "crush/csrc/crush_rule_diag.cu")]),
        "pipeline_g1_sass_equal": same(
            lambda r: r["osd/csrc/pipeline.cu"]["sass_sha256"]),
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "pipeline_ab.json").write_text(json.dumps(
        {"rows": rows, "summary": summary}, indent=1) + "\n")
    print(json.dumps(summary), flush=True)
    if not summary["outputs_equal"]:
        print("pipeline_ab: the trees' outputs differ", file=sys.stderr)
        return 1
    if not summary["rule_and_diag_sass_equal"]:
        print("pipeline_ab: the rule or diagnostics kernel's SASS differs",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
