#!/usr/bin/env python3
"""Time the placement diagnostics of several trees, in turns, on one card.

    python3 diag_ab.py TREE [TREE ...]

Each TREE is a directory that holds a `ceph_tpu_torch` package: a
checkout, or a `git archive` of one unpacked (into a gitignored directory
such as `ab_trees/`).  In the order given, a child process per tree
imports that tree's package and times, on config 5 (10M PGs / 10k
OSDs, hosts of 8 under racks of 16 hosts, as chip_smoke.py builds it):

- kernels (batches of launches behind a sleep kernel that holds the
  stream while the host enqueues them, CUDA events around the launches,
  the L2 flushed before each batch; the median over 5 batches of a
  batch's mean):
  - planes_c5, planes_64, planes_8192: the diagnostics kernel in planes
    mode (`crush_rule_diag_cuda`) on the placement seeds of all of config
    5's PGs and of its first 64 and 8192;
  - summary_c5: the kernel in summary mode as diagnose() launches it on
    all of config 5 (`crush_rule_diag_summary_cuda` on the PGs as a
    range, the placement seed in the lane), where the tree has it;
  - sample_512: the diagnostics launch diagnose(sample) makes on 512
    sampled PGs (summary mode on their PG seeds, or planes mode on their
    placement seeds in a tree without a summary mode);
  - pipeline_c5: the pipeline kernel (mode up) on all of config 5, the
    same PGs;
- entry points (host wall, synchronised, median of 7, the L2 flushed
  before each): config 5's `PoolMapper.diagnose()`, `diagnose(sample)`
  on the 512 PGs, and `explain.device_choose_tries` (`crushtool --test
  --show-choose-tries`'s histogram) on x 0..2^20-1.

Each child also reports every diagnostics launch's group
(`mapper.diag_group_size`, 1 where the tree has none), ptxas's report of
the three placement sources, and the SASS sha256 (cuobjdump -sass) of the
rule kernel and of the pipeline kernel (every group's instance).  The
script fails unless every tree gives the same outputs (the diagnose
summaries, the planes, the histogram) and the same rule kernel SASS, and
says whether the pipeline kernels' SASS agree (`pipeline_sass_equal`).

It prints the card's name and power limit, then one JSON line per child
and a last line with each measurement by tree, and writes them to
chiprun_out/diag_ab.json.  Give the trees as parent, change, change,
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
from ceph_tpu_torch.crush import explain, mapper
from ceph_tpu_torch.osd import pipeline
from ceph_tpu_torch.osd.osdmap import build_hierarchical
from ceph_tpu_torch.osd.pipeline import PoolMapper
from ceph_tpu_torch.osd.types import PgPool, PoolType
assert Path(mapper.__file__).resolve().is_relative_to(tree.resolve())

RUNS = {"planes_c5": 2, "summary_c5": 2, "pipeline_c5": 2,
        "planes_64": 40, "planes_8192": 20, "sample_512": 40}
BATCHES = 5
SAMPLE = 512
SHOW_X = 1 << 20
dev = torch.device("cuda")
flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
clock = float(subprocess.run(
    ["nvidia-smi", "--query-gpu=clocks.max.sm",
     "--format=csv,noheader,nounits"], capture_output=True, text=True,
    check=True).stdout.split()[0]) * 1e6
summary_mode = hasattr(mapper, "crush_rule_diag_summary_cuda")


def sha(outs):
    h = hashlib.sha256()
    for t in outs if isinstance(outs, (tuple, list)) else (outs,):
        if isinstance(t, dict):
            for k in sorted(t):
                h.update(k.encode())
                h.update(np.ascontiguousarray(t[k].cpu().numpy()).tobytes())
            continue
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


def wall_ms(fn, runs=7):
    fn()
    walls = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def group_of(n, mode="planes"):
    if hasattr(mapper, "diag_group_size"):
        return mapper.diag_group_size(n, mode)
    return 1


n_pgs, n_osds = 10_000_000, 10_000
pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
              pg_num=n_pgs, pgp_num=n_pgs)
pm = PoolMapper(build_hierarchical(n_osds // 8, 8,
                                   n_rack=n_osds // 8 // 16, pool=pool),
                0, device=dev)
T, prog = pm.tables, pm.prog
ps = torch.arange(n_pgs, device=dev)
x = mapper.u32_bits(pm.placement_seeds(ps))
w = mapper.u32_bits(pm.rule_weights())
rng = np.random.default_rng(9)
sample = np.sort(rng.choice(n_pgs, SAMPLE, replace=False))
sample_ps = torch.from_numpy(sample).to(dev)
sample_x = mapper.u32_bits(pm.placement_seeds(sample_ps))
bound = min(prog.diag_tries_bound, 63)

kernels = {
    "planes_c5": (lambda: mapper.crush_rule_diag_cuda(T, prog, x, w),
                  n_pgs, "planes"),
    "planes_64": (lambda: mapper.crush_rule_diag_cuda(T, prog, x[:64], w),
                  64, "planes"),
    "planes_8192": (lambda: mapper.crush_rule_diag_cuda(
        T, prog, x[:8192], w), 8192, "planes"),
    "pipeline_c5": (lambda: pipeline.pipeline_cuda(pm, ps, "up"), n_pgs,
                    None),
}
if summary_mode:
    kernels["summary_c5"] = (
        lambda: mapper.crush_rule_diag_summary_cuda(
            T, prog, range(n_pgs), w, bound, pm.pool_seeds()),
        n_pgs, "summary")
    kernels["sample_512"] = (
        lambda: mapper.crush_rule_diag_summary_cuda(
            T, prog, sample_ps, w, bound, pm.pool_seeds()),
        SAMPLE, "summary")
else:
    kernels["sample_512"] = (
        lambda: mapper.crush_rule_diag_cuda(T, prog, sample_x, w), SAMPLE,
        "planes")
out = {"tree": str(tree), "summary_mode": summary_mode, "kernels": {},
       "entry": {}}
for name, (fn, n, mode) in kernels.items():
    times = batch_ms(fn, RUNS[name])
    got = fn()
    out["kernels"][name] = {
        "pgs": n, "mode": mode,
        "group": group_of(n, mode) if mode else None,
        "ms": statistics.median(times), "batch_ms": times,
        "runs": RUNS[name],
        # the planes launches' outputs are every tree's (the sample's
        # launch is a summary where the tree has one)
        "sha256": sha(got) if name.startswith("planes_") else None}
xs = np.arange(SHOW_X, dtype=np.int64)
weights = [0x10000] * pm.m.crush.max_devices
entries = {
    "diagnose_c5": lambda: pm.diagnose(record=False),
    "diagnose_sample": lambda: pm.diagnose(sample, record=False),
    "show_choose_tries": lambda: explain.device_choose_tries(
        pm.arrays, pm.spec.ruleno, 3, xs, weights,
        pm.m.crush.tunables.choose_total_tries + 1, dev)[0],
}
for name, fn in entries.items():
    got = fn()
    walls = wall_ms(fn)
    out["entry"][name] = {
        "wall_ms": statistics.median(walls), "walls_ms": walls,
        "sha256": hashlib.sha256(json.dumps(
            got if isinstance(got, dict) else np.asarray(got).tolist(),
            sort_keys=True).encode()).hexdigest()[:16]}
insn = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?);")
cuobjdump = str(Path(build.nvcc()).parent / "cuobjdump")
for src, kernel in (("crush/csrc/crush_rule.cu", "crush_rule_kernel"),
                    ("crush/csrc/crush_rule_diag.cu", None),
                    ("osd/csrc/pipeline.cu", "pipeline_kernel")):
    lib = build.build(src)
    entry = {"ptxas": build.ptxas_report(src)}
    if kernel:
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        h = hashlib.sha256()
        for fn in re.split(r"\n\s*Function : ", sass)[1:]:
            if re.search(kernel, fn.splitlines()[0]):
                for m in insn.finditer(fn):
                    h.update(m.group(1).encode() + b"\n")
        entry["sass_sha256"] = h.hexdigest()[:16]
    out[src] = entry
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
        print("diag_ab: no card (nvidia-smi failed)", file=sys.stderr)
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

    names = sorted({k for r in rows for k in r["kernels"]})
    summary = {
        "card": card, "trees": trees,
        "ms": {k: [r["kernels"].get(k, {}).get("ms") for r in rows]
               for k in names},
        "group": {k: [r["kernels"].get(k, {}).get("group") for r in rows]
                  for k in names},
        "entry_wall_ms": {k: [r["entry"][k]["wall_ms"] for r in rows]
                          for k in rows[0]["entry"]},
        "outputs_equal": same(lambda r: [
            {k: v["sha256"] for k, v in r["kernels"].items()
             if v["sha256"]},
            {k: v["sha256"] for k, v in r["entry"].items()}]),
        "rule_sass_equal": same(
            lambda r: r["crush/csrc/crush_rule.cu"]["sass_sha256"]),
        "pipeline_sass_equal": same(
            lambda r: r["osd/csrc/pipeline.cu"]["sass_sha256"]),
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "diag_ab.json").write_text(json.dumps(
        {"rows": rows, "summary": summary}, indent=1) + "\n")
    print(json.dumps(summary), flush=True)
    if not summary["outputs_equal"]:
        print("diag_ab: the trees' outputs differ", file=sys.stderr)
        return 1
    if not summary["rule_sass_equal"]:
        print("diag_ab: the rule kernel's SASS differs", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
