#!/usr/bin/env python3
"""Where a device_loop plan's time goes on the card, stage by stage.

    python3 upmap_loop_stages.py [config5] [config2] [fleet]

Builds an instrumented copy of the plan kernel (`balancer/csrc/upmap_loop
.cu` and `.cuh` of this checkout, into `ceph_tpu_torch/build/stages/`):
thread 0 of a block writes the card's global timer and its block into a
log at each stage boundary of `run_plan`, at the steps of the last
block's section (`resolve`, `apply_round`).  The marks go in by matching
lines of the sources; should a line be gone, the script says which and
stops.  For each plan (as `upmap_loop_ab.py` builds it: config 5,
config 2, a FLEET_MAIN member's replicated pool) and 16 candidates a
round, then one, it launches the instrumented kernel once warm and once
logged, checks the outputs against the plain version, and prints one
JSON line: the plan's µs from the first mark to the last, and each
round's stages in µs: stage (a) (the slowest block: phase (a), or the
pools' target prefixes where kept), the top-B (block 0, beside it), the
shortlists (the slowest block), the last
block's section with its steps (loading the group, the resolve, the
overlay slots, the apply, the moved lanes of the sum, the sum), and the
start and the finish.  The marks cost a little themselves; the plain
kernel's ms is printed beside (CUDA events, as `upmap_loop_ab.py`).
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ceph_tpu_torch import build  # noqa: E402
from ceph_tpu_torch.balancer import calc_pg_upmaps, upmap  # noqa: E402
from ceph_tpu_torch.osd.osdmap import build_hierarchical  # noqa: E402
from ceph_tpu_torch.osd.types import PgPool, PoolType  # noqa: E402
from ceph_tpu_torch.sim.lifetime import Scenario, build_cluster  # noqa: E402

CSRC = ROOT / "ceph_tpu_torch" / "balancer" / "csrc"
OUT = ROOT / "ceph_tpu_torch" / "build" / "stages"
LOG = 65536  # marks a launch keeps

MARK = """
__device__ unsigned long long stage_log[2 * 65536];
__device__ unsigned stage_n;
#ifdef __CUDA_ARCH__
__device__ inline void stage_mark(int i) {
    if (threadIdx.x == 0) {
        unsigned long long t;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        const unsigned k = atomicAdd(&stage_n, 1u);
        if (k < 65536) {
            stage_log[2 * k] = (unsigned long long)i | ((unsigned long long)blockIdx.x << 8);
            stage_log[2 * k + 1] = t;
        }
    }
}
#else
inline void stage_mark(int) {}
#endif
"""
# (line of the source, the mark put after it); the ids: 0 start, 1 the
# start's grid work, 2 past the start's barrier, 3 top-B done, 4 stage (a)
# (a) done, 5 past its barrier, 6 shortlists done, 7 / 8 a last-block
# section's start / end, 9 past the group's barrier, 10 the end; 20-25
# the steps of the round's section
CUH_MARKS = [
    ("UL_HD void run_plan(Grid& grid, const Plan& p) {\n", 0),
    ("    grid.each([&](auto& b, int blk, int nblk) { start_grid(b, p, blk, nblk); });\n", 1),
    ("    grid.sync([&](auto& b) { start_last(b, p); });\n", 2),
    ("            if (blk == 0) top_b(b, p);\n", 3),
    ("                phase_a(b, p, blk - first, last - first + 1);\n        });\n", 4),
    ("        grid.sync([](auto&) {});\n", 5),
    ("                shortlists(b, p, blk, nblk, g0);\n            });\n", 6),
    ("            grid.sync([&](auto& b) { resolve(b, p, g0); });\n", 9),
    ("    grid.each([&](auto& b, int blk, int nblk) { finish_plan(b, p, blk, nblk); });\n", 10),
    ("                         ldcg(&p.cand[j].n)};\n    b.sync();\n", 20),
    ("            st->n_used = nu0 + nn;\n        }\n    }\n    b.sync();\n", 21),
    ("        st->n_ov = n_ov;\n    }\n    b.sync();\n", 22),
    ("    dlo = b.sum(dlo);\n", 23),
    ("        p.part[l] = lane_sq(l, p.dv, [&](int d) { return ldcg(p.dev + d); });\n    }\n    b.sync();\n", 24),
    ("    const double ss2 = sum_sq_of_lanes(b, p);\n", 25),
]
STEPS = {20: "load_group", 21: "resolve", 22: "overlay_slots",
         23: "apply", 24: "moved_lanes", 25: "sum", 8: "state"}


def instrumented() -> ctypes.CDLL:
    cuh = (CSRC / "upmap_loop.cuh").read_text()
    cu = (CSRC / "upmap_loop.cu").read_text()
    cuh = cuh.replace("namespace upmap_loop {\n", "namespace upmap_loop {\n" + MARK, 1)
    for line, i in CUH_MARKS:
        if cuh.count(line) != 1:
            raise SystemExit(f"upmap_loop_stages: the line {line!r} of "
                             f"upmap_loop.cuh is gone: move mark {i}")
        cuh = cuh.replace(line, line + f"stage_mark({i});\n")
    # the sections' start and end: inside the last block's lambda
    cuh = cuh.replace("grid.sync([&](auto& b) { resolve(b, p, g0); });",
                      "grid.sync([&](auto& b) { stage_mark(7); resolve(b, p, g0); stage_mark(8); });")
    cuh = cuh.replace("grid.sync([&](auto& b) { start_last(b, p); });",
                      "grid.sync([&](auto& b) { stage_mark(7); start_last(b, p); stage_mark(8); });")
    cu = cu.replace('extern "C" {', '''extern "C" {
int stage_read(unsigned long long* out, int* n) {
    unsigned k;
    cudaMemcpyFromSymbol(&k, upmap_loop::stage_n, sizeof(k));
    if (k > 65536) k = 65536;
    *n = (int)k;
    cudaMemcpyFromSymbol(out, upmap_loop::stage_log, 16 * (size_t)k);
    unsigned z = 0;
    cudaMemcpyToSymbol(upmap_loop::stage_n, &z, sizeof(z));
    return (int)cudaGetLastError();
}
''', 1)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "upmap_loop.cuh").write_text(cuh)
    (OUT / "upmap_loop.cu").write_text(cu)
    lib = OUT / "libupmap_loop_stages.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(OUT / "upmap_loop.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"upmap_loop_stages: nvcc failed:\n{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    real = upmap._loop_lib()
    for fn in ("upmap_loop_launch", "upmap_loop_plan",
               "upmap_loop_scratch_bytes", "upmap_loop_error_string"):
        getattr(so, fn).argtypes = getattr(real, fn).argtypes
        getattr(so, fn).restype = getattr(real, fn).restype
    so.stage_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return so


def config(n_pgs, n_osds):
    n_host = n_osds // 8
    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                  pg_num=n_pgs, pgp_num=n_pgs)
    m = build_hierarchical(n_host, 8, n_rack=max(1, n_host // 16), pool=pool)
    rng = np.random.default_rng(5)
    for o in rng.choice(n_osds, max(1, n_osds // 50), replace=False):
        m.osd_weight[int(o)] = int(0x10000 * 0.85)
    return m


PLANS = {
    "config5": (lambda: config(10_000_000, 10_000), 10, None),
    "config2": (lambda: config(100_000, 1024), 10, None),
    "fleet": (lambda: build_cluster(Scenario.parse(
        "hosts=128,osds_per_host=8,racks=8,pgs=32768,ec=4+2,ec_pgs=8192,"
        "seed=3")), 8, {0}),
}


def operands(name):
    make, max_iter, pools = PLANS[name]
    seen, real = [], upmap.loop_plan

    def spy(*args):
        seen.append(args)
        return real(*args)

    upmap.loop_plan = spy
    try:
        calc_pg_upmaps(make(), max_deviation=5, max_iter=max_iter,
                       only_pools=pools, rng=np.random.default_rng(100),
                       device=torch.device("cuda"), backend="device_loop",
                       candidate_batch=16)
    finally:
        upmap.loop_plan = real
    return seen[0]


def stages(marks) -> dict:
    """Each round's stages (µs) from the marks of one launch."""
    ids, blks, ts = marks
    t0 = ts.min()
    us = lambda t: round(float(t - t0) / 1e3, 2)  # noqa: E731
    per = {}  # (mark, block) -> times in order
    for i, b, t in sorted(zip(ids, blks, ts), key=lambda x: x[2]):
        per.setdefault((int(i), int(b)), []).append(int(t))
    nb = int(blks.max()) + 1
    grid = range(1, nb) if nb > 1 else range(nb)

    def last(i, r):  # the slowest block's r-th mark i
        return max(per[(i, b)][r] for b in grid if len(per.get((i, b), [])) > r)

    sections = sorted((t, i) for (i, b), v in per.items() if i in (7, 8)
                      for t in v)
    steps = sorted((t, i) for (i, b), v in per.items()
                   if i >= 20 or i == 8 for t in v)
    rounds = len(per[(4, nb - 1)])
    out = {"blocks": nb, "total_us": us(ts.max()),
           "start_us": us(last(2, 0)), "rounds": []}
    start = last(2, 0)
    for r in range(rounds):
        a = last(4, r)
        row = {"phase_a_us": round((a - start) / 1e3, 2),
               "top_b_us": round((per[(3, 0)][r] - start) / 1e3, 2),
               "barrier_a_us": round((last(5, r) - max(a, per[(3, 0)][r])) / 1e3, 2),
               "shortlists_us": round((last(6, r) - last(5, r)) / 1e3, 2)}
        s7, s8 = sections[2 * (r + 1)][0], sections[2 * (r + 1) + 1][0]
        row["section_us"] = round((s8 - s7) / 1e3, 2)
        prev = s7
        for t, i in steps:
            if s7 < t <= s8:
                row[STEPS[i] + "_us"] = round((t - prev) / 1e3, 2)
                prev = t
        end = last(9, r)
        row["round_us"] = round((end - start) / 1e3, 2)
        out["rounds"].append(row)
        start = end
    out["finish_us"] = round((last(10, 0) - start) / 1e3, 2)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("upmap_loop_stages: no card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    names = sys.argv[1:] or list(PLANS)
    so = instrumented()
    real = upmap._loop_lib()
    buf = (ctypes.c_ulonglong * (2 * LOG))()
    n = ctypes.c_int()
    for name in names:
        args = operands(name)
        for batch in (16, 1):
            a = args[:10] + (batch,) + args[11:]
            plain = upmap._loop_plan(*a)
            upmap._LOOP_LIBS[:] = [real]
            upmap.upmap_loop_cuda(*a)
            times = []
            for _ in range(5):
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
                for _ in range(10):
                    upmap.upmap_loop_cuda(*a)
                e.record()
                e.synchronize()
                times.append(s.elapsed_time(e) / 10)
            upmap._LOOP_LIBS[:] = [so]
            upmap.loop_launch_plan.cache_clear()
            got = upmap._loop_kernel(*a)
            same = all(np.array_equal(np.asarray(x), np.asarray(y))
                       for x, y in zip(got, plain))
            so.stage_read(buf, ctypes.byref(n))
            upmap.upmap_loop_cuda(*a)
            torch.cuda.synchronize()
            so.stage_read(buf, ctypes.byref(n))
            ev = np.frombuffer(buf, dtype=np.uint64)[:2 * n.value].reshape(-1, 2)
            marks = ((ev[:, 0] & 255).astype(int), (ev[:, 0] >> 8).astype(int),
                     ev[:, 1].astype(np.int64))
            row = {"plan": name, "batch": batch, "equal_plain": same,
                   "kernel_ms": statistics.median(times), **stages(marks)}
            upmap._LOOP_LIBS[:] = [real]
            upmap.loop_launch_plan.cache_clear()
            print(json.dumps(row), flush=True)
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
