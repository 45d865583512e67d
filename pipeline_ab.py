#!/usr/bin/env python3
"""Time the placement pipeline kernel against the plain torch-op chain it
replaced, in turns, in one process on one card.

    python3 pipeline_ab.py [--runs N]

Run from the root of the repository on a machine with an NVIDIA H100 and
the CUDA toolkit.  Maps BASELINE configs 2 (100k PGs, 1024 OSDs) and 5
(10M PGs, 10k OSDs) as chip_smoke.py builds them, and times each
measurement in the order plain, kernel, kernel, plain (each a median of
--runs, default 7, the L2 cache flushed before each run):

- the kernels alone (CUDA events) on all of a config's PGs: the pipeline
  kernel (`pipeline_cuda`, in the entry point's mode) against the rule
  kernel (`crush_rule_cuda`) on the same placement seeds, and the plain
  chain (`PoolMapper.pipeline_plain`: the rule kernel and the torch ops
  around it);
- the entry points (host clock around a synchronised call): config 5's
  `map_all_device`, config 2's `map_all`, a ClusterState remap of config 5
  (`ClusterState._remap`, its cached rows dropped), config 5's
  `ShardedClusterMapper.map_stats` on one block and a 8192-lane
  `map_batch` of config 5 (serving's bulk sub-block).  "plain" runs each
  with `PoolMapper._pipeline` sent to the plain chain on the card, as the
  port ran before the pipeline kernel; "kernel" as it runs now.

Every kernel output is checked equal to the plain chain's first.  Prints
the card's name and power limit, one JSON line per measurement and a last
line with all of them; writes the same to chiprun_out/pipeline_ab.json.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from ceph_tpu_torch.crush import mapper  # noqa: E402
from ceph_tpu_torch.osd import pipeline  # noqa: E402
from ceph_tpu_torch.osd.osdmap import build_hierarchical  # noqa: E402
from ceph_tpu_torch.osd.pipeline import PoolMapper  # noqa: E402
from ceph_tpu_torch.osd.state import ClusterState  # noqa: E402
from ceph_tpu_torch.osd.types import PgPool, PoolType  # noqa: E402
from ceph_tpu_torch.parallel.sharded import (  # noqa: E402
    ShardedClusterMapper,
    make_mesh,
)

CONFIGS = {"config2": (100_000, 1024), "config5": (10_000_000, 10_000)}
OSD_PER_HOST = 8
SUB_BLOCK = 8192  # serving's bulk sub-block (chip_smoke.py, serve_main)
MiB = 1 << 20


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def bench_map(n_pgs: int, n_osds: int):
    """chip_smoke.py's bench_map: hosts of 8 OSDs, racks of 16 hosts, one
    replicated size-3 pool."""
    n_host = max(1, n_osds // OSD_PER_HOST)
    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                  pg_num=n_pgs, pgp_num=n_pgs)
    return build_hierarchical(n_host, OSD_PER_HOST,
                              n_rack=max(1, n_host // 16), pool=pool)


@contextlib.contextmanager
def plain_chain():
    """PoolMapper's stages as the port ran them before the pipeline
    kernel: the plain chain on the card, its rows cast to int32."""
    real = PoolMapper._pipeline

    def plain(self, ps, mode):
        return tuple(t.to(torch.int32)
                     for t in self.pipeline_plain(ps, mode))

    PoolMapper._pipeline = plain
    try:
        yield
    finally:
        PoolMapper._pipeline = real


def event_ms(fn, flush, runs: int) -> float:
    """Median CUDA-event ms of fn(), the L2 flushed before each run."""
    fn()
    out = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def wall_ms(fn, flush, runs: int) -> float:
    """Median host-clock ms of fn() to its end on the card."""
    fn()
    out = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def turns(timer, plain_fn, kernel_fn, flush, runs: int) -> dict:
    """plain, kernel, kernel, plain."""
    order = (("plain", plain_fn), ("kernel", kernel_fn),
             ("kernel", kernel_fn), ("plain", plain_fn))
    out = {"plain": [], "kernel": []}
    for label, fn in order:
        out[label].append(timer(fn, flush, runs))
    return out


def same(a, b, what: str) -> None:
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    ok = len(a) == len(b) and all(
        torch.equal(torch.as_tensor(x).long().cpu(),
                    torch.as_tensor(y).long().cpu()) for x, y in zip(a, b))
    if not ok:
        raise RuntimeError(f"{what}: the kernel's rows differ from the "
                           "plain chain's")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pipeline_ab: no CUDA device", file=sys.stderr)
        return 1
    card = smi()
    print(card, flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    runs = args.runs
    rows = []

    def record(name, res, **extra):
        row = {"measure": name, "card": card, "runs": runs, **extra,
               **res}
        row["plain_median"] = statistics.median(res["plain"])
        row["kernel_median"] = statistics.median(res["kernel"])
        row["speedup"] = row["plain_median"] / row["kernel_median"]
        print(json.dumps(row), flush=True)
        rows.append(row)

    pms = {k: PoolMapper(bench_map(*v), 0, device=dev)
           for k, v in CONFIGS.items()}
    for name, pm in pms.items():
        n = pm.spec.pg_num
        mode = "up" if name == "config5" else "rows"
        ps = torch.arange(n, device=dev)
        same(pipeline.pipeline_cuda(pm, ps, mode),
             pm.pipeline_plain(ps, mode), f"{name} {mode}")
        x = mapper.u32_bits(pm.placement_seeds(ps))
        w = mapper.u32_bits(pm.rule_weights())
        rule_ms = [event_ms(lambda: mapper.crush_rule_cuda(
            pm.tables, pm.prog, x, w), flush, runs)]
        res = turns(event_ms, lambda: pm.pipeline_plain(ps, mode),
                    lambda: pipeline.pipeline_cuda(pm, ps, mode), flush,
                    runs)
        rule_ms.append(event_ms(lambda: mapper.crush_rule_cuda(
            pm.tables, pm.prog, x, w), flush, runs))
        record(f"{name}_kernels", res, pgs=n, mode=mode, unit="ms (CUDA "
               "events)", rule_kernel_ms=rule_ms,
               kernel_over_rule=statistics.median(res["kernel"])
               / statistics.median(rule_ms),
               mappings_per_s=n / (statistics.median(res["kernel"]) * 1e-3))

    pm5, pm2 = pms["config5"], pms["config2"]
    entries = {
        "config5_map_all_device": (pm5.map_all_device, 10_000_000),
        "config2_map_all": (pm2.map_all, 100_000),
    }
    st = ClusterState(pm5.m, device=dev)

    def remap():
        st._base.clear()
        return st._remap(0)[0]

    scm = ShardedClusterMapper(pm5.m, 0, make_mesh(1))
    seeds = np.random.default_rng(12).integers(
        0, pm5.spec.pg_num, SUB_BLOCK).astype(np.uint32)
    entries.update({
        "config5_state_remap": (remap, 10_000_000),
        "config5_map_stats": (lambda: scm.map_stats()["up"], 10_000_000),
        "config5_sub_block_map_batch": (lambda: pm5.map_batch(seeds),
                                        SUB_BLOCK),
    })
    for name, (fn, n) in entries.items():
        got = fn()
        with plain_chain():
            want = fn()
        same(got, want, name)

        def plain(fn=fn):
            with plain_chain():
                return fn()

        res = turns(wall_ms, plain, fn, flush, runs)
        record(name, res, pgs=n, unit="ms (host clock, synchronised)",
               mappings_per_s=n / (statistics.median(res["kernel"]) * 1e-3),
               plain_mappings_per_s=n / (statistics.median(res["plain"])
                                         * 1e-3))
    summary = {"card": card, "measures": {
        r["measure"]: {"plain": r["plain"], "kernel": r["kernel"],
                       "speedup": r["speedup"]} for r in rows}}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "pipeline_ab.json").write_text(json.dumps(
        {"rows": rows, "summary": summary}, indent=1) + "\n")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
