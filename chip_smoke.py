#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ceph_tpu_torch`) on one card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one NVIDIA H100
and the CUDA toolkit.  It builds every kernel from the sources in the
checkout (one nvcc per source, all at once) and prints what ptxas
reports of each, holds each kernel against its plain PyTorch version (the
rule kernel both with the shared-memory staging its wrapper chooses and
with none; the GF kernel on single products and on grouped lists; the
pipeline kernel, `pipeline_vs_plain`, in its three modes against the
plain chain on the card on the placement corpus, the maps of
tests/data/pipeline_kernel_cases.json and configs 2 and 5, and at a
number of lanes that gives each group size G from 1 to 32 on maps with
every overlay, an EC map and config-5-shaped maps of legacy hosts; every
path through PoolMapper counts pipeline launches, crushtool --test the
rule kernel's; `placement_main` prints each timed launch's G, and the
pipeline kernel's time and bound at 64 and 8192 lanes of config 5),
drives the erasure-coding path (the RS corpus profiles,
RS(8,4) encode/decode at full size, the clay, shec and lrc corpus
profiles, BASELINE config 4's Clay(8,4,11) encode (its plan's grouped
launches) and minimum-bandwidth repair of every chunk at a 4 MiB stripe, the benchmark CLI on RS, clay,
shec and lrc, then every plugin through a profile that names no backend,
whose default is the device engine, and the RS CLI lines on that default
beside `backend=numpy`) and the
placement path (the placement corpus, then BASELINE configs 2 and 5
through `PoolMapper`, then the legacy bucket draws on maps of config 5's
shape, then the placement CLIs `crushtool --test` and `osdmaptool
--test-map-pgs` on configs 1, 2 and 5, and `osdmaptool --upmap` on config
2) and the upmap balancer (`calc_pg_upmaps` on config 2 with every
backend, then three device_loop rounds of config 5, the rebalance of
BASELINE.json's north-star workload; each device_loop plan one launch of
the plan kernel and one read back) and the plan kernel against its plain
version on the card (`loop_vs_plain`: every device_loop case of the CPU
tests from tests/data/upmap_loop_corpus.json, whose JAX digests they
must give, config 2 and config 5's three rounds; outputs equal, their
ms, launches and host reads a plan) and the mgr balancer on a
ClusterState (`mgr_balancer`: config 5's eval, upmap plan and execute
and two value-only Incrementals applied in O(delta), each step's rows
held to a fresh state and the host oracle; crush-compat and the
`balancer` CLI on config 2; tests/data/mgr_corpus.json on the card),
then the placement diagnostics (the rule kernel's diagnostics variant
against its plain version on every corpus, legacy and diag case;
`PoolMapper.diagnose` over config 5's 10M PGs with and without a
ClusterState; `crushtool explain` / `--locate-divergence` against the
JAX CLI's stdout and `--test --show-choose-tries` on config 5) and a
`ClusterSim` failure run at config 5 (8 OSDs of a host failed, 2
revived, a reweight, a balance round, each epoch's report held to a
numpy diff and its rows to the host oracle), then the lifetime simulator
(`lifetime_corpus`: every scenario of tests/data/lifetime_corpus.json on
the card, digests and each epoch's launches equal to the corpus, a CLI
run stopped and resumed;
`lifetime_main`: 48 epochs at 10M PGs / 10k OSDs with the workload,
correlated failures and the balancer, after measuring the EC 4+2 encode
GB/s, each epoch's launches, program times and parts, four epochs'
programs held to numpy and 32 seeds a pool an epoch to the host oracle,
then a forced expand and a forced remove epoch, each a ClusterState
rebuild, held to the host oracle), then GF(2^8) products past the old
32 x 64 tiling (`ec_wide`: one launch each against the plain version
and the host-side tiling, RS(70,4) and Clay(2,33,19) against
tests/data/ec_wide.json, the JAX package's bytes) and the fleet
simulator (`fleet_corpus`: the
JAX tests' four-member DIGEST_SPEC, digests equal to
tests/data/fleet_corpus.json and to solo runs, launches and stats lanes
equal to the CPU run's; `fleet_main`: the JAX bench's 16-combination
sweep at 64 members of 1024 OSDs, 16 epochs, stacked and with
CEPH_TPU_FLEET_STACK=0, digests equal to each other and to solo runs,
each run's widest stats call held lane by lane to numpy and the solo
members' rows to the host oracle, each epoch's launches held first at a
small size to the CPU run's rule calls) and the placement service
(`serve_corpus`: tests/test_torch_serve.py's scripts on the card, rows
and sample digests equal to tests/data/serve_corpus.json, the JAX
checkpoint resumed and the port's own, an admission burst shedding
exactly 8;
`serve_main`: at config 5 with bench.py::bench_serve's settings, one
query_block of 2^20 seeds held to map_all_tensors() and the host
oracle, 3 closed-loop clients through the micro-batcher while a
value-only reweight lands every second, 2 bulk clients while an upmap
overlay is adopted mid-window, and a 2-replica front on config 2 with
one replica stalled; every lane answered, from the device), every EC
strategy (`ec_strategies`: xor, xor_cse, bitplane, logexp, pallas and
auto through create_erasure_code(..., strategy=s) on RS(8,4) shapes
(a)-(c), bytes equal to the kernel's, timed beside it, auto's record on
each shape, and the ec_corpus entries under each) and the native host
engines (`native_main`: the g++ builds, NativeMapper on config 5's
seeds on one core and on all, rows equal to the rule kernel's, beside
its mappings/s; crushtool --test --backend native on config 2 equal to
the default backend; backend=native RS(8,4) on 16 MiB equal to the
kernel's bytes; CRC-32C of 1 MiB equal to the Python loop) and the
operator surface (`obs_main`: the daemon CLI's `perf dump` and `metrics`
in two children on the card, each kernel launched and its registry count
equal to its wrapper's, `bytes_encoded` equal to the JAX self-test's; a
child mapping config 2 with `CEPH_TPU_ADMIN_SOCKET` set, queried through
`--sock` while it maps; config 5's `map_all_device` with tracing off and
on, the trace file parsed) and the runtime and mesh slice
(`runtime_main`: the backend ladder acquiring the card through its
watchdogged probe, an armed descent to the CPU in a child, the stage
scheduler killed after its second stage and resumed in children,
config 5 through ShardedClusterMapper unsplit and split in 4 on the
card with three rebalance steps held to the same torch ops on the CPU,
the meshcheck digest against the JAX worker's, and an armed lifetime
and serving device loss, which raise and answer EFAULT on the card),
through the entry points a user calls, and prints one JSON object per
phase.  No phase may book a descent to the host (`fallback_total`):
on the card nothing degrades.  Any failure raises and exits non-zero.

The line before the last is the kernels line (each kernel's launches on
the main path, read from the kernel registry, its time, bound and
plain-version time); the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits with 1 and
prints no result.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import dataclasses
import hashlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ceph_tpu_torch import build, native, obs
from ceph_tpu_torch.balancer import calc_pg_upmaps, state, upmap
from ceph_tpu_torch.balancer.crush_analysis import get_rule_weight_osd_map
from ceph_tpu_torch.cli import balancer as balancer_cli
from ceph_tpu_torch.cli import crushtool, ec_benchmark, osdmaptool
from ceph_tpu_torch.core import reduce
from ceph_tpu_torch.crush import mapper, mapper_ref, soa
from ceph_tpu_torch.crush.codec import encode_crushmap
from ceph_tpu_torch.crush.types import ITEM_NONE, BucketAlg
from ceph_tpu_torch.ec import create_erasure_code, torch_backend
from ceph_tpu_torch.ec.rs import decode_plan
from ceph_tpu_torch.ec.torch_backend import (
    STRATEGIES,
    TorchEngine,
    bit_matrix,
    gf_matmul_cuda,
    gf_matmul_plain,
    BASE1,
    Product,
    ProductList,
    gf_grouped_cuda,
    gf_grouped_plain,
    gf_matmul_tiled,
    matmul_bitplane,
    product_tables,
)
from ceph_tpu_torch.ec.xor_schedule import matrix_key
from ceph_tpu_torch.fleet import FleetSim, parse_fleet
from ceph_tpu_torch.native.mapper import NativeMapper
from ceph_tpu_torch.osd import pipeline

from ceph_tpu_torch.mgr import Balancer, MappingState, synthetic_pg_stats
from ceph_tpu_torch.osd.carry import crush_from_reference, osdmap_from_reference
from ceph_tpu_torch.osd.incremental import Incremental, encode_incremental
from ceph_tpu_torch.osd.io import save_osdmap
from ceph_tpu_torch.osd.osdmap import OSD_UP, OSDMap, build_hierarchical
from ceph_tpu_torch.osd.pipeline import PoolMapper
from ceph_tpu_torch.osd.state import ClusterState, value_copy_map
from ceph_tpu_torch.osd.types import PgId, PgPool, PoolType
from ceph_tpu_torch.recovery import DRAIN_KEYS
from ceph_tpu_torch.recovery import queue as recovery_queue
from ceph_tpu_torch.runtime import faults
from ceph_tpu_torch.serve import PlacementService, ServeConfig
from ceph_tpu_torch.sim import ClusterSim, LifetimeSim
from ceph_tpu_torch.sim import lifetime as sim_lifetime
from ceph_tpu_torch.sim import workload as sim_workload
from ceph_tpu_torch.sim.workload import WL_KEYS
from ceph_tpu_torch.utils import crc32c as crc32c_mod

ROOT = Path(__file__).resolve().parent
CORPUS = ROOT / "tests" / "data" / "ec_corpus.json"
PLACEMENT_CORPUS = ROOT / "tests" / "data" / "placement_corpus.json"
LEGACY_CASES = ROOT / "tests" / "data" / "legacy_rule_cases.json"
CLI_CORPUS = ROOT / "tests" / "data" / "cli_corpus.json"
BALANCER_CORPUS = ROOT / "tests" / "data" / "balancer_corpus.json"
UPMAP_LOOP_CORPUS = ROOT / "tests" / "data" / "upmap_loop_corpus.json"
UPMAP_PLAN_OSDS = 10_000  # config 5's OSDs: the plan kernel's launch plan
LEGACY_MAP = ROOT / "tests" / "data" / "legacy_crushmap.txt"
CLAY_CONFIG4 = ROOT / "tests" / "data" / "clay_config4.json"
RS_ENTRIES = (
    "rs_k8m4_reed_sol_van",
    "rs_k6m2_reed_sol_r6_op",
    "rs_k4m2_cauchy_good",
    "isa_k8m4_reed_sol_van",
)
LAYERED_ENTRIES = ("clay_k4m2_d5", "shec_k4m3_c2", "lrc_k4m2_l3")
# BASELINE config 4, Clay(8, 4, 11): q = 4, t = 3, 64 planes.  An encode
# is 352 engine products (per plane 3 pair decouplings on average in the
# two live columns, one inner-MDS solve, 1.5 pair recouplings in the
# parity column, as in the JAX package), which its plan runs as 3 grouped
# launches (the decouplings, the solves, the recouplings); a
# single-chunk repair 13 (12 pair decouplings, one product-matrix
# solve).  The counts held on the card are the plan's, counted on the CPU
# (`cpu_launches`); an encode may take at most this many.
CLAY4_ENCODE_MAX_LAUNCHES = 16
# peak HBM bandwidth of the one card the port is measured on (NVIDIA's
# H100 SXM5 data sheet); its name as torch reports it
H100_SXM = "NVIDIA H100 80GB HBM3"
H100_SXM_BW = 3.35e12
H100_SMS, SCHEDULERS_PER_SM, WARP = 132, 4, 32  # issue slots per clock
RUNS = 25  # timed runs per measurement (median reported)
MiB = 1 << 20


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rand_u8(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                         device=device)


def peak_bandwidth(name: str) -> tuple[float, str]:
    if name != H100_SXM:
        raise RuntimeError(f"no peak bandwidth known for {name!r}; the "
                           f"bounds are for the {H100_SXM}")
    return H100_SXM_BW, "H100 SXM, 3.35 TB/s"


def registry_launches(kernel) -> int:
    """A kernel's launches as the kernel registry (`obs.executables`)
    holds them (its wrapper's `launches` reads the same record)."""
    return obs.executables.record(kernel.record.name).launches


def counts(group: str) -> dict:
    """The u64 counters of perf group `group`."""
    return {k: v for k, v in obs.group_view(group).items()
            if isinstance(v, int)}


def counted(expected: int, what: str, fn, kernel=gf_matmul_cuda):
    """Run fn() with the kernel's launch count set to 0 just before and
    read just after, from the kernel registry; fail unless it launched
    exactly `expected` times."""
    kernel.launches = 0
    out = fn()
    launches = registry_launches(kernel)
    check(launches == expected,
          f"{what}: {launches} kernel launches, expected {expected}")
    return out, launches


def time_ms(fn, flush: torch.Tensor, runs: int = RUNS,
            warmup: int = 3) -> float:
    """Median device time of fn() in ms, CUDA events around each run, with
    the L2 cache flushed before each (a caller's stripes arrive cold)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def engine_launches():
    """Records the kernel launches the device engine makes, on whatever
    device it runs: yields the list.  A grouped product
    (`TorchEngine.matmul_grouped`) is ("group", ProductList, b0, b1, the
    strategy the list resolved to), one launch when that is `pallas`; any
    other product is ("product", M, data u8[N, S, L], the strategy it
    resolved to), a launch when that is `pallas`.  On CPU tensors each
    runs its plain version."""
    log, run, grouped = [], TorchEngine._run, TorchEngine.matmul_grouped
    inside = [0]

    def _run(self, M, d):
        out = run(self, M, d)
        if not inside[0]:
            log.append(("product", M, d, self._resolved_strategy))
        return out

    def _grouped(self, plist, b0, b1=None):
        log.append(("group", plist, b0, b1,
                    self.list_strategy(plist, b0, b1)))
        inside[0] += 1
        try:
            return grouped(self, plist, b0, b1)
        finally:
            inside[0] -= 1

    TorchEngine._run, TorchEngine.matmul_grouped = _run, _grouped
    try:
        yield log
    finally:
        TorchEngine._run, TorchEngine.matmul_grouped = run, grouped


def launches_of(log) -> int:
    return sum(e[-1] == "pallas" for e in log)


def cpu_launches(fn) -> int:
    """The kernel launches fn() makes on the card, counted on the CPU (the
    plain versions): one per grouped product, one per product resolved to
    `pallas`."""
    with engine_launches() as log:
        fn()
    check(all(e[2].device.type == "cpu" for e in log), "a CPU dry run")
    return launches_of(log)


def device_ms(fn, flush: torch.Tensor, clock_hz: float,
              runs: int = RUNS) -> float:
    """Median device time in ms of the kernels fn() enqueues, back to
    back: a sleep kernel holds the stream for twice fn's enqueue time, so
    the events time the kernels and not the host's gaps between launches
    (the L2 is flushed before each run)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2 * enqueue_s * clock_hz) + 100_000
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, flush: torch.Tensor, runs: int = RUNS) -> float:
    """Median host-clock ms of fn() to its end on the card (synchronised
    before and after), the L2 flushed before each run."""
    fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# -- phase 1: the card --------------------------------------------------------

def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    bw, label = peak_bandwidth(name)
    info = {
        "phase": "device", "nvidia_smi": smi, "name": name,
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "peak_bw": bw, "peak_bw_source": label,
    }
    emit(info)
    return info


# -- phase 2: build -----------------------------------------------------------

def phase_build() -> dict:
    """Every kernel source, one nvcc each, started together; then what
    each kernel is built with: ptxas's registers, stack (local bytes),
    spills and static shared memory, the dynamic shared memory of a
    block (gf_matmul: S / 4 KiB of tables, S = 8 at RS(8,4), a 32 KiB
    ring and 32 KiB of output tiles; crush_rule: the
    crush_ln tables and 16 B per staged record, placement_main prints
    the total), the rule kernel's launch plan (`mapper.launch_plan`), the
    pipeline kernel's (`pipeline.launch_plan`: the rule's body and staging
    with the stages after it; its registers beside the rule kernel's) and
    the plan kernel's (`upmap.loop_launch_plan` at config 5's OSDs: its
    cooperative grid and dynamic shared memory) and each instance of the
    diagnostics kernel (`mapper.diag_launch_plan`: planes and summary at
    every group)."""
    t0 = time.perf_counter()
    libs = build.build_all()
    seconds = time.perf_counter() - t0
    kernels = {}
    for src in libs:
        kernels.update(build.ptxas_report(src))
    plan = vars(mapper.launch_plan(torch.cuda.current_device()))
    pipe_plan = vars(pipeline.launch_plan(torch.cuda.current_device()))
    # each instantiation of the pipeline kernel (a PG per group of G
    # lanes): its registers, local bytes and the occupancy calculator's
    # block (every launch runs group 1's block size)
    group_plans = {
        g: vars(pipeline.launch_plan(torch.cuda.current_device(), g))
        for g in pipeline.GROUPS}
    # the diagnostics kernel's instances: a mode (planes, summary) and a
    # group each, all built from one source
    diag_plans = {
        f"{mode}_g{g}": vars(mapper.diag_launch_plan(
            torch.cuda.current_device(), mode, g))
        for mode in mapper.DIAG_MODES for g in mapper.GROUPS}
    # at config 5's OSDs, with phase (a)'s shared memory of 8 B an OSD
    loop_plan = vars(upmap.loop_launch_plan(torch.cuda.current_device(),
                                            UPMAP_PLAN_OSDS))
    check(loop_plan["cooperative"] == 1 and loop_plan["blocks_per_sm"] >= 1
          and loop_plan["dynamic_smem"] == 8 * UPMAP_PLAN_OSDS,
          f"upmap_loop: a cooperative launch over {UPMAP_PLAN_OSDS} OSDs "
          f"fits the card ({loop_plan})")
    emit({"phase": "build", "seconds": seconds,
          "libraries": {src: str(lib.relative_to(ROOT))
                        for src, lib in libs.items()},
          "kernels": kernels, "crush_rule_plan": plan,
          "pipeline_plan": pipe_plan,
          "pipeline_group_plans": {
              g: {k: p[k] for k in ("registers", "local_bytes", "threads",
                                    "blocks_per_sm")}
              for g, p in group_plans.items()},
          "diag_plans": {
              key: {k: p[k] for k in ("registers", "local_bytes", "threads",
                                      "blocks_per_sm")}
              for key, p in diag_plans.items()},
          # the fused kernel's registers and residency beside the rule
          # kernel's: the stages after the rule must not cost the descent
          # a resident warp
          "registers": {"crush_rule": plan["registers"],
                        "pipeline": pipe_plan["registers"]},
          "resident_threads_per_sm": {
              "crush_rule": plan["threads"] * plan["blocks_per_sm"],
              "pipeline": pipe_plan["threads"]
              * pipe_plan["blocks_per_sm"]},
          "upmap_loop_plan": loop_plan,
          "dynamic_smem_per_block": {
              # 256 bytes of tables per input row of the widest product,
              # the ring (2 stages of 4 rows x 4 KiB) and 2 output tiles
              # (4 rows x 4 KiB)
              "gf_matmul_rs84": 8 * 256 + 2 * 4 * 4096 + 2 * 4 * 4096,
              "crush_rule_tables": plan["table_bytes"],
              "crush_rule_per_staged_record": mapper.RECORD_BYTES}})
    return libs


# -- phase 3: kernel vs plain version -----------------------------------------

def phase_kernel_vs_plain(dev) -> int:
    rng = np.random.default_rng(3)
    cases = []
    worst = 0

    def one(label, M, data):
        nonlocal worst
        tables = torch.from_numpy(product_tables(M).reshape(-1)).to(dev)
        batched = data if data.dim() == 3 else data[None]
        got = gf_matmul_cuda(tables, batched, M.shape[0])
        want = gf_matmul_plain(M, batched)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        worst = max(worst, err)
        cases.append({"case": label, "shape": list(data.shape),
                      "rows": int(M.shape[0]),
                      "equal": bool(torch.equal(got, want))})
        check(torch.equal(got, want), f"kernel == plain at {label}")

    shapes = [(4, 8, 2097152), (2, 8, 2097152), (1, 8, 4097), (4, 8, 1),
              (3, 7, 5000), (5, 8, 8192), (32, 64, 12295)]
    for i, (R, S, L) in enumerate(shapes):
        M = rng.integers(0, 256, (R, S)).astype(np.uint8)
        one(f"R{R}_S{S}_L{L}", M, rand_u8((S, L), 100 + i, dev))
    M = rng.integers(0, 256, (4, 8)).astype(np.uint8)
    buf = rand_u8((8 * 65536 + 3,), 200, dev)
    unaligned = buf[3:].view(8, 65536)  # contiguous, data_ptr % 16 == 3
    check(unaligned.data_ptr() % 16 == 3, "unaligned view")
    one("unaligned_offset3", M, unaligned)
    one("strided_view", M, rand_u8((8, 65539), 201, dev)[:, 3:])
    for R in (4, 2):
        M = rng.integers(0, 256, (R, 8)).astype(np.uint8)
        one(f"batched_R{R}", M, rand_u8((8192, 8, 4096), 300 + R, dev))

    # grouped launches (gf_grouped_cuda) == the grouped plain version on
    # the same buffers
    def grouped(label, products, b0, b1):
        nonlocal worst
        plist = ProductList(products)
        want0, want1 = b0.clone(), b1.clone()
        gf_grouped_plain(plist, want0, want1)
        gf_grouped_cuda(plist, b0, b1)
        torch.cuda.synchronize()
        err = max(int((b0.int() - want0.int()).abs().max()),
                  int((b1.int() - want1.int()).abs().max()))
        worst = max(worst, err)
        equal = torch.equal(b0, want0) and torch.equal(b1, want1)
        cases.append({"case": label, "products": len(plist.products),
                      "items": plist.items, "equal": equal})
        check(equal, f"grouped kernel == plain at {label}")

    def products(shapes, b0_size, align):
        """Products of shapes (R, S, L): inputs anywhere in b0 (at
        multiples of `align`), outputs one after another in b1."""
        out, at = [], 0
        for R, S, L in shapes:
            ins = rng.integers(0, (b0_size - L) // align, S) * align
            outs = [BASE1 | (at + r * (L + align)) for r in range(R)]
            at += R * (L + align)
            out.append(Product(rng.integers(0, 256, (R, S), np.uint8),
                               tuple(int(v) for v in ins), tuple(outs), L))
        return out, at

    mixed = [(4, 8, 8192), (1, 2, 8192), (2, 2, 8192), (4, 8, 1),
             (6, 5, 12345), (1, 1, 4096), (32, 64, 700), (33, 3, 5000),
             (4, 70, 4100), (2, 256, 513)]
    for align in (16, 1):
        plist, size = products(mixed, 1 << 20, align)
        grouped(f"grouped_mixed_align{align}", plist,
                rand_u8((1 << 20,), 400 + align, dev),
                rand_u8((size,), 401 + align, dev))
    # wide M: 130 and 70 input rows walked in slabs, 40 output rows in
    # groups, each one product
    plist, size = products([(40, 130, 65536), (4, 70, 4096)], 16 << 20, 16)
    grouped("grouped_wide", plist, rand_u8((16 << 20,), 410, dev),
            rand_u8((size,), 411, dev))
    # Clay's pair transforms: hundreds of 2-row products of 8 KiB
    plist, size = products([(1 + i % 2, 2, 8192) for i in range(384)],
                           8 << 20, 8192)
    grouped("grouped_clay_pairs", plist, rand_u8((8 << 20,), 420, dev),
            rand_u8((size,), 421, dev))
    # both buffers unaligned views: every row at an odd address
    plist, size = products(mixed, 1 << 20, 16)
    buf0, buf1 = rand_u8((3 + (1 << 20),), 430, dev), rand_u8((size + 5,),
                                                             431, dev)
    check(buf0[3:].data_ptr() % 16 == 3, "unaligned buffer")
    grouped("grouped_unaligned_bases", plist, buf0[3:], buf1[5:])
    emit({"phase": "kernel_vs_plain", "cases": cases, "max_abs_err": worst})
    return worst


# -- phase 4: corpus ----------------------------------------------------------

def _data_for(name: str, k: int, length: int) -> np.ndarray:
    """tools/ec_corpus.py::_data_for: the corpus inputs, seeded by name."""
    seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:8], "big")
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(k, length), dtype=np.uint8)


def _digest(rows) -> str:
    h = hashlib.sha256()
    for row in rows:
        h.update(row.cpu().numpy().tobytes())
    return h.hexdigest()


def phase_corpus(dev) -> int:
    """The four RS corpus entries through the entry points; returns the
    kernel's launches, one per encode and one per decode case."""
    entries = {e["name"]: e
               for e in json.loads(CORPUS.read_text())["entries"]}
    cases = [(name, case) for name in RS_ENTRIES
             for case in entries[name]["decode"]]
    codes = {name: create_erasure_code(dict(entries[name]["profile"],
                                            backend="torch"), device="cuda")
             for name in RS_ENTRIES}

    def drive():
        for name in RS_ENTRIES:
            entry, code = entries[name], codes[name]
            L = entry["chunk_bytes"]
            data = torch.from_numpy(_data_for(name, code.k, L)).to(dev)
            enc = code.encode_chunks(data)
            check(_digest(enc) == entry["digest"], f"{name} stripe digest")
            n = entry["n_chunks"]
            for case in entry["decode"]:
                erased = list(case["erased"])
                avail = {i: enc[i] for i in range(n) if i not in erased}
                dec = code.decode_chunks(set(erased), avail, L)
                check(_digest(dec[i] for i in erased) == case["digest"],
                      f"{name} decode {erased} digest")

    _, launches = counted(len(RS_ENTRIES) + len(cases), "corpus", drive)
    emit({"phase": "corpus", "entries": list(RS_ENTRIES),
          "decode_cases": len(cases), "digests_equal": True,
          "launches": launches})
    return launches


# -- phase 5: the main path at full size --------------------------------------

def _measure(label, kernel_fn, entry_fn, plain_fn, nbytes, peak, dev,
             flush, launches) -> dict:
    kernel_ms = time_ms(kernel_fn, flush)
    entry_ms = time_ms(entry_fn, flush)
    plain_ms = time_ms(plain_fn, flush)
    # a copy that moves the same HBM bytes (reads half, writes half)
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), flush)
    del src, dst
    bound_ms = nbytes / peak * 1e3
    out = {
        "shape": label, "launches": launches, "hbm_bytes": nbytes,
        "ms": kernel_ms, "entry_ms": entry_ms, "plain_ms": plain_ms,
        "copy_ms": copy_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None,
        "gb_per_s": nbytes / (kernel_ms * 1e-3) / 1e9,
        "bound_share": bound_ms / kernel_ms,
    }
    emit(dict(phase="main_path", **out))
    return out


def phase_main_path(dev, peak: float) -> dict:
    """Shapes (a)-(c): each entry point is called once with the launch
    count from 0 (one launch expected) and checked, then timed."""
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    code = create_erasure_code({"plugin": "jax", "k": "8", "m": "4"},
                               device="cuda")
    k, m, C = code.k, code.m, code.C
    eng = code.engine
    res = {}

    # (a) one 16 MiB object, RS(8,4) encode_parity, L = 2 MiB
    L = 2 * MiB
    obj = rand_u8((k, L), 500, dev)
    parity, n = counted(1, "(a) encode_parity",
                        lambda: code.encode_parity(obj))
    check(torch.equal(parity, gf_matmul_plain(C, obj)), "(a) parity")
    res["a"] = _measure(
        "a: encode_parity [8, 2097152]",
        lambda: eng.matmul(C, obj), lambda: code.encode_parity(obj),
        lambda: gf_matmul_plain(C, obj), (k + m) * L, peak, dev, flush, n,
    )

    # (b) encode_batch of 64 x 4 MiB objects at a 4 KiB stripe unit
    N, L = 8192, 4096
    stripes = rand_u8((N, k, L), 501, dev)
    enc, n = counted(1, "(b) encode_batch",
                     lambda: code.encode_batch(stripes))
    check(tuple(enc.shape) == (N, k + m, L), "(b) shape")
    check(torch.equal(enc[:, :k], stripes), "(b) data rows")
    check(torch.equal(enc[:, k:], gf_matmul_plain(C, stripes)),
          "(b) parity rows")
    res["b"] = _measure(
        "b: encode_batch [8192, 8, 4096]",
        lambda: eng.matmul_batch(C, stripes),
        lambda: code.encode_batch(stripes),
        lambda: gf_matmul_plain(C, stripes), N * (k + m) * L, peak, dev,
        flush, n,
    )

    # (c) decode_batch of (b) with chunks {0, 5} lost
    lost = (0, 5)
    have = {i: enc[:, i] for i in range(k + m) if i not in lost}
    dec, n = counted(1, "(c) decode_batch",
                     lambda: code.decode_batch(set(range(k)), have, L))
    for i in lost:
        check(torch.equal(dec[i], stripes[:, i]), f"(c) chunk {i}")
    use = sorted(have)[:k]
    R = decode_plan(C, tuple(use), lost, eng)
    stack = torch.stack([have[i] for i in use], dim=1)
    res["c"] = _measure(
        "c: decode_batch [8192, 8, 4096] lost {0,5}",
        lambda: eng.matmul_batch(R, stack),
        lambda: code.decode_batch(set(range(k)), have, L),
        lambda: gf_matmul_plain(R, stack), N * (k + len(lost)) * L, peak,
        dev, flush, n,
    )
    return res


# -- phase 6: the CLI ---------------------------------------------------------

def phase_cli() -> dict:
    """The benchmark CLI, encode then decode.  Encode launches once per
    iteration; decode once for its initial encode, then once for each
    iteration whose erasure pattern hits a data chunk (an iteration that
    lost only parity has nothing to rebuild)."""
    lines, launches = {}, {}
    iterations, k = 10, 8
    for workload, extra in (("encode", []), ("decode", ["-e", "2"])):
        argv = ["--plugin", "jax", "-P", f"k={k}", "-P", "m=4",
                "--size", "16777216", "--iterations", str(iterations),
                "--workload", workload, "--device", "cuda", *extra]
        opts = ec_benchmark._parse(argv)
        _, patterns = ec_benchmark.workload_inputs(opts, k + 4)
        if workload == "encode":
            expected = iterations
        else:
            expected = 1 + sum(
                any(i < k for i in patterns[it % len(patterns)])
                for it in range(iterations)
            )
        buf = io.StringIO()
        _, launches[workload] = counted(
            expected, f"CLI {workload}",
            lambda: ec_benchmark.run(opts, out=buf),
        )
        line = buf.getvalue().strip()
        fields = line.split("\t")
        check(len(fields) == 2 and float(fields[0]) > 0
              and float(fields[1]) == 16384 * iterations,
              f"CLI {workload}: {line}")
        lines[workload] = line
    # the layered codes on the device engine; their launches are those of
    # the same command run on the CPU (`cpu_launches`)
    for name, argv in (
            ("clay_encode", ["--plugin", "clay", "-P", "k=8", "-P", "m=4",
                             "-P", "d=11", "--workload", "encode"]),
            ("clay_decode", ["--plugin", "clay", "-P", "k=8", "-P", "m=4",
                             "-P", "d=11", "--workload", "decode", "-e",
                             "2"]),
            ("shec_decode", ["--plugin", "shec", "-P", "k=4", "-P", "m=3",
                             "-P", "c=2", "--workload", "decode"]),
            ("lrc_decode", ["--plugin", "lrc", "-P", "k=4", "-P", "m=2",
                            "-P", "l=3", "--workload", "decode"])):
        argv = argv + ["-P", "backend=torch", "--size", str(4 * MiB),
                       "--iterations", str(iterations)]
        expected = cpu_launches(lambda: ec_benchmark.run(
            ec_benchmark._parse(argv + ["--device", "cpu"]),
            out=io.StringIO()))
        buf = io.StringIO()
        _, launches[name] = counted(
            expected, f"CLI {name}",
            lambda: ec_benchmark.run(
                ec_benchmark._parse(argv + ["--device", "cuda"]), out=buf))
        line = buf.getvalue().strip()
        fields = line.split("\t")
        check(launches[name] > 0 and len(fields) == 2
              and float(fields[0]) > 0
              and float(fields[1]) == 4096 * iterations,
              f"CLI {name}: {line}")
        lines[name] = line
    emit({"phase": "cli", "output": lines, "launches": launches})
    return launches


# -- the layered codes: corpus and BASELINE config 4 --------------------------

def phase_layered_corpus(dev) -> dict:
    """The clay, shec and lrc corpus entries with backend=torch on CUDA
    tensors: each encode digest and every decode case's digest equal to
    the corpus.  Each code's run is counted from 0 and held to the
    products the same run makes on the CPU."""
    entries = {e["name"]: e
               for e in json.loads(CORPUS.read_text())["entries"]}
    launches, cases = {}, 0

    def drive(name, device):
        entry = entries[name]
        code = create_erasure_code(dict(entry["profile"], backend="torch"),
                                   device=device)
        L, n = entry["chunk_bytes"], entry["n_chunks"]
        data = torch.from_numpy(_data_for(name, code.k, L)).to(device)
        enc = code.encode_chunks(data)
        check(_digest(enc) == entry["digest"], f"{name} stripe digest")
        for case in entry["decode"]:
            erased = list(case["erased"])
            avail = {i: enc[i] for i in range(n) if i not in erased}
            dec = code.decode_chunks(set(erased), avail, L)
            check(_digest(dec[i] for i in erased) == case["digest"],
                  f"{name} decode {erased} digest")

    for name in LAYERED_ENTRIES:
        expected = cpu_launches(lambda: drive(name, "cpu"))
        _, launches[name] = counted(expected, f"corpus {name}",
                                    lambda: drive(name, dev))
        check(launches[name] > 0, f"{name}: the kernel ran")
        cases += len(entries[name]["decode"])
    emit({"phase": "layered_corpus", "entries": list(LAYERED_ENTRIES),
          "decode_cases": cases, "digests_equal": True,
          "launches": launches})
    return launches


def repair_helpers(code, enc, lost: int) -> dict:
    """The d helpers' repair sub-chunks of chunk `lost`, as
    minimum_to_repair names them, gathered on the card."""
    need = code.minimum_to_repair({lost}, set(range(len(enc))) - {lost})
    out = {}
    for h, runs in need.items():
        planes = torch.tensor(
            [z for ind, cnt in runs for z in range(ind, ind + cnt)],
            device=enc.device)
        out[h] = enc[h].view(code.sub_chunk_no, -1)[planes].reshape(-1)
    return out


def replay(log, code, dev, plain=False):
    """The launches of an engine_launches() log, as a function that runs
    them again on the same tensors: the kernel's, or with plain=True their
    plain versions (each grouped product's in list order)."""
    tables = [code.engine._tables_for(e[1], dev) if e[0] == "product"
              else None for e in log]

    def run():
        for e, t in zip(log, tables):
            if e[0] == "group":
                (gf_grouped_plain if plain else gf_grouped_cuda)(*e[1:4])
            elif plain:
                gf_matmul_plain(e[1], e[2])
            else:
                gf_matmul_cuda(t, e[2], e[1].shape[0])
    return run


def phase_clay_repair(dev, peak: float) -> dict:
    """BASELINE config 4, Clay(k=8, m=4, d=11) with backend=torch, at a
    4 MiB stripe (512 KiB chunks of 64 sub-chunks of 8 KiB) and at
    bench.py::bench_clay's 1 MiB chunks: the stripe's encode digest equal
    to the JAX package's (tests/data/clay_config4.json); on the 4 MiB
    stripe every lost chunk 0..11 repaired from its helpers' repair
    sub-chunks (CUDA tensors) to the encoded chunk, and chunk 2's repair
    equal to the CPU's.  Each encode and repair is counted from 0 and held
    to its plan's launches, counted on the same call on the CPU (an encode
    at most CLAY4_ENCODE_MAX_LAUNCHES).  Then, for chunk 2 at both sizes
    and for the encode: wall ms (host clock, synchronised), the kernels'
    own ms (CUDA events, launches back to back), the same launches through
    the plain versions, and the bytes bound."""
    stored = json.loads(CLAY_CONFIG4.read_text())
    code = create_erasure_code(dict(stored["profile"], backend="torch"),
                               device=dev)
    cpu = create_erasure_code(dict(stored["profile"], backend="torch"),
                              device="cpu")
    k, m, d, q = code.k, code.m, code.d, code.q
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    clock = max_sm_clock_hz()
    launches = {"encode": 0, "repair": 0}
    rows = {}
    for si, stripe in enumerate(stored["stripes"]):
        Lc = stripe["chunk_bytes"]
        label = f"{Lc >> 10}KiB_chunks"
        host = np.random.default_rng(stripe["seed"]).integers(
            0, 256, (k, Lc), dtype=np.uint8)
        data = torch.from_numpy(host).to(dev)
        with engine_launches() as log:
            cpu_enc = cpu.encode_chunks(torch.from_numpy(host))
        plan_n = launches_of(log)
        check(plan_n <= CLAY4_ENCODE_MAX_LAUNCHES,
              f"config 4 encode: {plan_n} launches in its plan")
        enc, enc_n = counted(plan_n, f"config 4 encode {label}",
                             lambda: code.encode_chunks(data))
        launches["encode"] += enc_n
        check(_digest(enc) == stripe["digest"],
              f"config 4 {label}: stripe digest == the JAX package's")
        lost_all = range(k + m) if si == 0 else (2,)
        for lost in lost_all:
            helpers = repair_helpers(code, enc, lost)
            cpu_helpers = {h: v.cpu() for h, v in helpers.items()}
            expect = cpu_launches(lambda: cpu.repair({lost}, cpu_helpers,
                                                     Lc))
            got, n = counted(expect, f"config 4 {label} repair {lost}",
                             lambda: code.repair({lost}, helpers, Lc))
            launches["repair"] += n
            if lost == 2:
                rep_n = n
            check(torch.equal(got[lost], enc[lost]),
                  f"config 4 {label}: chunk {lost} repaired")
        helpers = repair_helpers(code, enc, 2)
        read = sum(h.numel() for h in helpers.values())
        if si == 0:
            want = cpu.repair({2}, {h: v.cpu() for h, v in helpers.items()},
                              Lc)
            check(torch.equal(code.repair({2}, helpers, Lc)[2].cpu(),
                              want[2]),
                  "config 4: chunk 2's repair == the CPU's")
            check(torch.equal(enc.cpu(), cpu_enc),
                  "config 4: the encode == the CPU's")

        # the launches to replay; they are counted above
        with engine_launches() as rep_log:
            code.repair({2}, helpers, Lc)
        with engine_launches() as enc_log:
            code.encode_chunks(data)
        check(launches_of(rep_log) == rep_n
              and launches_of(enc_log) == enc_n,
              f"config 4 {label}: the replay holds the counted launches")
        rep_bytes = read + Lc
        enc_bytes = (k + m) * Lc  # data read once, parity written once
        row = {
            "chunk_bytes": Lc, "sub_chunk_bytes": Lc // code.sub_chunk_no,
            "repair_launches": rep_n,
            "repair_shapes": sorted({(int(e[1].shape[0]),
                                      int(e[1].shape[1]),
                                      int(e[2].shape[-1]))
                                     for e in rep_log if e[0] == "product"}),
            "repair_wall_ms": wall_ms(lambda: code.repair({2}, helpers, Lc),
                                      flush),
            "repair_ms": device_ms(replay(rep_log, code, dev), flush, clock),
            "repair_plain_ms": time_ms(replay(rep_log, code, dev, True),
                                       flush, runs=5),
            "repair_bytes": rep_bytes,
            "repair_bound_ms": rep_bytes / peak * 1e3,
            "read_fraction": read / (k * Lc),
            "encode_launches": enc_n,
            "encode_products": sum(len(e[1].products) for e in enc_log),
            "encode_wall_ms": wall_ms(lambda: code.encode_chunks(data),
                                      flush, runs=7),
            "encode_ms": device_ms(replay(enc_log, code, dev), flush, clock,
                                   runs=7),
            "encode_plain_ms": time_ms(replay(enc_log, code, dev, True),
                                       flush, runs=3, warmup=1),
            "encode_bytes": enc_bytes,
            "encode_bound_ms": enc_bytes / peak * 1e3,
        }
        row["repair_gb_per_s"] = k * Lc / row["repair_wall_ms"] / 1e6
        row["encode_gb_per_s"] = k * Lc / row["encode_wall_ms"] / 1e6
        check(abs(row["read_fraction"] - d / q / k) < 1e-12,
              "config 4: helpers read d/q of a chunk each")
        rows[label] = row
        print(f"config 4 {label}: repair wall {row['repair_wall_ms']:.6f} "
              f"ms ({row['repair_launches']} launches, kernels "
              f"{row['repair_ms']:.6f} ms, plain {row['repair_plain_ms']:.6f}"
              f" ms, bound {row['repair_bound_ms']:.6f} ms, "
              f"{row['repair_gb_per_s']:.3f} GB/s, read fraction "
              f"{row['read_fraction']:.6f}); encode wall "
              f"{row['encode_wall_ms']:.6f} ms ({row['encode_launches']} "
              f"launches of {row['encode_products']} products, kernels "
              f"{row['encode_ms']:.6f} ms, bound "
              f"{row['encode_bound_ms']:.6f} ms)", flush=True)
    emit({"phase": "clay_repair", "profile": stored["profile"],
          "digests_equal": True, "repairs_equal": k + m + 1,
          "equal_to_cpu": True, "launches": launches, "rows": rows})
    return launches, rows


# -- placement: the rule kernel and the pipeline kernel on the card ---------

CONFIGS = {
    # BASELINE.json configs 2 and 5, built as bench.py::build_map builds
    # them: hosts of 8 OSDs, racks of 16 hosts, one replicated size-3 pool
    # with chooseleaf firstn over host
    "config2": (100_000, 1024),
    "config5": (10_000_000, 10_000),
}
OSD_PER_HOST = 8
PLAIN_BLOCK = 1 << 20  # seeds of config 5 the plain version is held to


def bench_map(n_pgs: int, n_osds: int):
    n_host = max(1, n_osds // OSD_PER_HOST)
    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                  pg_num=n_pgs, pgp_num=n_pgs)
    return build_hierarchical(n_host, OSD_PER_HOST,
                              n_rack=max(1, n_host // 16), pool=pool)


def rule_inputs(pm: PoolMapper, n: int):
    """The kernel's inputs on the main path for the first n PGs of the
    pool: (seeds, reweights), u32 values in int64 on the card."""
    ps = torch.arange(n, device=pm.device)
    return pm.placement_seeds(ps), pm.rule_weights()


def rule_kernel_checked(T, prog, x, w, want, what: str) -> int:
    """crush_rule_cuda on seeds x, with the wrapper's staging and with
    staging forced to 0 (every record read from global memory), each held
    element for element to the plain version's rows `want`; returns the
    max abs error (0)."""
    err = 0
    for stage in (None, 0):
        got = mapper.crush_rule_cuda(T, prog, mapper.u32_bits(x),
                                     mapper.u32_bits(w), stage=stage)
        torch.cuda.synchronize()
        if got.numel():
            err = max(err, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want),
              f"crush_rule kernel == plain ({what}, stage {stage})")
    return err


def kernel_vs_plain(pm: PoolMapper, n: int):
    """crush_rule_cuda against crush_rule_plain on the main path's inputs
    (both staging paths); returns (max_abs_err, draws per lane of the
    plain version)."""
    x, w = rule_inputs(pm, n)
    want, draws = mapper.crush_rule_plain(pm.tables, pm.prog, x, w)
    return rule_kernel_checked(pm.tables, pm.prog, x, w, want,
                               f"{n} PGs"), draws


def phase_rule_vs_plain(dev, corpus: dict, pms: dict) -> tuple[int, dict]:
    """Phase 1 of placement: the kernel (with the wrapper's staging and
    with none) vs its plain version on every corpus map, the whole of
    config 2 and the first 2^20 PGs of config 5 (all_draws holds it to
    the rest)."""
    worst, cases, draws = 0, [], {}
    for name, entry in corpus.items():
        pm = PoolMapper(osdmap_from_reference(entry["map"]),
                        entry["pool_id"], device=dev)
        err, _ = kernel_vs_plain(pm, pm.spec.pg_num)
        worst = max(worst, err)
        cases.append({"case": name, "pgs": pm.spec.pg_num, "equal": True})
    for name, n in (("config2", CONFIGS["config2"][0]),
                    ("config5", PLAIN_BLOCK)):
        err, d = kernel_vs_plain(pms[name], n)
        worst = max(worst, err)
        draws[name] = d
        cases.append({"case": name, "pgs": n, "equal": True,
                      "draws_per_pg": d.double().mean().item()})
    err, names = legacy_cases(dev)
    worst = max(worst, err)
    cases.append({"case": "legacy_cases", "names": names, "equal": True,
                  "equal_to_jax_rows": True})
    err, legacy = legacy_config5(dev)
    worst = max(worst, err)
    for alg in LEGACY_ALGS:
        for label, n in (("block", LEGACY_X), ("all", C5_X)):
            if label in legacy[alg]:
                cases.append({"case": f"config5_{alg}_hosts", "x": n,
                              "equal": True,
                              "hashes_by_alg": legacy[alg][label]})
    emit({"phase": "rule_vs_plain", "cases": cases, "max_abs_err": worst})
    return worst, draws, legacy


PIPELINE_CASES = ROOT / "tests" / "data" / "pipeline_kernel_cases.json"
PIPELINE_MODES = tuple(pipeline.MODES)


def pipeline_checked(pm: PoolMapper, ps: torch.Tensor, what: str) -> int:
    """pipeline_cuda on seeds ps in each mode, with the wrapper's staging
    and with none, each output held element for element to the plain
    chain on the card (`pipeline_plain`: the rule kernel and the torch
    ops); returns the max abs error (0)."""
    err = 0
    for mode in PIPELINE_MODES:
        want = pm.pipeline_plain(ps, mode)
        for stage in (None, 0):
            got = pipeline.pipeline_cuda(pm, ps, mode, stage=stage)
            torch.cuda.synchronize()
            check(len(got) == len(want), f"pipeline {mode} outputs")
            for g, w in zip(got, want):
                if g.numel():
                    err = max(err, int((g.long() - w).abs().max()))
                check(g.dtype == torch.int32 and torch.equal(g.long(), w),
                      f"pipeline kernel == plain chain ({what}, {mode}, "
                      f"stage {stage})")
    return err


def phase_pipeline_vs_plain(dev, corpus: dict, pms: dict) -> int:
    """The pipeline kernel against the plain chain on the card, in its
    three modes, with the wrapper's staging and with none: every
    placement corpus map and every map of
    tests/data/pipeline_kernel_cases.json (the 16 pipeline test cases and
    two maps with every overlay at once and rows wider than the pool),
    each with its overlays and without, its rows also held to the JAX
    package's stored rows; config 2 whole, config 5's first PLAIN_BLOCK
    PGs and, in `up` mode (map_all_device's), all of them."""
    worst, cases = 0, []
    maps = [(f"corpus_{name}", osdmap_from_reference(e["map"]),
             e["pool_id"], None) for name, e in sorted(corpus.items())]
    stored = json.loads(PIPELINE_CASES.read_text())["cases"]
    maps += [(name, osdmap_from_reference(e["map"]), e["pool"], e["jax"])
             for name, e in sorted(stored.items())]
    for name, m, pid, jax in maps:
        width = PoolMapper(m, pid, device=dev).spec.out_width
        for ov in (True, False):
            pm = PoolMapper(m, pid, device=dev, overlays=ov)
            ps = torch.arange(pm.spec.pg_num, device=dev)
            worst = max(worst, pipeline_checked(pm, ps, f"{name} {ov}"))
            if jax is not None and ov:
                got = pipeline.pipeline_cuda(pm, ps, "rows")
                check(all(g.cpu().tolist() == w
                          for g, w in zip(got, jax["rows"])),
                      f"pipeline kernel == the JAX package's rows ({name})")
        cases.append({"case": name, "pgs": pm.spec.pg_num,
                      "width": width, "equal": True,
                      "equal_to_jax_rows": jax is not None})
    for name, n in (("config2", CONFIGS["config2"][0]),
                    ("config5", PLAIN_BLOCK)):
        pm = pms[name]
        worst = max(worst, pipeline_checked(
            pm, torch.arange(n, device=dev), f"{name}, {n} PGs"))
        cases.append({"case": name, "pgs": n, "equal": True})
    pm = pms["config5"]
    ps = torch.arange(pm.spec.pg_num, device=dev)
    got = pipeline.pipeline_cuda(pm, ps, "up")[0]
    check(torch.equal(got.long(), pm.pipeline_plain(ps, "up")[0]),
          "pipeline kernel == plain chain (config5, all PGs, up)")
    cases.append({"case": "config5_up", "pgs": pm.spec.pg_num,
                  "equal": True})
    # the groups: the kernel at every G, on maps with every overlay
    # (replicated and EC) and on config-5-shaped maps of legacy hosts
    sweep = group_sweep()
    group_maps = [(name, osdmap_from_reference(stored[name]["map"]),
                   stored[name]["pool"])
                  for name in ("random_replicated", "random_ec")]
    group_maps += [(f"legacy_{alg}", legacy_osdmap(alg), 0)
                   for alg in LEGACY_ALGS]
    for name, m, pid in group_maps:
        pm = PoolMapper(m, pid, device=dev)
        for g, n in sweep:
            ps = torch.arange(n, device=dev) % pm.spec.pg_num
            worst = max(worst, pipeline_checked(
                pm, ps, f"{name}, {n} lanes, group {g}"))
        cases.append({"case": f"groups_{name}", "pgs": pm.spec.pg_num,
                      "lanes_by_group": sweep, "equal": True})
    emit({"phase": "pipeline_vs_plain", "cases": cases,
          "max_abs_err": worst})
    return worst


def group_sweep() -> list[tuple[int, int]]:
    """(G, n) for every group the launch chooses: the largest odd n (never
    a multiple of the group) a launch maps with G lanes a PG, each held to
    `pipeline.group_size`; and 1 and 63 lanes (G = 32)."""
    plan = pipeline.launch_plan(torch.cuda.current_device())
    resident = plan.blocks_per_sm * plan.threads * plan.sms
    sweep = [(g, (resident // g - 1) | 1) for g in pipeline.GROUPS]
    sweep += [(32, 1), (32, 63)]
    for g, n in sweep:
        check(pipeline.group_size(n) == g and n % 2 == 1,
              f"pipeline: {n} lanes map with group {g} "
              f"(group_size {pipeline.group_size(n)})")
    return sweep


def legacy_osdmap(alg: str):
    """legacy_map(alg) as an OSDMap: every OSD up and in, one replicated
    size-3 pool of 2^20 PGs on rule 0."""
    m = OSDMap(legacy_map(alg))
    m.set_max_osd(m.crush.max_devices)
    for o in range(m.max_osd):
        m.mark_up_in(o)
    m.add_pool("rbd", PgPool(type=PoolType.REPLICATED, size=3,
                             crush_rule=0, pg_num=1 << 20,
                             pgp_num=1 << 20))
    return m


def placement_digest(rows) -> str:
    h = hashlib.sha256()
    for a in rows:
        h.update(np.ascontiguousarray(a, np.int32).tobytes())
    return h.hexdigest()


def phase_placement_corpus(dev, corpus: dict) -> int:
    """Every corpus entry's digest through PoolMapper.map_all() on the
    card: one pipeline launch per entry (each pool has fewer than BLOCK
    PGs)."""
    maps = {name: osdmap_from_reference(e["map"])
            for name, e in corpus.items()}

    def drive():
        for name, e in corpus.items():
            rows = PoolMapper(maps[name], e["pool_id"], device=dev).map_all()
            check(placement_digest(rows) == e["digest"],
                  f"placement digest {name}")

    _, n = counted(len(corpus), "placement corpus", drive,
                   pipeline.pipeline_cuda)
    emit({"phase": "placement_corpus", "entries": sorted(corpus),
          "digests_equal": True, "launches": n})
    return n


# The instructions one straw2 draw needs at the fewest, per lane: each
# operation of the reference draw (hash.c crush_hash32_rjenkins1_3,
# mapper.c crush_ln, the divide and the keep-the-first-maximum compare)
# mapped to the fewest sm_90 instructions that compute it exactly:
# three-input IADD3 and LOP3, IMAD.WIDE for 32x32->64 products, table
# loads from shared memory at an immediate base.  The divide is counted
# as a multiply by a per-weight reciprocal (the JAX package's
# magic-number constants), not the emulated divide the kernel runs.  The
# rest of the rule (is_out's hash2, collision checks, loop control) is
# not counted, so the bound is below the least time.
DRAW_OPS = {
    "loads": 2,  # the weight with its reciprocal (one 16 B load), the id
    "hash3": 2 + 5 * 9 * 3 + 1,  # seed^a^b^c; 5 mixes of 9 steps, each
                                 # IADD3 + SHF + LOP3; & 0xffff
    "crush_ln": 19,  # +1 (1); normalise: FLO, 15 - f, max 0, SHF, exponent
                     # (5); RH/LH row index (2) and one LDS.128 (1);
                     # x * RH >> 48: IMAD.WIDE + IMAD (2); LL index (2)
                     # and LDS.64 (1); 64-bit add (2), >> 4 (2);
                     # + exponent << 44 (1)
    "numerator": 2,  # 2^48 - ln, 64-bit
    "divide": 7,  # high half of |n| x a 64-bit reciprocal (5 IMAD),
                  # 64-bit shift (2)
    "compare": 6,  # weight != 0; 64-bit compare (2); keep draw (2), index
}
OPS_PER_DRAW = sum(DRAW_OPS.values())
# the placement seed's hash32_2 a PG in the pipeline kernel: seed^a^b,
# 3 mixes of 9 steps (IADD3 + SHF + LOP3 each), counted as hash3 is
HASH2_OPS = 1 + 3 * 9 * 3
# A second reading beside the bound: hash3's IADD3/SHF/LOP3 alone, on the
# 64 INT32 lanes per clock of an sm_90 SM (the bound prices them at the
# issue rate of 128)
INT_LANES = 64


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def rule_bytes(T, prog, n_weights: int, n: int) -> int:
    """What the kernel must move: each input read once (seeds, the map's
    packed headers, records, items and tree nodes, reweights, steps,
    crush_ln tables), each output written once."""
    arrays = (T.headers, T.records, T.packed_items, T.nodes)
    return (4 * n + sum(a.numel() * 4 for a in arrays)
            + 4 * n_weights + prog.steps.nbytes
            + (258 + 256) * 8 + 4 * n * prog.result_max)


def host_of(m, n_osd: int) -> np.ndarray:
    """Each OSD's host bucket id (0 for an OSD in no host)."""
    out = np.zeros(n_osd, np.int64)
    for bid, b in m.crush.buckets.items():
        if b.type == 1:
            out[[i for i in b.items if i >= 0]] = bid
    return out


def reached_osds(m, root: int) -> np.ndarray:
    todo, seen = [root], []
    while todo:
        for it in m.crush.buckets[todo.pop()].items:
            (seen if it >= 0 else todo).append(it)
    return np.asarray(sorted(seen))


def sanity(name: str, m, up: torch.Tensor) -> dict:
    """Every PG on 3 distinct OSDs of 3 distinct hosts; the per-OSD PG
    count's stddev within 3x what osdmaptool --test-map-pgs expects
    (sqrt(total/n * (1 - 1/n)), cli/osdmaptool.py:234-237), over the OSDs
    the root reaches."""
    n_osd = m.max_osd
    check(bool((up != ITEM_NONE).all()), f"{name}: every PG has 3 OSDs")
    srt = up.long().sort(1).values
    check(bool((srt[:, 1:] != srt[:, :-1]).all()), f"{name}: distinct OSDs")
    hosts = torch.from_numpy(host_of(m, n_osd)).to(up.device)[up.long()]
    hs = hosts.sort(1).values
    check(bool((hs[:, 1:] != hs[:, :-1]).all()), f"{name}: distinct hosts")
    root = m.crush.rules[0].steps[0][1]
    reach = reached_osds(m, root)
    counts = torch.bincount(up.reshape(-1).long(), minlength=n_osd).cpu()
    c = counts.numpy()[reach].astype(np.float64)
    total, n = float(c.sum()), len(reach)
    check(total == up.numel(),
          f"{name}: every mapping lands on an OSD the root reaches")
    avg = total // n
    dev = float(np.sqrt(((avg - c) ** 2).mean()))
    expected = float(np.sqrt(total / n * (1 - 1 / n)))
    check(dev <= 3 * expected, f"{name}: stddev {dev} > 3 x {expected}")
    return {"osds_reached": n, "stddev": dev, "expected_stddev": expected}


def all_draws(pm: PoolMapper, n: int, draws: torch.Tensor) -> torch.Tensor:
    """The straw2 draws every one of the pool's n PGs needs, counted by
    the plain version; where phase 1 held it to fewer PGs, one more
    untimed pass covers them all (and holds the kernel to it there too,
    on both staging paths)."""
    if draws.numel() == n:
        return draws
    x, w = rule_inputs(pm, n)
    want, draws = mapper.crush_rule_plain(pm.tables, pm.prog, x, w)
    rule_kernel_checked(pm.tables, pm.prog, x, w, want, f"{n} PGs")
    return draws


def phase_placement_main(dev, pms: dict, draws: dict, peak: float) -> dict:
    """Config 2 through map_all, config 5 through map_all_device: each
    entry point called once with the pipeline kernel's launch count from
    0 (one launch per BLOCK seeds), checked, then timed with CUDA events:
    the rule kernel alone, the pipeline kernel in the entry point's mode,
    the entry point, the plain chain on the card (the torch ops around the
    rule kernel) and the rule's plain version.  The issue bound counts the
    draws this run's PGs need, OPS_PER_DRAW each (the pipeline's adds one
    seed hash a PG, HASH2_OPS)."""
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    clock = max_sm_clock_hz()
    issue_rate = H100_SMS * SCHEDULERS_PER_SM * WARP * clock
    res = {}
    for name, (n_pgs, n_osds) in CONFIGS.items():
        pm = pms[name]
        expected = -(-n_pgs // mapper.BLOCK)
        entry, mode = ((pm.map_all, "rows") if name == "config2"
                       else (pm.map_all_device, "up"))
        # the entry point launches the pipeline kernel alone: no rule
        # kernel, no diagnostics kernel
        out, rule_n, diag_n, n = count_placement(entry)
        check((rule_n, diag_n, n) == (0, 0, expected),
              f"{name}: {n} pipeline, {rule_n} crush_rule and {diag_n} "
              f"diag launches, expected {expected} pipeline launches only")
        up = (torch.from_numpy(out[0]).to(dev) if name == "config2"
              else out)
        check(tuple(up.shape) == (n_pgs, 3), f"{name}: up shape")
        stats = sanity(name, pm.m, up)
        x, w = rule_inputs(pm, n_pgs)
        xb, wb = mapper.u32_bits(x), mapper.u32_bits(w)
        kernel_ms = time_ms(
            lambda: mapper.crush_rule_cuda(pm.tables, pm.prog, xb, wb),
            flush, runs=7)
        entry_ms = time_ms(entry, flush, runs=5)
        # the entry point's kernel alone (the rest of entry_ms is the
        # seeds' arange and, for map_all, the copy to the host), and the
        # plain chain it replaced on the card: the seeds' and the stages'
        # torch ops around the rule kernel
        ps = torch.arange(n_pgs, device=dev)
        pipe_ms = time_ms(lambda: pipeline.pipeline_cuda(pm, ps, mode),
                          flush, runs=7)
        chain_ms = time_ms(lambda: pm.pipeline_plain(ps, mode), flush,
                           runs=3)
        pn = draws[name].numel()  # the block the plain version was held to
        px, pw = rule_inputs(pm, pn)
        pxb = mapper.u32_bits(px)
        block_ms = time_ms(
            lambda: mapper.crush_rule_cuda(pm.tables, pm.prog, pxb, wb),
            flush, runs=7)
        plain_ms = time_ms(
            lambda: mapper.crush_rule_plain(pm.tables, pm.prog, px, pw),
            flush, runs=5, warmup=0)
        n_draws = int(all_draws(pm, n_pgs, draws[name]).sum())
        draws_per_pg = n_draws / n_pgs
        ops = n_draws * OPS_PER_DRAW
        ops_ms = ops / issue_rate * 1e3
        int_pipe_ms = (n_draws * DRAW_OPS["hash3"]
                       / (H100_SMS * INT_LANES * clock) * 1e3)
        # the staging split: the wrapper's, beside none and all of the map
        # (where a block may hold it), timed in the same way
        plan = mapper.launch_plan(torch.cuda.current_device())
        staged = mapper.staged_records(pm.tables, plan)
        total = pm.tables.records.shape[0]
        fits = (plan.table_bytes + plan.static_smem
                + total * mapper.RECORD_BYTES <= plan.smem_optin)
        stage_ms = {
            label: time_ms(
                lambda st=st: mapper.crush_rule_cuda(
                    pm.tables, pm.prog, xb, wb, stage=st), flush, runs=7)
            for label, st in (("none", 0), ("all", total))
            if st != staged and (label == "none" or fits)}
        nbytes = rule_bytes(pm.tables, pm.prog, pm.rule_weights().numel(),
                            n_pgs)
        bytes_ms = nbytes / peak * 1e3
        pplan = pipeline.launch_plan(torch.cuda.current_device())
        pipe_bytes = pipeline._pipeline_work((
            pm.tables, pm.prog, n_pgs, pm.dev["weight"].numel(), mode,
            pm.spec.out_width, 0))[0]
        pipe_ops_ms = (ops + n_pgs * HASH2_OPS) / issue_rate * 1e3
        pipe_bytes_ms = pipe_bytes / peak * 1e3
        pipe_bound = max(pipe_ops_ms, pipe_bytes_ms)
        out = {
            "config": name, "pgs": n_pgs, "osds": n_osds, "launches": n,
            "ms": kernel_ms, "entry_ms": entry_ms,
            "mappings_per_s": n_pgs / (kernel_ms * 1e-3),
            "entry_mappings_per_s": n_pgs / (entry_ms * 1e-3),
            "pipeline_mode": mode, "pipeline_ms": pipe_ms,
            "pipeline_over_rule": pipe_ms / kernel_ms,
            "pipeline_mappings_per_s": n_pgs / (pipe_ms * 1e-3),
            "plain_chain_ms": chain_ms,
            "pipeline_ops_ms": pipe_ops_ms,
            "pipeline_hbm_bytes": pipe_bytes,
            "pipeline_bytes_ms": pipe_bytes_ms,
            "pipeline_bound_ms": pipe_bound,
            "pipeline_bound_by": "operations"
            if pipe_ops_ms >= pipe_bytes_ms else "bytes",
            "pipeline_bound_share": pipe_bound / pipe_ms,
            "pipeline_threads": pplan.threads,
            "pipeline_group": pipeline.group_size(n_pgs),
            "pipeline_staged_records": mapper.staged_records(pm.tables,
                                                             pplan),
            "plain_pgs": pn, "plain_ms": plain_ms, "block_ms": block_ms,
            "draws": n_draws, "draws_per_pg": draws_per_pg,
            "ops_per_draw": OPS_PER_DRAW, "draw_ops": DRAW_OPS,
            "max_sm_clock_hz": clock,
            "ops_ms": ops_ms, "int_pipe_ms": int_pipe_ms,
            "staged_records": staged, "records": total,
            "smem_per_block": plan.table_bytes + plan.static_smem
            + staged * mapper.RECORD_BYTES,
            "threads": plan.threads, "ms_by_stage": stage_ms,
            "hbm_bytes": nbytes, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_share": max(ops_ms, bytes_ms) / kernel_ms,
            "library_ms": None, **stats,
        }
        emit(dict(phase="placement_main", **out))
        res[name] = out
    res["config5"]["small"] = small_launches(dev, pms["config5"],
                                             draws["config5"], flush, clock,
                                             issue_rate, peak)
    return res


SMALL_LANES = (64, 8192)  # a micro-batch; serving's bulk sub-block


def touched_bytes(pm: PoolMapper, up: torch.Tensor) -> tuple[int, int]:
    """(bytes, OSDs) of the map a launch whose rows are `up` [n, W] reads
    at the least: the rule's steps and the crush_ln tables, and of the map
    only the buckets above the OSDs of its rows (each header and its
    records once); and those OSDs, whose per-OSD entries it reads.  A
    retry's other buckets are not counted, so this is a floor."""
    parent = {it: bid for bid, b in pm.m.crush.buckets.items()
              for it in b.items}
    osds = {int(v) for v in up.flatten().tolist() if v != ITEM_NONE}
    buckets, todo = set(), [parent[o] for o in osds if o in parent]
    while todo:
        bid = todo.pop()
        if bid not in buckets:
            buckets.add(bid)
            todo += [parent[bid]] if bid in parent else []
    rec = sum(soa.HEADER.itemsize + mapper.RECORD_BYTES
              * len(pm.m.crush.buckets[b].items) for b in buckets)
    return pm.prog.steps.nbytes + (258 + 256) * 8 + rec, len(osds)


def small_bytes(pm: PoolMapper, up: torch.Tensor) -> int:
    """The bytes a rows-mode launch whose up rows are `up` [n, W] moves at
    the least: its seeds read (8 B each) and its four planes written, and
    what touched_bytes reckons of the map, with those OSDs' exists and up
    flags and reweight.  _pipeline_work counts the whole map, which a
    launch of a few PGs never reads."""
    n, w = up.shape
    touched, n_osds = touched_bytes(pm, up)
    return 8 * n + 4 * n * (2 * w + 2) + touched + (1 + 1 + 8) * n_osds


def small_launches(dev, pm: PoolMapper, draws: torch.Tensor,
                   flush: torch.Tensor, clock: float, issue_rate: float,
                   peak: float) -> dict:
    """The pipeline kernel on config 5's first n PGs (rows mode, as
    map_batch), n in SMALL_LANES: each launch's group, its device time
    with the L2 flushed and warm (device_ms: the stream held while the
    host enqueues), its bound (the draws these lanes need, from phase 1's
    plain version, and a seed hash a PG; the bytes of small_bytes: what
    these lanes touch, not the whole map) and the plain chain's time."""
    warm = torch.empty(1, dtype=torch.uint8, device=dev)
    out = {}
    for n in SMALL_LANES:
        ps = torch.arange(n, device=dev)

        def launch(ps=ps):
            return pipeline.pipeline_cuda(pm, ps, "rows")

        n_draws = int(draws[:n].sum())
        ops_ms = (n_draws * OPS_PER_DRAW + n * HASH2_OPS) / issue_rate * 1e3
        nbytes = small_bytes(pm, launch()[0])
        bytes_ms = nbytes / peak * 1e3
        bound = max(ops_ms, bytes_ms)
        ms = device_ms(launch, flush, clock)
        out[n] = {
            "lanes": n, "group": pipeline.group_size(n), "ms": ms,
            "warm_ms": device_ms(launch, warm, clock),
            "plain_chain_ms": time_ms(lambda ps=ps: pm.pipeline_plain(
                ps, "rows"), flush, runs=5),
            "draws": n_draws, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_share": bound / ms}
    emit({"phase": "placement_small", "config": "config5",
          "launches": out})
    return out


# -- the legacy bucket draws --------------------------------------------------

LEGACY_ALGS = ("straw", "list", "tree", "uniform")
LEGACY_X = 1 << 20  # seeds (crushtool x) each legacy map is checked and
                    # timed on; straw's map is checked on all of config 5
C5_X = CONFIGS["config5"][0]
# The instructions of one hash call of each legacy draw at the fewest,
# counted as DRAW_OPS counts straw2's: hash3 is 137 without its & 0xffff,
# hash4 2 + 6 mixes x 9 x 3 = 164; a 16 B record load where the draw
# reads one; a u16 x u32 or u32 x u32 product is one IMAD.WIDE.U32.
LEGACY_OPS = {
    # load, hash3 & 0xffff (138), product, 64-bit compare (2) and keep (2)
    "straw": 1 + 138 + 1 + 4,
    # load, hash4 & 0xffff (165), product, 64-bit >> 16 (2), compare (2),
    # branch
    "list": 1 + 165 + 1 + 2 + 2 + 1,
    # two node loads, hash4, product (its high word is the >> 32), the
    # level step: trailing zeros (2), 1 << (h - 1) (2), n - half, compare,
    # select (3), loop test
    "tree": 2 + 164 + 1 + 7 + 1,
    # hash3, u32 % (size - p): the reciprocal sequence (I2F, MUFU.RCP,
    # F2I, 3 IMAD, IMAD.HI, 2 ISETP, 2 IADD3, 2 SEL: 14), compare and
    # select (2), loop counter (2)
    "uniform": 137 + 14 + 4,
}


def legacy_map(alg: str):
    """Config 5's shape with `alg` hosts, as the port's crushtool builds
    it: `crushtool --build --num_osds 10000 host <alg> 8 rack straw2 16
    root straw2 0` (1250 hosts of 8 OSDs under 79 racks)."""
    return crushtool.build_map(10000, [("host", alg, 8), ("rack", "straw2", 16),
                                       ("root", "straw2", 0)])


def legacy_cases(dev) -> tuple[int, list]:
    """The kernel (both staging paths) == the plain version == the JAX
    package's stored rows, on the legacy cases of
    tests/test_torch_crush_legacy.py."""
    err, cases = 0, []
    for e in json.loads(LEGACY_CASES.read_text())["cases"]:
        cm = crush_from_reference(e["map"])
        A = soa.build_arrays(cm, cm.choose_args.get(e["choose_args"]))
        T = soa.to_device(A, dev)
        prog = mapper.compile_rule(A, e["ruleno"], e["result_max"])
        x = torch.tensor(e["xs"], dtype=torch.long, device=dev)
        w = torch.tensor(e["weights"], dtype=torch.long, device=dev)
        want, _ = mapper.crush_rule_plain(T, prog, x, w)
        check(want.cpu().tolist() == e["rows"],
              f"legacy case {e['name']}: plain == JAX package")
        err = max(err, rule_kernel_checked(T, prog, x, w, want,
                                           f"legacy case {e['name']}"))
        cases.append(e["name"])
    return err, cases


def legacy_config5(dev) -> tuple[int, dict]:
    """Each legacy algorithm's config-5-shaped map: the kernel (both
    staging paths) == the plain version on the first LEGACY_X seeds, and
    for straw on all of config 5's.  Returns the maps' tables and the
    plain version's hash counts by algorithm for each block."""
    err, res = 0, {}
    for alg in LEGACY_ALGS:
        A = soa.build_arrays(legacy_map(alg))
        T = soa.to_device(A, dev)
        prog = mapper.compile_rule(A, 0, 3)
        w = torch.full((A.max_devices,), 0x10000, dtype=torch.long,
                       device=dev)
        blocks = {"block": LEGACY_X}
        if alg == "straw":
            blocks["all"] = C5_X
        res[alg] = {"tables": T, "prog": prog, "weights": w}
        for label, n in blocks.items():
            x = torch.arange(n, dtype=torch.long, device=dev)
            want, hashes = mapper.crush_rule_plain(T, prog, x, w,
                                                   by_alg=True)
            err = max(err, rule_kernel_checked(T, prog, x, w, want,
                                               f"{alg} hosts, {n} x"))
            res[alg][label] = hashes.sum(0).tolist()
        check(res[alg]["block"][int(BucketAlg[alg.upper()])] > 0,
              f"{alg} hosts: the plain version drew from them")
    return err, res


def phase_legacy_main(dev, legacy: dict, peak: float) -> dict:
    """Each legacy map's kernel time on its first LEGACY_X seeds (straw's
    also on all of config 5's), beside its bound: the hash calls the
    plain version counted, LEGACY_OPS each, and the straw2 draws of the
    racks and the root, OPS_PER_DRAW each, over the issue rate; or the
    bytes it must move, whichever is larger."""
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    clock = max_sm_clock_hz()
    issue_rate = H100_SMS * SCHEDULERS_PER_SM * WARP * clock
    out = {}
    for alg in LEGACY_ALGS:
        r = legacy[alg]
        T, prog, w = r["tables"], r["prog"], r["weights"]
        wb = mapper.u32_bits(w)
        for label in ("block", "all"):
            if label not in r:
                continue
            n = LEGACY_X if label == "block" else C5_X
            x = torch.arange(n, dtype=torch.long, device=dev)
            xb = mapper.u32_bits(x)
            ms = time_ms(lambda: mapper.crush_rule_cuda(T, prog, xb, wb),
                         flush, runs=7)
            hashes = r[label]
            a = int(BucketAlg[alg.upper()])
            ops = (hashes[BucketAlg.STRAW2] * OPS_PER_DRAW
                   + hashes[a] * LEGACY_OPS[alg])
            ops_ms = ops / issue_rate * 1e3
            bytes_ms = rule_bytes(T, prog, w.numel(), n) / peak * 1e3
            bound = max(ops_ms, bytes_ms)
            row = {"x": n, "ms": ms, "mappings_per_s": n / (ms * 1e-3),
                   "legacy_hashes": hashes[a],
                   "legacy_hashes_per_x": hashes[a] / n,
                   "straw2_draws": hashes[BucketAlg.STRAW2],
                   "ops_per_hash": LEGACY_OPS[alg], "ops_ms": ops_ms,
                   "bytes_ms": bytes_ms, "bound_ms": bound,
                   "bound_by": "operations" if ops_ms >= bytes_ms
                   else "bytes", "bound_share": bound / ms}
            if label == "block":
                row["plain_ms"] = time_ms(
                    lambda: mapper.crush_rule_plain(T, prog, x, w),
                    flush, runs=1, warmup=0)
            out[alg if label == "block" else f"{alg}_all"] = row
    emit({"phase": "legacy_main", "clock_hz": clock, "rows": out})
    return out


# -- the placement CLIs --------------------------------------------------------

def run_cli(tool, argv: list[str], want_rc: int = 0) -> tuple[str, float]:
    """(stdout, seconds) of one CLI run through its main(argv), which
    must exit want_rc; stderr is kept apart and shown if it does not."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tool.main(list(argv))
    seconds = time.perf_counter() - t0
    check(rc == want_rc, f"{tool.__name__} {' '.join(argv)}: rc {rc}, "
          f"{err.getvalue()[-2000:]}")
    return out.getvalue(), seconds


def cli_counts(text: str, pattern: str) -> dict[int, int]:
    return {int(i): int(c) for i, c in re.findall(pattern, text)}


def cli_kernel(tool):
    """The kernel a placement CLI's mapping launches: `crushtool --test`
    runs the rule alone (crush/tester.py, the rule kernel), osdmaptool
    maps through PoolMapper (the pipeline kernel)."""
    return mapper.crush_rule_cuda if tool is crushtool \
        else pipeline.pipeline_cuda


def phase_cli_placement(dev, pms: dict) -> dict:
    """The placement CLIs through their main(argv), on the card (their
    default device), each counted from 0: BASELINE config 1 (`crushtool
    --test`), config 1's test on a map of straw hosts, a test of
    tests/data/legacy_crushmap.txt, BASELINE config 2
    (`osdmaptool --test-map-pgs`), the balancer on it (`osdmaptool
    --upmap`) and its health with 8 OSDs down (`osdmaptool --health`, exit
    1 at HEALTH_WARN), each stdout's sha256 (and the upmap file's) equal
    to the JAX CLIs' (tests/data/cli_corpus.json); then config 5 through both, the
    per-OSD counts each prints equal to the osd_histogram of
    map_all_device's rows.  One launch per (rule, numrep) pass (the rule
    kernel) or pool (the pipeline kernel)."""
    corpus = json.loads(CLI_CORPUS.read_text())
    want, want_files = corpus["stdout_sha256"], corpus["file_sha256"]
    test1 = ["-i", "m", "--test", "--num-rep", "3", "--min-x", "0",
             "--max-x", "1023", "--show-statistics", "--show-utilization"]
    build1 = ["--build", "--num_osds", "32", "host", "{alg}", "4", "root",
              "straw2", "0", "-o", "m"]
    m5 = pms["config5"].m
    res = {}
    with tempfile.TemporaryDirectory() as d, contextlib.chdir(d):
        def hashed(name, setup, tool, argv, launches, pgs, want_rc=0):
            setup()
            kernel = cli_kernel(tool)
            (text, sec), n = counted(launches, f"CLI {name}",
                                     lambda: run_cli(tool, argv, want_rc),
                                     kernel)
            digest = hashlib.sha256(text.encode()).hexdigest()
            check(digest == want[name], f"CLI {name}: stdout sha256 "
                  f"{digest} != the JAX CLI's {want[name]}")
            for f, fsha in want_files.get(name, {}).items():
                got = hashlib.sha256(Path(f).read_bytes()).hexdigest()
                check(got == fsha, f"CLI {name}: {f} sha256 {got} != the "
                      f"JAX CLI's {fsha}")
            res[name] = {"launches": n, "kernel": kernel.record.name,
                         "seconds": sec, "mappings_per_s": pgs / sec,
                         "sha256_equal": True,
                         "files_equal": sorted(want_files.get(name, {}))}

        for name, alg in (("config1", "straw2"),
                          ("config1_straw_hosts", "straw")):
            hashed(name, lambda alg=alg: run_cli(
                crushtool, [a.format(alg=alg) for a in build1]),
                crushtool, test1, 1, 1024)
        hashed("legacy_text", lambda: run_cli(
            crushtool, ["-c", str(LEGACY_MAP), "-o", "legacy"]),
            crushtool, ["-i", "legacy", "--test", "--num-rep", "3",
                        "--max-x", "1023", "--show-mappings",
                        "--show-statistics"], 2, 2 * 1024)
        hashed("config2", lambda: save_osdmap(bench_map(*CONFIGS["config2"]),
                                              "m2"),
               osdmaptool, ["m2", "--test-map-pgs", "--pool", "0"], 1,
               CONFIGS["config2"][0])
        # the balancer's CLI: the "sets" backend, its PGs mapped once
        hashed("config2_upmap", lambda: None, osdmaptool,
               ["m2", "--upmap", "upmap.txt", "--upmap-deviation", "5",
                "--upmap-max", "10"], 1, CONFIGS["config2"][0])

        def config2_down():
            m2 = bench_map(*CONFIGS["config2"])
            for o in range(8):  # tests/test_torch_cli.py::CONFIG2_DOWN
                m2.mark_down(o)
            save_osdmap(m2, "m2down")

        # the health checks: per-PG live lanes reduced on the card
        hashed("config2_health_down", config2_down, osdmaptool,
               ["m2down", "--health"], 1, CONFIGS["config2"][0], want_rc=1)

        # config 5: the tester's x are the pool's placement seeds with
        # --pool-id 0 (pps = hash2(ps, pool) for ps < pg_num = pgp_num)
        hist = reduce.osd_histogram(pms["config5"].map_all_device(),
                                    m5.max_osd, dtype=torch.int64).cpu()
        with open("c5crush", "wb") as f:
            f.write(encode_crushmap(m5.crush))
        save_osdmap(m5, "c5")
        for name, tool, argv, pattern in (
                ("config5_crushtool", crushtool,
                 ["-i", "c5crush", "--test", "--num-rep", "3", "--min-x",
                  "0", "--max-x", str(C5_X - 1), "--pool-id", "0",
                  "--show-statistics", "--show-utilization"],
                 r"\n  device (\d+):\t\t stored : (\d+)\t"),
                ("config5_osdmaptool", osdmaptool,
                 ["c5", "--test-map-pgs", "--pool", "0"],
                 r"\nosd\.(\d+)\t(\d+)\t")):
            kernel = cli_kernel(tool)
            (text, sec), n = counted(1, f"CLI {name}",
                                     lambda: run_cli(tool, argv), kernel)
            got = cli_counts(text, pattern)
            check(len(got) > 0 and all(hist[i] == c for i, c in got.items())
                  and sum(got.values()) == int(hist.sum()),
                  f"CLI {name}: per-OSD counts == map_all_device's")
            res[name] = {"launches": n, "kernel": kernel.record.name,
                         "seconds": sec, "mappings_per_s": C5_X / sec,
                         "osds_printed": len(got), "counts_equal": True}
    emit({"phase": "cli_placement", "commands": res})
    return res


# -- the upmap balancer ----------------------------------------------------------

def reweighted(m, n_osds: int, seed: int):
    """bench.py::bench_rebalance's reweight: 2 % of the OSDs to 0.85,
    chosen by default_rng(seed)."""
    rng = np.random.default_rng(seed)
    for o in rng.choice(n_osds, max(1, n_osds // 50), replace=False):
        m.osd_weight[int(o)] = int(0x10000 * 0.85)
    return m


def plan_digest(m) -> str:
    """bench.py::_plan_digest: order-independent digest of the plan."""
    h = hashlib.sha256()
    for pg in sorted(m.pg_upmap_items):
        h.update(repr((pg, m.pg_upmap_items[pg])).encode())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def stage_times():
    """Times, with CUDA events, each DeviceState build and each
    device_loop plan (`upmap.loop_plan`: on the card one launch of the
    plan kernel and its readback) inside the calc_pg_upmaps calls of the
    block: yields a dict of lists of ms, {"build": [...], "plan": [...]}."""
    times = {"build": [], "plan": []}

    def timed(key, fn):
        def run(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            end.synchronize()
            times[key].append(start.elapsed_time(end))
            return out
        return run

    build_cls, plan_fn = state.DeviceState, upmap.loop_plan

    class TimedDeviceState(build_cls):
        __init__ = timed("build", build_cls.__init__)

    state.DeviceState = TimedDeviceState
    upmap.loop_plan = timed("plan", plan_fn)
    try:
        yield times
    finally:
        state.DeviceState, upmap.loop_plan = build_cls, plan_fn


def osd_targets(m):
    """calc_pg_upmaps's per-OSD weights and PGs per weight for a map of
    one pool: ({osd: weight}, pgs_per_weight)."""
    pool = m.pools[0]
    weight = {}
    for o, w in get_rule_weight_osd_map(m.crush, 0).items():
        adjusted = m.get_weightf(o) * w if o < m.max_osd else 0.0
        if adjusted != 0.0:
            weight[o] = adjusted
    return weight, pool.size * pool.pg_num / sum(weight.values())


def overlay_counts(m, dev) -> np.ndarray:
    """Per-OSD PG counts of the map with its upmaps, through PoolMapper
    (overlays on), on the card."""
    up = PoolMapper(m, 0, device=dev).map_all_tensors()[0]
    return reduce.osd_histogram(up, m.max_osd,
                                dtype=torch.int64).cpu().numpy()


def replay_round(r, before: np.ndarray, weight: dict, ppw: float):
    """tests/test_multichip.py::test_moves_osd_disjoint_and_individually_
    improving on one calc_pg_upmaps result: within every plan round no
    OSD is touched twice, and each move improves the objective on its
    own against the counts at its round's start.  Returns the counts
    after the moves."""
    counts = before.copy()
    by_round: dict[int, list] = {}
    for pg, frm, to, rnd in r.moves:
        by_round.setdefault(rnd, []).append((pg, frm, to))
    for rnd in sorted(by_round):
        touched: set[int] = set()
        for pg, frm, to in by_round[rnd]:
            check(frm not in touched and to not in touched,
                  f"plan round {rnd}: OSD touched twice ({frm}->{to})")
            touched |= {frm, to}
            delta = 2 * ((counts[to] - weight[to] * ppw)
                         - (counts[frm] - weight[frm] * ppw)) + 2
            check(delta < 0, f"plan round {rnd}: move {pg} {frm}->{to} "
                  f"does not improve ({delta})")
        for _, frm, to in by_round[rnd]:
            counts[frm] -= 1
            counts[to] += 1
    osds = sorted(weight)
    d = counts[osds] - np.asarray([weight[o] for o in osds]) * ppw
    check(abs(float(np.sum(d * d)) - r.stddev) < 1e-6
          and abs(float(np.max(np.abs(d))) - r.max_deviation) < 1e-6,
          "replayed counts give the plan's stddev and max_deviation")
    return counts


# The bytes of one device_loop plan round (balancer/upmap.py::_loop_plan)
# per PG of w members, from its candidate pass over the int32 rows [N, w]:
# each torch op's inputs read once and its output written once (bool 1 B,
# int32 and float32 4 B, int64 8 B); the per-OSD and per-candidate ops
# are not counted.  The least is the rows and the movable mask read once.
PLAN_PASS_BYTES = {
    "valid_m": 13,  # rows >= 0, rows < dv (4 in, 1 out each), & (2, 1)
    "rsafe": 9 + 12,  # where(valid_m, rows, 0) (5, 4); .long() (4, 8)
    "over_gather": 9 + 3,  # over[rsafe] (8, 1); & valid_m (2, 1)
    "dev_gather": 12 + 9,  # dev.float()[rsafe] (8, 4); where(.., -inf)
    "amax_argmax": 8,  # reads of the float32 rdev; per-PG outputs below
}
PLAN_PASS_PER_PG = 4 + 8 + 5 + 3 + 24 + 17 + 16  # amax, argmax outputs;
# isfinite; & movable; gather of the dominant member (index, value,
# out); where(.., dv); the scatter-min's index and values


def plan_round_bytes(n: int, w: int) -> tuple[int, int]:
    """(least, passes): the bytes a plan round over n PGs must move (the
    int32 rows and the bool movable mask read once) and the bytes the
    torch ops of its candidate pass move (PLAN_PASS_BYTES)."""
    return n * (4 * w + 1), n * (w * sum(PLAN_PASS_BYTES.values())
                                 + PLAN_PASS_PER_PG)


def rebalance_config5(dev, c5: dict, check_each: bool):
    """bench.py::bench_rebalance on config 5: three device_loop rounds
    sharing one mapper cache.  Each round is counted from 0 (one pipeline
    kernel launch, the DeviceState build).  With check_each, each round
    is replayed against the counts of the map with its upmaps mapped on
    the card before and after (outside the counted window)."""
    m = reweighted(bench_map(c5["pgs"], c5["osds"]), c5["osds"],
                   c5["reweight_seed"])
    weight, ppw = osd_targets(m)
    cache: dict = {}
    rounds, digests = [], []
    before = overlay_counts(m, dev) if check_each else None
    for entry in c5["rounds"]:
        c0 = counts("balancer")
        upmap.upmap_loop_cuda.launches = 0
        with stage_times() as st:
            t0 = time.perf_counter()
            r, n = counted(1, f"config5 round rng {entry['rng']}",
                           lambda: calc_pg_upmaps(
                               m, max_deviation=c5["max_deviation"],
                               max_iter=c5["max_iter"],
                               rng=np.random.default_rng(entry["rng"]),
                               device_cache=cache, device=dev,
                               **c5["kwargs"]),
                           pipeline.pipeline_cuda)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        c1 = counts("balancer")
        delta = {k: c1[k] - c0[k] for k in c0}
        plan_n = registry_launches(upmap.upmap_loop_cuda)
        check(plan_n == delta["plan_dispatches"] == delta["plan_host_syncs"]
              == 1, f"config5 round rng {entry['rng']}: one plan, one "
              f"upmap_loop launch ({plan_n}) and one host read "
              f"({delta['plan_host_syncs']})")
        digests.append(plan_digest(m))
        row = {"rng": entry["rng"], "wall_s": wall,
               "build_ms": st["build"], "plan_ms": st["plan"],
               # the rest of the round: host work around the two (the
               # rule weight map, the domain table, the readback)
               "other_ms": wall * 1e3 - sum(st["build"]) - sum(st["plan"]),
               "launches": n, "plan_launches": plan_n,
               "loop_rounds": delta["rounds"],
               "host_syncs": delta["plan_host_syncs"],
               "changes": r.num_changed, "stddev": r.stddev,
               "max_deviation": r.max_deviation,
               "readback_reverts": delta["plan_readback_reverts"],
               "upmap_items": len(m.pg_upmap_items),
               "digest": digests[-1]}
        if check_each:
            check(delta["plan_readback_reverts"] == 0,
                  "config5: no readback reverts")
            check(len(r.moves) == r.num_changed > 0,
                  "config5: the plan changed something and its audit "
                  "trail holds every change")
            after = overlay_counts(m, dev)
            check(np.array_equal(replay_round(r, before, weight, ppw),
                                 after),
                  "config5: the balanced map's per-OSD counts through "
                  "PoolMapper == the plan's final counts")
            before = after
        rounds.append(row)
    return m, rounds, digests


def phase_balancer_main(dev, peak: float) -> dict:
    """calc_pg_upmaps on the card.  Config 2 (100k PGs / 1024 OSDs, 2 %
    reweighted) on the four backends, each plan's digest equal to the
    JAX package's (tests/data/balancer_corpus.json).  Then config 5
    (10M PGs / 10k OSDs): three device_loop rounds, their digests equal
    to the JAX package's, every round replayed (OSD-disjoint, each move
    improving, no readback revert, the mapped counts equal to the
    plan's), stddev not rising across rounds, clean_pg_upmaps cancelling
    nothing, and a second fresh run giving the same plan."""
    corpus = json.loads(BALANCER_CORPUS.read_text())
    launches, res = {}, {"config2": {}}
    # the plan kernel's launches by path, each counted from 0
    plan_paths = res["plan_paths"] = {}
    c2 = corpus["config2"]
    for name, entry in c2["backends"].items():
        m = reweighted(bench_map(c2["pgs"], c2["osds"]), c2["osds"],
                       c2["reweight_seed"])
        c0 = counts("balancer")
        upmap.upmap_loop_cuda.launches = 0
        with stage_times() as st:
            t0 = time.perf_counter()
            r, n = counted(1, f"config2 {name}", lambda: calc_pg_upmaps(
                m, max_deviation=c2["max_deviation"],
                max_iter=c2["max_iter"], rng=np.random.default_rng(c2["rng"]),
                device=dev, **entry["kwargs"]), pipeline.pipeline_cuda)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        digest = plan_digest(m)
        plan_n = registry_launches(upmap.upmap_loop_cuda)
        syncs = counts("balancer")["plan_host_syncs"] - c0["plan_host_syncs"]
        check(plan_n == syncs == int(name == "device_loop"),
              f"config2 {name}: {plan_n} upmap_loop launches and {syncs} "
              f"host reads")
        check(digest == entry["digest"], f"config2 {name}: plan digest "
              f"{digest} != the JAX package's {entry['digest']}")
        check(r.num_changed == entry["num_changed"]
              and abs(r.stddev - entry["stddev"]) <= 1e-9,
              f"config2 {name}: changes and stddev == the JAX package's")
        launches[f"balancer_config2_{name}"] = n
        if plan_n:
            plan_paths[f"balancer_config2_{name}"] = plan_n
        res["config2"][name] = {
            "wall_s": wall, "build_ms": st["build"], "plan_ms": st["plan"],
            "launches": n, "plan_launches": plan_n,
            "changes": r.num_changed, "stddev": r.stddev,
            "max_deviation": r.max_deviation, "digest": digest,
            "digest_equal": True,
            "counters": {k: v - c0[k] for k, v in counts("balancer").items()}}

    c5 = corpus["config5"]
    torch.cuda.reset_peak_memory_stats()
    m, rounds, digests = rebalance_config5(dev, c5, check_each=True)
    least, passes = plan_round_bytes(c5["pgs"], 3)
    for r in rounds:
        r["plan_bound_ms"] = least * r["loop_rounds"] / peak * 1e3
        r["plan_pass_ms"] = passes * r["loop_rounds"] / peak * 1e3
    peak = torch.cuda.max_memory_allocated()
    for i, (row, entry) in enumerate(zip(rounds, c5["rounds"])):
        check(row["digest"] == entry["digest"],
              f"config5 round {i}: plan digest {row['digest']} != the JAX "
              f"package's {entry['digest']}")
        launches[f"balancer_config5_round{i}"] = row["launches"]
        plan_paths[f"balancer_config5_round{i}"] = row["plan_launches"]
    for a, b in zip(rounds, rounds[1:]):
        check(b["stddev"] <= a["stddev"], "config5: stddev does not rise "
              "across rounds")
    cancelled, remapped = copy.deepcopy(m).clean_pg_upmaps()
    check(not cancelled and not remapped,
          f"config5: clean_pg_upmaps cancels nothing ({len(cancelled)} "
          f"cancelled, {len(remapped)} simplified)")
    _, again, digests2 = rebalance_config5(dev, c5, check_each=False)
    check(digests2 == digests, "config5: a second fresh run gives the "
          "same plans")
    for i, row in enumerate(again):
        plan_paths[f"balancer_config5_again_round{i}"] = row["plan_launches"]
    res["config5"] = {"pgs": c5["pgs"], "osds": c5["osds"],
                      "rounds": rounds, "second_run_wall_s":
                      [r["wall_s"] for r in again],
                      "digests_equal_jax": True, "digest_stable": True,
                      "clean_pg_upmaps_cancelled": 0,
                      "peak_device_bytes": peak}
    for r in rounds:
        print(f"config5 round rng {r['rng']}: wall {r['wall_s']:.3f} s, "
              f"build {r['build_ms']} ms ({r['launches']} pipeline "
              f"launch), plan {r['plan_ms']} ms, other {r['other_ms']:.3f} "
              f"ms, {r['loop_rounds']} plan "
              f"rounds, {r['host_syncs']} host syncs, {r['changes']} "
              f"changes, stddev {r['stddev']!r}, max_deviation "
              f"{r['max_deviation']!r}", flush=True)
    print(f"config5 peak device memory {peak} bytes", flush=True)
    emit(dict(phase="balancer_main", **res))
    return launches, res


# -- the plan kernel against its plain version ---------------------------------

LOOP_RUNS = 10  # timed runs of the kernel on each plan's operands
LOOP_PLAIN_RUNS = 3  # timed runs of the plain version


def loop_digest(out) -> str:
    """tests/test_torch_upmap_kernel_host.py::outputs_digest: sha256 (16
    hex digits) of a plan's outputs (`upmap._loop_plan`'s return)."""
    cpg, cfrm, cto, crnd, crows, n_rej, rounds, counts_f = out
    data = [[int(x) for x in np.asarray(a).reshape(-1)]
            for a in (cpg, cfrm, cto, crnd, crows, counts_f)]
    return hashlib.sha256(json.dumps(
        [data, int(n_rej), int(rounds)]).encode()).hexdigest()[:16]


@contextlib.contextmanager
def plans_seen():
    """The arguments of every device_loop plan run in the block
    (`upmap.loop_plan`'s, tensors on the plan's device); each plan runs
    as it would.  Yields the list."""
    seen, real = [], upmap.loop_plan

    def spy(*args):
        seen.append(args)
        return real(*args)

    upmap.loop_plan = spy
    try:
        yield seen
    finally:
        upmap.loop_plan = real


@contextlib.contextmanager
def plan_path(paths: dict, name: str, need: bool = False):
    """Counts the plan kernel's launches over the block from 0 (read from
    the kernel registry just after) into paths[name], and checks that
    every device_loop plan the block ran on the card was one launch and
    one host read (`plan_host_syncs`); with need, at least one.  Plans a
    phase runs on the CPU (its dry runs: the plain version) are not
    counted."""
    card, real = [], upmap.loop_plan

    def spy(*args):
        if args[0].device.type != "cuda":
            return real(*args)
        s0 = counts("balancer")["plan_host_syncs"]
        out = real(*args)
        card.append(counts("balancer")["plan_host_syncs"] - s0)
        return out

    upmap.loop_plan = spy
    upmap.upmap_loop_cuda.launches = 0
    try:
        yield
    finally:
        upmap.loop_plan = real
    n = registry_launches(upmap.upmap_loop_cuda)
    check(n == len(card) and all(k == 1 for k in card),
          f"{name}: {n} upmap_loop launches for {len(card)} device_loop "
          f"plans on the card, host reads {card} (one each a plan)")
    check(n >= 1 or not need, f"{name}: no device_loop plan ran")
    paths[name] = n


def batch_ms(fn, runs: int, batches: int = 5) -> float:
    """Device ms of one fn() call: `runs` calls back to back between two
    CUDA events (the host's enqueue of a call overlaps the card's work on
    the one before), the median over `batches` batches."""
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return statistics.median(times)


def loop_checked(args, what: str, peak: float, want: str | None = None,
                 plain_runs: int = LOOP_PLAIN_RUNS) -> dict:
    """The plan kernel (one launch, one read back) and its plain version
    (`_loop_plan`, torch ops on the card) on one plan's operands: every
    output equal, and equal to the JAX plan's digest where one is given.
    Then their ms (`batch_ms`): the kernel's launch alone, LOOP_RUNS
    back to back, and the plain version whole, median of plain_runs;
    and the bound, the rows and the movable mask read once a round."""
    got = upmap._loop_kernel(*args)
    plain = upmap._loop_plan(*args)
    names = ("cpg", "cfrm", "cto", "crnd", "crows", "n_rej", "rounds",
             "counts")
    for key, a, b in zip(names, got, plain):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"loop_vs_plain {what}: the kernel's {key} == the plain "
              f"version's")
    digest = loop_digest(got)
    if want is not None:
        check(digest == want, f"loop_vs_plain {what}: plan digest "
              f"{digest} == the JAX package's {want}")

    upmap.upmap_loop_cuda(*args)  # warm
    ms = batch_ms(lambda: upmap.upmap_loop_cuda(*args), LOOP_RUNS)
    plain_ms = batch_ms(lambda: upmap._loop_plan(*args), 1,
                        batches=plain_runs)
    npg, w = (int(x) for x in args[0].shape)
    rounds = int(got[6])
    return {"pgs": npg, "w": w, "osds": int(args[5].numel()),
            "rounds": rounds, "changes": len(got[0]),
            "rejected": int(got[5]), "digest": digest,
            "equal": True, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": rounds * plan_round_bytes(npg, w)[0] / peak * 1e3,
            "bound_by": "bytes"}


def phase_loop_vs_plain(dev, peak: float) -> dict:
    """The plan kernel against its plain version on the card.  Every
    device_loop case of the CPU tests (tests/data/upmap_loop_corpus.json:
    each case's map and calls; each plan's digest the JAX package's),
    config 2's device_loop plan and config 5's three rounds run through
    calc_pg_upmaps on the card, each plan one launch of the kernel and
    one host read; then the kernel and `_loop_plan` on each plan's
    operands, every output equal, timed."""
    loop_corpus = json.loads(UPMAP_LOOP_CORPUS.read_text())["cases"]

    def mark_osd5_out(m):
        m.osd_weight[5] = 0

    then = {None: None, "mark_osd5_out": mark_osd5_out}
    res, paths = {"cases": {}}, {}
    for name, case in sorted(loop_corpus.items()):
        m = osdmap_from_reference(case["map"])
        rows = []
        for i, call in enumerate(case["calls"]):
            with plans_seen() as seen, plan_path(paths, f"{name}_{i}", True):
                calc_pg_upmaps(m, rng=np.random.default_rng(call["rng"]),
                               device=dev, **call["kwargs"])
            check(len(seen) == 1, f"loop_vs_plain {name}: one plan a call")
            rows.append(loop_checked(seen[0], f"{name} call {i}", peak,
                                     want=call["digest"]))
            if then[call["then"]] is not None:
                then[call["then"]](m)
        res["cases"][name] = rows

    c2 = json.loads(BALANCER_CORPUS.read_text())["config2"]
    entry = c2["backends"]["device_loop"]
    m = reweighted(bench_map(c2["pgs"], c2["osds"]), c2["osds"],
                   c2["reweight_seed"])
    with plans_seen() as seen, plan_path(paths, "config2", True):
        calc_pg_upmaps(m, max_deviation=c2["max_deviation"],
                       max_iter=c2["max_iter"],
                       rng=np.random.default_rng(c2["rng"]), device=dev,
                       **entry["kwargs"])
    check(plan_digest(m) == entry["digest"], "loop_vs_plain config2: the "
          "JAX package's plan digest")
    res["config2"] = loop_checked(seen[0], "config2", peak)

    c5 = json.loads(BALANCER_CORPUS.read_text())["config5"]
    # each round counted from 0 (one launch, one host read) by
    # rebalance_config5 itself
    with plans_seen() as seen:
        _, rounds, digests = rebalance_config5(dev, c5, check_each=False)
    check(digests == [r["digest"] for r in c5["rounds"]] and len(seen) == 3,
          "loop_vs_plain config5: three plans, the JAX package's digests")
    for i, r in enumerate(rounds):
        paths[f"config5_round{i}"] = r["plan_launches"]
    res["config5"] = [loop_checked(args, f"config5 round {i}", peak)
                      for i, args in enumerate(seen)]
    del seen
    res["launches_by_path"] = paths
    for key, r in [("config2", res["config2"])] + [
            (f"config5 round {i}", r) for i, r in enumerate(res["config5"])]:
        print(f"loop_vs_plain {key}: kernel {r['ms']:.6f} ms, plain "
              f"{r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms, "
              f"{r['rounds']} rounds, {r['changes']} changes", flush=True)
    emit(dict(phase="loop_vs_plain", **res))
    return res


# -- EC: every plugin's default engine ----------------------------------------

RS_CLI_SIZE = 16 * MiB  # the RS CLI lines' object, as in phase_cli
# a profile of each plugin that names no backend: the device engine
EC_DEFAULTS = {
    "jerasure": {"plugin": "jerasure", "k": "8", "m": "4"},
    "isa": {"plugin": "isa", "k": "8", "m": "4"},
    "clay": {"plugin": "clay", "k": "8", "m": "4", "d": "11"},
    "shec": {"plugin": "shec", "k": "4", "m": "3", "c": "2"},
    "lrc": {"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
}


def rs_cli_argv(plugin: str, workload: str, backend: str | None,
                iterations: int, dev) -> list[str]:
    argv = ["--plugin", plugin, "-P", "k=8", "-P", "m=4", "--size",
            str(RS_CLI_SIZE), "--iterations", str(iterations),
            "--workload", workload, "--device", str(dev)]
    if workload == "decode":
        argv += ["-e", "2"]
    if backend is not None:
        argv += ["-P", f"backend={backend}"]
    return argv


def phase_ec_defaults(dev) -> dict:
    """Each plugin through a profile that names no backend: every engine
    of it is the device engine on the card, and numpy in gives numpy out,
    equal to `backend=numpy`'s host bytes, for the encode of a 1 MiB
    object and a decode with its first and last chunks lost; its kernel
    launches are the products the same calls run on the CPU.  Then the
    RS CLI lines (jerasure, isa; encode and decode of 160 MiB) on the
    default engine and on `backend=numpy`, the default before, in turns:
    default, host, host, default."""
    launches, rng = {}, np.random.default_rng(11)
    obj = rng.integers(0, 256, MiB, dtype=np.uint8).tobytes()
    for plugin, prof in EC_DEFAULTS.items():
        code = create_erasure_code(dict(prof), device=dev)
        check(all(isinstance(e, TorchEngine) and e.device.type == dev.type
                  for e in ec_benchmark._engines(code)),
              f"{plugin}: the default engine is the device engine")
        n = code.get_chunk_count()

        def drive(c):
            enc = c.encode(set(range(n)), obj)
            have = {i: v for i, v in enc.items() if i not in (0, n - 1)}
            return enc, c.decode(set(range(n)), have)

        want = drive(create_erasure_code(dict(prof, backend="numpy"),
                                         device=dev))
        expected = cpu_launches(lambda: drive(
            create_erasure_code(dict(prof), device="cpu")))
        got, launches[plugin] = counted(expected, f"{plugin} default",
                                        lambda: drive(code))
        for g, w in zip(got, want):
            check(sorted(g) == sorted(w) and all(
                isinstance(g[i], np.ndarray) and np.array_equal(g[i], w[i])
                for i in w), f"{plugin} default: numpy out, the host bytes")
    lines = {}
    iterations, k = 10, 8
    for plugin in ("jerasure", "isa"):
        for workload in ("encode", "decode"):
            opts = ec_benchmark._parse(rs_cli_argv(plugin, workload, None,
                                                   iterations, dev))
            _, patterns = ec_benchmark.workload_inputs(opts, k + 4)
            expected = iterations if workload == "encode" else 1 + sum(
                any(i < k for i in patterns[it % len(patterns)])
                for it in range(iterations))
            for turn, backend in enumerate((None, "numpy", "numpy", None)):
                buf = io.StringIO()
                _, n = counted(
                    expected if backend is None else 0,
                    f"CLI {plugin} {workload} backend={backend}",
                    lambda: ec_benchmark.run(ec_benchmark._parse(
                        rs_cli_argv(plugin, workload, backend, iterations,
                                    dev)),
                        out=buf))
                line = buf.getvalue().strip()
                key = f"{plugin}_{workload}_{backend or 'default'}"
                lines.setdefault(key, []).append(line)
                if backend is None and turn == 0:
                    launches[f"cli_{plugin}_{workload}"] = n
    emit({"phase": "ec_defaults", "launches": launches,
          "rs_cli_seconds_kib": lines})
    for key, ls in lines.items():
        print(f"ec_benchmark {key}: {ls}", flush=True)
    return launches


# -- the mgr balancer on ClusterState -----------------------------------------

MGR_CORPUS = ROOT / "tests" / "data" / "mgr_corpus.json"
MGR_SAMPLE = 512  # sampled seeds held to the host oracle at config 5
MGR_DOWN = 8  # OSDs marked down by the scatter-path Incremental


def rows_digest(rows) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        rows.cpu().numpy(), np.int32).tobytes()).hexdigest()


def mgr_scores(pe) -> dict:
    return {"score": pe.score, "score_by_root": pe.score_by_root,
            "score_by_pool": pe.score_by_pool}


def mgr_case(case, dev, with_state: bool) -> dict:
    """tests/test_torch_mgr_balancer.py::run_case on the card (mapper
    "torch"; with_state: a ClusterState behind the MappingState, the plan
    executed into it)."""
    name, spec, mode, options, seed, stale = case
    m = balancer_cli.build_synthetic(spec)
    st = ClusterState(m, device=dev) if with_state else None
    ms = MappingState(m, synthetic_pg_stats(m), desc="current",
                      mapper="torch", device=dev, state=st)
    bal = Balancer(options=dict(options), rng=np.random.default_rng(seed))
    pe0 = bal.eval(ms)
    out = {"eval": mgr_scores(pe0), "eval_show": pe0.show(verbose=True)}
    if mode is None:
        return out
    weights = list(m.osd_weight)
    plan = bal.plan_create("p", ms, mode=mode)
    rc, detail = bal.optimize(plan)
    out.update(rc=rc, detail=detail, show=plan.show())
    if rc != 0:
        out["restored"] = (-1 not in plan.osdmap.crush.choose_args
                           and plan.osdmap.osd_weight == weights)
        return out
    pe1 = plan.final_eval or bal.eval(plan.final_state())
    out["final"] = mgr_scores(pe1)
    out["inc_sha256"] = hashlib.sha256(
        encode_incremental(plan.finalize_inc())).hexdigest()
    if stale:
        m.epoch += 1
    rc, detail = bal.execute(plan, m, state=st)
    out["execute"] = [rc, detail]
    if rc == 0:
        rows = (st.rows(0)[0] if st is not None else MappingState(
            m, mapper="torch", device=dev).pool_up_device(0))
        out["rows_sha256"] = rows_digest(rows)
    return out


def mgr_cli_cases(corpus: dict, tmp: Path, dev) -> dict:
    """The corpus's CLI cases in order in `tmp`, `--mapper host` replaced
    by `--mapper torch --device <dev>`: {name: {"rc", "stdout",
    "files"}}."""
    out = {}
    for name, argv, files in corpus["cli_inputs"]:
        argv = [str(tmp / a) if a.endswith((".inc", ".bin")) else a
                for a in argv]
        if "--mapper" in argv:
            i = argv.index("--mapper")
            argv[i:i + 2] = ["--mapper", "torch", "--device", str(dev)]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = balancer_cli.main(argv)
        out[name] = {"rc": rc,
                     "stdout": buf.getvalue().replace(f"{tmp}/", ""),
                     "files": {f: hashlib.sha256(
                         (tmp / f).read_bytes()).hexdigest() for f in files}}
    return out


def timed(fn):
    """fn() synchronised on both sides, with the pipeline kernel's launch
    count set to 0 just before and read just after: (out, s, launches)."""
    torch.cuda.synchronize()
    pipeline.pipeline_cuda.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, pipeline.pipeline_cuda.launches


def state_rows_checked(st, step: str, seeds: np.ndarray, dev) -> dict:
    """Hold a state's rows of pool 0 to a fresh ClusterState on the same
    map (bit-equal) and, on every overlay seed and the sampled seeds, to
    `host_up`.  Outside the counted windows; `check_s` is its host-clock
    seconds (the host oracle's descents, memoised by `host_up` until a
    descent input changes)."""
    t0 = time.perf_counter()
    rows = st.rows(0)[0]
    fresh = ClusterState(st.m, device=dev).rows(0)[0]
    check(torch.equal(rows, fresh),
          f"mgr {step}: rows == a fresh ClusterState's")
    over = np.asarray(st._overlay_seeds(0), np.int64)
    seeds = np.union1d(seeds, over)
    got = rows[torch.from_numpy(seeds).to(dev)].cpu().numpy()
    for s, row in zip(seeds.tolist(), got):
        check([int(o) for o in row if o != ITEM_NONE] == st.host_up(0, s),
              f"mgr {step}: seed {s} == host_up")
    return {"overlay_seeds": len(over), "checked_seeds": len(seeds),
            "check_s": time.perf_counter() - t0}


def phase_mgr_balancer(dev, smi: str) -> dict:
    """The mgr balancer on ClusterState.  Config 5 (10M PGs, 10k OSDs):
    the state and a MappingState on it, an eval, an upmap plan
    (device_loop, 16 candidates, 10 optimizations) executed into the
    state (one delta, no rebuild), then two value-only Incrementals
    through `state.apply`: 8 OSDs marked down (the 32-lane scatter) and
    2 % reweighted to 0.85 (a vector re-upload).  After each step the
    rows equal a fresh state's, and the overlay seeds and MGR_SAMPLE
    sampled seeds `host_up`.  Then crush-compat on config 2 with 25
    iterations, the balancer CLI on config 2 (optimize --plan-out, show,
    execute), and every entry of tests/data/mgr_corpus.json on the card.
    Each step's pipeline kernel launches are counted from 0."""
    launches, steps = {}, {}
    torch.cuda.reset_peak_memory_stats()
    n_pgs, n_osds = CONFIGS["config5"]
    m = bench_map(n_pgs, n_osds)
    st, s, n = timed(lambda: ClusterState(m, device=dev))
    steps["state_build"] = {"s": s, "launches": n}
    _, s, n = timed(lambda: st.rows(0))
    steps["first_rows"] = {"s": s, "launches": n}
    check(n == 1, "mgr: the first rows are one launch")
    ms = MappingState(m, synthetic_pg_stats(m, objects_per_pg=64),
                      mapper="torch", state=st)
    bal = Balancer(options={"upmap_state_backend": "device_loop",
                            "upmap_candidate_batch": 16,
                            "upmap_max_optimizations": 10},
                   rng=np.random.default_rng(0))
    pe0, s, n = timed(lambda: bal.eval(ms))
    steps["eval"] = {"s": s, "launches": n, "score": pe0.score}
    check(n == 0 and 0 < pe0.score < 1, "mgr eval: the state's rows, "
          "no launch, a score in (0, 1)")
    plan = bal.plan_create("p", ms, mode="upmap")
    (rc, detail), s, n = timed(lambda: bal.optimize(plan))
    steps["optimize"] = {"s": s, "launches": n,
                         "changes": len(plan.inc.new_pg_upmap_items)}
    check(rc == 0 and n == 0 and 0 < len(plan.inc.new_pg_upmap_items) <= 10,
          f"mgr optimize: rc {rc} ({detail}), the state's rows")
    c0 = counts("state")
    (rc, _), s, n = timed(lambda: bal.execute(plan, st.m, state=st))
    steps["execute"] = {"s": s, "launches": n,
                        "device_put_bytes": counts("state")[
                            "device_put_bytes"] - c0["device_put_bytes"]}
    check(rc == 0 and (st.delta_applies, st.full_rebuilds) == (1, 1)
          and steps["execute"]["device_put_bytes"] == 0,
          "mgr execute: one delta, no rebuild, no upload")
    rng = np.random.default_rng(5)
    seeds = np.unique(rng.integers(0, n_pgs, MGR_SAMPLE))
    _, s, n = timed(lambda: st.rows(0))
    steps["execute"].update(rows_s=s, rows_launches=n)
    check(n == 1, "mgr execute: the rows after it are one raw launch")
    steps["execute"].update(state_rows_checked(st, "execute", seeds, dev))
    pe1 = bal.eval(MappingState(st.m, ms.pg_stats, state=st))
    steps["execute"]["score"] = pe1.score
    up = [o for o in range(n_osds) if st.m.is_up(o)]
    incs = {
        "down": lambda inc: inc.new_state.update(
            {int(o): OSD_UP for o in rng.choice(up, MGR_DOWN,
                                                replace=False)}),
        "reweight": lambda inc: inc.new_weight.update(
            {int(o): int(0x10000 * 0.85) for o in rng.choice(
                n_osds, n_osds // 50, replace=False)}),
    }
    rows_launches = {"down": 1, "reweight": 2}  # reweights change raw rows
    for step, fill in incs.items():
        inc = Incremental(epoch=st.m.epoch + 1)
        fill(inc)
        # O(delta): one 32-lane block of the four vectors and the index
        # (14 B a lane), or, past 32 OSDs, one re-upload of the vectors
        # (DV + 1 entries of 1 + 1 + 4 + 4 B)
        k = len(inc.new_state) + len(inc.new_weight)
        uploads = (32 * 14 if k <= 32 and 2 * k < st.DV
                   else (st.DV + 1) * 10)
        c0 = counts("state")
        kind, s, n = timed(lambda: st.apply(inc))
        put = counts("state")["device_put_bytes"] - c0["device_put_bytes"]
        _, rs, rn = timed(lambda: st.rows(0))
        steps[step] = {"kind": kind, "apply_s": s, "launches": n,
                       "device_put_bytes": put, "rows_s": rs,
                       "rows_launches": rn}
        check(kind == "delta" and n == 0 and put == uploads
              and rn == rows_launches[step],
              f"mgr {step}: {kind}, {put} bytes up (O(delta): "
              f"{uploads}), rows {rn} launches")
        steps[step].update(state_rows_checked(st, step, seeds, dev))
    check((st.full_rebuilds, st.delta_applies) == (1, 3),
          "mgr: one build, three deltas")
    for step in ("execute", "down", "reweight"):
        launches[f"mgr_config5_{step}"] = steps[step]["rows_launches"]
    launches["mgr_config5_first_rows"] = steps["first_rows"]["launches"]
    peak = torch.cuda.max_memory_allocated()

    # crush-compat on config 2 with the default 25 iterations, executed
    # into a ClusterState
    m2 = bench_map(*CONFIGS["config2"])
    st2 = ClusterState(m2, device=dev)
    ms2 = MappingState(m2, synthetic_pg_stats(m2), state=st2)
    bal2 = Balancer(rng=np.random.default_rng(7))
    plan2 = bal2.plan_create("c", ms2, mode="crush-compat")
    score0 = bal2.eval(ms2).score
    (rc, detail), s, n = timed(lambda: bal2.optimize(plan2))
    check(rc == 0, f"mgr crush-compat config2: rc {rc} ({detail})")
    check(plan2.final_eval.score < score0,
          "mgr crush-compat config2: the plan's score is strictly better")
    (rc, _), es, en = timed(lambda: bal2.execute(plan2, m2, state=st2))
    rows = st2.rows(0)[0]
    fresh = PoolMapper(st2.m, 0, device=dev,
                       overlays=False).map_all_device()
    check(rc == 0 and torch.equal(rows, fresh) and -1 in st2.m.crush
          .choose_args, "mgr crush-compat config2: executed rows == a "
          "fresh mapper's")
    steps["compat_config2"] = {
        "optimize_s": s, "launches": n, "execute_s": es,
        "score": score0, "final_score": plan2.final_eval.score,
        "weight_set_osds": len(plan2.compat_ws)}
    launches["mgr_compat_config2"] = n

    # the balancer CLI on config 2: optimize --plan-out, show, execute
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        save_osdmap(bench_map(*CONFIGS["config2"]), str(d / "c2.bin"))
        cli = {}
        for name, argv in (
                ("optimize", ["-i", str(d / "c2.bin"), "optimize", "p",
                              "--plan-out", str(d / "p.inc"),
                              "--device", str(dev)]),
                ("show", ["show", str(d / "p.inc")]),
                ("execute", ["-i", str(d / "c2.bin"), "execute",
                             str(d / "p.inc"), "-o", str(d / "o.bin")])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc, s, n = timed(lambda: balancer_cli.main(argv))
            out = buf.getvalue()
            check(rc == 0, f"balancer CLI {name}: rc {rc}")
            cli[name] = {"s": s, "launches": n, "lines": len(
                out.splitlines()), "last": out.splitlines()[-1]}
            launches[f"mgr_cli_config2_{name}"] = n
        check("score" in cli["optimize"]["last"] or "wrote" in
              cli["optimize"]["last"], "balancer CLI optimize output")
        check(cli["execute"]["last"].startswith("wrote epoch 2"),
              "balancer CLI execute: the map moved one epoch")
    steps["cli_config2"] = cli

    # the corpus, on the card
    corpus = json.loads(MGR_CORPUS.read_text())
    for case in corpus["case_inputs"]:
        want = corpus["cases"][case[0]]
        for with_state in (False, True):
            got = mgr_case(case, dev, with_state)
            check(json.loads(json.dumps(got)) == want,
                  f"mgr corpus {case[0]} (state {with_state}) == the JAX "
                  f"package's")
    with tempfile.TemporaryDirectory() as d:
        check(mgr_cli_cases(corpus, Path(d), dev) == corpus["cli"],
              "mgr corpus: the balancer CLI's stdout and files == the JAX "
              "CLI's")
    res = {"steps": steps, "peak_device_bytes": peak,
           "corpus_cases": len(corpus["case_inputs"]),
           "corpus_equal": True, "sample": MGR_SAMPLE}
    emit(dict(phase="mgr_balancer", **res))
    c5 = (f"config5: state {steps['state_build']['s'] * 1e3:.6f} ms, "
          f"first rows {steps['first_rows']['s'] * 1e3:.6f} ms "
          f"({steps['first_rows']['launches']} pipeline launch), eval "
          f"{steps['eval']['s']:.6f} s ({steps['eval']['launches']}), "
          f"optimize {steps['optimize']['s']:.6f} s "
          f"({steps['optimize']['launches']}), execute "
          f"{steps['execute']['s']:.6f} s ({steps['execute']['launches']};"
          f" rows after {steps['execute']['rows_s'] * 1e3:.6f} ms, "
          f"{steps['execute']['rows_launches']})")
    for step in ("down", "reweight"):
        r = steps[step]
        c5 += (f", {step} apply {r['apply_s'] * 1e3:.6f} ms "
               f"({r['launches']}; rows after {r['rows_s'] * 1e3:.6f} ms, "
               f"{r['rows_launches']}; {r['device_put_bytes']} B up)")
    c2 = steps["compat_config2"]
    print(f"mgr on {smi}: {c5}; peak device memory {peak} bytes; config2 "
          f"crush-compat optimize {c2['optimize_s']:.6f} s "
          f"({c2['launches']}), score {c2['score']!r} -> "
          f"{c2['final_score']!r}; CLI " + ", ".join(
              f"{k} {v['s']:.6f} s ({v['launches']})"
              for k, v in steps["cli_config2"].items()), flush=True)
    return launches, res


# -- placement diagnostics and the failure simulator ----------------------------

EXPLAIN_CORPUS = ROOT / "tests" / "data" / "explain_corpus.json"
DIAG_SAMPLE = 512  # config-5 seeds whose histogram is held to mapper_ref
PLANE_FREE = 1 * MiB  # the most diagnose() may take beyond its start
SIM_SAMPLE = 32  # seeds a failure_sim epoch holds to the host oracle


PLACEMENT_KERNELS = (mapper.crush_rule_cuda, mapper.crush_rule_diag_cuda,
                     pipeline.pipeline_cuda)
# the diagnostics kernel's launches by instance ("<mode>_g<G>") over every
# run count_placement counts
DIAG_INSTANCES: dict[str, int] = {}
DIAG_SMALL = (64, 512, 8192)  # config-5 seeds of the small planes launches


def count_placement(fn):
    """fn() with the three placement kernels' launch counts set to 0 just
    before and read just after: (out, rule launches, diag launches,
    pipeline launches); the diagnostics launches by instance are added to
    DIAG_INSTANCES."""
    for k in PLACEMENT_KERNELS:
        k.launches = 0
    mapper.DIAG_LAUNCHES.clear()
    out = fn()
    for key, n in mapper.DIAG_LAUNCHES.items():
        DIAG_INSTANCES[key] = DIAG_INSTANCES.get(key, 0) + n
    return (out, *(registry_launches(k) for k in PLACEMENT_KERNELS))


def summary_checked(T, prog, want: dict, runs: dict, what: str) -> int:
    """Each summary-mode launch of `runs` (label -> fn(bound, stage)), with
    the wrapper's staging and with none, at the plan's bound and at bound
    1, equal to the plain planes `want` reduced (summary_of_planes):
    integer sums, so equal, not close.  Returns the max abs error (0)."""
    err = 0
    for bound in (prog.diag_tries_bound, 1):
        plain = mapper.summary_of_planes(prog, want, bound)
        for label, fn in runs.items():
            for stage in (None, 0):
                got = fn(bound, stage)
                torch.cuda.synchronize()
                err = max(err, int((got - plain).abs().max()))
                check(torch.equal(got, plain),
                      f"diag summary == plain ({what}, {label}, bound "
                      f"{bound}, stage {stage}): {got.tolist()} != "
                      f"{plain.tolist()}")
    return err


def diag_checked(T, prog, x, w, what: str, pm: PoolMapper | None = None
                 ) -> tuple[int, dict]:
    """The diagnostics kernel on seeds x against its plain version: planes
    mode (the wrapper's staging and none) plane for plane, its rows
    against crush_rule_cuda's; summary mode on the seeds as given and,
    for a pool's first PGs (pm: x their placement seeds), on the PG seeds
    as a tensor and as a range, the placement seed computed in the lane
    (summary_checked).  Returns (max abs error, the plain planes)."""
    rows, _, want = mapper.crush_rule_plain(T, prog, x, w, diag=True)
    xb, wb = mapper.u32_bits(x), mapper.kernel_weights(w)
    default = mapper.crush_rule_cuda(T, prog, xb, wb)
    err = 0
    for stage in (None, 0):
        got_rows, got = mapper.crush_rule_diag_cuda(T, prog, xb, wb,
                                                    stage=stage)
        torch.cuda.synchronize()
        check(torch.equal(got_rows, rows) and torch.equal(default, rows),
              f"diag rows == plain rows == crush_rule rows ({what})")
        for k, v in want.items():
            if v.numel():
                err = max(err, int((got[k].long() - v.long()).abs().max()))
            check(torch.equal(got[k], v),
                  f"diag plane {k} == plain ({what}, stage {stage})")
    runs = {"seeds": lambda b, st: mapper.crush_rule_diag_summary_cuda(
        T, prog, xb, wb, b, stage=st)}
    if pm is not None:
        ps = torch.arange(x.numel(), device=x.device)
        runs["pg_seeds"] = lambda b, st: mapper.crush_rule_diag_summary_cuda(
            T, prog, ps, wb, b, pm.pool_seeds(), stage=st)
        runs["pg_range"] = lambda b, st: mapper.crush_rule_diag_summary_cuda(
            T, prog, range(x.numel()), wb, b, pm.pool_seeds(), stage=st)
    err = max(err, summary_checked(T, prog, want, runs, what))
    return err, want


def diag_group_sweep() -> list[tuple[int, int]]:
    """(G, n) for every group a diagnostics launch chooses: the largest
    odd n a launch maps with G lanes a seed, in both modes, each held to
    `mapper.diag_group_size`."""
    plan = mapper.diag_launch_plan(torch.cuda.current_device())
    resident = plan.blocks_per_sm * plan.threads * plan.sms
    sweep = [(g, (resident // g - 1) | 1) for g in mapper.GROUPS]
    for g, n in sweep:
        for mode in mapper.DIAG_MODES:
            check(mapper.diag_group_size(n, mode) == g,
                  f"crush_rule_diag: {n} seeds in {mode} map with group "
                  f"{g} ({mapper.diag_group_size(n, mode)})")
    return sweep


def diag_small_bytes(pm: PoolMapper, rows: torch.Tensor, mode: str,
                     seed_bytes: int, bound: int) -> int:
    """The bytes a diagnostics launch of n seeds whose rows are `rows`
    moves at the least: its seeds, its outputs (planes mode: the rows and
    planes; summary mode: bound + 6 counters), the plan, and what
    touched_bytes reckons of the map with those OSDs' reweights."""
    n = rows.shape[0]
    touched, n_osds = touched_bytes(pm, rows)
    out = (plane_bytes(pm.prog, n) + 4 * n * pm.prog.result_max
           if mode == "planes" else 8 * (bound + 6))
    return (seed_bytes * n + out + pm.prog.diag_plan.nbytes + touched
            + 4 * n_osds)


def bound_of(ops: float, nbytes: int, issue_rate: float,
             peak: float) -> dict:
    """A launch's bound: the larger of its operations over the issue rate
    and its bytes over the HBM rate."""
    ops_ms, bytes_ms = ops / issue_rate * 1e3, nbytes / peak * 1e3
    return {"ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase_diag_vs_plain(dev, corpus: dict, pms: dict, draws: torch.Tensor,
                        peak: float) -> tuple[int, dict]:
    """The diagnostics kernel against its plain version, in both modes
    (diag_checked: every plane element-exact, every summary equal), on
    every placement corpus map, every legacy case, the diag cases of
    tests/data/explain_corpus.json (an indep EC rule, and the cases the
    JAX plan leaves inexact: 2 hosts for size 3, vary_r=0 and stable=0,
    leafy indep, two weight-set positions), config 5's first 2^20 PGs
    (timed: the plain version against the kernel in both modes), and
    config 5's first n PGs for every group a launch chooses and n in
    DIAG_SMALL, each checked in both modes and timed (device_ms: the
    stream held while the host enqueues, L2 flushed; warm beside it)
    against its bound (`draws`: the plain rule's draws of config 5's
    first PGs, phase 1's) and the plain version on the card."""
    worst, cases = 0, []

    def case(name, T, prog, x, w, pm=None):
        nonlocal worst
        err, _ = diag_checked(T, prog, x, w, name, pm)
        worst = max(worst, err)
        cases.append({"case": name, "seeds": x.numel(),
                      "group": mapper.diag_group_size(x.numel()),
                      "lanes": prog.diag_lanes, "steps": prog.diag_steps})

    for name, entry in corpus.items():
        pm = PoolMapper(osdmap_from_reference(entry["map"]),
                        entry["pool_id"], device=dev)
        case(f"placement_{name}", pm.tables, pm.prog,
             *rule_inputs(pm, pm.spec.pg_num), pm)
    stored = [("legacy", e) for e in
              json.loads(LEGACY_CASES.read_text())["cases"]]
    stored += [("diag", e) for e in
               json.loads(EXPLAIN_CORPUS.read_text())["diag_cases"]]
    for kind, e in stored:
        cm = crush_from_reference(e["map"])
        A = soa.build_arrays(cm, cm.choose_args.get(e["choose_args"]))
        case(f"{kind}_{e['name']}", soa.to_device(A, dev),
             mapper.compile_rule(A, e["ruleno"], e["result_max"]),
             torch.tensor(e["xs"], dtype=torch.long, device=dev),
             torch.tensor(e["weights"], dtype=torch.long, device=dev))
    pm = pms["config5"]
    T, prog = pm.tables, pm.prog
    x, w = rule_inputs(pm, PLAIN_BLOCK)
    err, want = diag_checked(T, prog, x, w, "config5 block", pm)
    worst = max(worst, err)
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    warm = torch.empty(1, dtype=torch.uint8, device=dev)
    xb, wb = mapper.u32_bits(x), mapper.kernel_weights(w)
    bound = min(prog.diag_tries_bound, 63)  # diagnose()'s
    block = {
        "pgs": PLAIN_BLOCK,
        "group": mapper.diag_group_size(PLAIN_BLOCK),
        "plain_ms": time_ms(lambda: mapper.crush_rule_plain(
            T, prog, x, w, diag=True), flush, runs=1, warmup=0),
        "ms": time_ms(lambda: mapper.crush_rule_diag_cuda(
            T, prog, xb, wb), flush, runs=7),
        "summary_ms": time_ms(lambda: mapper.crush_rule_diag_summary_cuda(
            T, prog, range(PLAIN_BLOCK), wb, bound, pm.pool_seeds()),
            flush, runs=7),
    }
    cases.append({"case": "config5_block", "seeds": PLAIN_BLOCK, **block})

    # every group a launch chooses, and the small shapes: both modes ==
    # the 2^20 block's plain planes on their prefix
    clock = max_sm_clock_hz()
    issue_rate = H100_SMS * SCHEDULERS_PER_SM * WARP * clock
    small = {}
    sweep = diag_group_sweep()
    for g, n in sweep + [(mapper.diag_group_size(n), n) for n in DIAG_SMALL]:
        sub = {k: v[:n] for k, v in want.items()}
        rows, got = mapper.crush_rule_diag_cuda(T, prog, xb[:n], wb)
        for k, v in sub.items():
            check(torch.equal(got[k], v),
                  f"diag plane {k} == plain (config 5's first {n}, G {g})")
        err = summary_checked(T, prog, sub, {
            "pg_range": lambda b, st, n=n: mapper.crush_rule_diag_summary_cuda(
                T, prog, range(n), wb, b, pm.pool_seeds(), stage=st)},
            f"config 5's first {n}, G {g}")
        worst = max(worst, err)
        if n not in DIAG_SMALL:
            continue
        n_draws = int(draws[:n].sum())
        for mode in mapper.DIAG_MODES:
            if mode == "planes":
                def launch(n=n):
                    return mapper.crush_rule_diag_cuda(T, prog, xb[:n], wb)

                def plain(n=n):
                    return mapper.crush_rule_plain(T, prog, x[:n], w,
                                                   diag=True)
                ops = n_draws * OPS_PER_DRAW
                nbytes = diag_small_bytes(pm, rows, mode, 4, bound)
            else:
                def launch(n=n):
                    return mapper.crush_rule_diag_summary_cuda(
                        T, prog, range(n), wb, bound, pm.pool_seeds())

                def plain(n=n):
                    return mapper.diag_summary_plain(T, prog, x[:n], w,
                                                     bound)
                ops = n_draws * OPS_PER_DRAW + n * HASH2_OPS
                nbytes = diag_small_bytes(pm, rows, mode, 0, bound)
            ms = device_ms(launch, flush, clock)
            b = bound_of(ops, nbytes, issue_rate, peak)
            small[f"{mode}_{n}"] = {
                "mode": mode, "pgs": n, "group": g, "ms": ms,
                "warm_ms": device_ms(launch, warm, clock),
                "plain_ms": time_ms(plain, flush, runs=1, warmup=1),
                "draws": n_draws, "hbm_bytes": nbytes, **b,
                "bound_share": b["bound_ms"] / ms}
    emit({"phase": "diag_vs_plain", "cases": cases, "max_abs_err": worst,
          "equal": True, "group_sweep": sweep, "small": small,
          "ptxas": build.ptxas_report("crush/csrc/crush_rule_diag.cu"),
          "plan": vars(mapper.diag_launch_plan(torch.cuda.current_device()))})
    return worst, {"block": block, "small": small}


def plane_bytes(prog, n: int) -> int:
    """The diagnostics' extra output: tries, steps and the 4 tallies."""
    return 4 * n * (prog.diag_lanes + prog.diag_steps * prog.result_max + 4)


def phase_diagnose_main(dev, pms: dict, n_draws: int, peak: float) -> dict:
    """PoolMapper.diagnose() over all of config 5's PGs, without and with
    a ClusterState, each counted from 0 (one summary-mode diagnostics
    launch, no rule or pipeline launch) with the device memory it takes
    beyond what it started with (no plane: under PLANE_FREE bytes, beside
    the planes' plane_bytes); the two summaries equal, and equal to the
    planes of a planes-mode pass over every PG reduced (the two modes of
    the kernel at full size); over 512 sampled seeds, the histogram equal
    to the host oracle's.  Timed (CUDA events, L2 flushed): the summary
    kernel as diagnose() launches it, the planes kernel, the default rule
    kernel and the pipeline kernel (mode up, row 6) on the same PGs, and
    the 512-seed sample's launch (device_ms); diagnose's entry on the host
    clock, all of the pool and the sample."""
    pm = pms["config5"]
    n = pm.spec.pg_num
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    out = {"pgs": n, "plane_bytes": plane_bytes(pm.prog, n)}
    state = ClusterState(pm.m, device=dev)
    for label, mpr in (("mapper", pm), ("state",
                                        PoolMapper(pm.m, 0, state=state))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        s, rule_n, diag_n, pipe_n = count_placement(
            lambda: mpr.diagnose(record=False))
        sec = time.perf_counter() - t0
        extra = torch.cuda.max_memory_allocated(dev) - base
        check((rule_n, diag_n, pipe_n) == (0, 1, 0),
              f"diagnose ({label}): {rule_n} rule, {diag_n} diag, "
              f"{pipe_n} pipeline launches")
        check(s["pgs"] == n and s["diag_exact"] and s["unresolved"] == 0,
              f"diagnose ({label}) covers every PG")
        check(extra < PLANE_FREE,
              f"diagnose ({label}) allocates no plane: {extra} bytes "
              f"beyond its start (the planes: {out['plane_bytes']})")
        out[label] = {"s": sec, "diag_launches": diag_n,
                      "extra_device_bytes": extra, "summary": {
                          k: v for k, v in s.items()
                          if k != "tries_histogram"},
                      "tries_histogram_head": s["tries_histogram"][:8]}
        out.setdefault("summary", s)
        check(s == out["summary"], "diagnose with a ClusterState == without")
    s = out["summary"]
    bound = s["tries_bound"]
    x, w = rule_inputs(pm, n)
    _, planes = mapper.diag_rule(pm.tables, pm.prog, x, w)
    got = mapper.summary_of_planes(pm.prog, planes, bound).tolist()
    check(got == s["tries_histogram"] + [
        s[k] for k in ("collisions", "rejections", "skips", "bad_mappings",
                       "retry_exhausted")],
          "diagnose's summary == the planes of every PG, reduced")
    booked = int((planes["tries"] >= 0).sum())
    check(sum(s["tries_histogram"]) == booked,
          "the histogram's total == the placements the planes book")
    check(booked + s["retry_exhausted"] == n * pm.prog.diag_lanes,
          "booked + unplaced == every placement lane")
    del planes
    rng = np.random.default_rng(9)
    sample = np.sort(rng.choice(n, DIAG_SAMPLE, replace=False))
    got = pm.diagnose(sample, record=False)["tries_histogram"]
    crush = pm.m.crush
    crush.choose_tries_histogram = [0] * (crush.tunables.choose_total_tries
                                          + 1)
    sample_ps = torch.from_numpy(sample).to(dev)
    pps = pm.placement_seeds(sample_ps)
    weights = pm.rule_weights().cpu().tolist()
    t0 = time.perf_counter()
    for xv in pps.cpu().tolist():
        mapper_ref.do_rule(crush, pm.spec.ruleno, xv, 3, weights,
                           collect_choose_tries=True)
    host_s = time.perf_counter() - t0
    check(got == crush.choose_tries_histogram[:len(got)],
          f"diagnose histogram == mapper_ref's over {DIAG_SAMPLE} seeds")
    crush.choose_tries_histogram = None
    xb, wb = mapper.u32_bits(x), mapper.kernel_weights(w)
    ps = torch.arange(n, device=dev)
    out["ms"] = time_ms(lambda: mapper.crush_rule_diag_summary_cuda(
        pm.tables, pm.prog, range(n), wb, bound, pm.pool_seeds()), flush,
        runs=7)
    out["planes_ms"] = time_ms(lambda: mapper.crush_rule_diag_cuda(
        pm.tables, pm.prog, xb, wb), flush, runs=7)
    out["default_ms"] = time_ms(lambda: mapper.crush_rule_cuda(
        pm.tables, pm.prog, xb, wb), flush, runs=7)
    out["pipeline_ms"] = time_ms(lambda: pipeline.pipeline_cuda(
        pm, ps, "up"), flush, runs=7)
    out["diagnose_ms"] = wall_ms(lambda: pm.diagnose(record=False), flush,
                                 runs=5)
    clock = max_sm_clock_hz()
    issue_rate = H100_SMS * SCHEDULERS_PER_SM * WARP * clock
    # the sample's launch, as diagnose(sample) makes it
    _, sample_draws = mapper.crush_rule_plain(pm.tables, pm.prog, pps, w)

    def sample_launch():
        return mapper.crush_rule_diag_summary_cuda(
            pm.tables, pm.prog, sample_ps, wb, bound, pm.pool_seeds())

    sample_rows = mapper.crush_rule_cuda(pm.tables, pm.prog,
                                         mapper.u32_bits(pps), wb)
    out["sample_launch"] = {
        "pgs": DIAG_SAMPLE, "group": mapper.diag_group_size(
            DIAG_SAMPLE, "summary"),
        "ms": device_ms(sample_launch, flush, clock),
        "diagnose_ms": wall_ms(lambda: pm.diagnose(sample, record=False),
                               flush, runs=9),
        **bound_of(int(sample_draws.sum()) * OPS_PER_DRAW
                   + DIAG_SAMPLE * HASH2_OPS,
                   diag_small_bytes(pm, sample_rows, "summary", 8, bound),
                   issue_rate, peak)}
    # the default kernel's draws on these seeds (placement_main counts
    # them): the variant makes the same draws; summary mode adds the seed
    # hash a PG and writes bound + 6 counters, planes mode writes planes
    summary_bytes = (rule_bytes(pm.tables, pm.prog, w.numel(), n)
                     - 4 * n * (1 + pm.prog.result_max) + 8 * (bound + 6))
    planes_bytes = (rule_bytes(pm.tables, pm.prog, w.numel(), n)
                    + plane_bytes(pm.prog, n))
    out.update({
        "draws": n_draws, "hbm_bytes": summary_bytes,
        **bound_of(n_draws * OPS_PER_DRAW + n * HASH2_OPS, summary_bytes,
                   issue_rate, peak),
        "planes": {"hbm_bytes": planes_bytes, **bound_of(
            n_draws * OPS_PER_DRAW, planes_bytes, issue_rate, peak)},
        "sample": DIAG_SAMPLE, "sample_host_s": host_s,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
    })
    out.pop("summary")
    emit(dict(phase="diagnose_main", **out))
    return out


def phase_explain_cli(dev, pms: dict) -> dict:
    """`crushtool explain` and `--locate-divergence` (clean, and against a
    perturbed-tunables map) on the map files of tests/test_torch_explain.py,
    on the card, each stdout's sha256 and exit code equal to the JAX
    CLI's (tests/data/explain_corpus.json), each counted from 0; then
    `--test --show-choose-tries` on config 5's map over x 0..2^20-1, its
    histogram equal to the plain version's planes."""
    corpus = json.loads(EXPLAIN_CORPUS.read_text())
    res = {}
    with tempfile.TemporaryDirectory() as d, contextlib.chdir(d):
        for name, f in corpus["maps"].items():
            Path(name).write_bytes(base64.b64decode(f))
        for name, case in corpus["cli"].items():
            argv = ["-i", case["maps"][0], *case["argv"]]
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc, rule_n, diag_n, pipe_n = count_placement(
                    lambda: crushtool.main(list(argv)))
            sec = time.perf_counter() - t0
            text = out.getvalue()
            check(rc == case["rc"], f"crushtool {name}: rc {rc}")
            digest = hashlib.sha256(text.encode()).hexdigest()
            check(digest == case["sha256"], f"crushtool {name}: stdout "
                  f"sha256 {digest} != the JAX CLI's {case['sha256']}")
            want = 1 if "--locate-divergence" in argv else 0
            check((rule_n, diag_n, pipe_n) == (0, want, 0),
                  f"crushtool {name}: {rule_n} rule, {diag_n} diag, "
                  f"{pipe_n} pipeline launches")
            res[name] = {"rc": rc, "seconds": sec, "sha256_equal": True,
                         "diag_launches": diag_n}
        pm = pms["config5"]
        with open("c5crush", "wb") as f:
            f.write(encode_crushmap(pm.m.crush))
        argv = ["-i", "c5crush", "--test", "--num-rep", "3", "--min-x", "0",
                "--max-x", str(PLAIN_BLOCK - 1), "--show-choose-tries"]
        ((text, sec), rule_n, diag_n, pipe_n) = count_placement(
            lambda: run_cli(crushtool, argv))
        check((rule_n, diag_n, pipe_n) == (1, 1, 0),
              f"--show-choose-tries: {rule_n} rule, {diag_n} diag, "
              f"{pipe_n} pipeline launches")
        got = cli_counts(text, r"\n (\d+): (\d+)")
        x = torch.arange(PLAIN_BLOCK, device=dev)
        w = torch.full((pm.m.crush.max_devices,), 0x10000, device=dev)
        _, _, planes = mapper.crush_rule_plain(pm.tables, pm.prog, x, w,
                                               diag=True)
        want = reduce.value_histogram(
            planes["tries"], pm.prog.choose_total_tries).cpu().tolist()
        last = max(i for i, v in enumerate(want) if v)
        check(got == {i: want[i] for i in range(last + 1)},
              "--show-choose-tries histogram == the plain version's")
        res["config5_show_choose_tries"] = {
            "seconds": sec, "rule_launches": rule_n, "diag_launches": diag_n,
            "placements": sum(want), "histogram_equal": True}
    emit({"phase": "explain_cli", "commands": res})
    return res


def numpy_report(before, after, size: int) -> dict:
    """The JAX diff_mappings semantics, written here in numpy over the
    fetched up rows: per PG the ordered non-NONE list changed, the OSDs
    that entered it, a changed up_primary, fewer than size OSDs."""
    (up1, p1), (up2, p2) = before, after

    def listed(up):
        out = up.copy()
        holes = np.nonzero((up == ITEM_NONE).any(1))[0]
        order = np.argsort(up[holes] == ITEM_NONE, axis=1, kind="stable")
        out[holes] = np.take_along_axis(up[holes], order, 1)
        return out

    a, b = listed(up1), listed(up2)
    remapped = (a != b).any(1)
    new = b != ITEM_NONE
    for j in range(b.shape[1]):
        new[:, j] &= (a != b[:, j:j + 1]).all(1)
        new[:, j] &= (b[:, :j] != b[:, j:j + 1]).all(1)
    return {"total_pgs": len(up1), "pgs_remapped": int(remapped.sum()),
            "pgs_primary_changed": int((p1 != p2).sum()),
            "replicas_moved": int(new.sum()),
            "degraded_pgs": int(((up2 != ITEM_NONE).sum(1) < size).sum())}


def phase_failure_sim(dev, pms: dict, smi: str) -> dict:
    """A ClusterSim(diagnostics=True) over config 5 on the card: 8 OSDs
    of one host failed one event each, 2 of them revived, one reweighted
    to 0.5, one balance() round (device_loop).  Each epoch: its wall
    seconds and launches (one remap and one diagnostics launch; balance
    also maps once for its plan), its MovementReport held to numpy_report
    of the fetched rows, and SIM_SAMPLE seeds of its rows held to the host
    oracle."""
    m = copy.deepcopy(pms["config5"].m)
    size = m.pools[0].size
    host_osds = next(bk.items for bk in m.crush.buckets.values()
                     if bk.type == 1 and 0 in bk.items)  # under the root
    check(len(host_osds) == OSD_PER_HOST and 100 not in host_osds,
          "a host of 8 OSDs, OSD 100 elsewhere")
    events = ([("fail_osd", (o,)) for o in host_osds]
              + [("revive_osd", (o,)) for o in host_osds[:2]]
              + [("reweight_osd", (100, 0.5)), ("balance", ())])
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim, rule_n, diag_n, pipe_n = count_placement(
        lambda: ClusterSim(m, diagnostics=True, device=dev))
    torch.cuda.synchronize()
    epochs = [{"event": "init", "s": time.perf_counter() - t0,
               "pipeline_launches": pipe_n, "diag_launches": diag_n}]
    check((rule_n, diag_n, pipe_n) == (0, 1, 1), "ClusterSim init launches")
    rng = np.random.default_rng(5)

    def fetched(cur):
        return cur[0].cpu().numpy(), cur[1].cpu().numpy()

    before = fetched(sim.current[0])
    for method, args in events:
        kw = {"backend": "device_loop"} if method == "balance" else {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep, rule_n, diag_n, pipe_n = count_placement(
            lambda: getattr(sim, method)(*args, **kw))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        want_pipe = 2 if method == "balance" else 1
        check((rule_n, diag_n, pipe_n) == (0, 1, want_pipe),
              f"{method}{args}: {rule_n} rule, {diag_n} diag, {pipe_n} "
              f"pipeline launches")
        after = fetched(sim.current[0])
        want = numpy_report(before, after, size)
        got = {k: getattr(rep, k) for k in want}
        check(got == want, f"{method}{args}: report {got} != numpy {want}")
        seeds = rng.choice(m.pools[0].pg_num, SIM_SAMPLE, replace=False)
        t1 = time.perf_counter()
        for ps in seeds.tolist():
            up, upp, _, _ = sim.m.pg_to_up_acting_osds(PgId(0, ps))
            row = [int(o) for o in after[0][ps] if o != ITEM_NONE]
            check(row == [int(o) for o in up] and int(after[1][ps]) == upp,
                  f"{method}{args}: seed {ps} == the host oracle")
        agg = sim.diag_history[-1][1]
        epochs.append({"event": f"{method}{args}", "s": sec,
                       "pipeline_launches": pipe_n, "diag_launches": diag_n,
                       "report": dataclasses.asdict(rep),
                       "report_equal_numpy": True,
                       "checked_seeds": SIM_SAMPLE,
                       "check_s": time.perf_counter() - t1,
                       "bad_mappings": agg["bad_mappings"],
                       "retry_exhausted": agg["retry_exhausted"],
                       "collisions": agg["collisions"]})
        before = after
    peak = torch.cuda.max_memory_allocated(dev)
    emit({"phase": "failure_sim", "pgs": m.pools[0].pg_num,
          "epochs": epochs, "peak_device_bytes": peak})
    walls = ", ".join(f"{e['event']} {e['s']:.6f} s" for e in epochs)
    print(f"failure_sim on {smi}: {walls}; peak device memory {peak} bytes",
          flush=True)
    return {"epochs": epochs, "peak_device_bytes": peak}


# -- the lifetime simulator -----------------------------------------------------

LIFETIME_CORPUS = ROOT / "tests" / "data" / "lifetime_corpus.json"
# summary keys that read the wall clock, and those that differ by design
# (tests/test_torch_lifetime.py::comparable)
LIFETIME_WALL = ("wall_s", "epochs_per_sec", "cluster_years_per_hour")
LIFETIME_BY_DESIGN = ("provenance", "state", "trace_once",
                      "jit_compiles_per_epoch")
# config 5's 10k OSDs (bench_map: 1250 hosts of 8 under 78 racks) with
# 10M PGs over a size-3 pool and an EC 4+2 pool; ec_gbps is measured
LIFETIME_MAIN = ("hosts=1250,osds_per_host=8,racks=78,pgs=8000000,"
                 "ec=4+2,ec_pgs=2000000,workload=1,correlated=1,epochs=48,"
                 "balance_every=16,checkpoint_every=0")
LIFETIME_CHECKED = 4  # epochs whose program inputs are held to numpy
LIFETIME_SAMPLE = 32  # seeds of each pool held to the host oracle an epoch
LIFETIME_RESUMED = ("tiny_wl", 4)  # the CLI --stop-after / --resume run


def lifetime_comparable(summary: dict) -> dict:
    out = {k: v for k, v in summary.items()
           if k not in LIFETIME_WALL + LIFETIME_BY_DESIGN}
    if "pareto" in out:
        out["pareto"] = {k: v for k, v in out["pareto"].items()
                         if k != "cluster_years_per_hour"}
    return json.loads(json.dumps(out))


def fresh_observers() -> None:
    """The health checks and the timeline are process-global: each run
    starts from none, as the corpus runs did."""
    obs.health.reset()
    obs.timeline.reset()


def phase_lifetime_corpus(dev) -> dict:
    """Every scenario of tests/data/lifetime_corpus.json on the card
    (backend "torch"): the JAX digest and summary, the pipeline kernel's
    launches of each epoch equal to the CPU run's rule calls (0 on every
    epoch in which no pool's rows tag changed), 0 compiles and no rebuild
    on a steady epoch.  Then one scenario stopped after epoch k and
    resumed through `python -m ceph_tpu_torch.cli.sim`; the injected
    device loss is `runtime_main`'s."""
    corpus = json.loads(LIFETIME_CORPUS.read_text())["scenarios"]
    res, launches_by = {}, {}
    for name, ent in sorted(corpus.items()):
        fresh_observers()
        t0 = time.perf_counter()
        pipeline.pipeline_cuda.launches = 0
        sim = LifetimeSim(ent["spec"], backend="torch", device=dev)
        init_n = pipeline.pipeline_cuda.launches
        todo = ent["forced"] + [None] * (sim.scenario.epochs
                                         - len(ent["forced"]))
        per_epoch = []
        for ev in todo:
            pipeline.pipeline_cuda.launches = 0
            sim.step(force_event=ev)
            per_epoch.append(pipeline.pipeline_cuda.launches)
        out = sim.run()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        check(out["digest"] == ent["digest"],
              f"lifetime {name}: digest {out['digest']} != JAX's")
        check(lifetime_comparable(out) == ent["summary"],
              f"lifetime {name}: summary == JAX's")
        check(per_epoch == ent["rule_calls"],
              f"lifetime {name}: launches {per_epoch} != the CPU run's "
              f"{ent['rule_calls']}")
        check(all(n == 0 for n, c in zip(per_epoch, ent["tags_changed"])
                  if not c), f"lifetime {name}: a tag-equal epoch launched")
        to = out["trace_once"]
        check(to["total_compiles"] == 0 and to["steady_full_rebuilds"] == 0,
              f"lifetime {name}: trace_once {to}")
        if "jax_backend" in ent:
            check(out["state"] == ent["jax_backend"]["state"],
                  f"lifetime {name}: state counts == the JAX backend's")
        res[name] = {"epochs": out["epochs"], "s": sec,
                     "init_launches": init_n, "launches": per_epoch,
                     "digest_equal": True}
        launches_by[name] = init_n + sum(per_epoch)

    # kill-free resume through the CLI: stop after k, resume, same digest
    name, k = LIFETIME_RESUMED
    spec = corpus[name]["spec"]
    with tempfile.TemporaryDirectory() as d:
        ck = str(Path(d) / "ck.json")
        t0 = time.perf_counter()
        for argv in (["--scenario", spec, "--stop-after", str(k)],
                     ["--resume"]):
            r = subprocess.run(
                [sys.executable, "-m", "ceph_tpu_torch.cli.sim", "digest",
                 "--device", str(dev), "--checkpoint", ck] + argv,
                cwd=ROOT, capture_output=True,
                text=True, timeout=300)
            check(r.returncode == 0, f"cli.sim {argv}: rc {r.returncode} "
                  f"{r.stderr[-2000:]}")
        check(r.stdout.strip() == corpus[name]["digest"],
              f"cli.sim --resume after {k}: digest == JAX's")
        resume_s = time.perf_counter() - t0

    fresh_observers()
    emit({"phase": "lifetime_corpus", "scenarios": res,
          "cli_resume": {"scenario": name, "stop_after": k,
                         "digest_equal": True, "s": resume_s}})
    return launches_by


class ProgramClock:
    """The three data-plane programs (epoch stats, recovery drain, client
    traffic) wrapped where the simulator calls them: CUDA events around
    every call, and, while `capture` is a list, each call's inputs and
    outputs appended to it."""

    PROGRAMS = (("stats", "lifetime", "_stats_torch"),
                ("drain", "queue", "drain_pool_torch"),
                ("traffic", "workload", "workload_pool_torch"))

    def __init__(self):
        self.events = {key: [] for key, _, _ in self.PROGRAMS}
        self.capture = None
        self._orig = []
        mods = {"lifetime": sim_lifetime, "queue": recovery_queue,
                "workload": sim_workload}
        for key, mod, attr in self.PROGRAMS:
            self._wrap(mods[mod], attr, key)

    def _wrap(self, mod, attr, key):
        orig = getattr(mod, attr)
        self._orig.append((mod, attr, orig))

        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*a, **kw)
            end.record()
            self.events[key].append((start, end))
            if self.capture is not None:
                self.capture.append((key, a, kw, out))
            return out

        setattr(mod, attr, timed)

    def take_ms(self) -> dict:
        """{program: [ms of each call]} since the last take."""
        torch.cuda.synchronize()
        out = {k: [s.elapsed_time(e) for s, e in v]
               for k, v in self.events.items()}
        self.events = {k: [] for k in self.events}
        return out

    def restore(self):
        for mod, attr, orig in self._orig:
            setattr(mod, attr, orig)


def numpy_epoch_stats(prev, rows, n: int, size: int, tol: int):
    """The epoch stats written lane by lane in numpy, apart from the
    port's and the JAX package's formulas: ([degraded, unmapped, at_risk,
    dup, moved, remapped], moved lanes per PG)."""
    real = np.arange(rows.shape[0]) < n
    W = rows.shape[1]
    ok = (rows != ITEM_NONE) & (rows >= 0)
    pok = (prev != ITEM_NONE) & (prev >= 0)
    occ = ok.sum(1)
    dup = np.zeros(rows.shape[0], bool)
    for i in range(W):
        for j in range(i + 1, W):
            dup |= ok[:, i] & ok[:, j] & (rows[:, i] == rows[:, j])
    moved = np.zeros(rows.shape[0], np.int64)
    gone = np.zeros(rows.shape[0], bool)
    for j in range(W):
        in_prev = np.zeros(rows.shape[0], bool)
        in_rows = np.zeros(rows.shape[0], bool)
        for k in range(W):
            in_prev |= rows[:, j] == prev[:, k]
            in_rows |= prev[:, j] == rows[:, k]
        moved += ok[:, j] & ~in_prev & real
        gone |= pok[:, j] & ~in_rows
    return [int((real & (occ < size)).sum()), int((real & (occ == 0)).sum()),
            int((real & (occ < size - tol)).sum()), int((real & dup).sum()),
            int(moved.sum()), int((real & ((moved > 0) | gone)).sum())], moved


def held_to_numpy(calls: list) -> dict:
    """Each captured program call held to numpy: the stats to
    numpy_epoch_stats, the drain to drain_pool_np, the traffic to
    workload_pool_np.  Returns the calls checked per program."""
    done = {"stats": 0, "drain": 0, "traffic": 0}
    for key, a, kw, out in calls:
        host = [x.cpu().numpy() if isinstance(x, torch.Tensor) else x
                for x in a]
        if key == "stats":
            prev, rows, n, size, tol = host
            want, moved = numpy_epoch_stats(prev, rows, n, size, tol)
            check(out[0].tolist() == want, f"stats {out[0].tolist()} != "
                  f"numpy {want}")
            check(np.array_equal(out[1].cpu().numpy(), moved),
                  "stats: moved lanes == numpy")
        elif key == "drain":
            b, cap, slots, scal = recovery_queue.drain_pool_np(*host, **kw)
            check(out[3].tolist() == [scal[k] for k in DRAIN_KEYS],
                  f"drain {out[3].tolist()} != drain_pool_np {scal}")
            check(np.array_equal(out[0].cpu().numpy(), b)
                  and np.array_equal(out[1].cpu().numpy(), cap)
                  and np.array_equal(out[2].cpu().numpy(), slots),
                  "drain: backlog, capacity, slots == drain_pool_np")
        else:
            client, scal = sim_workload.workload_pool_np(*host, **kw)
            check(out[1].tolist() == [scal[k] for k in WL_KEYS],
                  f"traffic {out[1].tolist()} != workload_pool_np {scal}")
            check(np.array_equal(out[0].cpu().numpy(), client),
                  "traffic: client bytes == workload_pool_np")
        done[key] += 1
    return done


def program_bound_ms(key: str, a, kw, peak: float) -> float:
    """Bytes a program must move (each input read once, each output
    written once) over the card's memory rate, in ms."""
    def nb(t):
        return t.numel() * t.element_size() if isinstance(
            t, torch.Tensor) else 0

    if key == "stats":
        prev, rows = a[0], a[1]
        byts = nb(prev) + nb(rows) + rows.shape[0] * 8 + 6 * 8
    elif key == "drain":
        backlog, moved, rows, cap, slots = a
        byts = (2 * nb(backlog) + nb(moved) + nb(rows) + 2 * nb(cap)
                + 2 * nb(slots) + 7 * 8)
    else:
        rows, backlog, seeds, read = a
        S, W = seeds.numel(), rows.shape[1]
        byts = (S * W * rows.element_size() + (S * 8 if backlog is not None
                else 0) + nb(seeds) + nb(read) + kw["DV"] * 8 + 7 * 8)
    return byts / peak * 1e3


LIFETIME_PARTS = ("_apply_event", "_account_epoch", "_workload_epoch",
                  "_recovery_epoch", "_durability_epoch", "_invariants",
                  "_observe_epoch")


def time_parts(sim) -> dict:
    """Wrap the parts of `sim.step()` on the instance: each call's host
    seconds, synchronised at its end, added to the returned dict (the
    step's breakdown; the caller zeroes it each epoch)."""
    spent = dict.fromkeys(LIFETIME_PARTS, 0.0)
    for name in LIFETIME_PARTS:
        def timed(*a, _real=getattr(sim, name), _name=name, **kw):
            t0 = time.perf_counter()
            out = _real(*a, **kw)
            torch.cuda.synchronize()
            spent[_name] += time.perf_counter() - t0
            return out

        setattr(sim, name, timed)
    return spent


def ec_encode_gbps(dev, flush) -> dict:
    """The EC pool's own profile (plugin jax, k=4, m=2) on the card
    through create_erasure_code: encode_batch of 4096 stripes of 4 x 4 KiB
    (64 MiB of data), checked against the plain version, then its wall
    time; GB/s of data encoded.  One gf_matmul launch per encode."""
    code = create_erasure_code({"plugin": "jax", "k": "4", "m": "2"},
                               device=dev)
    N, L = 4096, 4096
    stripes = rand_u8((N, code.k, L), 600, dev)
    enc, n = counted(1, "lifetime EC calibration",
                     lambda: code.encode_batch(stripes))
    check(torch.equal(enc[:, code.k:], gf_matmul_plain(code.C, stripes)),
          "lifetime EC calibration: parity == the plain version")
    ms = wall_ms(lambda: code.encode_batch(stripes), flush)
    return {"launches": n, "encode_ms": ms, "data_bytes": N * code.k * L,
            "gbps": N * code.k * L / (ms * 1e-3) / 1e9}


def phase_lifetime_main(dev, smi: str, peak: float) -> dict:
    """LifetimeSim at config 5's size on the card: 10M PGs (8M size-3,
    2M EC 4+2) over 10k OSDs, 48 epochs with the workload, correlated
    failures and the queue model, the mgr balancer every 16 epochs, with
    ec_gbps measured on the card first.  Each epoch: its event, wall
    seconds, pipeline launches (held to the map_all_device and raw_rows calls
    that make them: 0 on an epoch whose tags did not change), the
    CUDA-event ms of the stats, drain and traffic programs; the first
    LIFETIME_CHECKED epochs that ran the stats have every program's
    inputs fetched and held to numpy; every event epoch has
    LIFETIME_SAMPLE seeds of each pool held to the host oracle."""
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    ec = ec_encode_gbps(dev, flush)
    del flush
    spec = LIFETIME_MAIN + f",ec_gbps={round(ec['gbps'], 3)}"
    print(f"lifetime_main on {smi}: EC 4+2 encode {ec['gbps']:.3f} GB/s "
          f"-> ec_gbps", flush=True)
    calls = {"map_all": 0, "raw": 0}
    real_map, real_raw = PoolMapper.map_all_device, PoolMapper.raw_rows

    def map_all(self):
        calls["map_all"] += 1
        return real_map(self)

    def raw(self, seeds):
        calls["raw"] += int(len(seeds) > 0)
        return real_raw(self, seeds)

    PoolMapper.map_all_device, PoolMapper.raw_rows = map_all, raw
    clock = ProgramClock()
    rng = np.random.default_rng(10)
    try:
        fresh_observers()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        pipeline.pipeline_cuda.launches = 0
        t0 = time.perf_counter()
        sim = LifetimeSim(spec, backend="torch", device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_launches = pipeline.pipeline_cuda.launches
        clock.take_ms()
        parts = time_parts(sim)
        epochs, checked, check_s, oracle_s = [], {}, 0.0, 0.0
        for _ in range(sim.scenario.epochs):
            tags0 = {p: ent[0] for p, ent in sim._prev_rows.items()}
            calls.update(map_all=0, raw=0)
            capture = [] if len(checked) < LIFETIME_CHECKED else None
            clock.capture = capture
            torch.cuda.synchronize()
            pipeline.pipeline_cuda.launches = 0
            parts.update(dict.fromkeys(parts, 0.0))
            t0 = time.perf_counter()
            r = sim.step()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            n = pipeline.pipeline_cuda.launches
            clock.capture = None
            changed = sorted(p for p, ent in sim._prev_rows.items()
                             if tags0.get(p) != ent[0])
            ms = clock.take_ms()
            e = r["epoch"]
            kind = r["event"].split(" ")[0].split("(")[0]
            balance = kind == "balance"
            check(n >= calls["map_all"] + calls["raw"] and (
                balance or n == calls["map_all"] + calls["raw"]),
                f"epoch {e}: {n} launches, {calls['map_all']} remaps + "
                f"{calls['raw']} overlay raw refreshes")
            check(changed or n == 0, f"epoch {e}: tags equal, {n} launches")
            check(changed or not ms["stats"],
                  f"epoch {e}: tags equal, stats ran")
            rec = {"epoch": e, "event": r["event"][:120], "kind": kind,
                   "s": sec, "launches": n, "remaps": calls["map_all"],
                   "raw_refreshes": calls["raw"],
                   "balancer_own": n - calls["map_all"] - calls["raw"],
                   "tags_changed": changed, "structural": r["structural"],
                   "parts_s": dict(parts),
                   "program_ms": {k: sum(v) for k, v in ms.items()},
                   "program_calls": {k: len(v) for k, v in ms.items()}}
            if capture and any(c[0] == "stats" for c in capture):
                t1 = time.perf_counter()
                checked[e] = held_to_numpy(capture)
                rec["bounds_ms"] = {}
                for key, a, kw, _ in capture:
                    rec["bounds_ms"][key] = rec["bounds_ms"].get(key, 0.0) \
                        + program_bound_ms(key, a, kw, peak)
                check_s += time.perf_counter() - t1
            del capture
            if kind != "quiet":
                t1 = time.perf_counter()
                hold_to_oracle(sim, dev, rng, f"epoch {e}")
                oracle_s += time.perf_counter() - t1
            epochs.append(rec)
        out = sim.summary()
        peak_bytes = torch.cuda.max_memory_allocated(dev)
        forced = forced_epochs(sim, dev, rng)
    finally:
        clock.restore()
        PoolMapper.map_all_device, PoolMapper.raw_rows = real_map, real_raw
    check(out["invariant_violations"] == 0,
          f"lifetime_main: violations {out['violations']}")
    check(out["recovery"]["conservation_violations"] == 0,
          "lifetime_main: byte conservation every epoch")
    check(out["trace_once"]["steady_full_rebuilds"] == 0,
          "lifetime_main: no rebuild on a steady epoch")
    check(len(checked) == LIFETIME_CHECKED,
          f"lifetime_main: {len(checked)} epochs held to numpy")
    by_kind: dict = {}
    for rec in epochs:
        by_kind.setdefault(rec["kind"], []).append(rec["s"])
    programs = {}
    for key in ("stats", "drain", "traffic"):
        per = [rec["program_ms"][key] for rec in epochs
               if rec["program_calls"][key]]
        bounds = [rec["bounds_ms"][key] for rec in epochs
                  if "bounds_ms" in rec and key in rec["bounds_ms"]]
        programs[key] = {
            "epochs_run": len(per),
            "calls": sum(rec["program_calls"][key] for rec in epochs),
            "median_epoch_ms": statistics.median(per) if per else None,
            "max_epoch_ms": max(per) if per else None,
            "bound_ms": statistics.median(bounds) if bounds else None,
            "bound_by": "bytes",
            "library_ms": None}
    event_s = [rec["s"] for rec in epochs if rec["kind"] != "quiet"]
    res = {
        "scenario": spec, "ec_calibration": ec, "init_s": init_s,
        "init_launches": init_launches,
        "launches": init_launches + sum(r["launches"] for r in epochs),
        "epochs": epochs,
        "seconds_by_kind": {k: {"n": len(v), "median": statistics.median(v),
                                "max": max(v)} for k, v in by_kind.items()},
        "programs": programs,
        "program_share_of_event_epochs": sum(
            sum(r["program_ms"].values()) for r in epochs
            if r["kind"] != "quiet") / 1e3 / max(sum(event_s), 1e-9),
        "checked_epochs": checked, "check_s": check_s,
        "oracle_s": oracle_s, "oracle_seeds_per_pool": LIFETIME_SAMPLE,
        "summary": {k: out[k] for k in (
            "digest", "events", "cluster_years_per_hour", "wall_s",
            "invariant_violations", "recovery", "workload", "durability",
            "trace_once", "state", "health", "sim_years")},
        "peak_device_bytes": peak_bytes,
        "forced_epochs": forced,
    }
    emit(dict(phase="lifetime_main", **res))
    kinds = ", ".join(f"{k} median {v['median']:.3f} s max {v['max']:.3f} s"
                      for k, v in sorted(res["seconds_by_kind"].items()))
    print(f"lifetime_main on {smi}: init {init_s:.3f} s; {kinds}; "
          f"{out['cluster_years_per_hour']} cluster-years/hour; peak "
          f"device memory {peak_bytes} bytes", flush=True)
    for kind, r in forced.items():
        print(f"lifetime_main on {smi}: forced {kind} after the 48 epochs: "
              f"{r['s']:.3f} s, {r['rebuilds']} ClusterState rebuild(s), "
              f"{r['launches']} launches, {r['oracle_seeds']} seeds == the "
              "host oracle", flush=True)
    return res


# -- the expand and remove epochs at config 5's size ----------------------------

def hold_to_oracle(sim, dev, rng, what: str) -> int:
    """LIFETIME_SAMPLE seeds of each pool of a LifetimeSim: the up rows
    its last epoch left on the device == the host oracle on its map.
    Returns the seeds checked."""
    checked = 0
    for pid in sorted(sim.m.pools):
        rows = sim._prev_rows[pid][1]
        seeds = rng.choice(rows.shape[0], min(
            LIFETIME_SAMPLE, rows.shape[0]), replace=False)
        got = rows[torch.from_numpy(seeds).to(dev)].cpu()
        for ps, row in zip(seeds.tolist(), got.tolist()):
            up = sim.m.pg_to_up_acting_osds(PgId(pid, ps))[0]
            up = list(up) + [ITEM_NONE] * (len(row) - len(up))
            check(row == up, f"{what}: pg {pid}.{ps:x} == host oracle")
            checked += 1
    return checked


def forced_epochs(sim, dev, rng) -> dict:
    """After lifetime_main's 48 epochs: one epoch with a forced `expand`
    (new hosts inserted into CRUSH, a ClusterState rebuild) and one with a
    forced `remove` (a dead OSD destroyed and pulled from CRUSH), each
    synchronised and timed, its launches and rebuilds counted, and
    LIFETIME_SAMPLE seeds of each pool held to the host oracle.  Kept out
    of the 48 epochs' figures."""
    out = {}
    for kind in ("expand", "remove"):
        rb0 = sim.state.full_rebuilds
        torch.cuda.synchronize()
        pipeline.pipeline_cuda.launches = 0
        t0 = time.perf_counter()
        r = sim.step(force_event=kind)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n = pipeline.pipeline_cuda.launches
        check(r["event"].startswith(kind),
              f"forced {kind}: the event was {r['event'][:80]!r}")
        t1 = time.perf_counter()
        seeds_checked = hold_to_oracle(sim, dev, rng, f"forced {kind}")
        out[kind] = {"event": r["event"][:120], "s": sec, "launches": n,
                     "rebuilds": sim.state.full_rebuilds - rb0,
                     "structural": r["structural"],
                     "oracle_seeds": seeds_checked,
                     "oracle_s": time.perf_counter() - t1}
    check(sim.summary()["invariant_violations"] == 0,
          "forced epochs: no invariant violation")
    return out


# -- erasure codes past the old 32 x 64 tiling --------------------------------------

# RS(70,4) (a [4, 70] matrix) and Clay(2,33,19) (324 sub-chunks, an
# inner code of 33 parity rows): each profile's inputs beside the JAX
# package's SHA-256s, as tests/test_torch_ec_wide.py reads them
EC_WIDE = ROOT / "tests" / "data" / "ec_wide.json"


def _sha_chunks(chunks: dict) -> dict:
    return {str(i): hashlib.sha256(np.asarray(
        c.cpu() if isinstance(c, torch.Tensor) else c,
        np.uint8).tobytes()).hexdigest() for i, c in sorted(chunks.items())}


def run_wide(case: dict, device) -> dict:
    """tests/test_torch_ec_wide.py::run_wide on `device`: encode, decode
    each pattern, and (Clay) repair chunk 0 from its helpers' repair
    sub-chunks; the SHA-256 of every chunk out."""
    prof, size, patterns = case["profile"], case["size"], case["patterns"]
    code = create_erasure_code(dict(prof), device=device)
    n = code.get_chunk_count()
    payload = np.random.default_rng(n).integers(0, 256, size, np.uint8)
    enc = code.encode(set(range(n)), payload.tobytes())
    out = {"encode": _sha_chunks(enc), "decode": {}}
    for erased in patterns:
        have = {i: c for i, c in enc.items() if i not in erased}
        dec = code.decode(set(erased), have)
        out["decode"][",".join(map(str, erased))] = _sha_chunks(
            {i: dec[i] for i in erased})
    if prof["plugin"] == "clay":
        cs = len(enc[0])
        need = code.minimum_to_repair({0}, set(range(1, n)))
        helpers = {}
        for h, runs in need.items():
            planes = [z for ind, cnt in runs for z in range(ind, ind + cnt)]
            helpers[h] = np.asarray(enc[h], np.uint8).reshape(
                code.get_sub_chunk_count(), -1)[planes].reshape(-1)
        out["repair0"] = _sha_chunks(code.repair({0}, helpers, cs))
    return out


def phase_ec_wide(dev) -> dict:
    """C.2: products past the old 32 x 64 tiling, one launch each, equal
    to the plain version and to the host-side tiling `gf_matmul_tiled`
    (random M of 40 x 130, 33 x 3, 4 x 70 and 32 x 64 on CUDA tensors);
    then RS(70,4) and Clay(2,33,19) through create_erasure_code on the
    card, every chunk's SHA-256 equal to tests/data/ec_wide.json (the JAX
    package's bytes, which the CPU tests hold the plain version to),
    launches equal to the CPU run's (`cpu_launches`: Clay's grouped plan
    launches)."""
    eng = TorchEngine(dev)
    rng = np.random.default_rng(70)
    tiles = {}
    for R, S in ((40, 130), (33, 3), (4, 70), (32, 64)):
        M = rng.integers(0, 256, (R, S), np.uint8)
        data = rand_u8((16, S, 4096), R * S, dev)
        got, n = counted(1, f"ec_wide {R}x{S}",
                         lambda: eng.matmul_batch(M, data))
        check(torch.equal(got, gf_matmul_plain(M, data)),
              f"ec_wide {R}x{S} == the plain version")
        check(torch.equal(got, gf_matmul_tiled(
            M, data, lambda Mb, db: gf_matmul_plain(Mb, db))),
            f"ec_wide {R}x{S} == the plain version tiled")
        tiles[f"{R}x{S}"] = n
    cases = json.loads(EC_WIDE.read_text())
    res, launches = {}, {}
    for name, case in sorted(cases.items()):
        expect = cpu_launches(lambda: run_wide(case, "cpu"))
        t0 = time.perf_counter()
        got, n = counted(expect, f"ec_wide {name}",
                         lambda: run_wide(case, dev))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        check(got == case["sha256"],
              f"ec_wide {name}: SHA-256 == the JAX bytes")
        res[name] = {"launches": n, "s": sec, "bytes_equal": True}
        launches[name] = n
    emit({"phase": "ec_wide", "tiles": tiles, "profiles": res})
    return {**{f"ec_wide_tile_{k}": v for k, v in tiles.items()},
            **{f"ec_wide_{k}": v for k, v in launches.items()}}


# -- the fleet simulator ---------------------------------------------------------

# "digest_spec": tests/test_fleet.py's DIGEST_SPEC (plain, balanced,
# correlated and data-loss members) beside the JAX fleet's digests
FLEET_CORPUS = ROOT / "tests" / "data" / "fleet_corpus.json"


def fleet_spec(epochs: int, clusters: int, hosts: int, per_host: int,
               racks: int, pgs: tuple, ec_pgs: int) -> str:
    """The JAX bench's 16-combination fleet sweep (bench.py's fleet stage)
    at a given size."""
    return (f"base=epochs={epochs},hosts={hosts},osds_per_host={per_host},"
            f"racks={racks},pgs={pgs[0]},ec=4+2,ec_pgs={ec_pgs},workload=1,"
            "balance_every=8,spotcheck_every=0,checkpoint_every=0,seed=3,"
            "recovery=queue,max_backfills=4,recovery_mbps=200,osd_mbps=400,"
            "p_pool_create=0,p_split=0;axis=correlated:0|1;"
            "axis=p_death:0.02|0.12;axis=recovery_mbps:100|400;"
            f"axis=pgs:{pgs[0]}|{pgs[1]};clusters={clusters}")


# every member: 1024 OSDs (128 hosts of 8 under 8 racks) and about 100
# PGs per OSD (32768 or 65536 size-3 PGs and 8192 EC 4+2 PGs)
FLEET_MAIN = dict(epochs=16, clusters=64, hosts=128, per_host=8, racks=8,
                  pgs=(32768, 65536), ec_pgs=8192)
FLEET_SMALL = dict(epochs=5, clusters=16, hosts=16, per_host=2, racks=4,
                   pgs=(32, 64), ec_pgs=16)
FLEET_SOLO = (0, 21, 42, 63)  # members also run solo


def solo_digest(member, dev) -> str:
    fresh_observers()
    sim = LifetimeSim(member.scenario.spec(), backend="torch", device=dev)
    sim.balancer_options = {"upmap_state_backend": "device_loop"}
    out = sim.run()["digest"]
    fresh_observers()
    return out


def phase_fleet_corpus(dev) -> int:
    """tests/test_fleet.py's DIGEST_SPEC on the card: each member's digest
    == the JAX FleetSim's (tests/data/fleet_corpus.json) == a solo port
    run's; the loss member lost PGs and the DATA_LOSS latch holds; each
    fleet epoch's pipeline launches == the CPU run's rule calls, and its stats
    call's lanes == the CPU run's."""
    want = json.loads(FLEET_CORPUS.read_text())["digest_spec"]
    fresh_observers()
    t0 = time.perf_counter()
    pipeline.pipeline_cuda.launches = 0
    fleet = FleetSim(parse_fleet(want["spec"]), device=dev)
    init_n = pipeline.pipeline_cuda.launches
    lanes, real = [], sim_lifetime._stats_lanes

    def stats_lanes(prevs, rowss, *a):
        lanes[-1].append(len(rowss))
        return real(prevs, rowss, *a)

    per_epoch = []
    sim_lifetime._stats_lanes = stats_lanes
    try:
        while fleet.live():
            lanes.append([])
            pipeline.pipeline_cuda.launches = 0
            fleet.step()
            per_epoch.append(pipeline.pipeline_cuda.launches)
    finally:
        sim_lifetime._stats_lanes = real
    out = fleet.summary()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    check(fleet.digests() == want["digests"],
          f"fleet_corpus: digests {fleet.digests()} != the JAX fleet's")
    check(init_n == want["init_rule_calls"]
          and per_epoch == want["rule_calls"],
          f"fleet_corpus: launches {init_n} {per_epoch} != the CPU run's "
          f"{want['init_rule_calls']} {want['rule_calls']}")
    check(lanes == want["stats_lanes"],
          f"fleet_corpus: stats lanes {lanes} != {want['stats_lanes']}")
    check(out["members"][3]["pg_lost"] > 0, "fleet_corpus: PGs lost")
    chk = obs.health.checks().get("DATA_LOSS")
    check(bool(chk) and chk["severity"] == obs.health.ERR,
          "fleet_corpus: the DATA_LOSS latch holds")
    check(all(m["invariant_violations"] == 0 for m in out["members"]),
          "fleet_corpus: no violation")
    solo = [solo_digest(m, dev) for m in fleet.members]
    check(solo == want["digests"], "fleet_corpus: solo port runs == JAX")
    emit({"phase": "fleet_corpus", "s": sec, "init_launches": init_n,
          "launches": per_epoch, "stats_lanes": lanes,
          "digests_equal": True, "solo_equal": True,
          "pg_lost": out["members"][3]["pg_lost"]})
    return init_n + sum(per_epoch)


class FleetRun:
    """One fleet run on a device, epoch by epoch: wall seconds, rule
    launches (the card) or rule calls (the CPU), stats calls with their
    lanes and (the card) CUDA-event ms, and the remaps and overlay raw
    refreshes that make the launches.  After the run, outside its
    figures: every lane of the stats call with the most lanes held to
    `_stats_np` on its host copy, and the `oracle` members' rows held to
    the host oracle on LIFETIME_SAMPLE seeds of each pool."""

    def __init__(self, spec: str, dev, stack: bool, oracle: tuple):
        self.spec, self.dev, self.stack = spec, dev, stack
        self.oracle = oracle
        self.cuda = torch.device(dev).type == "cuda"

    def run(self) -> dict:
        env0 = os.environ.get("CEPH_TPU_FLEET_STACK")
        os.environ["CEPH_TPU_FLEET_STACK"] = "1" if self.stack else "0"
        real_stats, real_rule = sim_lifetime._stats_lanes, pipeline.map_rule
        real_map, real_raw = PoolMapper.map_all_device, PoolMapper.raw_rows
        n = {"rule": 0, "map_all": 0, "raw": 0}
        stats = []
        widest = []  # the call with the most lanes: its inputs and outputs

        def stats_lanes(prevs, rowss, *a):
            ev = None
            if self.cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = real_stats(prevs, rowss, *a)
            if self.cuda:
                ev[1].record()
            if not widest or len(rowss) > len(widest[1]):
                # kept, not copied: no lane tensor is written in place
                widest[:] = (prevs, rowss, *a, out)
            stats.append((len(rowss), ev, sum(
                r.numel() * r.element_size() for r in rowss), max(
                r.shape[0] for r in rowss), max(r.shape[1] for r in rowss)))
            return out

        def map_rule(T, prog, x, weight):
            n["rule"] += int(x.numel() > 0)
            return real_rule(T, prog, x, weight)

        def map_all(pm):
            n["map_all"] += 1
            return real_map(pm)

        def raw(pm, seeds):
            n["raw"] += int(len(seeds) > 0)
            return real_raw(pm, seeds)

        sim_lifetime._stats_lanes, pipeline.map_rule = stats_lanes, map_rule
        PoolMapper.map_all_device, PoolMapper.raw_rows = map_all, raw
        try:
            fresh_observers()
            if self.cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(self.dev)
            pipeline.pipeline_cuda.launches = 0
            t0 = time.perf_counter()
            fleet = FleetSim(parse_fleet(self.spec), device=self.dev)
            if self.cuda:
                torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            init = (pipeline.pipeline_cuda.launches if self.cuda
                    else n["rule"])
            epochs = []
            while fleet.live():
                n.update(rule=0, map_all=0, raw=0)
                stats.clear()
                pipeline.pipeline_cuda.launches = 0
                t0 = time.perf_counter()
                recs = fleet.step()
                if self.cuda:
                    torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                kinds = [r["event"].split(" ")[0].split("(")[0]
                         for r in recs]
                launches = (pipeline.pipeline_cuda.launches if self.cuda
                            else n["rule"])
                balance = "balance" in kinds
                if self.cuda:
                    check(launches >= n["map_all"] + n["raw"] and (
                        balance or launches == n["map_all"] + n["raw"]),
                        f"fleet epoch {fleet.steps}: {launches} launches, "
                        f"{n['map_all']} remaps + {n['raw']} raw refreshes")
                epochs.append({
                    "s": sec, "launches": launches,
                    "remaps": n["map_all"], "raw_refreshes": n["raw"],
                    "balance_members": kinds.count("balance"),
                    "stats_calls": len(stats),
                    "stats_lanes": [c[0] for c in stats],
                    "stats_ms": [c[1][0].elapsed_time(c[1][1])
                                 for c in stats] if self.cuda else None,
                    "stats_bytes": [(c[0], c[2], c[3], c[4])
                                    for c in stats]})
            out = fleet.summary()
            peak = (torch.cuda.max_memory_allocated(self.dev)
                    if self.cuda else None)
        finally:
            sim_lifetime._stats_lanes, pipeline.map_rule = \
                real_stats, real_rule
            PoolMapper.map_all_device, PoolMapper.raw_rows = \
                real_map, real_raw
            if env0 is None:
                os.environ.pop("CEPH_TPU_FLEET_STACK", None)
            else:
                os.environ["CEPH_TPU_FLEET_STACK"] = env0
        check(all(m["invariant_violations"] == 0 for m in out["members"]),
              f"fleet {self.spec[:40]}...: no violation")
        t0 = time.perf_counter()
        np_lanes = self.hold_lanes_to_numpy(widest)
        rng = np.random.default_rng(11)
        oracle_seeds = sum(hold_to_oracle(
            fleet.engines[i], self.dev, rng, f"fleet member {i}")
            for i in self.oracle)
        check_s = time.perf_counter() - t0
        wall = sum(e["s"] for e in epochs)
        members = fleet.members
        del fleet, widest
        fresh_observers()
        return {"init_s": init_s, "init_launches": init, "epochs": epochs,
                "wall_s": wall, "digests": [m["digest"]
                                            for m in out["members"]],
                "cluster_epochs": out["cluster_epochs"],
                "cluster_epochs_per_s": out["cluster_epochs"] / wall,
                "trace_once": out["trace_once"], "peak_device_bytes": peak,
                "pg_lost": sum(m["pg_lost"] for m in out["members"]),
                "members": members, "numpy_lanes": np_lanes,
                "oracle_seeds": oracle_seeds, "check_s": check_s}

    def hold_lanes_to_numpy(self, call: list) -> int:
        """Every lane of one `_stats_lanes` call: its six stats and per-PG
        moved counts == `_stats_np` on the lane's host copy, int64 exact.
        Returns the lanes checked."""
        check(bool(call), f"fleet {self.spec[:40]}...: a stats call ran")
        prevs, rowss, ns, sizes, tols, (got, moved) = call
        got = got.cpu()
        for i, (p, r) in enumerate(zip(prevs, rowss)):
            want, want_moved = sim_lifetime._stats_np(
                p.cpu().numpy(), r.cpu().numpy(), int(ns[i]), int(sizes[i]),
                int(tols[i]))
            check(got[i].tolist() == want and torch.equal(
                moved[i].cpu(), torch.from_numpy(want_moved)),
                f"fleet {self.spec[:40]}...: stats lane {i} of "
                f"{len(rowss)} == _stats_np")
        return len(rowss)


def stats_bound_ms(lanes: int, nmax: int, wmax: int, peak: float) -> float:
    """The stacked stats' byte bound: the padded [L, Nmax, Wmax] int32
    prev and rows blocks read once, the int64 [L, Nmax] moved lanes and
    [L, 6] stats written once, over the card's memory rate."""
    return (2 * lanes * nmax * wmax * 4 + lanes * nmax * 8
            + lanes * 6 * 8) / peak * 1e3


def phase_fleet_main(dev, smi: str, peak: float) -> dict:
    """The JAX bench's 16-combination fleet sweep, 64 members of 1024 OSDs
    and about 100 PGs per OSD, 16 epochs.  First the same sweep at a small
    size on the CPU and on the card: each fleet epoch's launches == the
    CPU run's rule calls, its stats calls and lanes equal, the digests
    equal.  Then at full size stacked, then with CEPH_TPU_FLEET_STACK=0:
    the digests equal between the two and to solo port runs of
    FLEET_SOLO's members; each epoch's launches == its remaps and overlay
    raw refreshes (balance epochs add the balancer's own) and equal
    between the two modes.  Each run also holds its widest stats call,
    lane by lane, to `_stats_np` on the host, and FLEET_SOLO's members'
    final rows to the host oracle (FleetRun)."""
    small = fleet_spec(**FLEET_SMALL)
    cpu = FleetRun(small, "cpu", True, (0, 15)).run()
    card = FleetRun(small, dev, True, (0, 15)).run()
    check(card["digests"] == cpu["digests"], "fleet small: card == CPU")
    check(card["init_launches"] == cpu["init_launches"] and [
        e["launches"] for e in card["epochs"]] == [
        e["launches"] for e in cpu["epochs"]],
        "fleet small: launches == the CPU run's rule calls")
    check([e["stats_lanes"] for e in card["epochs"]]
          == [e["stats_lanes"] for e in cpu["epochs"]],
          "fleet small: stats calls and lanes == the CPU run's")
    spec = fleet_spec(**FLEET_MAIN)
    stacked = FleetRun(spec, dev, True, FLEET_SOLO).run()
    unstacked = FleetRun(spec, dev, False, FLEET_SOLO).run()
    check(stacked["digests"] == unstacked["digests"],
          "fleet_main: stacked == CEPH_TPU_FLEET_STACK=0")
    check([e["launches"] for e in stacked["epochs"]]
          == [e["launches"] for e in unstacked["epochs"]],
          "fleet_main: stacked and unstacked launch alike")
    check(all(e["stats_calls"] <= 1 for e in stacked["epochs"]),
          "fleet_main: at most one stats call a stacked epoch")
    t0 = time.perf_counter()
    for i in FLEET_SOLO:
        check(solo_digest(stacked["members"][i], dev)
              == stacked["digests"][i], f"fleet_main: member {i} == solo")
    solo_s = time.perf_counter() - t0
    res = {"spec": spec, "small_spec": small,
           "small": {"epochs": len(cpu["epochs"]),
                     "launches": [e["launches"] for e in card["epochs"]],
                     "stats_lanes": [e["stats_lanes"]
                                     for e in card["epochs"]]},
           "solo_members": list(FLEET_SOLO), "solo_s": solo_s,
           "oracle_seeds_per_pool": LIFETIME_SAMPLE}
    for mode, r in (("stacked", stacked), ("unstacked", unstacked)):
        calls = [e for e in r["epochs"] if e["stats_calls"]]
        ms = [sum(e["stats_ms"]) for e in calls]
        bounds = [sum(stats_bound_ms(L, nm, wm, peak)
                      for L, _, nm, wm in e["stats_bytes"]) for e in calls]
        res[mode] = {
            "init_s": r["init_s"], "init_launches": r["init_launches"],
            "wall_s": r["wall_s"], "cluster_epochs": r["cluster_epochs"],
            "cluster_epochs_per_s": r["cluster_epochs_per_s"],
            "launches": r["init_launches"] + sum(
                e["launches"] for e in r["epochs"]),
            "stats_calls": sum(e["stats_calls"] for e in r["epochs"]),
            "stats_calls_per_epoch": [e["stats_calls"] for e in r["epochs"]],
            "stats_lanes_per_epoch": [sum(e["stats_lanes"])
                                      for e in r["epochs"]],
            "stats_ms_per_epoch": [sum(e["stats_ms"]) for e in r["epochs"]],
            "stats_ms_median": statistics.median(ms) if ms else None,
            "stats_bound_ms_median": (statistics.median(bounds)
                                      if bounds else None),
            "epoch_s": [e["s"] for e in r["epochs"]],
            "launches_per_epoch": [e["launches"] for e in r["epochs"]],
            "balance_members": [e["balance_members"] for e in r["epochs"]],
            "trace_once": r["trace_once"], "pg_lost": r["pg_lost"],
            "peak_device_bytes": r["peak_device_bytes"],
            "numpy_lanes": r["numpy_lanes"],
            "oracle_seeds": r["oracle_seeds"], "check_s": r["check_s"]}
    emit(dict(phase="fleet_main", **res))
    for mode in ("stacked", "unstacked"):
        r = res[mode]
        print(f"fleet_main on {smi}: {mode}: {r['cluster_epochs']} "
              f"cluster-epochs in {r['wall_s']:.3f} s, "
              f"{r['cluster_epochs_per_s']:.3f} cluster-epochs/s (init "
              f"{r['init_s']:.3f} s); {r['stats_calls']} stats calls, "
              f"median {r['stats_ms_median']} ms a fleet epoch (bound "
              f"{r['stats_bound_ms_median']} ms); {r['launches']} crush_rule "
              f"launches; peak device memory {r['peak_device_bytes']} bytes",
              flush=True)
    return res


# -- the placement service ----------------------------------------------------

SERVE_CORPUS = ROOT / "tests" / "data" / "serve_corpus.json"
SERVE_PGS, SERVE_OSDS = 256, 16  # tests/test_torch_serve.py's map
# bench.py::bench_serve's (:954)
SERVE_MAIN_CFG = dict(block=2048, fill=8192, max_queue=64, deadline_s=2.0,
                      degraded_batches=2)
SERVE_BULK_SEEDS = 1 << 20  # (a): one query_block
SERVE_ORACLE = 256  # (a): lanes held to the host oracle
SERVE_SCALAR_S, SERVE_SCALAR_CLIENTS, SERVE_SCALAR_BATCH = 10.0, 3, 1024
SERVE_BULK_S, SERVE_BULK_CLIENTS, SERVE_BULK_BLOCK = 5.0, 2, 1 << 16
SERVE_FRONT_BLOCKS, SERVE_FRONT_LANES = 40, 4096
SERVE_SEED = 12  # the seeds of serve_main's lookups and swaps


def serve_map(pgs: int = SERVE_PGS):
    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                  pg_num=pgs, pgp_num=pgs)
    return build_hierarchical(4, 4, n_rack=1, pool=pool)


def serve_cfg(**kw) -> ServeConfig:
    """tests/test_torch_serve.py's configuration."""
    base = dict(window_s=0.02, block=64, fill=512, max_queue=8,
                deadline_s=5.0, bulk_max=256, degraded_batches=1)
    base.update(kw)
    return ServeConfig(**base)


def reply_rows(r) -> dict:
    return {k: np.asarray(getattr(r, k)).tolist()
            for k in ("up", "up_primary", "acting", "acting_primary")}


def reply_sha(r) -> str:
    """sha256 over a (bulk) reply's statuses, if any, and its rows (the
    tests' `_sha`)."""
    h = hashlib.sha256()
    if hasattr(r, "statuses"):
        h.update(np.ascontiguousarray(r.statuses).tobytes())
    for k in ("up", "up_primary", "acting", "acting_primary"):
        h.update(np.ascontiguousarray(getattr(r, k)).tobytes())
    return h.hexdigest()


def reweight_inc(epoch: int, osd: int, frac: float) -> Incremental:
    inc = Incremental(epoch=epoch)
    inc.new_weight[osd] = int(0x10000 * frac)
    return inc


def overlay_inc(m, epoch: int) -> Incremental:
    """tests/test_torch_serve.py's `_overlay_inc`: PG 0.7's first OSD and
    PG 0.9's second upmapped to the lowest OSD not in the row."""
    inc = Incremental(epoch=epoch)
    for seed, j in ((7, 0), (9, 1)):
        _, _, act, _ = m.pg_to_up_acting_osds(PgId(0, seed))
        to = min(set(range(SERVE_OSDS)) - set(act))
        inc.new_pg_upmap_items[PgId(0, seed)] = [(act[j], to)]
    return inc


def device_only(replies, what: str) -> None:
    bad = [r.source for r in replies if r.source != "device"]
    check(not bad, f"{what}: {len(bad)} replies not from the device "
                   f"({sorted(set(bad))}) with no fault injected")


def phase_serve_corpus(dev) -> int:
    """tests/test_torch_serve.py's scripts on the card, held to the JAX
    service's records (tests/data/serve_corpus.json): lookups, a bulk
    block, value-only, overlay, structural and adopted swaps, the
    two-pool map's mixed submit and placement digest, a front, the JAX
    checkpoint resumed and the port's own; then an admission burst of
    max_queue + 8 (exactly 8 EBUSY).  Returns the pipeline kernel's
    launches from 0, the burst excluded.  (The injected device loss is
    runtime_main's.)"""
    from ceph_tpu_torch.serve import meshcheck, service
    from ceph_tpu_torch.serve.front import ServeFront

    corpus = json.loads(SERVE_CORPUS.read_text())
    cases = corpus["cases"]
    fresh_observers()
    torch.cuda.synchronize()
    pipeline.pipeline_cuda.launches = 0
    replies = []
    svc = PlacementService(serve_map(), config=serve_cfg(), device=dev,
                           name="chip.corpus")
    try:
        base = cases["base"]
        r = svc.lookup_batch(0, [0, 1, 42, 137, 255])
        replies.append(r)
        check(reply_rows(r) == base["lookup"], "serve_corpus: lookup rows")
        r = svc.lookup_object(0, "rbd_data.1f3a.0000000000000007")
        replies.append(r)
        check(reply_rows(r) == base["object"], "serve_corpus: object rows")
        seeds = np.random.default_rng(7).integers(0, SERVE_PGS, 500)
        r = svc.query_block(0, seeds.astype(np.uint32))
        replies.append(r)
        check(reply_sha(r) == base["block"], "serve_corpus: bulk block")
        check(svc.sample_digest() == base["digest"],
              "serve_corpus: sample_digest at epoch 1")
        rw = cases["reweight"]
        check(svc.apply(reweight_inc(svc.epoch + 1, 3, 0.5))["ok"],
              "serve_corpus: value-only swap")
        r = svc.query_block(0, np.arange(64))
        replies.append(r)
        check(reply_sha(r) == rw["rows"], "serve_corpus: reweighted rows")
        check(svc.sample_digest() == rw["digest1"],
              "serve_corpus: sample_digest after the swap")
        for _ in range(3):
            check(svc.apply(reweight_inc(svc.epoch + 1, 5, 0.9))["ok"],
                  "serve_corpus: value-only swap")
        check(svc.epoch == rw["epoch"]
              and svc.sample_digest() == rw["digest"],
              "serve_corpus: sample_digest after four swaps")
    finally:
        svc.close()

    svc = PlacementService(serve_map(), config=serve_cfg(), device=dev,
                           name="chip.swaps")
    try:
        sw = cases["swaps"]
        seeds = np.arange(SERVE_PGS, dtype=np.uint32)
        c0 = service.dump()
        check(svc.apply(overlay_inc(svc._active.m, svc.epoch + 1))["ok"],
              "serve_corpus: overlay swap")
        got = {"overlay": svc.query_block(0, seeds)}
        inc = Incremental(epoch=svc.epoch + 1)
        inc.new_state[2] = OSD_UP  # the XOR marks it down
        check(svc.apply(inc)["ok"], "serve_corpus: down swap")
        got["down"] = svc.query_block(0, seeds)
        inc = Incremental(epoch=svc.epoch + 1)
        inc.new_max_osd = svc._active.m.max_osd + 4
        check(svc.apply(inc)["ok"], "serve_corpus: structural swap")
        got["structural"] = svc.query_block(0, seeds)
        m2 = value_copy_map(svc._active.m)
        m2.epoch += 1
        m2.pg_upmap_items = dict(m2.pg_upmap_items)
        m2.pg_upmap_items[PgId(0, 1)] = [(0, 0), (1, 1)]
        check(svc.adopt_map(m2, reason="chip")["ok"],
              "serve_corpus: adopted map")
        got["adopted"] = svc.query_block(0, seeds)
        replies += got.values()
        for k, r in got.items():
            check(reply_sha(r) == sw[k], f"serve_corpus: {k} rows")
        c1 = service.dump()
        check({k: c1[k] - c0[k] for k in ("swap_delta_applies",
                                          "swap_full_restages")}
              == {"swap_delta_applies": 2, "swap_full_restages": 1},
              "serve_corpus: two forks and one structural restage")
        check(svc.epoch == sw["epoch"]
              and svc.sample_digest() == sw["digest"],
              "serve_corpus: sample_digest after the swaps")
    finally:
        svc.close()

    two = cases["two_pools"]
    m = meshcheck.build_default(pgs=64, osds=8)
    svc = PlacementService(m, config=serve_cfg(), device=dev,
                           name="chip.two")
    try:
        rng = np.random.default_rng(23)
        p0, p1 = sorted(m.pools)[:2]
        pools = rng.choice([p0, p1], 240)
        seeds = rng.integers(0, 32, 240).astype(np.uint32)
        digest, oracle = meshcheck.placement_digest(svc, m)
        r = svc.submit_many(pools, seeds)
        replies.append(r)
        check(reply_sha(r) == two["mixed"], "serve_corpus: submit_many")
        check(digest == two["placement_digest"] and oracle,
              "serve_corpus: placement digest == JAX and the host oracle")
        check(svc.sample_digest() == two["digest"],
              "serve_corpus: two-pool sample_digest")
    finally:
        svc.close()

    fr = cases["front"]
    f = ServeFront(serve_map(), replicas=2, config=serve_cfg(), device=dev,
                   name="chip.front")
    try:
        seeds = np.random.default_rng(3).integers(0, SERVE_PGS, 300)
        r = f.query_block(0, seeds)
        replies.append(r)
        check(reply_sha(r) == fr["block"], "serve_corpus: front block")
        check(f.apply(reweight_inc(f.epoch + 1, 3, 0.5))["ok"],
              "serve_corpus: front fan-out")
        r = f.query_block(0, seeds)
        replies.append(r)
        check(reply_sha(r) == fr["block2"], "serve_corpus: front block 2")
    finally:
        f.close()

    ck_want = corpus["checkpoint"]
    with tempfile.TemporaryDirectory() as tmp:
        ck = Path(tmp) / "jax_ck.json"
        ck.write_text(json.dumps({"stages_done": [],
                                  "serve": ck_want["ck"]}))
        svc = PlacementService(config=serve_cfg(), checkpoint=str(ck),
                               resume=True, device=dev, name="chip.resume")
        try:
            check(svc.epoch == ck_want["epoch"]
                  and svc.sample_digest() == ck_want["digest"],
                  "serve_corpus: the JAX checkpoint resumed")
            r = svc.lookup_batch(0, np.arange(16))
            replies.append(r)
            check(reply_sha(r) == ck_want["spot"],
                  "serve_corpus: resumed rows")
        finally:
            svc.close()
        ck = Path(tmp) / "port_ck.json"
        svc = PlacementService(serve_map(), config=serve_cfg(), device=dev,
                               checkpoint=str(ck), name="chip.ck")
        try:
            for _ in range(2):
                check(svc.apply(reweight_inc(svc.epoch + 1, 1, 0.75))["ok"],
                      "serve_corpus: checkpointed swap")
            digest = svc.sample_digest()
        finally:
            svc.close()
        check(json.loads(ck.read_text())["serve"]["map_b64"]
              == ck_want["ck"]["map_b64"],
              "serve_corpus: the checkpoint's map blob == JAX's")
        svc = PlacementService(config=serve_cfg(), checkpoint=str(ck),
                               resume=True, device=dev, name="chip.ck2")
        try:
            check(svc.resumed_from == ck_want["epoch"]
                  and svc.sample_digest() == digest == ck_want["digest"],
                  "serve_corpus: the port's checkpoint resumed")
        finally:
            svc.close()
    device_only(replies, "serve_corpus")
    torch.cuda.synchronize()
    launches = pipeline.pipeline_cuda.launches
    check(launches > 0, "serve_corpus: the pipeline kernel launched")

    # the admission burst, outside the count
    svc = PlacementService(serve_map(), config=serve_cfg(), device=dev,
                           name="chip.burst")
    try:
        svc.pause()
        burst: list = []
        n = svc.config.max_queue + 8

        def one():
            r = svc.lookup_batch(0, [1, 2, 3], deadline_s=10.0)
            burst.append(r)

        ths = [threading.Thread(target=one) for _ in range(n)]
        for t in ths:
            t.start()
        t_end = time.time() + 10
        while len(svc._q) + len(burst) < n and time.time() < t_end:
            time.sleep(0.01)
        svc.unpause()
        for t in ths:
            t.join(timeout=30)
        statuses = sorted(r.status for r in burst)
        check(len(burst) == n and statuses.count("EBUSY") == 8
              and statuses.count("ok") == n - 8,
              f"serve_corpus: a burst of {n}: exactly 8 EBUSY "
              f"({statuses})")
        device_only([r for r in burst if r.ok], "serve_corpus: the burst")
    finally:
        svc.close()
    emit({"phase": "serve_corpus", "launches": launches,
          "replies_checked": len(replies), "burst": n})
    return launches


def replied_lanes(lanes: int, r) -> dict:
    """A reply's lanes by status, read off the reply itself: a bulk
    reply's status vector, unless its rows do not cover it; a scalar ok
    reply counts the rows it carries, a refused one its `lanes`."""
    if hasattr(r, "counts"):
        rows = 0 if r.up is None else len(r.up)
        if rows != len(r.statuses) and r.counts().get("ok"):
            return {"rows_short": rows}
        return r.counts()
    return {r.status: len(r.up) if r.ok else lanes}


class ServeClients:
    """Closed-loop client threads: each calls `fn(rng)` until stopped and
    keeps every reply's lanes, status counts, sources and latency."""

    def __init__(self, n: int, fn, seed: int):
        self.fn = fn
        self.stop = threading.Event()
        self.lat: list = []
        self.submitted = self.replied = self.ok = 0
        self.done: list = []  # (host clock at the reply, ok lanes)
        self.sources: dict = {}
        self.statuses: dict = {}
        self.errors: list = []
        self._lock = threading.Lock()
        self.threads = [threading.Thread(
            target=self._run, args=(np.random.default_rng([seed, i]),))
            for i in range(n)]

    def _run(self, rng):
        try:
            while not self.stop.is_set():
                t0 = time.perf_counter()
                lanes, r = self.fn(rng)
                dt = time.perf_counter() - t0
                counts = replied_lanes(lanes, r)
                with self._lock:
                    self.submitted += lanes
                    self.replied += sum(counts.values())
                    self.ok += counts.get("ok", 0)
                    for k, v in counts.items():
                        self.statuses[k] = self.statuses.get(k, 0) + v
                    self.sources[r.source] = \
                        self.sources.get(r.source, 0) + 1
                    if counts.get("ok"):
                        self.lat.append(dt)
                        self.done.append((t0 + dt, counts["ok"]))
        except Exception as e:  # surfaced by finish()
            self.errors.append(f"{type(e).__name__}: {e}")

    def start(self):
        for t in self.threads:
            t.start()
        return self

    def finish(self, what: str) -> dict:
        self.stop.set()
        for t in self.threads:
            t.join(timeout=60)
        check(not self.errors, f"{what}: client errors {self.errors[:3]}")
        check(self.submitted == self.replied,
              f"{what}: submitted {self.submitted} == replied "
              f"{self.replied} (never dropped)")
        check(set(self.sources) == {"device"},
              f"{what}: every reply from the device ({self.sources})")
        check(self.statuses == {"ok": self.submitted},
              f"{what}: every lane ok ({self.statuses})")
        lat = np.asarray(self.lat)
        return {"lookups": self.ok, "requests": len(self.lat),
                "done": self.done,
                "p50_s": float(np.percentile(lat, 50)),
                "p99_s": float(np.percentile(lat, 99))}


def serve_rows_checked(svc, seeds: np.ndarray, what: str, dev) -> None:
    """The active epoch's answers on `seeds`, held to a fresh PoolMapper
    of the same map (outside the counted windows) and, on a few seeds,
    to the host oracle."""
    r = svc.query_block(0, seeds, deadline_s=0)
    m = svc._active.m
    want = PoolMapper(m, 0, device=dev).map_batch(seeds)
    check(r.ok and all(np.array_equal(a, b) for a, b in zip(
        (r.up, r.up_primary, r.acting, r.acting_primary), want)),
        f"{what}: rows == a fresh mapper's")
    for i in range(0, len(seeds), max(1, len(seeds) // 16)):
        up, upp, act, actp = m.pg_to_up_acting_osds(PgId(0, int(seeds[i])))
        check([int(o) for o in r.acting[i] if o != ITEM_NONE] == list(act)
              and int(r.acting_primary[i]) == actp,
              f"{what}: seed {seeds[i]} == the host oracle")


def sub_block_parts(pm, seeds: np.ndarray, runs: int = 20) -> dict:
    """Where one bulk sub-block's time goes (medians of `runs`, after the
    counted window): the whole `map_batch` (host clock), its rows left
    on the card (`_rows`, synchronised), the pipeline kernel that computes
    them and the rule kernel alone on the same seeds (CUDA events), the
    rule kernel held to its plain version, whose draws give the issue
    bound of these lanes (OPS_PER_DRAW a draw), the pipeline kernel to the
    plain chain."""
    def median_s(fn):
        out = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out)

    ps = pm._seeds(seeds)
    x = mapper.u32_bits(pm.placement_seeds(ps))
    w = mapper.u32_bits(mapper._weight_vector(pm.rule_weights()))
    def event_ms(fn):
        out = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return statistics.median(out)

    kernel_ms = event_ms(lambda: mapper.crush_rule_cuda(pm.tables, pm.prog,
                                                        x, w))
    pipe_ms = event_ms(lambda: pipeline.pipeline_cuda(pm, ps, "rows"))
    check(all(torch.equal(g.long(), p) for g, p in zip(
        pipeline.pipeline_cuda(pm, ps, "rows"), pm.pipeline_plain(ps))),
        "serve_main (a): sub-block pipeline kernel == plain chain")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, draws = mapper.crush_rule_plain(pm.tables, pm.prog, x, w)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(mapper.crush_rule_cuda(pm.tables, pm.prog, x, w),
                      want), "serve_main (a): sub-block kernel == plain")
    issue_rate = H100_SMS * SCHEDULERS_PER_SM * WARP * max_sm_clock_hz()
    return {"lanes": len(seeds), "plain_ms": plain_ms,
            "draws": int(draws.sum()),
            "bound_ms": int(draws.sum()) * OPS_PER_DRAW / issue_rate * 1e3,
            "bound_by": "operations",
            "map_batch_ms": median_s(lambda: pm.map_batch(seeds)) * 1e3,
            "rows_on_device_ms": median_s(lambda: pm._rows(
                pm._seeds(seeds))) * 1e3,
            "pipeline_ms": pipe_ms, "kernel_ms": kernel_ms}


def phase_serve_main(dev, smi: str) -> dict:
    """The placement service at BASELINE config 5 (10M PGs / 10k OSDs)
    with bench.py::bench_serve's settings: (a) one query_block of 2^20
    seeds held to map_all_tensors() and 256 lanes to the host oracle;
    (b) 3 closed-loop clients of 1024 seeds for 10 s through the
    micro-batcher while a value-only reweight lands every second; (c) 2
    bulk clients of 2^16 seeds for 5 s with one structural swap (an
    upmap overlay adopted) mid-window; (d) a 2-replica ServeFront on
    config 2 with a stall aimed at one replica.  Each part's rule
    launches counted from 0; every lane answered, from the device."""
    from ceph_tpu_torch.serve import service
    from ceph_tpu_torch.serve.front import ServeFront

    fresh_observers()
    service.reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res: dict = {"nvidia_smi": smi}
    m = bench_map(*CONFIGS["config5"])
    cfg = ServeConfig(**SERVE_MAIN_CFG)
    rng = np.random.default_rng(SERVE_SEED)

    # (a) the bulk edge: 2^20 lanes fit a lane capacity of max_queue x
    # block only with max_queue 512, so (a) raises it
    (svc, init_s, _) = timed(lambda: PlacementService(
        m, config=dataclasses.replace(cfg, max_queue=512), device=dev,
        name="chip.serve.bulk"))
    try:
        seeds = rng.integers(0, CONFIGS["config5"][0],
                             SERVE_BULK_SEEDS).astype(np.uint32)
        r, s, launches = timed(lambda: svc.query_block(0, seeds,
                                                       deadline_s=60.0))
        check(r.ok and r.source == "device",
              f"serve_main (a): every lane ok from the device "
              f"({r.counts()}, {r.source})")
        sub = max(cfg.bulk_max, cfg.block)
        check(launches == -(-SERVE_BULK_SEEDS // sub),
              f"serve_main (a): {launches} launches, one a sub-block of "
              f"{sub}")
        full = svc._active.mapper(0).map_all_tensors()
        idx = torch.from_numpy(seeds.astype(np.int64)).to(dev)
        for got, t in zip((r.up, r.up_primary, r.acting, r.acting_primary),
                          full):
            check(np.array_equal(got, t[idx].cpu().numpy()),
                  "serve_main (a): rows == map_all_tensors() at the seeds")
        del full
        t0 = time.perf_counter()
        for i in range(SERVE_ORACLE):
            up, upp, act, actp = m.pg_to_up_acting_osds(
                PgId(0, int(seeds[i])))
            check([int(o) for o in r.up[i] if o != ITEM_NONE] == list(up)
                  and [int(o) for o in r.acting[i] if o != ITEM_NONE]
                  == list(act) and int(r.up_primary[i]) == upp
                  and int(r.acting_primary[i]) == actp,
                  f"serve_main (a): seed {seeds[i]} == the host oracle")
        res["bulk"] = {"lookups": SERVE_BULK_SEEDS, "s": s,
                       "lookups_per_s": SERVE_BULK_SEEDS / s,
                       "launches": launches, "init_s": init_s,
                       "oracle_lanes": SERVE_ORACLE,
                       "oracle_s": time.perf_counter() - t0,
                       "sub_block": sub_block_parts(
                           svc._active.mapper(0), seeds[:cfg.bulk_max])}
    finally:
        svc.close()

    svc = PlacementService(m, config=cfg, device=dev, name="chip.serve")
    try:
        # (b) the queued micro-batcher under a value-only swap a second
        c0, st0 = service.dump(), counts("state")
        n_pgs = CONFIGS["config5"][0]
        clients = ServeClients(SERVE_SCALAR_CLIENTS, lambda g: (
            SERVE_SCALAR_BATCH, svc.lookup_batch(
                0, g.integers(0, n_pgs, SERVE_SCALAR_BATCH))), SERVE_SEED)
        applies: list = []
        torch.cuda.synchronize()
        pipeline.pipeline_cuda.launches = 0
        t0 = time.perf_counter()
        clients.start()
        next_swap = t0 + 1.0
        while time.perf_counter() - t0 < SERVE_SCALAR_S:
            time.sleep(0.01)
            if time.perf_counter() >= next_swap:
                inc = Incremental(epoch=svc.epoch + 1)
                for o in rng.choice(CONFIGS["config5"][1], 4,
                                    replace=False):
                    inc.new_weight[int(o)] = int(
                        0x10000 * (0.7 + 0.3 * rng.random()))
                ta = time.perf_counter()
                out = svc.apply(inc)
                applies.append(time.perf_counter() - ta)
                check(out["ok"], f"serve_main (b): swap {out}")
                next_swap += 1.0
        b = clients.finish("serve_main (b)")
        del b["done"]
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        c1, st1 = service.dump(), counts("state")
        stall = c1["swap_stall_seconds"]
        b.update(
            s=wall, qps=b["lookups"] / wall,
            launches=pipeline.pipeline_cuda.launches, swaps=len(applies),
            apply_ms=[round(a * 1e3, 3) for a in applies],
            swap_stall_p99_s=stall["p99"], swap_stall_max_s=stall["max"],
            bytes_uploaded=st1["device_put_bytes"]
            - st0["device_put_bytes"],
            swap_delta_applies=c1["swap_delta_applies"]
            - c0["swap_delta_applies"],
            swap_full_restages=c1["swap_full_restages"]
            - c0["swap_full_restages"],
            state_rebuilds=st1["full_rebuilds"] - st0["full_rebuilds"],
            batches=c1["batches"] - c0["batches"],
            batch_fill_p50=c1["batch_fill_hist"]["p50"])
        check(b["swap_delta_applies"] == b["swaps"] >= 8
              and b["swap_full_restages"] == 0 == b["state_rebuilds"],
              f"serve_main (b): every swap a fork ({b})")
        res["scalar"] = b
        serve_rows_checked(svc, rng.integers(0, n_pgs, 1 << 14)
                           .astype(np.uint32), "serve_main (b)", dev)

        # (c) the bulk edge under one structural swap mid-window
        c0 = service.dump()
        clients = ServeClients(SERVE_BULK_CLIENTS, lambda g: (
            SERVE_BULK_BLOCK, svc.query_block(
                0, g.integers(0, n_pgs, SERVE_BULK_BLOCK))), SERVE_SEED + 1)
        m2 = value_copy_map(svc._active.m)
        m2.epoch += 1
        m2.pg_upmap_items = dict(m2.pg_upmap_items)
        _, _, act, _ = m2.pg_to_up_acting_osds(PgId(0, 1))
        to = next(o for o in range(m2.max_osd)
                  if o not in act and m2.osd_weight[o])
        m2.pg_upmap_items[PgId(0, 1)] = [(act[0], to)]
        torch.cuda.synchronize()
        pipeline.pipeline_cuda.launches = 0
        t0 = time.perf_counter()
        clients.start()
        time.sleep(SERVE_BULK_S / 2)
        ta = time.perf_counter()
        swap = svc.adopt_map(m2, reason="chip structural")
        stage_s = time.perf_counter() - ta
        check(swap["ok"], f"serve_main (c): structural swap {swap}")
        time.sleep(SERVE_BULK_S / 2)
        c = clients.finish("serve_main (c)")
        wall = time.perf_counter() - t0
        done = c.pop("done")
        t_flip = ta + stage_s
        for key, lo, hi in (("before_swap", t0, ta),
                            ("after_swap", t_flip, t0 + wall)):
            n = sum(k for t, k in done if lo <= t < hi)
            c[f"lookups_per_s_{key}"] = n / (hi - lo)
        torch.cuda.synchronize()
        c1 = service.dump()
        c.update(s=wall, lookups_per_s=c["lookups"] / wall,
                 launches=pipeline.pipeline_cuda.launches,
                 stage_s=stage_s, flip_stall_s=swap["swap_stall_s"],
                 structural_swap_stalls=c1["structural_swap_stalls"]
                 - c0["structural_swap_stalls"],
                 warm_stages=c1["warm_stages"] - c0["warm_stages"])
        check(c["structural_swap_stalls"] == 0 and c["warm_stages"] == 1,
              f"serve_main (c): one stage off the readers' threads, the "
              f"flip within its bound ({c})")
        res["structural"] = c
        seeds = np.concatenate([[1], rng.integers(0, n_pgs, 4095)])
        serve_rows_checked(svc, seeds.astype(np.uint32), "serve_main (c)",
                           dev)
        r = svc.lookup(0, 1)
        check(to in [int(o) for o in r.up[0]],
              "serve_main (c): PG 0.1 answers its upmap")
        res["degraded_answered"] = service.dump()["degraded_answered"]
        check(res["degraded_answered"] == 0,
              "serve_main: no lane answered by the host")
    finally:
        svc.close()

    # (d) a 2-replica front on config 2, a stall aimed at replica 1
    m = bench_map(*CONFIGS["config2"])
    f = ServeFront(m, replicas=2, config=cfg, device=dev,
                   name="chip.front")
    try:
        n_pgs = CONFIGS["config2"][0]
        f0 = counts("serve")
        blocks = [rng.integers(0, n_pgs, SERVE_FRONT_LANES).astype(
            np.uint32) for _ in range(SERVE_FRONT_BLOCKS)]
        f.query_block(0, blocks[0])  # both replicas' latency EWMA
        torch.cuda.synchronize()
        pipeline.pipeline_cuda.launches = 0
        faults.arm("serve_dispatch.chip.front.r1", "stall", "0.4", 8)
        lat, replies = [], []
        try:
            for seeds in blocks:
                t0 = time.perf_counter()
                replies.append(f.query_block(0, seeds))
                lat.append(time.perf_counter() - t0)
        finally:
            faults.disarm("serve_dispatch.chip.front.r1")
        torch.cuda.synchronize()
        launches = pipeline.pipeline_cuda.launches
        check(all(r.ok and r.source == "device" for r in replies),
              "serve_main (d): every lane ok from the device")
        want = PoolMapper(m, 0, device=dev)
        for seeds, r in zip(blocks[:4], replies[:4]):
            check(all(np.array_equal(a, b) for a, b in zip(
                (r.up, r.up_primary, r.acting, r.acting_primary),
                want.map_batch(seeds))),
                "serve_main (d): rows == a fresh mapper's")
        f1 = counts("serve")
        d = {k: f1[k] - f0[k] for k in f1 if k.startswith("front_")}
        check(d["front_replica_sheds"] >= 1 and d["front_shed_routes"] > 0,
              f"serve_main (d): the stalled replica shed ({d})")
        lat = np.asarray(lat)
        res["front"] = dict(d, blocks=SERVE_FRONT_BLOCKS,
                            lanes=SERVE_FRONT_LANES, launches=launches,
                            block_p50_s=float(np.percentile(lat, 50)),
                            block_p99_s=float(np.percentile(lat, 99)))
    finally:
        f.close()
    torch.cuda.synchronize()
    res["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    emit(dict(phase="serve_main", **res))
    a, b, c, d = res["bulk"], res["scalar"], res["structural"], res["front"]
    print(f"serve_main on {smi}: (a) {a['lookups']} lookups in one "
          f"query_block, {a['s']:.6f} s, {a['lookups_per_s']:.1f} "
          f"lookups/s, {a['launches']} launches; (b) {b['qps']:.1f} "
          f"lookups/s, request p50 {b['p50_s']:.6f} s p99 "
          f"{b['p99_s']:.6f} s over {b['requests']} requests, swap stall "
          f"p99 {b['swap_stall_p99_s']:.9f} s max "
          f"{b['swap_stall_max_s']:.9f} s, {b['swaps']} swaps, apply ms "
          f"{b['apply_ms']}, {b['bytes_uploaded']} bytes up, "
          f"{b['launches']} launches; (c) {c['lookups_per_s']:.1f} "
          f"lookups/s, stage {c['stage_s']:.3f} s, flip "
          f"{c['flip_stall_s']} s, {c['structural_swap_stalls']} "
          f"structural stalls, {c['launches']} launches; (d) block p99 "
          f"{d['block_p99_s']:.6f} s, {d['front_replica_sheds']} sheds; "
          f"peak device memory {res['peak_device_bytes']} bytes",
          flush=True)
    return res


# -- the EC strategies and the native host engines ----------------------------

STRATEGY_RUNS = 10  # timed runs of each strategy per shape (median)
NATIVE_X = 1 << 20  # config-5 seeds the native mapper maps on all cores
# the prefix of them it maps on one core (all 2^20 take about 20 s on
# one core of the H100 machine's 8-core host)
NATIVE_ONE_CORE_X = 1 << 18
NATIVE_RUNS = 5  # timed runs of the native RS(8,4) encode / decode


def strategy_launches(what: str, fn, dev):
    """Run fn() with the GF kernel's count from 0 and hold its launches to
    those its products make (`engine_launches`: a grouped product one
    when its list resolved to `pallas`, under `auto` too, another product
    one when it resolved to `pallas`), plus
    the two (warm-up and timed) of the `pallas` candidate in each
    autotune on the card."""
    tunes = counts("ec")["autotunes"]
    gf_matmul_cuda.launches = 0
    with engine_launches() as log:
        out = fn()
    launches = gf_matmul_cuda.launches
    tunes = counts("ec")["autotunes"] - tunes
    per_tune = 2 if "pallas" in TorchEngine._candidates(dev) else 0
    expected = launches_of(log) + per_tune * tunes
    check(launches == expected, f"{what}: {launches} kernel launches, "
          f"expected {expected} ({len(log)} products and groups, {tunes} "
          f"autotunes)")
    return out, launches, tunes


def ec_strategy_corpus(strategy: str, dev) -> None:
    """Every entry of tests/data/ec_corpus.json (jerasure, isa, clay,
    shec, lrc, whose layers take the strategy) on CUDA tensors through
    `strategy`: stripe and rebuilt digests equal to the corpus."""
    for entry in json.loads(CORPUS.read_text())["entries"]:
        name = entry["name"]
        code = create_erasure_code(dict(entry["profile"], strategy=strategy),
                                   device="cuda")
        L = entry["chunk_bytes"]
        data = torch.from_numpy(_data_for(name, code.k, L)).to(dev)
        enc = code.encode_chunks(data)
        check(_digest(enc) == entry["digest"],
              f"{strategy}: {name} stripe digest")
        n = entry["n_chunks"]
        for case in entry["decode"]:
            erased = list(case["erased"])
            avail = {i: enc[i] for i in range(n) if i not in erased}
            dec = code.decode_chunks(set(erased), avail, L)
            check(_digest(dec[i] for i in erased) == case["digest"],
                  f"{strategy}: {name} decode {erased} digest")


def phase_ec_strategies(dev, peak: float, main: dict) -> tuple[dict, dict]:
    """Every EC strategy (torch_backend.STRATEGIES) through
    create_erasure_code(..., strategy=s) at RS(8,4) on shapes (a)-(c) of
    main_path: bytes equal to the kernel's (`pallas`), which equal the
    plain version's; each timed with CUDA events, L2 flushed, beside the
    kernel's time and HBM bound from main_path.  `auto` measures anew on
    each shape and its record is printed.  Then the ec_corpus entries
    under every strategy.  Returns (results, gf_matmul launches by
    path)."""
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    k, m, N, L = 8, 4, 8192, 4096
    obj = rand_u8((k, 2 * MiB), 500, dev)
    stripes = rand_u8((N, k, L), 501, dev)
    lost = (0, 5)
    codes = {s: create_erasure_code({"plugin": "jax", "k": str(k),
                                     "m": str(m), "strategy": s},
                                    device="cuda") for s in STRATEGIES}
    C = codes["pallas"].C
    Ckey = ("cuda", matrix_key(C))
    want = {}
    paths, res = {}, {}
    for s in ["pallas"] + [s for s in STRATEGIES if s != "pallas"]:
        code, eng = codes[s], codes[s].engine
        got, picks = {}, {}

        def drive():
            torch_backend._AUTOTUNE.pop(Ckey, None)
            got["a"] = code.encode_parity(obj)
            picks["a"] = dict(eng.autotune.get(Ckey[1], {}))
            torch_backend._AUTOTUNE.pop(Ckey, None)
            got["b"] = code.encode_batch(stripes)
            picks["b"] = dict(eng.autotune.get(Ckey[1], {}))
            have = {i: got["b"][:, i] for i in range(k + m) if i not in lost}
            got["c"] = code.decode_batch(set(range(k)), have, L)
            return have

        have, n, tunes = strategy_launches(f"ec_strategies {s}", drive,
                                           dev)
        torch.cuda.synchronize()
        if s == "pallas":
            check(torch.equal(got["a"], gf_matmul_plain(C, obj)),
                  "(a) kernel == plain")
            check(torch.equal(got["b"][:, k:], gf_matmul_plain(C, stripes)),
                  "(b) kernel == plain")
            want = {"a": got["a"], "b": got["b"]}
        check(torch.equal(got["a"], want["a"]), f"{s}: (a) == the kernel's")
        check(torch.equal(got["b"], want["b"]), f"{s}: (b) == the kernel's")
        for i in lost:
            check(torch.equal(got["c"][i], stripes[:, i]),
                  f"{s}: (c) chunk {i}")
        use = sorted(have)[:k]
        R = decode_plan(C, tuple(use), lost, eng)
        stack = torch.stack([have[i] for i in use], dim=1)
        picks["c"] = dict(eng.autotune.get(matrix_key(R), {}))
        times = {
            "a": time_ms(lambda: eng.matmul(C, obj), flush, STRATEGY_RUNS),
            "b": time_ms(lambda: eng.matmul_batch(C, stripes), flush,
                         STRATEGY_RUNS),
            "c": time_ms(lambda: eng.matmul_batch(R, stack), flush,
                         STRATEGY_RUNS),
        }
        del got, have, stack
        out = {"launches": n, "autotunes": tunes}
        for key, ms in times.items():
            nbytes, kernel = main[key]["hbm_bytes"], main[key]
            out[key] = {"ms": ms, "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
                        "kernel_ms": kernel["ms"],
                        "bound_ms": kernel["bound_ms"],
                        "over_kernel": ms / kernel["ms"]}
            if s == "auto":
                out[key]["autotune"] = picks[key]
        res[s] = out
        paths[f"ec_strategies_{s}"] = n
        emit({"phase": "ec_strategies", "strategy": s, **out})
        torch.cuda.empty_cache()
    # row 1's library times: (a)-(c) each as one untiled bitplane
    # product, a single torch.matmul over the whole input's bit expansion
    # ((b), (c): 4 GiB of float16); the `bitplane` strategy above runs it
    # in _BIT_TILE tiles
    have = {i: want["b"][:, i] for i in range(k + m) if i not in lost}
    use = sorted(have)[:k]
    R = decode_plan(C, tuple(use), lost, codes["pallas"].engine)
    inputs = {"a": (C, obj, want["a"]),
              "b": (C, stripes, want["b"][:, k:]),
              "c": (R, torch.stack([have[i] for i in use], dim=1),
                    stripes[:, list(lost)])}
    untiled = {}
    for key, (M, x, out) in inputs.items():
        B = bit_matrix(M, dev)
        check(torch.equal(matmul_bitplane(B, x), out),
              f"untiled bitplane ({key}) == the kernel's")
        untiled[key] = time_ms(lambda: matmul_bitplane(B, x), flush,
                               STRATEGY_RUNS)
        res["bitplane"][key]["untiled_ms"] = untiled[key]
        del B
        torch.cuda.empty_cache()
    del have, inputs
    emit({"phase": "ec_strategies", "bitplane_untiled_ms": untiled,
          "bitplane_tiled_ms": {key: res["bitplane"][key]["ms"]
                                for key in untiled},
          "kernel_ms": {key: main[key]["ms"] for key in untiled}})
    torch.cuda.empty_cache()
    for s in STRATEGIES:
        _, n, tunes = strategy_launches(
            f"ec_strategies corpus {s}", lambda: ec_strategy_corpus(s, dev),
            dev)
        paths[f"ec_strategies_corpus_{s}"] = n
        res[s]["corpus"] = {"entries": 7, "digests_equal": True,
                            "launches": n, "autotunes": tunes}
    # `auto` runs each list under one strategy: a list it gives the
    # kernel is one launch, as under `pallas`, never one per product
    auto, pallas = res["auto"]["corpus"], res["pallas"]["corpus"]
    check(auto["launches"] - 2 * auto["autotunes"] <= pallas["launches"],
          f"ec_strategies corpus auto: {auto['launches']} launches "
          f"({auto['autotunes']} autotunes) against pallas's "
          f"{pallas['launches']}")
    emit({"phase": "ec_strategies_corpus",
          "launches": {s: res[s]["corpus"]["launches"] for s in STRATEGIES},
          "digests_equal": True})
    return res, paths


def host_cpu() -> dict:
    """The host's CPU model and core counts, beside the native numbers."""
    info = {}
    with contextlib.suppress(OSError):
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            key = key.strip()
            if key in ("model name", "vendor_id", "cpu family", "model"):
                info.setdefault(key, value.strip())
    return {"cpuinfo": info, "cpu_count": os.cpu_count(),
            "usable_cores": len(os.sched_getaffinity(0))}


def phase_native_main(dev, pms: dict, smi: str) -> dict:
    """The native host engines (native/*.cpp, g++ at first use): config
    5's first NATIVE_X placement seeds through NativeMapper on all cores
    and their first NATIVE_ONE_CORE_X on one core, rows equal to
    map_rule's on the card, beside the rule kernel's mappings/s on the
    same seeds (BASELINE.md's target is stated against the one-core
    rate); `crushtool --test --backend native` on
    config 2, stdout equal to the default backend's; RS(8,4) encode and
    decode of a 16 MiB object with backend=native, bytes equal to the
    kernel's; CRC-32C of 1 MiB equal to the Python loop."""
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    for name in native.LIBRARIES:
        native.build(name)
    gf, crc_lib = native.load_gf(), native.load_crc()
    out = {"nvidia_smi": smi, "host": host_cpu(),
           "gpp_build_s": dict(native.BUILD_SECONDS),
           "gf_native_simd_level": int(gf.gf_native_simd_level()),
           "crc32c_hw": int(crc_lib.ceph_tpu_crc32c_hw())}

    # config 5: the native mapper beside the rule kernel
    pm = pms["config5"]
    crush = pm.m.crush
    ca = crush.choose_args.get(pm.pool_id, crush.choose_args.get(-1))
    t0 = time.perf_counter()
    nm = NativeMapper(crush, choose_args=ca)
    mirror_s = time.perf_counter() - t0
    x, w = rule_inputs(pm, NATIVE_X)
    want = mapper.map_rule(pm.tables, pm.prog, x, w).cpu().numpy()
    xs = x.cpu().numpy().astype(np.uint32)
    ws = w.cpu().numpy().astype(np.uint32)
    xb, wb = mapper.u32_bits(x), mapper.u32_bits(w)
    rates = {}
    for label, threads, n in (("one_core", 1, NATIVE_ONE_CORE_X),
                              ("all_cores", 0, NATIVE_X)):
        t0 = time.perf_counter()
        rows = nm.map_batch(pm.spec.ruleno, xs[:n], pm.spec.size, ws,
                            n_threads=threads)
        sec = time.perf_counter() - t0
        check(np.array_equal(rows, want[:n]),
              f"native {label}: rows == map_rule's on the card")
        kernel_ms = time_ms(
            lambda n=n: mapper.crush_rule_cuda(pm.tables, pm.prog, xb[:n],
                                               wb), flush, runs=7)
        rates[label] = {
            "seeds": n, "seconds": sec, "mappings_per_s": n / sec,
            "kernel_ms": kernel_ms,
            "kernel_mappings_per_s": n / (kernel_ms * 1e-3),
            # the same seeds: host wall time over kernel CUDA-event time
            "kernel_over_native": sec / (kernel_ms * 1e-3)}
    out["config5"] = {"mirror_s": mirror_s, **rates, "rows_equal": True}

    # crushtool --test on config 2: native == the default backend
    argv = ["-i", "c2crush", "--test", "--num-rep", "3", "--min-x", "0",
            "--max-x", str(CONFIGS["config2"][0] - 1), "--pool-id", "0",
            "--show-statistics", "--show-utilization"]
    with tempfile.TemporaryDirectory() as d, contextlib.chdir(d):
        with open("c2crush", "wb") as f:
            f.write(encode_crushmap(pms["config2"].m.crush))
        (default, dsec), n = counted(
            1, "crushtool default backend", lambda: run_cli(crushtool, argv),
            mapper.crush_rule_cuda)
        (nat, nsec), n_native = counted(
            0, "crushtool --backend native",
            lambda: run_cli(crushtool, argv + ["--backend", "native"]),
            mapper.crush_rule_cuda)
    sha = {key: hashlib.sha256(t.encode()).hexdigest()
           for key, t in (("default", default), ("native", nat))}
    check(sha["default"] == sha["native"],
          "crushtool --backend native stdout == the default backend's")
    out["crushtool_config2"] = {"sha256": sha["native"], "launches": n,
                                "default_s": dsec, "native_s": nsec}

    # RS(8,4) with backend=native on a 16 MiB object, against the kernel
    code = create_erasure_code({"plugin": "jax", "k": "8", "m": "4",
                                "backend": "native"}, device="cuda")
    L = 2 * MiB
    obj = rand_u8((8, L), 600, dev)
    want_parity = gf_matmul_plain(code.C, obj)
    (kparity, _) = counted(1, "native rs: the kernel's parity",
                           lambda: TorchEngine(dev).matmul(code.C, obj))
    check(torch.equal(kparity, want_parity), "kernel == plain (native rs)")
    host = obj.cpu().numpy()
    times = {"encode": [], "decode": []}
    for _ in range(NATIVE_RUNS):
        t0 = time.perf_counter()
        parity = code.encode_parity(host)
        times["encode"].append(time.perf_counter() - t0)
    check(np.array_equal(parity, kparity.cpu().numpy()),
          "native encode == the kernel's bytes")
    chunks = {i: c for i, c in enumerate(np.concatenate([host, parity]))
              if i not in (0, 5)}
    for _ in range(NATIVE_RUNS):
        t0 = time.perf_counter()
        dec = code.decode_chunks({0, 5}, dict(chunks), L)
        times["decode"].append(time.perf_counter() - t0)
    check(all(np.array_equal(dec[i], host[i]) for i in (0, 5)),
          "native decode == the object's bytes")
    out["rs84_16mib"] = {
        key: {"seconds_median": statistics.median(v),
              "object_gb_per_s": 8 * L / statistics.median(v) / 1e9}
        for key, v in times.items()}

    # CRC-32C of 1 MiB: the native kernel == the Python loop
    buf = rand_u8((MiB,), 601, dev).cpu().numpy().tobytes()
    t0 = time.perf_counter()
    got = crc32c_mod.crc32c(buf)
    crc_s = time.perf_counter() - t0
    check(got == crc32c_mod._crc_bytes(buf, 0xFFFFFFFF) & 0xFFFFFFFF,
          "native CRC-32C == the Python loop")
    out["crc32c_1mib"] = {"value": got, "seconds": crc_s}
    emit({"phase": "native_main", **out})
    return out


# -- the operator surface: the daemon, a live admin socket, tracing -----------

OBS_CORPUS = ROOT / "tests" / "data" / "obs_corpus.json"
PROM_LINE = re.compile(
    r"^[a-zA-Z_][a-zA-Z0-9_]*(\{[^}]*\})? (-?[0-9.e+-]+|NaN|\+Inf)$")
# the daemon self-test's launches of each kernel: one RS(8,4) encode of
# 8 x 4096 bytes, one map_batch of 256 PGs (the pipeline kernel), one
# diagnose
OBS_KERNELS = (("gf_matmul", "ec", 1), ("pipeline", "pipeline", 1),
               ("crush_rule_diag", "pipeline", 1))
# a child mapping config 2 on the card in a loop while its admin socket
# answers (CEPH_TPU_ADMIN_SOCKET); it stops itself after two minutes
_LIVE_MAPPER = r"""
import sys, time
import numpy as np
from ceph_tpu_torch import obs  # serves CEPH_TPU_ADMIN_SOCKET
from ceph_tpu_torch.osd.osdmap import build_hierarchical
from ceph_tpu_torch.osd.pipeline import PoolMapper
from ceph_tpu_torch.osd.types import PgPool, PoolType
n_pgs, n_osds, per_host = (int(a) for a in sys.argv[1:4])
n_host = max(1, n_osds // per_host)
pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
              pg_num=n_pgs, pgp_num=n_pgs)
m = build_hierarchical(n_host, per_host, n_rack=max(1, n_host // 16),
                       pool=pool)
pm = PoolMapper(m, 0, overlays=False)
pm.map_all()
print("ready", flush=True)
t_end = time.time() + 120
while time.time() < t_end:
    pm.map_all()
"""


def _daemon_argv(*argv: str) -> list[str]:
    return [sys.executable, "-m", "ceph_tpu_torch.cli.daemon", *argv]


def _prometheus_ok(text: str) -> bool:
    return text.endswith("\n") and all(
        line.startswith(("# HELP ", "# TYPE ")) or PROM_LINE.match(line)
        for line in text.rstrip("\n").split("\n"))


def phase_obs_main(pms: dict, smi: str, timed_b: dict) -> dict:
    """The operator surface on the card.  (1) `python -m
    ceph_tpu_torch.cli.daemon perf dump` and `metrics` in two child
    processes without --device: the self-test maps 256 PGs, diagnoses
    them and encodes RS(8,4) on the card; pgs_mapped, bytes_encoded (==
    the JAX self-test's), each kernel's launches in `cache dump` == the
    self-test's (one each; its perf group's `<kernel>_launches` reads the
    same record), the metrics valid Prometheus text.
    (2) A child mapping config 2 in a loop with CEPH_TPU_ADMIN_SOCKET
    set, queried twice through `--sock perf dump`: pgs_mapped grows.
    (3) config 5's map_all_device, median of 5, tracing off and on
    (`set_trace_path`); the trace holds each run's pipeline.map_block
    span and each pipeline launch's span.  (4) The GF(2^8) kernel's (b)
    time from `main_path` (CUDA events) booked into its registry
    record: `cache dump`'s achieved GB/s equals the phase's."""
    t_phase = time.perf_counter()
    corpus = json.loads(OBS_CORPUS.read_text())
    env = dict(os.environ)
    for k in ("CEPH_TPU_ADMIN_SOCKET", "CEPH_TPU_TRACE"):
        env.pop(k, None)
    tmp = Path(tempfile.mkdtemp(prefix="obs_main"))
    sock = str(tmp / "live.asok")
    n_pgs, n_osds = CONFIGS["config2"]
    pipe = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=ROOT)
    procs = {
        "perf": subprocess.Popen(_daemon_argv("perf", "dump"), env=env,
                                 **pipe),
        "metrics": subprocess.Popen(_daemon_argv("metrics"), env=env,
                                    **pipe),
        "live": subprocess.Popen(
            [sys.executable, "-c", _LIVE_MAPPER, str(n_pgs), str(n_osds),
             str(OSD_PER_HOST)],
            env=dict(env, CEPH_TPU_ADMIN_SOCKET=sock), **pipe),
    }
    res: dict = {"nvidia_smi": smi}
    try:
        out, err = procs["perf"].communicate(timeout=300)
        check(procs["perf"].returncode == 0,
              f"obs_main: daemon perf dump rc {procs['perf'].returncode}: "
              f"{err[-600:]}")
        d = json.loads(out)
        check(d["pipeline"]["pgs_mapped"] == 256,
              f"obs_main: pgs_mapped {d['pipeline']['pgs_mapped']}")
        want = corpus["perf"]["ec"]["bytes_encoded"]
        check(d["ec"]["bytes_encoded"] == want,
              f"obs_main: bytes_encoded {d['ec']['bytes_encoded']} != "
              f"the JAX self-test's {want}")
        reg = {e["kernel"]: e for e in d["executables"]["entries"]}
        daemon_launches = {}
        for name, group, want in OBS_KERNELS:
            n = reg[name]["launches"]
            check(n == want and d[group][f"{name}_launches"] == n,
                  f"obs_main: {name} launched {n} times in the daemon's "
                  f"self-test, expected {want}")
            daemon_launches[name] = n
        res["daemon"] = {
            "launches": daemon_launches,
            "enqueue_p50_s": {k: reg[k]["enqueue_seconds"]["p50"]
                              for k in daemon_launches},
            "build_seconds": {k: reg[k]["build_seconds"]
                              for k in daemon_launches},
            "bytes_per_launch": {k: reg[k]["bytes_per_launch"]
                                 for k in daemon_launches}}
        out, err = procs["metrics"].communicate(timeout=300)
        check(procs["metrics"].returncode == 0 and _prometheus_ok(out),
              f"obs_main: daemon metrics: {err[-600:]}")
        for name, _, _ in OBS_KERNELS:
            m = re.search(r'^ceph_tpu_executables_dispatches_total\{cache="'
                          + name + r'"\} (\d+)$', out, re.M)
            check(m is not None and int(m.group(1)) >= 1,
                  f"obs_main: metrics show no launch of {name}")
        res["metrics_lines"] = out.count("\n")

        # (2) a live process on the card answering while it maps
        live = procs["live"]
        t0 = time.perf_counter()
        line = live.stdout.readline()
        check(line.strip() == "ready",
              f"obs_main: the live mapper did not start: {line!r} "
              f"{live.stderr.read()[-600:] if live.poll() else ''}")
        counts = []
        for _ in range(2):
            q = subprocess.run(_daemon_argv("--sock", sock, "perf", "dump"),
                               capture_output=True, text=True, cwd=ROOT,
                               env=env, timeout=120)
            check(q.returncode == 0, f"obs_main: --sock query: {q.stderr}")
            counts.append(json.loads(q.stdout)["pipeline"]["pgs_mapped"])
            deadline = time.time() + 60
            while time.time() < deadline:  # until the child maps more
                c = json.loads(obs.admin_socket.client_command(
                    sock, "perf dump"))["pipeline"]["pgs_mapped"]
                if c > counts[-1]:
                    break
        check(live.poll() is None and counts[1] > counts[0] > 0,
              f"obs_main: pgs_mapped over --sock {counts}")
        res["live"] = {"pgs_mapped": counts,
                       "queries_s": time.perf_counter() - t0}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.communicate()

    # (3) tracing off vs on, config 5's map_all_device (host clock around
    # a synchronised call: the span records enqueue, this the whole call)
    pm = pms["config5"]

    def run():
        pm.map_all_device()
        torch.cuda.synchronize()

    def median_ms(runs: int = 5) -> float:
        times = []
        for _ in range(runs):
            t = time.perf_counter()
            run()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    run()
    obs.trace.clear()
    off_ms = median_ms()
    path = tmp / "trace.json"
    obs.set_trace_path(str(path))
    pipeline.pipeline_cuda.launches = 0
    try:
        on_ms = median_ms()
    finally:
        obs.set_trace_path(None)
    launches = registry_launches(pipeline.pipeline_cuda)
    check(obs.flush(str(path)) == str(path), "obs_main: no trace written")
    events = json.loads(path.read_text())["traceEvents"]
    obs.trace.clear()
    names = [e["name"] for e in events]
    check(names.count("pipeline.map_block") == 5
          and names.count("pipeline.pipeline.launch") == launches > 0,
          f"obs_main: trace holds {names.count('pipeline.map_block')} "
          f"map_block and {names.count('pipeline.pipeline.launch')} "
          f"launch spans, {launches} launches")
    res["trace"] = {"map_all_device_ms_off": off_ms,
                    "map_all_device_ms_on": on_ms,
                    "pgs": pm.spec.pg_num, "events": len(events),
                    "launches": launches}
    print(f"obs_main: config 5 map_all_device median of 5: tracing off "
          f"{off_ms:.3f} ms, on {on_ms:.3f} ms ({smi})", flush=True)
    for f in tmp.iterdir():
        f.unlink()
    tmp.rmdir()

    # (4) a launch timed on the card, in the registry's roofline
    rec = obs.executables.record("gf_matmul")
    rec.note_timed(timed_b["ms"] * 1e-3, nbytes=timed_b["hbm_bytes"])
    entry = next(e for e in json.loads(obs.admin_socket.handle_command(
        "cache dump"))["entries"] if e["kernel"] == "gf_matmul")
    gbps = entry["roofline"]["achieved_gbps"]
    check(abs(gbps - timed_b["gb_per_s"]) <= 1e-3 * timed_b["gb_per_s"],
          f"obs_main: cache dump {gbps} GB/s, main_path "
          f"{timed_b['gb_per_s']}")
    res["cache_dump_gf_matmul"] = {k: entry[k] for k in (
        "launches", "bytes_per_launch", "build_seconds", "roofline",
        "ptxas")}
    res["cache_dump_gf_matmul"]["enqueue_p50_s"] = \
        entry["enqueue_seconds"]["p50"]
    res["seconds"] = time.perf_counter() - t_phase
    emit(dict(phase="obs_main", **res))
    return res


# -- the runtime and mesh slice ----------------------------------------------

RUNTIME_CORPUS = ROOT / "tests" / "data" / "runtime_corpus.json"
MESHCHECK_CORPUS = ROOT / "tests" / "data" / "meshcheck.json"
MESH_SPLIT = 4  # config 5's blocks on one card (a Mesh of cuda:0 x 4)
MESH_STEPS = 3  # rebalance steps fed back
SCHED_KILL = "ec_encode"  # the second stage: stage_end.<it>=exit:3
LADDER_CHILD = r"""
import json, warnings
from ceph_tpu_torch import runtime
warnings.simplefilter("ignore")
info = runtime.acquire_backend(watchdog=False, attempts=1)
out = {"provenance": info.provenance()}
try:
    runtime.acquire_backend(watchdog=False, attempts=1, require="cuda")
    out["require_raised"] = ""
except runtime.RequiredBackendError as e:
    out["require_raised"] = str(e)[:200]
print(json.dumps(out))
"""
SCHED_CHILD = r"""
import json, sys
import chip_smoke
out = chip_smoke.runtime_stages(sys.argv[1], sys.argv[2] == "1")
print(json.dumps(out["stages_done"]))
"""


def fallback_total() -> int:
    """Every descent to the host the process booked: the `runtime`
    group's device_loss_fallbacks (ClusterSim, LifetimeSim, FleetSim)
    and the lanes the placement service answered from the host."""
    d = obs.perf_dump()
    return (int((d.get("runtime") or {}).get("device_loss_fallbacks", 0))
            + int((d.get("serve") or {}).get("degraded_answered", 0)))


def runtime_stages(path: str, resume: bool) -> dict:
    """The scheduler's three stages on the card, highest priority first:
    config 2's map_all digest, the RS(8,4) parity of shape (a), one
    rebalance_step of config 2; a `stage_end.<name>=exit:<rc>` armed in
    the environment kills the process after that stage's checkpoint."""
    from ceph_tpu_torch import runtime
    from ceph_tpu_torch.parallel.sharded import Mesh, ShardedClusterMapper

    dev = torch.device("cuda")

    def map_config2(h):
        up = PoolMapper(bench_map(*CONFIGS["config2"]), 0,
                        device=dev).map_all_device()
        return {"sha256": hashlib.sha256(
            up.cpu().numpy().tobytes()).hexdigest()}

    def ec_encode(h):
        code = create_erasure_code({"plugin": "jax", "k": "8", "m": "4"},
                                   device="cuda")
        parity = code.encode_parity(rand_u8((8, 2 * MiB), 500, dev))
        return {"sha256": hashlib.sha256(
            parity.cpu().numpy().tobytes()).hexdigest()}

    def rebalance(h):
        scm = ShardedClusterMapper(bench_map(*CONFIGS["config2"]), 0,
                                   Mesh([dev]))
        new_w, sd, hist = scm.rebalance_step()
        return {"new_w_sha256": hashlib.sha256(
            new_w.cpu().numpy().tobytes()).hexdigest(),
            "stddev": float(sd), "mapped": int(hist.sum())}

    sched = runtime.StageScheduler(
        runtime.Checkpoint(path, resume=resume), deadline_s=600)
    for prio, name, fn in ((90, "map_config2", map_config2),
                           (80, SCHED_KILL, ec_encode),
                           (70, "rebalance", rebalance)):
        sched.add(name, fn, priority=prio, est_s=5)
    return sched.run()


def _stage_results(data: dict) -> dict:
    return {n: {k: v for k, v in data[n].items() if k != "perf"}
            for n in data["stages_done"]}


def _child(code: str, env_extra: dict, *argv, timeout=300):
    env = dict(os.environ, **env_extra)
    env.pop("CEPH_TPU_ADMIN_SOCKET", None)
    return subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def phase_runtime_main(dev, pms: dict, smi: str, peak: float) -> dict:
    """The runtime and mesh slice on the card.  (1) The ladder: one
    watchdogged acquisition with the default ladder lands on cuda with
    no fallback (the probe child's and the acquisition's seconds); a
    child with `init.cuda` failing and CEPH_TPU_LADDER=cuda,cpu records
    the descent, and its require="cuda" raises.  (2) The scheduler: a
    child runs three stages on the card and is killed by
    `stage_end.ec_encode=exit:3`; a second child resumes, skips the done
    stages, and the results equal this process's uninterrupted run.
    (3) Config 5 through ShardedClusterMapper on make_mesh(1) and on a
    4-block split of cuda:0: rows == map_all_device, histograms == a
    bincount, one pipeline launch per block, map_stats timed; three
    rebalance_steps, new_w == the same torch ops on the CPU from the
    same histograms, the step timed beside its byte bound;
    CEPH_TPU_MESH_DEVICES=4 on one card is recorded degraded.  (4)
    meshcheck's digest == the JAX worker's, unsplit and split.  (5) An
    armed epoch_apply loss in a lifetime corpus scenario raises out of
    that epoch, and a serve_dispatch loss in the service answers its
    batch EFAULT and the next ones from the device with the rows of the
    stored JAX replies: nothing degrades to the host on the card.
    Returns the rule (and GF) launches by path."""
    from ceph_tpu_torch import runtime
    from ceph_tpu_torch.parallel import sharded
    from ceph_tpu_torch.parallel.sharded import (
        Mesh,
        ShardedClusterMapper,
        make_mesh,
        rebalance_update,
    )
    from ceph_tpu_torch.runtime import preflight
    from ceph_tpu_torch.serve import meshcheck

    t_phase = time.perf_counter()
    check(fallback_total() == 0,
          f"every earlier phase: no descent to the host "
          f"({fallback_total()})")
    pipe, gf = {}, {}

    # (1) the ladder
    probes = []
    real_probe = preflight.probe

    def recording(*a, **kw):
        probes.append(real_probe(*a, **kw))
        return probes[-1]

    preflight.probe = recording
    try:
        info = runtime.acquire_backend()
    finally:
        preflight.probe = real_probe
    check(info.backend == "cuda" and info.fallback_reason is None
          and info.n_devices >= 1,
          f"runtime_main: the default ladder lands on the card "
          f"({info.provenance()})")
    r = _child(LADDER_CHILD, {"CEPH_TPU_FAULTS": "init.cuda=fail:chip smoke",
                              "CEPH_TPU_LADDER": "cuda,cpu"})
    check(r.returncode == 0, f"ladder child: rc {r.returncode} "
          f"{r.stderr[-2000:]}")
    desc = json.loads(r.stdout.strip().splitlines()[-1])
    check(desc["provenance"]["backend"] == "cpu"
          and "chip smoke" in desc["provenance"]["fallback_reason"]
          and desc["provenance"]["rungs_tried"] == ["cuda", "cpu"]
          and "required backend 'cuda'" in desc["require_raised"],
          f"runtime_main: the armed descent recorded, require raises "
          f"({desc})")
    ladder = {"provenance": info.provenance(),
              "probe_s": probes[0].init_s,
              "init_seconds": info.init_seconds,
              "descent": desc["provenance"]}

    # (2) the scheduler: kill after the second stage, resume
    tmp = Path(tempfile.mkdtemp(prefix="runtime_main"))
    ck = tmp / "stages.json"
    t0 = time.perf_counter()
    r1 = _child(SCHED_CHILD, {"CEPH_TPU_FAULTS":
                              f"stage_end.{SCHED_KILL}=exit:3"},
                str(ck), "0")
    killed_s = time.perf_counter() - t0
    check(r1.returncode == 3, f"scheduler child: killed with 3, got "
          f"{r1.returncode} {r1.stderr[-2000:]}")
    first = json.loads(ck.read_text())
    check(first["stages_done"] == ["map_config2", SCHED_KILL],
          f"the killed run checkpointed two stages ({first['stages_done']})")
    t0 = time.perf_counter()
    r2 = _child(SCHED_CHILD, {}, str(ck), "1")
    resume_s = time.perf_counter() - t0
    check(r2.returncode == 0, f"scheduler resume: rc {r2.returncode} "
          f"{r2.stderr[-2000:]}")
    resumed = json.loads(ck.read_text())
    pipeline.pipeline_cuda.launches = 0
    gf_matmul_cuda.launches = 0
    straight = runtime_stages(str(tmp / "straight.json"), False)
    torch.cuda.synchronize()
    pipe["runtime_main_scheduler"] = registry_launches(pipeline.pipeline_cuda)
    gf["runtime_main_scheduler"] = registry_launches(gf_matmul_cuda)
    check(resumed["stages_done"] == ["map_config2", SCHED_KILL, "rebalance"]
          and resumed["resumed_stages"] == ["map_config2", SCHED_KILL]
          and _stage_results(resumed) == _stage_results(straight),
          f"the resumed run skips the done stages and equals the "
          f"uninterrupted run ({resumed.get('resumed_stages')})")
    sched = {"killed_s": killed_s, "resume_s": resume_s,
             "stages": _stage_results(straight)}

    # (3) the mesh at config 5
    pm5 = pms["config5"]
    m5 = pm5.m
    want = pm5.map_all_device()
    n = int(want.shape[0])
    flat = want[want != ITEM_NONE].long()
    first_lane = want[:, 0][want[:, 0] != ITEM_NONE].long()
    mesh = {}
    outs = {}
    for label, msh in (("mesh1", make_mesh(1)),
                       (f"split{MESH_SPLIT}", Mesh([dev] * MESH_SPLIT))):
        scm = ShardedClusterMapper(m5, 0, msh)
        torch.cuda.synchronize()
        pipeline.pipeline_cuda.launches = 0
        out = scm.map_stats()
        torch.cuda.synchronize()
        launches = registry_launches(pipeline.pipeline_cuda)
        pipe[f"runtime_main_{label}"] = launches
        check(launches == msh.size,
              f"{label}: one pipeline launch per block ({launches})")
        DV = scm.DV
        check(torch.equal(out["up"][:n], want)
              and torch.equal(out["acting"][:n], want),
              f"{label}: rows == map_all_device")
        check(torch.equal(out["pgs_per_osd"].long(),
                          torch.bincount(flat, minlength=DV)[:DV])
              and torch.equal(out["first_per_osd"].long(),
                              torch.bincount(first_lane, minlength=DV)[:DV])
              and torch.equal(out["primary_per_osd"], out["first_per_osd"]),
              f"{label}: histograms == bincount of the rows")
        outs[label] = out
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            scm.map_stats()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        mesh[label] = {"blocks": msh.size, "launches": launches,
                       "map_stats_ms": statistics.median(times)}
    # three rebalance steps on the split, each held to the CPU ops
    scm = ShardedClusterMapper(m5, 0, Mesh([dev] * MESH_SPLIT))
    w = None
    steps = []
    for i in range(MESH_STEPS):
        wt = scm.pm.dev["weight"] if w is None else w
        new_w, sd, hist = scm.rebalance_step(w)
        cw, csd = rebalance_update(hist.cpu(), wt.cpu(),
                                   scm._target_w.cpu(), scm.pg_num, 3)
        check(torch.equal(new_w.cpu(), cw),
              f"rebalance step {i}: new_w == the CPU ops'")
        steps.append({"stddev": float(sd), "cpu_stddev": float(csd),
                      "changed": int((new_w != wt).sum())})
        w = new_w
    parts = scm._map_blocks(scm.pm)
    W = int(parts[0][1][2].shape[1])

    def step():
        h = scm._hist_sum(parts, 2)
        return rebalance_update(h, scm.pm.dev["weight"], scm._target_w,
                                scm.pg_num, 3)

    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    step_ms = time_ms(step, flush, runs=10)
    DV = scm.DV
    step_bytes = scm.pg_padded * W * 4 + DV * (8 + 8 + 8 + 4) + 4
    mesh["step"] = {"ms": step_ms, "bytes": step_bytes,
                    "bound_ms": step_bytes / peak * 1e3,
                    "bound_by": "bytes", "steps": steps}
    del flush, outs, parts
    old = os.environ.get("CEPH_TPU_MESH_DEVICES")
    os.environ["CEPH_TPU_MESH_DEVICES"] = "4"
    sharded._DEFAULT_MESH.clear()
    try:
        dm = sharded.default_mesh()
        prov = sharded.last_mesh_provenance()
    finally:
        if old is None:
            os.environ.pop("CEPH_TPU_MESH_DEVICES")
        else:
            os.environ["CEPH_TPU_MESH_DEVICES"] = old
        sharded._DEFAULT_MESH.clear()
    check(dm is not None and prov["requested"] == 4
          and prov["actual"] == torch.cuda.device_count()
          and prov["degraded"] is (torch.cuda.device_count() < 4),
          f"CEPH_TPU_MESH_DEVICES=4 recorded degraded ({prov})")
    mesh["knob_provenance"] = prov

    # (4) meshcheck against the JAX worker's digest
    mc_want = json.loads(MESHCHECK_CORPUS.read_text())["digest"]
    pipeline.pipeline_cuda.launches = 0
    mc = {split: meshcheck.run(device=dev, split=split)
          for split in (0, MESH_SPLIT)}
    torch.cuda.synchronize()
    pipe["runtime_main_meshcheck"] = registry_launches(pipeline.pipeline_cuda)
    check(all(r["digest"] == mc_want and r["oracle_match"]
              for r in mc.values()),
          f"meshcheck digest == the JAX worker's ({mc})")

    # (5) the armed device losses: on the card nothing degrades to the
    # host.  The lifetime run raises out of the lost epoch; the service
    # answers the lost batch EFAULT and the next ones from the device,
    # with the rows of the JAX service's replies
    stored = json.loads(RUNTIME_CORPUS.read_text())
    life_corpus = json.loads(LIFETIME_CORPUS.read_text())["scenarios"]
    arm = stored["lifetime"]["arm"]
    lost_epoch = int(arm.split("=")[0].split(".")[1])
    fresh_observers()
    faults.configure(arm)
    try:
        sim = LifetimeSim(life_corpus[stored["lifetime"]["scenario"]]["spec"],
                          backend="torch", device=dev)
        raised = None
        try:
            sim.run()
        except faults.DeviceLostError as e:
            raised = e
    finally:
        faults.disarm_all()
    check(raised is not None and sim.steps == lost_epoch - 1
          and sim.provenance()["device_loss_fallbacks"] == 0,
          f"lifetime under {arm}: the loss raises out of epoch "
          f"{lost_epoch}, nothing degrades ({raised!r}, {sim.steps}, "
          f"{sim.provenance()})")
    fresh_observers()
    seeds = np.asarray([5, 9, 100, 200], np.uint32)
    d0 = dict(obs.group_view("serve"))
    pipeline.pipeline_cuda.launches = 0
    svc = PlacementService(serve_map(), config=serve_cfg(), device=dev,
                           name="chip.loss")
    try:
        base = svc.lookup_batch(0, seeds)
        faults.arm("serve_dispatch", "lost", "mid-traffic loss", 1)
        try:
            replies = [svc.lookup_batch(0, seeds) for _ in range(3)]
            left = svc.status()["degraded_batches_left"]
        finally:
            faults.disarm("serve_dispatch")
        prov = svc.provenance()
    finally:
        svc.close()
    torch.cuda.synchronize()
    pipe["runtime_main_device_loss"] = registry_launches(
        pipeline.pipeline_cuda)
    d = obs.group_view("serve")
    want = stored["serve"]["rows"][0]
    rec = {
        "statuses": [r.status for r in replies],
        "sources": [base.source] + [r.source for r in replies],
        "rows_equal_jax": [reply_rows(r) == want
                           for r in [base] + replies[1:]],
        "fallbacks": prov["device_loss_fallbacks"],
        "events": [e.split(": ", 1)[-1] if e.startswith("recovered")
                   else e.rsplit(" -> ", 1)[-1]
                   for e in prov["fallback_events"]],
        "backend": prov["backend"],
        "degraded_answered": int(d["degraded_answered"])
        - int(d0["degraded_answered"]),
        "device_recoveries": int(d["device_recoveries"])
        - int(d0["device_recoveries"]),
        "left": left,
    }
    check(rec == {"statuses": ["EFAULT", "ok", "ok"],
                  "sources": ["device", "", "device", "device"],
                  "rows_equal_jax": [True, True, True],
                  "fallbacks": 1,
                  "events": ["EFAULT", "device dispatch healthy again"],
                  "backend": "device", "degraded_answered": 0,
                  "device_recoveries": 1, "left": 0},
          f"serve under serve_dispatch=lost: EFAULT, then the device "
          f"with the JAX rows ({rec})")
    check(fallback_total() == 0,
          f"runtime_main: no descent to the host ({fallback_total()})")
    res = {"phase": "runtime_main", "nvidia_smi": smi,
           "s": time.perf_counter() - t_phase, "ladder": ladder,
           "scheduler": sched, "mesh": mesh,
           "meshcheck": {str(k): v["digest"] for k, v in mc.items()},
           "device_loss": {"lifetime_raised_at_epoch": lost_epoch,
                           "serve": rec},
           "launches": {"pipeline": pipe, "gf": gf}}
    emit(res)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    info = phase_device()
    phase_build()
    # erasure coding: kernel vs plain, then the main path, path by path,
    # each counted from 0 (see counted())
    err = phase_kernel_vs_plain(dev)
    by_path = {"corpus": phase_corpus(dev)}
    res = phase_main_path(dev, info["peak_bw"])
    by_path.update({key: r["launches"] for key, r in res.items()})
    by_path.update({f"layered_corpus_{name.split('_')[0]}": n
                    for name, n in phase_layered_corpus(dev).items()})
    clay_launches, clay_rows = phase_clay_repair(dev, info["peak_bw"])
    by_path.update({f"clay_config4_{key}": n
                    for key, n in clay_launches.items()})
    by_path.update({f"cli_{w}": n for w, n in phase_cli().items()})
    by_path.update({f"ec_default_{key}": n
                    for key, n in phase_ec_defaults(dev).items()})
    by_path.update(phase_ec_wide(dev))
    strat, strat_paths = phase_ec_strategies(dev, info["peak_bw"], res)
    by_path.update(strat_paths)

    # placement: the same, for the rule kernel and the pipeline kernel.
    # crushtool --test runs the rule kernel (rule_paths); every path
    # through PoolMapper runs the pipeline kernel (pipe_paths)
    corpus = {e["name"]: e for e in
              json.loads(PLACEMENT_CORPUS.read_text())["entries"]}
    pms = {name: PoolMapper(bench_map(*shape), 0, device=dev)
           for name, shape in CONFIGS.items()}
    rule_err, draws, legacy = phase_rule_vs_plain(dev, corpus, pms)
    pipe_err = phase_pipeline_vs_plain(dev, corpus, pms)
    rule_paths = {}
    pipe_paths = {"placement_corpus": phase_placement_corpus(dev, corpus)}
    pres = phase_placement_main(dev, pms, draws, info["peak_bw"])
    pipe_paths.update({key: r["launches"] for key, r in pres.items()})
    lres = phase_legacy_main(dev, legacy, info["peak_bw"])
    # the plan kernel's launches by path: each path counted from 0 by
    # plan_path (or by its phase), every device_loop plan one launch
    plan_paths = {}
    with plan_path(plan_paths, "cli_placement"):
        cres = phase_cli_placement(dev, pms)
    for key, r in cres.items():
        paths = rule_paths if r["kernel"] == "crush_rule" else pipe_paths
        paths[f"cli_{key}"] = r["launches"]
    bal_paths, bres = phase_balancer_main(dev, info["peak_bw"])
    pipe_paths.update(bal_paths)
    plan_paths.update(bres["plan_paths"])
    loop = phase_loop_vs_plain(dev, info["peak_bw"])
    plan_paths.update({f"loop_vs_plain_{key}": n
                       for key, n in loop["launches_by_path"].items()})
    with plan_path(plan_paths, "mgr_balancer", need=True):
        mgr_paths, mres = phase_mgr_balancer(dev, info["nvidia_smi"])
    pipe_paths.update(mgr_paths)

    # placement diagnostics and the failure simulator: the diagnostics
    # kernel vs its plain version, then its paths, each counted from 0
    diag_err, dsmall = phase_diag_vs_plain(dev, corpus, pms,
                                           draws["config5"], info["peak_bw"])
    dres = phase_diagnose_main(dev, pms, pres["config5"]["draws"],
                               info["peak_bw"])
    diag_paths = {"diagnose_config5": dres["mapper"]["diag_launches"],
                  "diagnose_config5_state": dres["state"]["diag_launches"]}
    eres = phase_explain_cli(dev, pms)
    diag_paths.update({f"cli_{k}": r["diag_launches"]
                       for k, r in eres.items()})
    rule_paths["cli_config5_show_choose_tries"] = \
        eres["config5_show_choose_tries"]["rule_launches"]
    with plan_path(plan_paths, "failure_sim", need=True):
        fres = phase_failure_sim(dev, pms, info["nvidia_smi"])
    for i, e in enumerate(fres["epochs"]):
        diag_paths[f"sim_config5_{i}"] = e["diag_launches"]
        pipe_paths[f"sim_config5_{i}"] = e["pipeline_launches"]

    # the native host engines beside the kernels
    nat = phase_native_main(dev, pms, info["nvidia_smi"])
    rule_paths["native_main_crushtool_default"] = \
        nat["crushtool_config2"]["launches"]

    # the operator surface: the daemon's launches are its own process's,
    # read from that process's kernel registry
    ores = phase_obs_main(pms, info["nvidia_smi"], res["b"])
    by_path["obs_main_daemon"] = ores["daemon"]["launches"]["gf_matmul"]
    pipe_paths["obs_main_daemon"] = ores["daemon"]["launches"]["pipeline"]
    diag_paths["obs_main_daemon"] = \
        ores["daemon"]["launches"]["crush_rule_diag"]
    pipe_paths["obs_main_trace"] = ores["trace"]["launches"]

    # the runtime and mesh slice: the ladder, the stage scheduler, the
    # mesh at config 5, meshcheck and the armed device losses
    rt = phase_runtime_main(dev, pms, info["nvidia_smi"], info["peak_bw"])
    pipe_paths.update(rt["launches"]["pipeline"])
    by_path.update(rt["launches"]["gf"])

    # the lifetime simulator: the corpus, then config 5's size
    del pms
    torch.cuda.empty_cache()
    with plan_path(plan_paths, "lifetime_corpus"):
        pipe_paths.update({f"lifetime_corpus_{name}": n for name, n in
                           phase_lifetime_corpus(dev).items()})
    with plan_path(plan_paths, "lifetime_main"):
        life = phase_lifetime_main(dev, info["nvidia_smi"],
                                   info["peak_bw"])
    pipe_paths["lifetime_main"] = life["launches"]
    for kind, r in life["forced_epochs"].items():
        pipe_paths[f"lifetime_main_{kind}"] = r["launches"]
    by_path["lifetime_ec_calibration"] = life["ec_calibration"]["launches"]

    # the fleet simulator: the JAX digest corpus, then the bench's sweep
    torch.cuda.empty_cache()
    with plan_path(plan_paths, "fleet_corpus"):
        pipe_paths["fleet_corpus"] = phase_fleet_corpus(dev)
    with plan_path(plan_paths, "fleet_main", need=True):
        fleet = phase_fleet_main(dev, info["nvidia_smi"], info["peak_bw"])
    pipe_paths["fleet_main_small"] = sum(fleet["small"]["launches"])
    for mode in ("stacked", "unstacked"):
        pipe_paths[f"fleet_main_{mode}"] = fleet[mode]["launches"]

    # the placement service: the corpus scripts, then config 5's traffic
    torch.cuda.empty_cache()
    with plan_path(plan_paths, "serve_corpus"):
        pipe_paths["serve_corpus"] = phase_serve_corpus(dev)
    # serve_main resets the serve group and checks its own lanes
    check(fallback_total() == 0,
          f"the phases after runtime_main: no descent to the host "
          f"({fallback_total()})")
    with plan_path(plan_paths, "serve_main"):
        serve = phase_serve_main(dev, info["nvidia_smi"])
    for part in ("bulk", "scalar", "structural", "front"):
        pipe_paths[f"serve_main_{part}"] = serve[part]["launches"]
    torch.cuda.synchronize()
    check(fallback_total() == 0 and serve["degraded_answered"] == 0,
          "serve_main: no descent to the host")

    b, c5 = res["b"], pres["config5"]
    c5_plan = loop["config5"][0]
    emit({"kernels": [{
        "name": "gf_matmul",
        "route": "cuda",
        "source": "ceph_tpu_torch/ec/csrc/gf_matmul.cu",
        "replaces": "ceph_tpu/ec/jax_backend.py:209::gf_matmul_pallas",
        "equal": err == 0,
        # the sum over the paths' counted runs; timed runs are not counted
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": err,
        "ms": b["ms"],
        "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"],
        "bound_by": "bytes",
        # (b) as one untiled bitplane product: torch.matmul of the GF(2)
        # bit-matrix and the data's bit planes (float16, exact), mod 2;
        # the `bitplane` strategy's tiled time beside it; (a) and (c)'s
        # under "shapes"
        "library_ms": strat["bitplane"]["b"]["untiled_ms"],
        "library": "matmul_bitplane untiled (torch.matmul on the bit "
                   "expansion)",
        "bitplane_strategy_ms": strat["bitplane"]["b"]["ms"],
        # each shape beside its library time, the untiled bitplane
        # product on the same inputs
        "shapes": {key: dict({f: r[f] for f in (
            "ms", "plain_ms", "copy_ms", "bound_ms", "gb_per_s")},
            library_ms=strat["bitplane"][key]["untiled_ms"])
                   for key, r in res.items()},
        # every strategy's ms on (a)-(c), CUDA events, L2 flushed
        "strategies": {s: {key: r[key]["ms"] for key in ("a", "b", "c")}
                       for s, r in strat.items()},
        # BASELINE config 4 (Clay(8,4,11)): a repair's and an encode's
        # products, summed kernel ms beside the wall ms and the bound
        "config4": {key: {f: r[f] for f in (
            "repair_launches", "repair_shapes", "repair_ms",
            "repair_wall_ms", "repair_plain_ms", "repair_bound_ms",
            "repair_gb_per_s", "read_fraction", "encode_launches",
            "encode_products", "encode_ms", "encode_wall_ms",
            "encode_plain_ms", "encode_bound_ms")}
            for key, r in clay_rows.items()},
    }, {
        "name": "crush_rule",
        "route": "cuda",
        "source": "ceph_tpu_torch/crush/csrc/crush_rule.cu",
        "replaces": "ceph_tpu/crush/mapper_jax.py:1529::compile_rule (XLA)",
        "equal": rule_err == 0,
        "launches": sum(rule_paths.values()),
        "launches_by_path": rule_paths,
        "max_abs_err": rule_err,
        # config 5 (10M PGs); plain_ms is on its first plain_pgs PGs,
        # beside the kernel's time on the same block (block_ms)
        "ms": c5["ms"],
        "plain_ms": c5["plain_ms"],
        "plain_pgs": c5["plain_pgs"],
        "block_ms": c5["block_ms"],
        "bound_ms": c5["bound_ms"],
        "bound_by": c5["bound_by"],
        "library_ms": None,
        "shapes": {key: {f: r[f] for f in (
            "pgs", "ms", "mappings_per_s", "plain_pgs",
            "plain_ms", "block_ms", "draws", "draws_per_pg", "ops_per_draw",
            "ops_ms", "int_pipe_ms", "bytes_ms", "bound_ms", "bound_by",
            "staged_records", "records", "ms_by_stage")}
                   for key, r in pres.items()},
        # the legacy draws on config-5-shaped maps: kernel ms, bound and
        # the share of the bound reached, per algorithm
        "legacy": {key: {f: r[f] for f in (
            "x", "ms", "plain_ms", "legacy_hashes", "ops_per_hash",
            "bound_ms", "bound_by", "bound_share") if f in r}
                   for key, r in lres.items()},
        "cli": {key: {f: r[f] for f in ("seconds", "mappings_per_s")}
                for key, r in cres.items() if r["kernel"] == "crush_rule"},
        # the native C++ mapper on config 5, one core (the first
        # NATIVE_ONE_CORE_X seeds) and all (NATIVE_X), beside this kernel
        # on the same seeds: CUDA-event kernel time against host wall
        # time, not crushtool end to end
        "native_config5": nat["config5"],
    }, {
        "name": "pipeline",
        "route": "cuda",
        "source": "ceph_tpu_torch/osd/csrc/pipeline.cu",
        "replaces": "ceph_tpu/osd/pipeline_jax.py:221::compile_pipeline "
                    "(its fn :298 under jax.jit(jax.vmap(fn)) :699; XLA, "
                    "no pallas_call)",
        "equal": pipe_err == 0,
        "launches": sum(pipe_paths.values()),
        "launches_by_path": pipe_paths,
        "max_abs_err": pipe_err,
        # config 5 (10M PGs) in map_all_device's mode ("up"); plain_ms is
        # the plain chain on the card (the rule kernel and the torch ops
        # it replaced), beside the rule kernel alone and the entry point
        "ms": c5["pipeline_ms"],
        "plain_ms": c5["plain_chain_ms"],
        "bound_ms": c5["pipeline_bound_ms"],
        "bound_by": c5["pipeline_bound_by"],
        "library_ms": None,
        "library": "none: no PyTorch call computes a placement",
        "rule_kernel_ms": c5["ms"],
        "entry_ms": c5["entry_ms"],
        "shapes": {key: {f: r[f] for f in (
            "pgs", "pipeline_mode", "pipeline_ms", "ms", "entry_ms",
            "plain_chain_ms", "pipeline_over_rule",
            "pipeline_mappings_per_s", "entry_mappings_per_s",
            "pipeline_ops_ms", "pipeline_bytes_ms", "pipeline_bound_ms",
            "pipeline_bound_by", "pipeline_bound_share",
            "pipeline_threads", "pipeline_staged_records")}
                   for key, r in pres.items()},
        "cli": {key: {f: r[f] for f in ("seconds", "mappings_per_s")}
                for key, r in cres.items() if r["kernel"] == "pipeline"},
        # the rebalance rounds of config 5: the launches of each round's
        # DeviceState build (one per pool) and the plan's host syncs
        "balancer_config5": [{f: r[f] for f in (
            "wall_s", "build_ms", "plan_ms", "plan_bound_ms",
            "plan_pass_ms", "launches", "loop_rounds", "host_syncs",
            "changes")} for r in bres["config5"]["rounds"]],
        # the mgr balancer on ClusterState (config 5, then config 2's
        # crush-compat plan and CLI): each step's seconds, launches and
        # host-to-device bytes
        "mgr": mres["steps"],
        # the lifetime simulator at config 5's size: seconds and launches
        # by event kind
        "lifetime_main": {"init_s": life["init_s"],
                          "seconds_by_kind": life["seconds_by_kind"],
                          "launches": life["launches"],
                          "forced_epochs": life["forced_epochs"]},
        # the fleet sweep (64 members of 1024 OSDs): rates, stats calls
        # and their ms a fleet epoch, launches, peak memory, per mode
        "fleet_main": {mode: {f: fleet[mode][f] for f in (
            "cluster_epochs_per_s", "wall_s", "init_s", "launches",
            "stats_calls", "stats_ms_median", "stats_bound_ms_median",
            "peak_device_bytes")} for mode in ("stacked", "unstacked")},
        # config 5 through ShardedClusterMapper as one block and as 4
        # blocks of this card (one launch each), and B.14's step (torch
        # ops, no hand kernel) beside its byte bound
        "mesh_config5": {
            "map_stats_ms": {k: rt["mesh"][k]["map_stats_ms"]
                             for k in ("mesh1", f"split{MESH_SPLIT}")},
            "step_ms": rt["mesh"]["step"]["ms"],
            "step_bound_ms": rt["mesh"]["step"]["bound_ms"],
            "step_bound_by": "bytes"},
        # the placement service at config 5: (a) one 2^20-lane block,
        # (b) the micro-batcher under value-only swaps, (c) the bulk edge
        # under a structural swap; (d) a 2-replica front on config 2
        "serve_main": {
            "bulk": {f: serve["bulk"][f] for f in (
                "lookups", "s", "lookups_per_s", "launches", "sub_block")},
            "scalar": {f: serve["scalar"][f] for f in (
                "qps", "p50_s", "p99_s", "requests", "swaps",
                "swap_stall_p99_s", "swap_stall_max_s", "apply_ms",
                "bytes_uploaded", "swap_delta_applies", "launches")},
            "structural": {f: serve["structural"][f] for f in (
                "lookups_per_s", "p50_s", "p99_s", "stage_s",
                "flip_stall_s", "structural_swap_stalls", "launches")},
            "front": {f: serve["front"][f] for f in (
                "block_p50_s", "block_p99_s", "front_replica_sheds",
                "launches")},
            "peak_device_bytes": serve["peak_device_bytes"]},
    }, {
        "name": "crush_rule_diag",
        "route": "cuda",
        "source": "ceph_tpu_torch/crush/csrc/crush_rule_diag.cu",
        "replaces": "ceph_tpu/crush/mapper_jax.py:1529::compile_rule("
                    "with_diag=True) (XLA), reduced by "
                    "ceph_tpu/osd/pipeline_jax.py:781::PoolMapper.diagnose",
        "equal": diag_err == 0,
        "launches": sum(diag_paths.values()),
        "launches_by_path": diag_paths,
        # in-process paths only: the daemon's launch is its child's
        "launches_by_instance": DIAG_INSTANCES,
        "max_abs_err": diag_err,
        # config 5 (10M PGs), summary mode as diagnose() launches it,
        # beside the planes mode, the default kernel and the pipeline
        # kernel (row 6, mode up) on the same PGs; plain_ms on the first
        # plain_pgs PGs (planes, the plain version on the card), beside
        # the kernel's time on the same block in both modes
        "ms": dres["ms"],
        "plain_ms": dsmall["block"]["plain_ms"],
        "plain_pgs": dsmall["block"]["pgs"],
        "block_ms": dsmall["block"]["ms"],
        "block_summary_ms": dsmall["block"]["summary_ms"],
        "bound_ms": dres["bound_ms"],
        "bound_by": dres["bound_by"],
        "library_ms": None,
        "library": "none: no PyTorch call computes CRUSH",
        "modes": {
            "summary": {"ms": dres["ms"], "bound_ms": dres["bound_ms"],
                        "bound_by": dres["bound_by"]},
            "planes": {"ms": dres["planes_ms"],
                       "bound_ms": dres["planes"]["bound_ms"],
                       "bound_by": dres["planes"]["bound_by"]}},
        "default_ms": dres["default_ms"],
        "pipeline_ms": dres["pipeline_ms"],
        "diagnose_ms": dres["diagnose_ms"],
        "diagnose_s": {k: dres[k]["s"] for k in ("mapper", "state")},
        "diagnose_extra_device_bytes": {
            k: dres[k]["extra_device_bytes"] for k in ("mapper", "state")},
        "plane_bytes": dres["plane_bytes"],
        # the 512-seed sample's summary launch (G from its size), and the
        # small launches of config 5's first PGs in both modes: ms
        # (device_ms, L2 flushed), bound and the plain version's ms
        "sample_launch": dres["sample_launch"],
        "small": dsmall["small"],
        "cli": {k: r["seconds"] for k, r in eres.items()},
        "failure_sim": [{f: e[f] for f in ("event", "s", "pipeline_launches",
                                          "diag_launches")}
                        for e in fres["epochs"]],
        "failure_sim_peak_device_bytes": fres["peak_device_bytes"],
    }, {
        "name": "upmap_loop",
        "route": "cuda",
        "source": "ceph_tpu_torch/balancer/csrc/upmap_loop.cu",
        "replaces": "ceph_tpu/balancer/upmap.py:718::_loop_account (XLA "
                    "lax.while_loop :867, no pallas_call)",
        "equal": True,  # loop_vs_plain checked every output
        "launches": sum(plan_paths.values()),
        "launches_by_path": plan_paths,
        "max_abs_err": 0,
        # config 5's first rebalance round (10M PGs, 10k OSDs): the
        # kernel's launch, the plain version on the card, the bytes bound
        "ms": c5_plan["ms"],
        "plain_ms": c5_plan["plain_ms"],
        "bound_ms": c5_plan["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "library": "none: no PyTorch call computes an upmap plan",
        "launches_per_plan": 1,
        "host_syncs_per_plan": 1,
        "shapes": {"config5": loop["config5"], "config2": loop["config2"],
                   "cases": loop["cases"]},
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
