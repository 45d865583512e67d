#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ceph_tpu_torch`) on one card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one NVIDIA H100
and the CUDA toolkit.  It builds every kernel from the sources in the
checkout (one nvcc per source, all at once) and prints what ptxas
reports of each, holds each kernel against its plain PyTorch version (the
rule kernel both with the shared-memory staging its wrapper chooses and
with none), drives the erasure-coding path (the RS corpus profiles,
RS(8,4) encode/decode at full size, the clay, shec and lrc corpus
profiles, BASELINE config 4's Clay(8,4,11) encode and minimum-bandwidth
repair of every chunk at a 4 MiB stripe, the benchmark CLI on RS, clay,
shec and lrc, then every plugin through a profile that names no backend,
whose default is the device engine, and the RS CLI lines on that default
beside `backend=numpy`) and the
placement path (the placement corpus, then BASELINE configs 2 and 5
through `PoolMapper`, then the legacy bucket draws on maps of config 5's
shape, then the placement CLIs `crushtool --test` and `osdmaptool
--test-map-pgs` on configs 1, 2 and 5, and `osdmaptool --upmap` on config
2) and the upmap balancer (`calc_pg_upmaps` on config 2 with every
backend, then three device_loop rounds of config 5, the rebalance of
BASELINE.json's north-star workload) and the mgr balancer on a
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
run stopped and resumed, an injected device loss raising;
`lifetime_main`: 48 epochs at 10M PGs / 10k OSDs with the workload,
correlated failures and the balancer, after measuring the EC 4+2 encode
GB/s, each epoch's launches, program times and parts, four epochs'
programs held to numpy and 32 seeds a pool an epoch to the host oracle),
through the entry points a user calls, and prints one JSON object per
phase.  Any failure raises and exits non-zero.

The line before the last is the kernels line (each kernel's launches on
the main path, its time, bound and plain-version time); the last line is
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
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ceph_tpu_torch import build, obs
from ceph_tpu_torch.balancer import calc_pg_upmaps, state, upmap
from ceph_tpu_torch.balancer.crush_analysis import get_rule_weight_osd_map
from ceph_tpu_torch.cli import balancer as balancer_cli
from ceph_tpu_torch.cli import crushtool, ec_benchmark, osdmaptool
from ceph_tpu_torch.core import reduce
from ceph_tpu_torch.crush import mapper, mapper_ref, soa
from ceph_tpu_torch.crush.codec import encode_crushmap
from ceph_tpu_torch.crush.types import ITEM_NONE, BucketAlg
from ceph_tpu_torch.ec import create_erasure_code
from ceph_tpu_torch.ec.rs import decode_plan
from ceph_tpu_torch.ec.torch_backend import (
    TorchEngine,
    gf_matmul_cuda,
    gf_matmul_plain,
    product_tables,
)

from ceph_tpu_torch.mgr import Balancer, MappingState, synthetic_pg_stats
from ceph_tpu_torch.osd.carry import crush_from_reference, osdmap_from_reference
from ceph_tpu_torch.osd.incremental import Incremental, encode_incremental
from ceph_tpu_torch.osd.io import save_osdmap
from ceph_tpu_torch.osd.osdmap import OSD_UP, build_hierarchical
from ceph_tpu_torch.osd.pipeline import PoolMapper
from ceph_tpu_torch.osd.state import COUNTERS as state_counters
from ceph_tpu_torch.osd.state import ClusterState
from ceph_tpu_torch.osd.types import PgId, PgPool, PoolType
from ceph_tpu_torch.recovery import DRAIN_KEYS
from ceph_tpu_torch.recovery import queue as recovery_queue
from ceph_tpu_torch.runtime import DeviceLostError, faults
from ceph_tpu_torch.sim import ClusterSim, LifetimeSim
from ceph_tpu_torch.sim import lifetime as sim_lifetime
from ceph_tpu_torch.sim import workload as sim_workload
from ceph_tpu_torch.sim.workload import WL_KEYS

ROOT = Path(__file__).resolve().parent
CORPUS = ROOT / "tests" / "data" / "ec_corpus.json"
PLACEMENT_CORPUS = ROOT / "tests" / "data" / "placement_corpus.json"
LEGACY_CASES = ROOT / "tests" / "data" / "legacy_rule_cases.json"
CLI_CORPUS = ROOT / "tests" / "data" / "cli_corpus.json"
BALANCER_CORPUS = ROOT / "tests" / "data" / "balancer_corpus.json"
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
# parity column); a single-chunk repair 13 (12 pair decouplings, one
# product-matrix solve).  The JAX package's counts are the same.
CLAY4_ENCODE_PRODUCTS = 352
CLAY4_REPAIR_PRODUCTS = 13
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


def counted(expected: int, what: str, fn, kernel=gf_matmul_cuda):
    """Run fn() with the kernel's launch count set to 0 just before and
    read just after; fail unless it launched exactly `expected` times."""
    kernel.launches = 0
    out = fn()
    launches = kernel.launches
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
def engine_calls():
    """Records each product the device engine runs, as (M, data) with data
    u8[N, S, L]: yields the list.  On CPU tensors each is one call of the
    plain version, on CUDA tensors one kernel launch."""
    calls, real = [], TorchEngine._run

    def run(self, M, d):
        calls.append((M, d))
        return real(self, M, d)

    TorchEngine._run = run
    try:
        yield calls
    finally:
        TorchEngine._run = real


def cpu_products(fn) -> int:
    """The device engine's products in fn(), run on the CPU (the plain
    version): the launches the same calls make on the card."""
    with engine_calls() as calls:
        fn()
    check(all(d.device.type == "cpu" for _, d in calls), "a CPU dry run")
    return len(calls)


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
    block (gf_matmul: S KiB of tables, S = 8 at RS(8,4); crush_rule: the
    crush_ln tables and 16 B per staged record, placement_main prints
    the total) and the rule kernel's launch plan (`mapper.launch_plan`)."""
    t0 = time.perf_counter()
    libs = build.build_all()
    seconds = time.perf_counter() - t0
    kernels = {}
    for src in libs:
        kernels.update(build.ptxas_report(src))
    plan = vars(mapper.launch_plan(torch.cuda.current_device()))
    emit({"phase": "build", "seconds": seconds,
          "libraries": {src: str(lib.relative_to(ROOT))
                        for src, lib in libs.items()},
          "kernels": kernels, "crush_rule_plan": plan,
          "dynamic_smem_per_block": {
              "gf_matmul_rs84": 8 * 256 * 4,
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
    # the layered codes on the device engine; their launches are the
    # products of the same command run on the CPU
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
        expected = cpu_products(lambda: ec_benchmark.run(
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
        expected = cpu_products(lambda: drive(name, "cpu"))
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


def phase_clay_repair(dev, peak: float) -> dict:
    """BASELINE config 4, Clay(k=8, m=4, d=11) with backend=torch, at a
    4 MiB stripe (512 KiB chunks of 64 sub-chunks of 8 KiB) and at
    bench.py::bench_clay's 1 MiB chunks: the stripe's encode digest equal
    to the JAX package's (tests/data/clay_config4.json); on the 4 MiB
    stripe every lost chunk 0..11 repaired from its helpers' repair
    sub-chunks (CUDA tensors) to the encoded chunk, each repair counted
    from 0 (13 launches), and chunk 2's repair equal to the CPU's.
    Then, for chunk 2 at both sizes and for the encode: wall ms (host
    clock, synchronised), the kernels' own ms (CUDA events, launches back
    to back), the same products through the plain version, and the
    bytes bound."""
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
        data = torch.from_numpy(np.random.default_rng(
            stripe["seed"]).integers(0, 256, (k, Lc), dtype=np.uint8)).to(dev)
        enc, enc_n = counted(CLAY4_ENCODE_PRODUCTS,
                             f"config 4 encode {label}",
                             lambda: code.encode_chunks(data))
        launches["encode"] += enc_n
        check(_digest(enc) == stripe["digest"],
              f"config 4 {label}: stripe digest == the JAX package's")
        lost_all = range(k + m) if si == 0 else (2,)
        for lost in lost_all:
            helpers = repair_helpers(code, enc, lost)
            got, n = counted(CLAY4_REPAIR_PRODUCTS,
                             f"config 4 {label} repair {lost}",
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

        def replay(calls, plain=False):
            tables = [code.engine._tables_for(M, dev) for M, _ in calls]

            def run():
                for (M, x), t in zip(calls, tables):
                    if plain:
                        gf_matmul_plain(M, x)
                    else:
                        gf_matmul_cuda(t, x, M.shape[0])
            return run

        # the products to replay, as (M, x); the launches are counted above
        with engine_calls() as rep_calls:
            code.repair({2}, helpers, Lc)
        with engine_calls() as enc_calls:
            code.encode_chunks(data)
        check(len(rep_calls) == rep_n and len(enc_calls) == enc_n,
              f"config 4 {label}: the replay holds the counted products")
        rep_bytes = read + Lc
        enc_bytes = (k + m) * Lc  # data read once, parity written once
        row = {
            "chunk_bytes": Lc, "sub_chunk_bytes": Lc // code.sub_chunk_no,
            "repair_launches": rep_n,
            "repair_shapes": sorted({(int(M.shape[0]), int(M.shape[1]),
                                      int(x.shape[-1]))
                                     for M, x in rep_calls}),
            "repair_wall_ms": wall_ms(lambda: code.repair({2}, helpers, Lc),
                                      flush),
            "repair_ms": device_ms(replay(rep_calls), flush, clock),
            "repair_plain_ms": time_ms(replay(rep_calls, True), flush,
                                       runs=5),
            "repair_bytes": rep_bytes,
            "repair_bound_ms": rep_bytes / peak * 1e3,
            "read_fraction": read / (k * Lc),
            "encode_launches": enc_n,
            "encode_wall_ms": wall_ms(lambda: code.encode_chunks(data),
                                      flush, runs=7),
            "encode_ms": device_ms(replay(enc_calls), flush, clock, runs=7),
            "encode_plain_ms": time_ms(replay(enc_calls, True), flush,
                                       runs=3, warmup=1),
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
              f"launches, kernels {row['encode_ms']:.6f} ms, bound "
              f"{row['encode_bound_ms']:.6f} ms)", flush=True)
    emit({"phase": "clay_repair", "profile": stored["profile"],
          "digests_equal": True, "repairs_equal": k + m + 1,
          "equal_to_cpu": True, "launches": launches, "rows": rows})
    return launches, rows


# -- placement: the rule kernel on the card ----------------------------------

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


def placement_digest(rows) -> str:
    h = hashlib.sha256()
    for a in rows:
        h.update(np.ascontiguousarray(a, np.int32).tobytes())
    return h.hexdigest()


def phase_placement_corpus(dev, corpus: dict) -> int:
    """Every corpus entry's digest through PoolMapper.map_all() on the
    card: one launch per entry (each pool has fewer than BLOCK PGs)."""
    maps = {name: osdmap_from_reference(e["map"])
            for name, e in corpus.items()}

    def drive():
        for name, e in corpus.items():
            rows = PoolMapper(maps[name], e["pool_id"], device=dev).map_all()
            check(placement_digest(rows) == e["digest"],
                  f"placement digest {name}")

    _, n = counted(len(corpus), "placement corpus", drive,
                   mapper.crush_rule_cuda)
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
    entry point called once with the launch count from 0, checked, then
    timed (kernel, entry point, plain version) with CUDA events.  The
    issue bound counts the draws this run's PGs need, OPS_PER_DRAW each."""
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    clock = max_sm_clock_hz()
    issue_rate = H100_SMS * SCHEDULERS_PER_SM * WARP * clock
    res = {}
    for name, (n_pgs, n_osds) in CONFIGS.items():
        pm = pms[name]
        expected = -(-n_pgs // mapper.BLOCK)
        if name == "config2":
            entry = pm.map_all
            rows, n = counted(expected, name, entry, mapper.crush_rule_cuda)
            up = torch.from_numpy(rows[0]).to(dev)
        else:
            entry = pm.map_all_device
            up, n = counted(expected, name, entry, mapper.crush_rule_cuda)
        check(tuple(up.shape) == (n_pgs, 3), f"{name}: up shape")
        stats = sanity(name, pm.m, up)
        x, w = rule_inputs(pm, n_pgs)
        xb, wb = mapper.u32_bits(x), mapper.u32_bits(w)
        kernel_ms = time_ms(
            lambda: mapper.crush_rule_cuda(pm.tables, pm.prog, xb, wb),
            flush, runs=7)
        entry_ms = time_ms(entry, flush, runs=5)
        # the entry point's first two stages on their own: the placement
        # seeds, then map_rule (the kernel with its int32 conversions);
        # the rest of entry_ms is the post-CRUSH stages (and, for
        # map_all, the copy to the host)
        ps = torch.arange(n_pgs, device=dev)
        seeds_ms = time_ms(lambda: pm.placement_seeds(ps), flush, runs=5)
        rule_ms = time_ms(
            lambda: mapper.map_rule(pm.tables, pm.prog, x, w), flush, runs=5)
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
        out = {
            "config": name, "pgs": n_pgs, "osds": n_osds, "launches": n,
            "ms": kernel_ms, "entry_ms": entry_ms, "seeds_ms": seeds_ms,
            "rule_ms": rule_ms,
            "mappings_per_s": n_pgs / (kernel_ms * 1e-3),
            "entry_mappings_per_s": n_pgs / (entry_ms * 1e-3),
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
    return res


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
    map_all_device's rows.  One launch per (rule, numrep) pass or pool."""
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
            (text, sec), n = counted(launches, f"CLI {name}",
                                     lambda: run_cli(tool, argv, want_rc),
                                     mapper.crush_rule_cuda)
            digest = hashlib.sha256(text.encode()).hexdigest()
            check(digest == want[name], f"CLI {name}: stdout sha256 "
                  f"{digest} != the JAX CLI's {want[name]}")
            for f, fsha in want_files.get(name, {}).items():
                got = hashlib.sha256(Path(f).read_bytes()).hexdigest()
                check(got == fsha, f"CLI {name}: {f} sha256 {got} != the "
                      f"JAX CLI's {fsha}")
            res[name] = {"launches": n, "seconds": sec,
                         "mappings_per_s": pgs / sec,
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
            (text, sec), n = counted(1, f"CLI {name}",
                                     lambda: run_cli(tool, argv),
                                     mapper.crush_rule_cuda)
            got = cli_counts(text, pattern)
            check(len(got) > 0 and all(hist[i] == c for i, c in got.items())
                  and sum(got.values()) == int(hist.sum()),
                  f"CLI {name}: per-OSD counts == map_all_device's")
            res[name] = {"launches": n, "seconds": sec,
                         "mappings_per_s": C5_X / sec,
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
    device_loop plan inside the calc_pg_upmaps calls of the block: yields
    a dict of lists of ms, {"build": [...], "plan": [...]}."""
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

    build_cls, plan_fn = state.DeviceState, upmap._loop_plan

    class TimedDeviceState(build_cls):
        __init__ = timed("build", build_cls.__init__)

    state.DeviceState = TimedDeviceState
    upmap._loop_plan = timed("plan", plan_fn)
    try:
        yield times
    finally:
        state.DeviceState, upmap._loop_plan = build_cls, plan_fn


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
    sharing one mapper cache.  Each round is counted from 0 (one rule
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
        c0 = dict(upmap.COUNTERS)
        with stage_times() as st:
            t0 = time.perf_counter()
            r, n = counted(1, f"config5 round rng {entry['rng']}",
                           lambda: calc_pg_upmaps(
                               m, max_deviation=c5["max_deviation"],
                               max_iter=c5["max_iter"],
                               rng=np.random.default_rng(entry["rng"]),
                               device_cache=cache, device=dev,
                               **c5["kwargs"]),
                           mapper.crush_rule_cuda)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        delta = {k: upmap.COUNTERS[k] - c0[k] for k in c0}
        digests.append(plan_digest(m))
        row = {"rng": entry["rng"], "wall_s": wall,
               "build_ms": st["build"], "plan_ms": st["plan"],
               # the rest of the round: host work around the two (the
               # rule weight map, the domain table, the readback)
               "other_ms": wall * 1e3 - sum(st["build"]) - sum(st["plan"]),
               "launches": n, "loop_rounds": delta["rounds"],
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
    c2 = corpus["config2"]
    for name, entry in c2["backends"].items():
        m = reweighted(bench_map(c2["pgs"], c2["osds"]), c2["osds"],
                       c2["reweight_seed"])
        c0 = dict(upmap.COUNTERS)
        with stage_times() as st:
            t0 = time.perf_counter()
            r, n = counted(1, f"config2 {name}", lambda: calc_pg_upmaps(
                m, max_deviation=c2["max_deviation"],
                max_iter=c2["max_iter"], rng=np.random.default_rng(c2["rng"]),
                device=dev, **entry["kwargs"]), mapper.crush_rule_cuda)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        digest = plan_digest(m)
        check(digest == entry["digest"], f"config2 {name}: plan digest "
              f"{digest} != the JAX package's {entry['digest']}")
        check(r.num_changed == entry["num_changed"]
              and abs(r.stddev - entry["stddev"]) <= 1e-9,
              f"config2 {name}: changes and stddev == the JAX package's")
        launches[f"balancer_config2_{name}"] = n
        res["config2"][name] = {
            "wall_s": wall, "build_ms": st["build"], "plan_ms": st["plan"],
            "launches": n, "changes": r.num_changed, "stddev": r.stddev,
            "max_deviation": r.max_deviation, "digest": digest,
            "digest_equal": True,
            "counters": {k: upmap.COUNTERS[k] - c0[k] for k in c0}}

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
    res["config5"] = {"pgs": c5["pgs"], "osds": c5["osds"],
                      "rounds": rounds, "second_run_wall_s":
                      [r["wall_s"] for r in again],
                      "digests_equal_jax": True, "digest_stable": True,
                      "clean_pg_upmaps_cancelled": 0,
                      "peak_device_bytes": peak}
    for r in rounds:
        print(f"config5 round rng {r['rng']}: wall {r['wall_s']:.3f} s, "
              f"build {r['build_ms']} ms ({r['launches']} crush_rule "
              f"launch), plan {r['plan_ms']} ms, other {r['other_ms']:.3f} "
              f"ms, {r['loop_rounds']} plan "
              f"rounds, {r['host_syncs']} host syncs, {r['changes']} "
              f"changes, stddev {r['stddev']!r}, max_deviation "
              f"{r['max_deviation']!r}", flush=True)
    print(f"config5 peak device memory {peak} bytes", flush=True)
    emit(dict(phase="balancer_main", **res))
    return launches, res


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
        expected = cpu_products(lambda: drive(
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
    """fn() synchronised on both sides, with the rule kernel's launch
    count set to 0 just before and read just after: (out, s, launches)."""
    torch.cuda.synchronize()
    mapper.crush_rule_cuda.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, mapper.crush_rule_cuda.launches


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
    Each step's rule kernel launches are counted from 0."""
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
    c0 = dict(state_counters)
    (rc, _), s, n = timed(lambda: bal.execute(plan, st.m, state=st))
    steps["execute"] = {"s": s, "launches": n,
                        "device_put_bytes": state_counters[
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
        c0 = dict(state_counters)
        kind, s, n = timed(lambda: st.apply(inc))
        put = state_counters["device_put_bytes"] - c0["device_put_bytes"]
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
          f"({steps['first_rows']['launches']} crush_rule launch), eval "
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
SIM_SAMPLE = 32  # seeds a failure_sim epoch holds to the host oracle


def count_both(fn):
    """fn() with both rule kernels' launch counts set to 0 just before and
    read just after: (out, rule launches, diag launches)."""
    mapper.crush_rule_cuda.launches = 0
    mapper.crush_rule_diag_cuda.launches = 0
    out = fn()
    return (out, mapper.crush_rule_cuda.launches,
            mapper.crush_rule_diag_cuda.launches)


def diag_checked(T, prog, x, w, what: str) -> tuple[int, dict]:
    """crush_rule_diag_cuda on seeds x (the wrapper's staging and none)
    against the plain version, plane for plane, and its rows against
    crush_rule_cuda's: (max abs error, the plain planes)."""
    rows, _, want = mapper.crush_rule_plain(T, prog, x, w, diag=True)
    xb, wb = mapper.u32_bits(x), mapper.u32_bits(w)
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
    return err, want


def phase_diag_vs_plain(dev, corpus: dict, pms: dict) -> tuple[int, dict]:
    """The diagnostics kernel against its plain version, every plane
    element-exact, on every placement corpus map, every legacy case, the
    diag cases of tests/data/explain_corpus.json (an indep EC rule, and
    the cases the JAX plan leaves inexact: 2 hosts for size 3, vary_r=0
    and stable=0, leafy indep, two weight-set positions) and config 5's
    first 2^20 PGs (timed: the plain version against the kernel)."""
    worst, cases = 0, []

    def case(name, T, prog, x, w):
        nonlocal worst
        err, _ = diag_checked(T, prog, x, w, name)
        worst = max(worst, err)
        cases.append({"case": name, "seeds": x.numel(),
                      "lanes": prog.diag_lanes, "steps": prog.diag_steps})

    for name, entry in corpus.items():
        pm = PoolMapper(osdmap_from_reference(entry["map"]),
                        entry["pool_id"], device=dev)
        case(f"placement_{name}", pm.tables, pm.prog,
             *rule_inputs(pm, pm.spec.pg_num))
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
    x, w = rule_inputs(pm, PLAIN_BLOCK)
    err, _ = diag_checked(pm.tables, pm.prog, x, w, "config5 block")
    worst = max(worst, err)
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    xb, wb = mapper.u32_bits(x), mapper.u32_bits(w)
    block = {
        "pgs": PLAIN_BLOCK,
        "plain_ms": time_ms(lambda: mapper.crush_rule_plain(
            pm.tables, pm.prog, x, w, diag=True), flush, runs=1, warmup=0),
        "ms": time_ms(lambda: mapper.crush_rule_diag_cuda(
            pm.tables, pm.prog, xb, wb), flush, runs=7),
    }
    cases.append({"case": "config5_block", "seeds": PLAIN_BLOCK, **block})
    emit({"phase": "diag_vs_plain", "cases": cases, "max_abs_err": worst,
          "equal": True, "ptxas": build.ptxas_report(
              "crush/csrc/crush_rule_diag.cu"),
          "plan": vars(mapper.launch_plan(torch.cuda.current_device(),
                                          True))})
    return worst, block


def plane_bytes(prog, n: int) -> int:
    """The diagnostics' extra output: tries, steps and the 4 tallies."""
    return 4 * n * (prog.diag_lanes + prog.diag_steps * prog.result_max + 4)


def phase_diagnose_main(dev, pms: dict, n_draws: int, peak: float) -> dict:
    """PoolMapper.diagnose() over all of config 5's PGs, without and with
    a ClusterState, each counted from 0 (one diagnostics launch): the
    histogram's total equal to the placements the planes book, and, over
    512 sampled seeds, the histogram equal to the host oracle's; the diag
    kernel's time beside the default kernel's on the same seeds (CUDA
    events, L2 flushed) and diagnose's entry time on the host clock."""
    pm = pms["config5"]
    n = pm.spec.pg_num
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    out = {"pgs": n}
    state = ClusterState(pm.m, device=dev)
    for label, mpr in (("mapper", pm), ("state",
                                        PoolMapper(pm.m, 0, state=state))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, rule_n, diag_n = count_both(lambda: mpr.diagnose(record=False))
        sec = time.perf_counter() - t0
        check((rule_n, diag_n) == (0, 1),
              f"diagnose ({label}): {rule_n} rule, {diag_n} diag launches")
        check(s["pgs"] == n and s["diag_exact"] and s["unresolved"] == 0,
              f"diagnose ({label}) covers every PG")
        out[label] = {"s": sec, "diag_launches": diag_n, "summary": {
            k: v for k, v in s.items() if k != "tries_histogram"},
            "tries_histogram_head": s["tries_histogram"][:8]}
        out.setdefault("summary", s)
        check(s == out["summary"], "diagnose with a ClusterState == without")
    s = out["summary"]
    x, w = rule_inputs(pm, n)
    _, planes = mapper.diag_rule(pm.tables, pm.prog, x, w)
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
    pps = pm.placement_seeds(torch.from_numpy(sample).to(dev)).cpu()
    weights = pm.rule_weights().cpu().tolist()
    t0 = time.perf_counter()
    for xv in pps.tolist():
        mapper_ref.do_rule(crush, pm.spec.ruleno, xv, 3, weights,
                           collect_choose_tries=True)
    host_s = time.perf_counter() - t0
    check(got == crush.choose_tries_histogram[:len(got)],
          f"diagnose histogram == mapper_ref's over {DIAG_SAMPLE} seeds")
    crush.choose_tries_histogram = None
    xb, wb = mapper.u32_bits(x), mapper.u32_bits(w)
    out["ms"] = time_ms(lambda: mapper.crush_rule_diag_cuda(
        pm.tables, pm.prog, xb, wb), flush, runs=7)
    out["default_ms"] = time_ms(lambda: mapper.crush_rule_cuda(
        pm.tables, pm.prog, xb, wb), flush, runs=7)
    out["diagnose_ms"] = wall_ms(lambda: pm.diagnose(record=False), flush,
                                 runs=5)
    clock = max_sm_clock_hz()
    # the default kernel's draws on these seeds (placement_main counts
    # them): the variant makes the same draws
    ops_ms = (n_draws * OPS_PER_DRAW
              / (H100_SMS * SCHEDULERS_PER_SM * WARP * clock) * 1e3)
    nbytes = (rule_bytes(pm.tables, pm.prog, w.numel(), n)
              + plane_bytes(pm.prog, n))
    bytes_ms = nbytes / peak * 1e3
    out.update({
        "draws": n_draws, "ops_ms": ops_ms, "hbm_bytes": nbytes,
        "plane_bytes": plane_bytes(pm.prog, n), "bytes_ms": bytes_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
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
                rc, rule_n, diag_n = count_both(
                    lambda: crushtool.main(list(argv)))
            sec = time.perf_counter() - t0
            text = out.getvalue()
            check(rc == case["rc"], f"crushtool {name}: rc {rc}")
            digest = hashlib.sha256(text.encode()).hexdigest()
            check(digest == case["sha256"], f"crushtool {name}: stdout "
                  f"sha256 {digest} != the JAX CLI's {case['sha256']}")
            want = 1 if "--locate-divergence" in argv else 0
            check((rule_n, diag_n) == (0, want),
                  f"crushtool {name}: {rule_n} rule, {diag_n} diag launches")
            res[name] = {"rc": rc, "seconds": sec, "sha256_equal": True,
                         "diag_launches": diag_n}
        pm = pms["config5"]
        with open("c5crush", "wb") as f:
            f.write(encode_crushmap(pm.m.crush))
        argv = ["-i", "c5crush", "--test", "--num-rep", "3", "--min-x", "0",
                "--max-x", str(PLAIN_BLOCK - 1), "--show-choose-tries"]
        ((text, sec), rule_n, diag_n) = count_both(
            lambda: run_cli(crushtool, argv))
        check((rule_n, diag_n) == (1, 1),
              f"--show-choose-tries: {rule_n} rule, {diag_n} diag launches")
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
    sim, rule_n, diag_n = count_both(
        lambda: ClusterSim(m, diagnostics=True, device=dev))
    torch.cuda.synchronize()
    epochs = [{"event": "init", "s": time.perf_counter() - t0,
               "rule_launches": rule_n, "diag_launches": diag_n}]
    check((rule_n, diag_n) == (1, 1), "ClusterSim init launches")
    rng = np.random.default_rng(5)

    def fetched(cur):
        return cur[0].cpu().numpy(), cur[1].cpu().numpy()

    before = fetched(sim.current[0])
    for method, args in events:
        kw = {"backend": "device_loop"} if method == "balance" else {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep, rule_n, diag_n = count_both(
            lambda: getattr(sim, method)(*args, **kw))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        want_rule = 2 if method == "balance" else 1
        check((rule_n, diag_n) == (want_rule, 1),
              f"{method}{args}: {rule_n} rule, {diag_n} diag launches")
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
                       "rule_launches": rule_n, "diag_launches": diag_n,
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
    (backend "torch"): the JAX digest and summary, the rule kernel's
    launches of each epoch equal to the CPU run's rule calls (0 on every
    epoch in which no pool's rows tag changed), 0 compiles and no rebuild
    on a steady epoch.  Then one scenario stopped after epoch k and
    resumed through `python -m ceph_tpu_torch.cli.sim`, and an injected
    device loss, which must raise."""
    corpus = json.loads(LIFETIME_CORPUS.read_text())["scenarios"]
    res, launches_by = {}, {}
    for name, ent in sorted(corpus.items()):
        fresh_observers()
        t0 = time.perf_counter()
        mapper.crush_rule_cuda.launches = 0
        sim = LifetimeSim(ent["spec"], backend="torch", device=dev)
        init_n = mapper.crush_rule_cuda.launches
        todo = ent["forced"] + [None] * (sim.scenario.epochs
                                         - len(ent["forced"]))
        per_epoch = []
        for ev in todo:
            mapper.crush_rule_cuda.launches = 0
            sim.step(force_event=ev)
            per_epoch.append(mapper.crush_rule_cuda.launches)
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

    # no fallback: an injected device loss raises out of step()
    faults.configure("epoch_apply.3=lost:injected x1")
    try:
        sim = LifetimeSim(corpus["tiny"]["spec"], backend="torch",
                          device=dev)
        raised = False
        try:
            sim.run()
        except DeviceLostError:
            raised = True
    finally:
        faults.disarm_all()
    check(raised and sim.steps == 2 and sim.provenance()[
        "device_loss_fallbacks"] == 0, "an injected device loss raises")
    fresh_observers()
    emit({"phase": "lifetime_corpus", "scenarios": res,
          "cli_resume": {"scenario": name, "stop_after": k,
                         "digest_equal": True, "s": resume_s},
          "device_loss_raises": True})
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
    seconds, rule launches (held to the map_all_device and raw_rows calls
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
        mapper.crush_rule_cuda.launches = 0
        t0 = time.perf_counter()
        sim = LifetimeSim(spec, backend="torch", device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_launches = mapper.crush_rule_cuda.launches
        clock.take_ms()
        parts = time_parts(sim)
        epochs, checked, check_s, oracle_s = [], {}, 0.0, 0.0
        for _ in range(sim.scenario.epochs):
            tags0 = {p: ent[0] for p, ent in sim._prev_rows.items()}
            calls.update(map_all=0, raw=0)
            capture = [] if len(checked) < LIFETIME_CHECKED else None
            clock.capture = capture
            torch.cuda.synchronize()
            mapper.crush_rule_cuda.launches = 0
            parts.update(dict.fromkeys(parts, 0.0))
            t0 = time.perf_counter()
            r = sim.step()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            n = mapper.crush_rule_cuda.launches
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
                for pid in sorted(sim.m.pools):
                    rows = sim._prev_rows[pid][1]
                    seeds = rng.choice(rows.shape[0], min(
                        LIFETIME_SAMPLE, rows.shape[0]), replace=False)
                    got = rows[torch.from_numpy(seeds).to(dev)].cpu()
                    for ps, row in zip(seeds.tolist(), got.tolist()):
                        up = sim.m.pg_to_up_acting_osds(PgId(pid, ps))[0]
                        up = list(up) + [ITEM_NONE] * (len(row) - len(up))
                        check(row == up,
                              f"epoch {e}: pg {pid}.{ps:x} == host oracle")
                oracle_s += time.perf_counter() - t1
            epochs.append(rec)
        out = sim.summary()
        peak_bytes = torch.cuda.max_memory_allocated(dev)
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
    }
    emit(dict(phase="lifetime_main", **res))
    kinds = ", ".join(f"{k} median {v['median']:.3f} s max {v['max']:.3f} s"
                      for k, v in sorted(res["seconds_by_kind"].items()))
    print(f"lifetime_main on {smi}: init {init_s:.3f} s; {kinds}; "
          f"{out['cluster_years_per_hour']} cluster-years/hour; peak "
          f"device memory {peak_bytes} bytes", flush=True)
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

    # placement: the same, for the rule kernel
    corpus = {e["name"]: e for e in
              json.loads(PLACEMENT_CORPUS.read_text())["entries"]}
    pms = {name: PoolMapper(bench_map(*shape), 0, device=dev)
           for name, shape in CONFIGS.items()}
    rule_err, draws, legacy = phase_rule_vs_plain(dev, corpus, pms)
    rule_paths = {"placement_corpus": phase_placement_corpus(dev, corpus)}
    pres = phase_placement_main(dev, pms, draws, info["peak_bw"])
    rule_paths.update({key: r["launches"] for key, r in pres.items()})
    lres = phase_legacy_main(dev, legacy, info["peak_bw"])
    cres = phase_cli_placement(dev, pms)
    rule_paths.update({f"cli_{key}": r["launches"]
                       for key, r in cres.items()})
    bal_paths, bres = phase_balancer_main(dev, info["peak_bw"])
    rule_paths.update(bal_paths)
    mgr_paths, mres = phase_mgr_balancer(dev, info["nvidia_smi"])
    rule_paths.update(mgr_paths)

    # placement diagnostics and the failure simulator: the diagnostics
    # kernel vs its plain version, then its paths, each counted from 0
    diag_err, dblock = phase_diag_vs_plain(dev, corpus, pms)
    dres = phase_diagnose_main(dev, pms, pres["config5"]["draws"],
                               info["peak_bw"])
    diag_paths = {"diagnose_config5": dres["mapper"]["diag_launches"],
                  "diagnose_config5_state": dres["state"]["diag_launches"]}
    eres = phase_explain_cli(dev, pms)
    diag_paths.update({f"cli_{k}": r["diag_launches"]
                       for k, r in eres.items()})
    rule_paths["cli_config5_show_choose_tries"] = \
        eres["config5_show_choose_tries"]["rule_launches"]
    fres = phase_failure_sim(dev, pms, info["nvidia_smi"])
    for i, e in enumerate(fres["epochs"]):
        diag_paths[f"sim_config5_{i}"] = e["diag_launches"]
        rule_paths[f"sim_config5_{i}"] = e["rule_launches"]

    # the lifetime simulator: the corpus, then config 5's size
    del pms
    torch.cuda.empty_cache()
    rule_paths.update({f"lifetime_corpus_{name}": n for name, n in
                       phase_lifetime_corpus(dev).items()})
    life = phase_lifetime_main(dev, info["nvidia_smi"], info["peak_bw"])
    rule_paths["lifetime_main"] = life["launches"]
    by_path["lifetime_ec_calibration"] = life["ec_calibration"]["launches"]
    torch.cuda.synchronize()

    b, c5 = res["b"], pres["config5"]
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
        "library_ms": None,
        "shapes": {key: {f: r[f] for f in ("ms", "plain_ms", "copy_ms",
                                           "bound_ms", "gb_per_s")}
                   for key, r in res.items()},
        # BASELINE config 4 (Clay(8,4,11)): a repair's and an encode's
        # products, summed kernel ms beside the wall ms and the bound
        "config4": {key: {f: r[f] for f in (
            "repair_launches", "repair_shapes", "repair_ms",
            "repair_wall_ms", "repair_plain_ms", "repair_bound_ms",
            "repair_gb_per_s", "read_fraction", "encode_launches",
            "encode_ms", "encode_wall_ms", "encode_plain_ms",
            "encode_bound_ms")} for key, r in clay_rows.items()},
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
            "pgs", "ms", "entry_ms", "seeds_ms", "rule_ms",
            "mappings_per_s", "plain_pgs",
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
                for key, r in cres.items()},
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
                          "launches": life["launches"]},
    }, {
        "name": "crush_rule_diag",
        "route": "cuda",
        "source": "ceph_tpu_torch/crush/csrc/crush_rule_diag.cu",
        "replaces": "ceph_tpu/crush/mapper_jax.py:1529::compile_rule("
                    "with_diag=True) (XLA)",
        "equal": diag_err == 0,
        "launches": sum(diag_paths.values()),
        "launches_by_path": diag_paths,
        "max_abs_err": diag_err,
        # config 5 (10M PGs) beside the default kernel on the same seeds;
        # plain_ms on the first plain_pgs PGs, beside the kernel's time on
        # the same block (block_ms)
        "ms": dres["ms"],
        "default_ms": dres["default_ms"],
        "plain_ms": dblock["plain_ms"],
        "plain_pgs": dblock["pgs"],
        "block_ms": dblock["ms"],
        "bound_ms": dres["bound_ms"],
        "bound_by": dres["bound_by"],
        "library_ms": None,
        "diagnose_ms": dres["diagnose_ms"],
        "diagnose_s": {k: dres[k]["s"] for k in ("mapper", "state")},
        "cli": {k: r["seconds"] for k, r in eres.items()},
        "failure_sim": [{f: e[f] for f in ("event", "s", "rule_launches",
                                          "diag_launches")}
                        for e in fres["epochs"]],
        "failure_sim_peak_device_bytes": fres["peak_device_bytes"],
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
