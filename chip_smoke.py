#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ceph_tpu_torch`) on one card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one NVIDIA H100
and the CUDA toolkit.  It builds every kernel from the sources in the
checkout, holds each kernel against its plain PyTorch version, drives the
erasure-coding path through the entry points a user calls (the corpus
profiles, RS(8,4) encode/decode at full size, the benchmark CLI), and
prints one JSON object per phase.  Any failure raises and exits non-zero.

The line before the last is the kernels line (each kernel's launches on
the main path, its time, bound and plain-version time); the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits with 1 and
prints no result.
"""

from __future__ import annotations

import hashlib
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ceph_tpu_torch.cli import ec_benchmark
from ceph_tpu_torch.ec import build, create_erasure_code
from ceph_tpu_torch.ec.rs import decode_plan
from ceph_tpu_torch.ec.torch_backend import (
    gf_matmul_cuda,
    gf_matmul_plain,
    product_tables,
)

ROOT = Path(__file__).resolve().parent
CORPUS = ROOT / "tests" / "data" / "ec_corpus.json"
RS_ENTRIES = (
    "rs_k8m4_reed_sol_van",
    "rs_k6m2_reed_sol_r6_op",
    "rs_k4m2_cauchy_good",
    "isa_k8m4_reed_sol_van",
)
# peak HBM bandwidth of the one card the port is measured on (NVIDIA's
# H100 SXM5 data sheet); its name as torch reports it
H100_SXM = "NVIDIA H100 80GB HBM3"
H100_SXM_BW = 3.35e12
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


def counted(expected: int, what: str, fn):
    """Run fn() with the kernel's launch count set to 0 just before and
    read just after; fail unless it launched exactly `expected` times."""
    gf_matmul_cuda.launches = 0
    out = fn()
    launches = gf_matmul_cuda.launches
    check(launches == expected,
          f"{what}: {launches} kernel launches, expected {expected}")
    return out, launches


def time_ms(fn, flush: torch.Tensor, runs: int = RUNS) -> float:
    """Median device time of fn() in ms, CUDA events around each run, with
    the L2 cache flushed before each (a caller's stripes arrive cold)."""
    for _ in range(3):
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

def phase_build() -> None:
    t0 = time.perf_counter()
    lib = build.build("gf_matmul")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT))})


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
    emit({"phase": "cli", "output": lines, "launches": launches})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    info = phase_device()
    phase_build()
    err = phase_kernel_vs_plain(dev)

    # the main path, path by path: each counted from 0 (see counted())
    by_path = {"corpus": phase_corpus(dev)}
    res = phase_main_path(dev, info["peak_bw"])
    by_path.update({key: r["launches"] for key, r in res.items()})
    by_path.update({f"cli_{w}": n for w, n in phase_cli().items()})
    torch.cuda.synchronize()

    b = res["b"]
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
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
