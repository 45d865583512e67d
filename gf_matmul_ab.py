#!/usr/bin/env python3
"""Time the GF(2^8) product kernel and the EC paths that launch it, for
several checkouts of this repository in one run on one card, in the order
given (e.g. parent, change, change, parent).

    python3 gf_matmul_ab.py TREE [TREE ...]

Each TREE is a directory that holds a checkout of the repository (a
`git archive` unpacked, e.g. under ab_trees/, which .gitignore lists).
For each, in turn, a child process imports `ceph_tpu_torch` from that
tree, builds its GF kernel and times, with the L2 cache flushed before
each run:
- RS(8,4) shapes (a) encode_parity of a 16 MiB object, (b) encode_batch
  [8192, 8, 4096], (c) decode_batch of (b) with chunks {0, 5} lost: the
  kernel alone (`gf_matmul_cuda`, CUDA events, median of 25) beside its
  HBM bound, and the entry point (host clock, synchronised, median of 25);
- BASELINE config 4, Clay(8,4,11) on a 4 MiB stripe: the encode and the
  repair of chunk 2 from its helpers' repair sub-chunks;
- Clay(2,33,19) (tests/data/ec_wide.json's profile): the encode of its
  stripe.
For each path: `launches` (the kernel's registry count over one untimed
call), `device_ms` (CUDA events around the call, the stream held by a
sleep kernel while the host enqueues it, so its kernels run back to back:
every kernel of the path, not only the GF ones; median of 7, of 3 for
Clay(2,33,19)) and `wall_ms` (host clock, synchronised; median of 7, 3).
Every tree must give the same bytes (sha256 of each path's output); the
script fails otherwise.

Prints one JSON line per tree, with the card's name and power limit, and
a last line with every tree's numbers side by side.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

MiB = 1 << 20
PEAK_BW = 3.35e12  # NVIDIA H100 SXM5 HBM3 (data sheet)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# -- one tree (the child) -----------------------------------------------------

def child(tree: Path, label: str) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from ceph_tpu_torch import build
    from ceph_tpu_torch.ec import create_erasure_code, torch_backend
    from ceph_tpu_torch.ec.rs import decode_plan

    if not torch.cuda.is_available():
        raise SystemExit("gf_matmul_ab: no CUDA device")
    assert Path(build.__file__).resolve().is_relative_to(tree.resolve())
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.build("ec/csrc/gf_matmul.cu")
    res: dict = {"tree": label, "nvidia_smi": smi(),
                 "build_s": time.perf_counter() - t0}
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]) * 1e6
    kernel = torch_backend.gf_matmul_cuda

    def rand_u8(shape, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, 256, shape, generator=gen,
                             dtype=torch.uint8, device=dev)

    def sha(x) -> str:
        h = hashlib.sha256()
        for t in (x if isinstance(x, (list, tuple)) else [x]):
            h.update(t.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    def events_ms(fn, runs=25):
        for _ in range(3):
            fn()
        times = []
        for _ in range(runs):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def device_ms(fn, runs):
        """CUDA events around fn() with the stream held by a sleep kernel
        for twice fn's enqueue time: its kernels back to back."""
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        enqueue = time.perf_counter() - t
        torch.cuda.synchronize()
        cycles = int(2 * enqueue * clock_hz) + 100_000
        times = []
        for _ in range(runs):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def wall_ms(fn, runs):
        fn()
        times = []
        for _ in range(runs):
            flush.zero_()
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    def path(fn, runs=7):
        kernel.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return {"launches": kernel.launches, "sha256": sha(out),
                "device_ms": device_ms(fn, runs),
                "wall_ms": wall_ms(fn, runs)}

    # RS(8,4), shapes (a)-(c)
    code = create_erasure_code({"plugin": "jax", "k": "8", "m": "4"},
                               device=dev)
    k, m, C = code.k, code.m, code.C
    tables = torch.from_numpy(
        torch_backend.product_tables(C).reshape(-1)).to(dev)
    obj = rand_u8((k, 2 * MiB), 500)
    stripes = rand_u8((8192, k, 4096), 501)
    enc = code.encode_batch(stripes)
    lost = (0, 5)
    have = {i: enc[:, i] for i in range(k + m) if i not in lost}
    use = sorted(have)[:k]
    R = decode_plan(C, tuple(use), lost, code.engine)
    rtables = torch.from_numpy(
        torch_backend.product_tables(R).reshape(-1)).to(dev)
    stack = torch.stack([have[i] for i in use], dim=1)
    shapes = {
        "a": (lambda: kernel(tables, obj[None], m),
              lambda: code.encode_parity(obj), (k + m) * 2 * MiB),
        "b": (lambda: kernel(tables, stripes, m),
              lambda: code.encode_batch(stripes), 8192 * (k + m) * 4096),
        "c": (lambda: kernel(rtables, stack, len(lost)),
              lambda: code.decode_batch(set(range(k)), have, 4096),
              8192 * (k + len(lost)) * 4096),
    }
    for key, (fn, entry, nbytes) in shapes.items():
        out = fn()
        torch.cuda.synchronize()
        ms = events_ms(fn)
        res[key] = {"sha256": sha(out), "kernel_ms": ms,
                    "bound_ms": nbytes / PEAK_BW * 1e3,
                    "bound_share": nbytes / PEAK_BW * 1e3 / ms,
                    "entry_ms": wall_ms(entry, 25)}
    del stripes, enc, have, stack
    torch.cuda.empty_cache()

    # BASELINE config 4: encode, and chunk 2's repair
    root = Path(__file__).resolve().parent
    stored = json.loads((root / "tests/data/clay_config4.json").read_text())
    clay = create_erasure_code(dict(stored["profile"], backend="torch"),
                               device=dev)
    stripe = stored["stripes"][0]
    data = torch.from_numpy(np.random.default_rng(stripe["seed"]).integers(
        0, 256, (clay.k, stripe["chunk_bytes"]), dtype=np.uint8)).to(dev)
    res["config4_encode"] = path(lambda: clay.encode_chunks(data))
    chunks = clay.encode_chunks(data)
    need = clay.minimum_to_repair({2}, set(range(clay.k + clay.m)) - {2})
    helpers = {}
    for h, runs in need.items():
        planes = torch.tensor([z for ind, cnt in runs
                               for z in range(ind, ind + cnt)], device=dev)
        helpers[h] = chunks[h].view(clay.sub_chunk_no, -1)[planes].reshape(-1)
    res["config4_repair"] = path(
        lambda: clay.repair({2}, helpers, stripe["chunk_bytes"])[2])

    # Clay(2,33,19): the encode of ec_wide's stripe
    case = json.loads((root / "tests/data/ec_wide.json").read_text())[
        "clay_k2m33_d19"]
    wide = create_erasure_code(dict(case["profile"]), device=dev)
    cs = wide.get_chunk_size(case["size"])
    wdata = rand_u8((wide.k, cs), 502)
    res["clay_k2m33_d19_encode"] = path(lambda: wide.encode_chunks(wdata),
                                        runs=3)
    return res


# -- the parent ---------------------------------------------------------------

PATHS = ("a", "b", "c", "config4_encode", "config4_repair",
         "clay_k2m33_d19_encode")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--label", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.trees[0], args.label)), flush=True)
        return 0
    print(smi(), flush=True)
    results = []
    for i, tree in enumerate(args.trees):
        label = f"{i}-{tree.resolve().name}"
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             "--label", label, str(tree)],
            capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(res), flush=True)
        results.append(res)
    for p in PATHS:
        if len({r[p]["sha256"] for r in results}) != 1:
            print(f"gf_matmul_ab: {p}: the trees' bytes differ",
                  file=sys.stderr)
            return 1
    print(json.dumps({"nvidia_smi": results[0]["nvidia_smi"],
                      "bytes_equal": True, "side_by_side": {
                          r["tree"]: {p: {f: v for f, v in r[p].items()
                                          if f != "sha256"} for p in PATHS}
                          for r in results}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
