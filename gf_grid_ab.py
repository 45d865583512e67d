#!/usr/bin/env python3
"""Time the GF(2^8) product kernel at shape (a), RS(8,4) encode_parity of
a 16 MiB object (512 work items), under several widths of its persistent
grid, in turns within one process on one card: the measurement behind
`ceph_tpu_torch.ec.torch_backend._grid`.

    python3 gf_grid_ab.py [--rounds 10]

Each width is timed `--rounds` times, the order of the widths rotated and
reversed from round to round; a time is the median of 25 launches (CUDA
events, the L2 flushed before each).  Every launch's bytes are held to the
plain version.  Prints the card's name and power limit, a line per width
(median, quartiles, every time) and how often the wrapper's own width beat
the width of every block that fits.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from ceph_tpu_torch.ec import create_erasure_code
from ceph_tpu_torch.ec import torch_backend as tb

MiB = 1 << 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gf_grid_ab: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    C = create_erasure_code({"plugin": "jax", "k": "8", "m": "4"},
                            device=dev).C
    tables = torch.from_numpy(tb.product_tables(C).reshape(-1)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(500)
    obj = torch.randint(0, 256, (8, 2 * MiB), generator=gen,
                        dtype=torch.uint8, device=dev)
    want = tb.gf_matmul_plain(C, obj[None])
    items = 512
    fit, chosen = tb._blocks(dev, 8), tb._grid(dev, 8, items)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    widths = sorted({fit, chosen, items, sms, 2 * sms})
    real = tb._grid

    def timed(width: int) -> float:
        tb._grid = lambda device, max_cols, n: min(n, width)
        try:
            out = tb.gf_matmul_cuda(tables, obj[None], 4)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"gf_grid_ab: width {width}: bytes differ")
            for _ in range(3):
                tb.gf_matmul_cuda(tables, obj[None], 4)
            times = []
            for _ in range(25):
                flush.zero_()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                tb.gf_matmul_cuda(tables, obj[None], 4)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            return statistics.median(times)
        finally:
            tb._grid = real

    res: dict[int, list[float]] = {w: [] for w in widths}
    for i in range(args.rounds):
        order = widths[i % len(widths):] + widths[:i % len(widths)]
        for w in order[::-1] if i % 2 else order:
            res[w].append(timed(w))
    for w in widths:
        q = statistics.quantiles(res[w], n=4)
        print(json.dumps({"grid": w, "fit": w == fit, "chosen": w == chosen,
                          "median_ms": statistics.median(res[w]),
                          "q1_ms": q[0], "q3_ms": q[2], "ms": res[w]}),
              flush=True)
    wins = sum(a < b for a, b in zip(res[chosen], res[fit]))
    print(json.dumps({"items": items, "fit": fit, "chosen": chosen,
                      "chosen_beats_fit": wins, "rounds": args.rounds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
