"""Run a cell with its control in the program's place, at the cell's size.

    python bench_port/control.py --workload <cell> --seeds 1,2,3 [--ops N]

For each seed: the cell's set-up and `--ops` operations (default: two of
the traffic's cycles, or its batches and kept sample) with the control of
`controls.py` in the program's place, then the cell's own check.  One
JSON line a seed: the numbers compared, each with its limit, and
`correct`, which must read false.  It needs the card, as the benchmark
does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench_port import harness  # noqa: E402
from bench_port.controls import CONTROLS  # noqa: E402


def default_ops(cell) -> int:
    p = cell.traffic["params"]
    if "cycle" in p:
        return 2 * len(p["cycle"])
    return p["batches"] + p["check_sample_ops"]


def run(cell, seed: int, device, ops: int) -> dict:
    control = CONTROLS[cell.traffic["driver"]]
    drv = harness.make_driver(harness.Ctx(cell, seed, device,
                                          program=control))
    t0 = time.perf_counter()
    drv.setup()
    w = harness.run_window(drv, device, 1e9, False, max_ops=ops)
    drv.release()
    checks = drv.check()
    return {"workload": cell.name, "seed": seed,
            "program": control.__name__,
            "ops": w.ops, "failed": w.failed,
            "seconds": time.perf_counter() - t0,
            "correct": w.failed == 0 and all(v <= lim
                                              for _, v, lim in checks),
            "checks": {n: {"value": v, "limit": lim}
                       for n, v, lim in checks}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--ops", type=int)
    a = ap.parse_args(argv)
    harness.checkout_caches()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell.load(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        res = run(cell, seed, torch.device("cuda", 0),
                  a.ops or default_ops(cell))
        print(json.dumps(res), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
