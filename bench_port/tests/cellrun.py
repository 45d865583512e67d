"""Drive one cell on the port's CPU path, as the harness drives it on the
card: set-up, a window of a few operations, the check."""

from __future__ import annotations

from bench_port import harness


def run_cell(root, name: str, seed: int = 20260001, ops: int = 9,
             program=None, trace: bool = False) -> dict:
    cell = harness.Cell.load(name, root)
    drv = harness.make_driver(harness.Ctx(cell, seed, "cpu",
                                          program=program))
    drv.setup()
    w = harness.run_window(drv, "cpu", 1e9, trace, max_ops=ops)
    drv.release()
    checks = drv.check()
    return {"window": w, "driver": drv, "checks": {n: v for n, v, _ in checks},
            "correct": w.failed == 0 and w.ops > 0
            and all(v <= lim for _, v, lim in checks)}
