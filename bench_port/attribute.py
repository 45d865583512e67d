"""Run one cell's traced window and put its time down to the program's
own spans.

    python3 bench_port/attribute.py --workload <cell> --seed <n> \
        --seconds <s>

from the root of a checkout, on the card.  It runs the cell as `run.py
--trace 1` does (the same set-up, window, traced part and check) and
prints one JSON line: the traced part's operations, busy and window
seconds, the cell's per-layer metrics, the readings of `PENDING` (the
metrics that read the program's spans in the profiler's trace), the
window's idle seconds split by the innermost span the host was in
(`attribution.py`; `bench.loop` where it was in none), the device
seconds by the innermost span that launched them, the device work with
no launch call, and the least lead from a launch call to its device
interval (negative: the trace's clocks disagree, and the idle split is
off by that much).

`PENDING` are the per-layer entries that BENCHMARK.json takes once
`trace.read` keeps the events it reads on its `Readings` (as `events`):
`run.py` cannot give their readers those events before then.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port import attribution, harness  # noqa: E402
from bench_port import trace as tr  # noqa: E402

CHURN = ["c5_rep3.churn", "c5_ec84.churn"]
EC = ["c5_ec84.write", "c5_ec84.degraded_read"]
PENDING = [
    {"name": "apply_idle_ms", "unit": "ms", "better": "lower",
     "source": "device_trace",
     "layer": "Cluster state: osd/state.py ClusterState.apply",
     "moves": "epoch_p95_ms", "workloads": CHURN},
    {"name": "rows_idle_ms", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "Placement entry: ClusterState.rows,"
     " osd/pipeline.py PoolMapper.map_all_device",
     "moves": "pg_mappings_per_s", "workloads": CHURN},
    {"name": "ec_entry_idle_ms", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "EC codec: ec/rs.py encode_batch "
     "and decode_batch, ec/torch_backend.py TorchEngine",
     "moves": "ec_gbps", "workloads": EC},
    {"name": "ec_entry_copy_ms", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "EC codec: ec/rs.py encode_batch "
     "and decode_batch, ec/torch_backend.py TorchEngine",
     "moves": "ec_gbps", "workloads": EC},
]


def readings(cell, drv, w, n_chips: int):
    """The traced part's `Readings`, as `harness.per_layer` makes them,
    with the profiler's events kept as `events`."""
    events = tr._events(w.profile)
    rd = tr.read(events, n_chips)
    rd.events = events
    rd.spans = w.spans.seconds
    rd.ops = w.ops
    rd.traced = w.traced
    rd.traced_ops = w.traced[1] - w.traced[0]
    rd.info = drv.trace_info(*w.traced)
    rd.cell = cell
    return rd


def run(name: str, seed: int, seconds: float, device,
        root: Path = harness.ROOT, max_ops: int | None = None) -> dict:
    cell = harness.Cell.load(name, root)
    drv = harness.make_driver(harness.Ctx(cell, seed, device))
    drv.setup()
    harness.warm_profiler(device)
    w = harness.run_window(drv, device, seconds, True, max_ops=max_ops)
    drv.release()
    checks = drv.check()
    out = {"workload": name, "seed": seed,
           "correct": w.failed == 0 and w.ops > 0
           and all(v <= lim for _, v, lim in checks),
           "ops": w.ops, "failed": w.failed}
    if w.profile is None:  # the window ended before its traced part began
        return out
    rd = readings(cell, drv, w, int(cell.workload["chips"]))
    metrics = {}
    for m in cell.per_layer + [m for m in PENDING
                               if name in m["workloads"]]:
        reader = harness.load_module(
            harness.HERE / "metrics" / f"{m['name']}.py",
            f"bench_port.metrics.{m['name']}")
        metrics[m["name"]] = reader.read(rd)
    a = attribution.of(rd)
    inner: dict = {}
    for st, s in a.device.items():
        key = st[-1] if st else "(no span)"
        inner[key] = inner.get(key, 0.0) + s
    out.update(
        traced_ops=rd.traced_ops, busy_s=rd.busy_s, window_s=rd.window_s,
        metrics=metrics, idle_s=sum(a.idle.values()),
        idle_split=a.idle_by_innermost(),
        device_split=dict(sorted(inner.items(), key=lambda kv: -kv[1])),
        unlinked_s=a.unlinked_s, min_lead_us=a.min_lead_us, gaps=rd.gaps)
    return out


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    harness.checkout_caches()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    out = run(a.workload, a.seed, a.seconds, torch.device("cuda", 0))
    out["device"] = torch.cuda.get_device_name(0)
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
