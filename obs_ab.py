#!/usr/bin/env python3
"""Time the host cost around the port's kernel launches for several
checkouts of this repository in one run on one card, in the order given
(e.g. parent, change, change, parent).

    python3 obs_ab.py TREE [TREE ...]

Each TREE is a directory that holds a checkout of the repository (a
`git archive` unpacked).  For each, in turn, a child process imports
`ceph_tpu_torch` from that tree, builds its kernels and measures on the
card:
- `gf_b_kernel_ms`: one `gf_matmul_cuda` launch on RS(8,4) shape (b),
  [8192, 8, 4096], CUDA events around the call with a 64 MiB buffer
  zeroed before each run, median of 25 (where the host's work before
  the launch outlasts that zeroing, the card waits and the events
  count the wait);
- `gf_b_back_to_back_ms`: the same launch ten times in a row between
  the events, after one zeroing, per launch, median of 15 (the host
  enqueues ahead of the card, so this is the kernel's own time and the
  difference from `gf_b_kernel_ms` is the host's gap before a lone
  launch);
- `encode_batch_b_ms`: `encode_batch` of RS(8,4) on (b), the same way;
- `one_stripe_launch_wall_us`: the host wall time of one launch on one
  stripe, over 1000 launches and a synchronise;
- `one_stripe_launch_min_us`: the same, the least of ten batches of 100
  launches (the least is the host's cost with the least interference);
- `account_us`: one `LaunchAccount.launch` of a no-op function on a
  throwaway account, the least of five batches of 20 000: the launch
  accounting's own host cost (null for a tree without it);
- `config2_map_all_ms`: `PoolMapper.map_all` of BASELINE config 2's
  shape (128 hosts of 8 OSDs, 100 000 PGs), host clock around a
  synchronised call, median of 15.

Prints the card's name and power limit, then one JSON line per tree.
"""

import json
import subprocess
import sys

CHILD = r'''
import json, statistics, sys, time
tree = sys.argv[1]
sys.path.insert(0, tree)
import numpy as np, torch
from ceph_tpu_torch import build
build.build_all()
from ceph_tpu_torch.ec import create_erasure_code
from ceph_tpu_torch.ec.torch_backend import gf_matmul_cuda, product_tables
from ceph_tpu_torch.osd.osdmap import build_hierarchical
from ceph_tpu_torch.osd.pipeline import PoolMapper
from ceph_tpu_torch.osd.types import PgPool, PoolType
dev = torch.device("cuda")
code = create_erasure_code({"plugin": "jax", "k": "8", "m": "4"}, device=dev)
tables = torch.from_numpy(product_tables(code.C).reshape(-1)).to(dev)
gen = torch.Generator(device=dev).manual_seed(1)
data = torch.randint(0, 256, (8192, 8, 4096), generator=gen,
                     dtype=torch.uint8, device=dev)
flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
def time_ms(fn, runs=25):
    for _ in range(3):
        fn()
    ts = []
    for _ in range(runs):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record(); fn(); e.record(); e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)
kernel = time_ms(lambda: gf_matmul_cuda(tables, data, 4))
def ten():
    for _ in range(10):
        gf_matmul_cuda(tables, data, 4)
back_to_back = time_ms(ten, runs=15) / 10
entry = time_ms(lambda: code.encode_batch(data))
one = data[:1].contiguous()
for _ in range(20):
    gf_matmul_cuda(tables, one, 4)
torch.cuda.synchronize()
t = time.perf_counter()
for _ in range(1000):
    gf_matmul_cuda(tables, one, 4)
torch.cuda.synchronize()
one_ms = (time.perf_counter() - t)
batches = []
for _ in range(10):
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(100):
        gf_matmul_cuda(tables, one, 4)
    torch.cuda.synchronize()
    batches.append((time.perf_counter() - t) / 100 * 1e6)
try:
    import inspect
    from ceph_tpu_torch.obs import logger_for
    from ceph_tpu_torch.obs.cuda_accounting import LaunchAccount
except ImportError:
    account_us = None
else:
    acct = LaunchAccount(logger_for("obs_ab"), "obs_ab",
                         "ec/csrc/gf_matmul.cu")
    params = inspect.signature(acct.launch).parameters
    kw = {"shape": (1,)} if "shape" in params else {"nbytes": 1, "ops": 1}
    nop = lambda: 0
    runs = []
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(20000):
            acct.launch(nop, **kw)
        runs.append((time.perf_counter() - t) / 20000 * 1e6)
    account_us = min(runs)
pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
              pg_num=100000, pgp_num=100000)
m = build_hierarchical(128, 8, n_rack=8, pool=pool)
pm = PoolMapper(m, 0, device=dev)
pm.map_all()
ws = []
for _ in range(15):
    torch.cuda.synchronize()
    t = time.perf_counter()
    pm.map_all()
    ws.append((time.perf_counter() - t) * 1e3)
print(json.dumps({"tree": tree, "gf_b_kernel_ms": kernel,
                  "gf_b_back_to_back_ms": back_to_back,
                  "encode_batch_b_ms": entry,
                  "one_stripe_launch_wall_us": one_ms * 1e3,
                  "one_stripe_launch_min_us": min(batches),
                  "account_us": account_us,
                  "config2_map_all_ms": statistics.median(ws)}))
'''

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
print(smi, flush=True)
for tree in sys.argv[1:]:
    out = subprocess.run([sys.executable, "-c", CHILD, tree],
                         capture_output=True, text=True, timeout=900)
    print(out.stdout.strip() or out.stderr[-2000:], flush=True)
