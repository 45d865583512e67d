#!/usr/bin/env python3
"""Time the CRUSH rule kernel of several checkouts of this repository in
one run on one card, in the order given (e.g. parent, change, change,
parent), and show what each built.

    python3 crush_rule_ab.py [--sass DIR] TREE [TREE ...]

Each TREE is a directory that holds a checkout of the repository (a
`git archive` unpacked).  For each, in turn, a child process imports
`ceph_tpu_torch` from that tree, builds its rule kernel, maps BASELINE
configs 2 and 5 as chip_smoke.py builds them, and times with CUDA events,
the L2 cache flushed before each run:
- the kernel (`crush_rule_cuda`) on all of a config's PGs, median of 7;
  where the tree's wrapper takes a `stage` argument, also with no record
  and with every record of the map staged in shared memory;
- the entry points, `map_all` (config 2) and `map_all_device` (config 5),
  median of 5.
Every run of every tree must give the same rows (sha256 of the kernel's
rows per config); the script fails otherwise.  With --sass DIR each
child also writes the built library's SASS (cuobjdump -sass) to
DIR/<n>-<tree>.txt and counts the instructions of every loop
that holds a straw2 draw (a backward branch around at least 100
IADD3/LOP3/SHF instructions, hash3's mix), and the last line says
whether every tree's rule kernel (`crush_rule_kernel`) has the same SASS
(`kernel_sass_equal`, from the sha256 of its instructions).

Prints one JSON line per tree, with the card's name and power limit, and
a last line with every tree's times side by side.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

CONFIGS = {"config2": (100_000, 1024), "config5": (10_000_000, 10_000)}
OSD_PER_HOST = 8
MiB = 1 << 20


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# -- SASS ---------------------------------------------------------------------

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_BRA = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")


def kernel_sass_sha256(sass: str) -> str:
    """sha256 of the rule kernel's SASS instructions, in order."""
    h = hashlib.sha256()
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        if "crush_rule_kernel" in fn.splitlines()[0]:
            for m in _INSN.finditer(fn):
                h.update(m.group(2).encode() + b"\n")
    return h.hexdigest()


def draw_loops(sass: str) -> list[dict]:
    """The loops of the rule kernels that hold a straw2 draw: per loop,
    its instruction count and the count of each opcode."""
    loops = []
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if "crush_rule" not in name:
            continue
        insns = [(int(a, 16), body.strip())
                 for a, body in _INSN.findall(fn)]
        index = {a: i for i, (a, _) in enumerate(insns)}
        for i, (addr, body) in enumerate(insns):
            m = _BRA.search(body)
            if not m or int(m.group(1), 16) >= addr:
                continue
            start = index.get(int(m.group(1), 16))
            if start is None:
                continue
            ops = Counter(
                re.sub(r"^@!?U?P\w+\s+", "", b).split()[0].split(".")[0]
                for _, b in insns[start:i + 1])
            if ops["IADD3"] + ops["LOP3"] + ops["SHF"] >= 100:
                loops.append({"function": name, "start": hex(insns[start][0]),
                              "instructions": i + 1 - start,
                              "ops": dict(ops.most_common())})
    # innermost first: a loop that holds another holds-a-draw loop is not
    # the draw loop
    inner = [lp for lp in loops if not any(
        o is not lp and o["function"] == lp["function"]
        and int(lp["start"], 16) <= int(o["start"], 16)
        and o["instructions"] < lp["instructions"] for o in loops)]
    return inner


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
               / "bin" / "cuobjdump")


# -- one tree (the child) -----------------------------------------------------

def child(tree: Path, label: str, sass: Path | None) -> dict:
    sys.path.insert(0, str(tree))
    import inspect

    import torch

    from ceph_tpu_torch import build
    from ceph_tpu_torch.crush import mapper
    from ceph_tpu_torch.osd.osdmap import build_hierarchical
    from ceph_tpu_torch.osd.pipeline import PoolMapper
    from ceph_tpu_torch.osd.types import PgPool, PoolType

    if not torch.cuda.is_available():
        raise SystemExit("crush_rule_ab: no CUDA device")
    assert Path(build.__file__).resolve().is_relative_to(tree.resolve())
    dev = torch.device("cuda")
    lib = build.build("crush/csrc/crush_rule.cu")
    res: dict = {"tree": label, "nvidia_smi": smi()}
    if hasattr(build, "ptxas_report"):
        res["ptxas"] = build.ptxas_report("crush/csrc/crush_rule.cu")
    if sass is not None:
        text = subprocess.run([cuobjdump(), "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        sass.mkdir(parents=True, exist_ok=True)
        (sass / f"{label}.txt").write_text(text)
        res["draw_loops"] = draw_loops(text)
        res["kernel_sass_sha256"] = kernel_sass_sha256(text)

    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)

    def time_ms(fn, runs):
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

    staged = "stage" in inspect.signature(mapper.crush_rule_cuda).parameters
    for name, (n_pgs, n_osds) in CONFIGS.items():
        n_host = max(1, n_osds // OSD_PER_HOST)
        pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                      pg_num=n_pgs, pgp_num=n_pgs)
        m = build_hierarchical(n_host, OSD_PER_HOST,
                               n_rack=max(1, n_host // 16), pool=pool)
        pm = PoolMapper(m, 0, device=dev)
        ps = torch.arange(n_pgs, device=dev)
        x = mapper.u32_bits(pm.placement_seeds(ps))
        w = mapper.u32_bits(pm.rule_weights())

        def kernel(**kw):
            return mapper.crush_rule_cuda(pm.tables, pm.prog, x, w, **kw)

        rows = kernel()
        torch.cuda.synchronize()
        digest = hashlib.sha256(rows.cpu().numpy().tobytes()).hexdigest()
        out = {"ms": time_ms(kernel, 7), "rows_sha256": digest}
        if staged:
            plan = mapper.launch_plan(torch.cuda.current_device())
            total = pm.tables.records.shape[0]
            out["staged_records"] = mapper.staged_records(pm.tables, plan)
            out["records"] = total
            out["plan"] = vars(plan)
            for key, st in (("ms_stage_none", 0), ("ms_stage_all", total)):
                if (plan.table_bytes + plan.static_smem + 16 * st
                        > plan.smem_optin):
                    continue
                got = kernel(stage=st)
                torch.cuda.synchronize()
                if not torch.equal(got, rows):
                    raise SystemExit(f"{label} {name}: stage {st} rows "
                                     f"differ")
                out[key] = time_ms(lambda st=st: kernel(stage=st), 7)
        entry = pm.map_all if name == "config2" else pm.map_all_device
        out["entry"] = entry.__name__
        out["entry_ms"] = time_ms(entry, 5)
        res[name] = out
        del pm, rows
        torch.cuda.empty_cache()
    return res


# -- the parent ---------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--sass", type=Path, metavar="DIR",
                    help="write each tree's SASS to DIR and count its "
                         "draw loops")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--label", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.trees[0], args.label, args.sass)),
              flush=True)
        return 0
    results = []
    for i, tree in enumerate(args.trees):
        label = f"{i}-{tree.resolve().name}"
        cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
               "--label", label, str(tree)] + (
                   ["--sass", str(args.sass.resolve())] if args.sass else [])
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=1800)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(res), flush=True)
        results.append(res)
    for name in CONFIGS:
        digests = {r[name]["rows_sha256"] for r in results}
        if len(digests) != 1:
            print(f"crush_rule_ab: {name}: the trees' rows differ",
                  file=sys.stderr)
            return 1
    last = {"nvidia_smi": results[0]["nvidia_smi"], "side_by_side": {
        r["tree"]: {name: {k: v for k, v in r[name].items()
                           if k.startswith("ms") or k == "entry_ms"}
                    for name in CONFIGS} for r in results}}
    if args.sass:
        last["kernel_sass_equal"] = len(
            {r["kernel_sass_sha256"] for r in results}) == 1
    print(json.dumps(last))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
