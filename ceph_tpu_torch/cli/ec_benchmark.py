"""ceph_erasure_code_benchmark equivalent, on the port's engines.

Port of `ceph_tpu/cli/ec_benchmark.py`, flag-compatible with the
reference benchmark CLI (reference
src/test/erasure-code/ceph_erasure_code_benchmark.cc):

    python -m ceph_tpu_torch.cli.ec_benchmark --plugin jax \
        --workload encode|decode --size TOTAL_BYTES --iterations N \
        --parameter k=8 --parameter m=4 [--parameter technique=...] \
        [--erasures E | --erasures-generation exhaustive] \
        [--device cuda|cpu]

Prints "<seconds>\t<KiB processed>" like the reference.  `--device`
(default cuda) is where the device engine runs; plugin jax uses it by
default, jerasure/isa with `-P backend=torch`.
"""

from __future__ import annotations

import itertools
import sys
import time

import numpy as np

from ceph_tpu_torch.ec import create_erasure_code


def _parse(argv: list[str]) -> dict:
    opts = {
        "plugin": "jerasure",
        "workload": "encode",
        "size": 1 << 20,
        "iterations": 1,
        "erasures": 1,
        "erasures_generation": "random",
        "erased": [],
        "parameters": {},
        "verbose": False,
        "device": None,
    }
    i = 0
    while i < len(argv):
        a = argv[i]

        def nxt() -> str:
            nonlocal i
            i += 1
            if i >= len(argv):
                print(f"missing argument for {a}", file=sys.stderr)
                raise SystemExit(1)
            return argv[i]

        if a in ("-p", "--plugin"):
            opts["plugin"] = nxt()
        elif a in ("-w", "--workload"):
            opts["workload"] = nxt()
        elif a in ("-s", "--size"):
            opts["size"] = int(nxt())
        elif a in ("-i", "--iterations"):
            opts["iterations"] = int(nxt())
        elif a in ("-e", "--erasures"):
            opts["erasures"] = int(nxt())
        elif a in ("-N", "--erased"):
            opts["erased"].append(int(nxt()))
        elif a in ("-E", "--erasures-generation"):
            opts["erasures_generation"] = nxt()
        elif a in ("-P", "--parameter"):
            k, _, v = nxt().partition("=")
            opts["parameters"][k] = v
        elif a in ("-v", "--verbose"):
            opts["verbose"] = True
        elif a == "--device":
            opts["device"] = nxt()
        else:
            print(f"unrecognized argument {a!r}", file=sys.stderr)
            raise SystemExit(1)
        i += 1
    return opts


def workload_inputs(opts: dict, n: int) -> tuple[np.ndarray, list]:
    """The object bytes and, for the decode workload, the erasure
    patterns: both drawn from one fixed seed, so a run is repeatable."""
    rng = np.random.default_rng(0xEC)
    data = rng.integers(0, 256, opts["size"], dtype=np.int64)
    data = data.astype(np.uint8)
    if opts["workload"] == "encode":
        return data, []
    if opts["erased"]:
        patterns = [tuple(opts["erased"])]
    elif opts["erasures_generation"] == "exhaustive":
        patterns = list(itertools.combinations(range(n), opts["erasures"]))
    else:
        patterns = [
            tuple(rng.choice(n, opts["erasures"], replace=False).tolist())
            for _ in range(opts["iterations"])
        ]
    return data, patterns


def run(opts: dict, out=None) -> float:
    out = out or sys.stdout
    profile = dict(opts["parameters"])
    profile["plugin"] = opts["plugin"]
    code = create_erasure_code(profile, device=opts["device"])
    k, m = code.k, code.m
    n = k + m
    size = opts["size"]
    data, patterns = workload_inputs(opts, n)
    want_all = set(range(n))

    if opts["workload"] == "encode":
        t0 = time.perf_counter()
        for _ in range(opts["iterations"]):
            code.encode(want_all, data)
        dt = time.perf_counter() - t0
        kib = size * opts["iterations"] / 1024
    else:
        encoded = code.encode(want_all, data)
        t0 = time.perf_counter()
        kib = 0.0
        for it in range(opts["iterations"]):
            pat = patterns[it % len(patterns)]
            have = {
                i: c for i, c in encoded.items() if i not in pat
            }
            got = code.decode(set(range(k)), dict(have))
            if not all(i in got for i in range(k)):
                raise RuntimeError(f"decode of {pat} lost data chunks")
            kib += size / 1024
        dt = time.perf_counter() - t0

    print(f"{dt:g}\t{kib:.0f}", file=out)
    return dt


def main(argv: list[str] | None = None) -> int:
    opts = _parse(list(sys.argv[1:] if argv is None else argv))
    run(opts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
