"""ceph_erasure_code_benchmark equivalent, on the port's engines.

Port of `ceph_tpu/cli/ec_benchmark.py`, flag-compatible with the
reference benchmark CLI (reference
src/test/erasure-code/ceph_erasure_code_benchmark.cc):

    python -m ceph_tpu_torch.cli.ec_benchmark --plugin jax \
        --workload encode|decode --size TOTAL_BYTES --iterations N \
        --parameter k=8 --parameter m=4 [--parameter technique=...] \
        [--erasures E | --erasures-generation exhaustive] \
        [--device cuda|cpu]

Plugins: jerasure, isa, jax, example, and the layered codes with their
parameters: clay (`-P d=`), shec (`-P c=`), lrc (`-P l=`, or `-P
mapping=` with `-P layers=`).

Prints "<seconds>\t<KiB processed>" like the reference.  `--device`
(default cuda) is where the device engine runs, every plugin's engine
unless `-P backend=numpy` or `-P backend=native` (the C++ SIMD engine)
asks for the host; `-P strategy=...` picks the device engine's strategy
(ec.torch_backend.STRATEGIES).  With the device engine a
layered code's object is put on that device once, before the timed loop;
the other plugins get the host bytes on every call, as the JAX CLI gives
them (each call uploads them and reads the result back).
"""

from __future__ import annotations

import itertools
import sys
import time

import numpy as np
import torch

from ceph_tpu_torch.ec import create_erasure_code
from ceph_tpu_torch.ec.clay import ClayCode
from ceph_tpu_torch.ec.lrc import LrcCode
from ceph_tpu_torch.ec.shec import ShecCode
from ceph_tpu_torch.ec.torch_backend import TorchEngine


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


def _engines(code) -> list:
    """The engines a code computes with (lrc: its layers')."""
    if hasattr(code, "layers"):
        return [e for layer in code.layers for e in _engines(layer.code)]
    return [getattr(code, "engine", None)]


def object_input(code, data: np.ndarray):
    """The object as the timed loop hands it to the code.  When every
    engine of a layered code (clay, shec, lrc) is the device engine, it
    takes a tensor on that engine's device, put there once.  The other
    plugins take the host bytes on every call, as the JAX CLI passes
    them."""
    engines = _engines(code)
    if isinstance(code, (ClayCode, ShecCode, LrcCode)) and all(
            isinstance(e, TorchEngine) for e in engines):
        return torch.from_numpy(data).to(engines[0].device)
    return data


def _sync(data) -> None:
    """Wait for the card, so the clock reads the work and not its
    enqueue."""
    if isinstance(data, torch.Tensor) and data.device.type == "cuda":
        torch.cuda.synchronize(data.device)


def run(opts: dict, out=None) -> float:
    out = out or sys.stdout
    profile = dict(opts["parameters"])
    profile["plugin"] = opts["plugin"]
    code = create_erasure_code(profile, device=opts["device"])
    k, m = code.k, code.m
    n = k + m
    size = opts["size"]
    data, patterns = workload_inputs(opts, n)
    data = object_input(code, data)
    want_all = set(range(n))

    if opts["workload"] == "encode":
        t0 = time.perf_counter()
        for _ in range(opts["iterations"]):
            code.encode(want_all, data)
        _sync(data)
        dt = time.perf_counter() - t0
        kib = size * opts["iterations"] / 1024
    else:
        encoded = code.encode(want_all, data)
        _sync(data)
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
        _sync(data)
        dt = time.perf_counter() - t0

    print(f"{dt:g}\t{kib:.0f}", file=out)
    return dt


def main(argv: list[str] | None = None) -> int:
    opts = _parse(list(sys.argv[1:] if argv is None else argv))
    run(opts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
