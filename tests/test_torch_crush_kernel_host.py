"""The rule kernel's per-lane body (`crush/csrc/crush_rule.cuh`), built
for the host with g++ (`__host__`/`__device__` defined empty), held
element-exact against `crush_rule_plain` and the JAX package's rows
(`compile_batched` and `mapper_ref`, as stored in
tests/data/placement_corpus.json) on the mapper cases of
tests/test_torch_crush_mapper.py.

nvcc builds the same file into the kernel on the card; here a small shim
loops the body over the seeds, with the arguments the kernel's C entry
takes.  Skips, with the reason, where g++ is missing.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu_torch.core.lntable import LL_TBL, RH_LH_TBL  # noqa: E402
from ceph_tpu_torch.crush import mapper, soa  # noqa: E402
from test_torch_crush_mapper import CASES, port_case, stored_rows  # noqa: E402

CSRC = ROOT / "ceph_tpu_torch" / "crush" / "csrc"

SHIM = r"""
#include "crush_rule.cuh"

extern "C" void crush_rule_host(
    const int32_t* btype, const int32_t* size, const int32_t* items,
    const uint32_t* pos_weights, const int32_t* arg_ids,
    const uint32_t* weight, const int64_t* rh_lh, const int64_t* ll,
    const int32_t* steps, int n_buckets, int max_size, int positions,
    int max_devices, int max_depth, int weight_len, int n_steps,
    int result_max, int choose_total_tries, int chooseleaf_descend_once,
    int chooseleaf_vary_r, int chooseleaf_stable, const uint32_t* xs,
    long long n, int32_t* out) {
    crush_rule::Map m{btype, size, items, pos_weights, arg_ids, weight,
                      rh_lh, ll, n_buckets, max_size, positions,
                      max_devices, max_depth, weight_len};
    crush_rule::Rule rule{steps, n_steps, result_max, choose_total_tries,
                          chooseleaf_descend_once, chooseleaf_vary_r,
                          chooseleaf_stable};
    for (long long i = 0; i < n; i++) {
        int32_t res[crush_rule::RMAX_CAP];
        const int got = crush_rule::do_rule(m, rule, xs[i], res);
        for (int j = 0; j < result_max; j++)
            out[i * result_max + j] = j < got ? res[j] : crush_rule::ITEM_NONE;
    }
}
"""


@pytest.fixture(scope="module")
def body(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel body cannot be built for "
                    "the host")
    out = tmp_path_factory.mktemp("crush_rule_host")
    shim = out / "shim.cpp"
    shim.write_text(SHIM)
    lib = out / "libcrush_rule_host.so"
    subprocess.run(
        [gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-D__host__=",
         "-D__device__=", f"-I{CSRC}", "-o", str(lib), str(shim)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.crush_rule_host.argtypes = (
        [p] * 9 + [i] * 12 + [p, ctypes.c_longlong, p])
    so.crush_rule_host.restype = None
    return so


def run_body(so, A, prog, xs: np.ndarray, weight: np.ndarray) -> np.ndarray:
    """The host-built body over seeds xs (u32) with reweights (u32)."""
    T = soa.to_device(A, "cpu")
    xs = np.ascontiguousarray(xs, np.uint32)
    weight = np.ascontiguousarray(weight if len(weight) else [0], np.uint32)
    out = np.empty((len(xs), prog.result_max), np.int32)
    keep = [T.btype, T.size, T.items, T.pos_weights, T.arg_ids]
    so.crush_rule_host(
        *[t.data_ptr() for t in keep], weight.ctypes.data,
        RH_LH_TBL.ctypes.data, LL_TBL.ctypes.data,
        prog.steps.ctypes.data, T.n_buckets, T.max_size, T.positions,
        T.max_devices, T.max_depth, len(weight), len(prog.steps),
        prog.result_max, prog.choose_total_tries,
        prog.chooseleaf_descend_once, prog.chooseleaf_vary_r,
        prog.chooseleaf_stable, xs.ctypes.data, len(xs), out.ctypes.data,
    )
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_body_equals_plain_and_jax_package(body, name):
    A, prog, xs, w = port_case(name)
    got = run_body(body, A, prog, xs.numpy().astype(np.uint32),
                   w.numpy().astype(np.uint32))
    plain, _ = mapper.crush_rule_plain(soa.to_device(A, "cpu"), prog, xs, w)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, stored_rows(name))


def test_body_on_many_seeds(body):
    """More seeds than the cases carry, on a map whose lanes retry
    (weights below 1.0, devices out): body == plain version."""
    A, prog, _, w = port_case("chooseleaf_firstn")
    rng = np.random.default_rng(11)
    xs = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    got = run_body(body, A, prog, xs, w.numpy().astype(np.uint32))
    plain, _ = mapper.crush_rule_plain(
        soa.to_device(A, "cpu"), prog, torch.from_numpy(xs.astype(np.int64)),
        w)
    np.testing.assert_array_equal(got, plain.numpy())
