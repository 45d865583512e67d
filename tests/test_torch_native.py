"""The port's native host engines (`ceph_tpu_torch.native`) held against
`ceph_tpu.native` and the port's oracles: the cases of
`tests/test_native.py`, on the port.

Every comparison is exact: the port's `NativeMapper` rows equal the JAX
package's `NativeMapper` and the port's `crush/mapper_ref.py`;
`backend=native` bytes equal the JAX package's; native CRC-32C equals
the Python loop; `crushtool --test --backend native` prints the JAX
CLI's stdout.  A failed g++ build raises.
"""

import ctypes
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu.crush.types import BucketAlg, ChooseArgs, Tunables  # noqa: E402
from ceph_tpu.ec import create_erasure_code as jax_create  # noqa: E402
from ceph_tpu.native.mapper import NativeMapper as JaxNativeMapper  # noqa: E402
from ceph_tpu.utils.crc32c import crc32c as jax_crc32c  # noqa: E402
from ceph_tpu_torch import native  # noqa: E402
from ceph_tpu_torch.crush import mapper_ref  # noqa: E402
from ceph_tpu_torch.ec import create_erasure_code, matrices  # noqa: E402
from ceph_tpu_torch.ec.gf import GF_MUL_TABLE, gf_matvec_data  # noqa: E402
from ceph_tpu_torch.ec.rs import NativeEngine, NumpyEngine  # noqa: E402
from ceph_tpu_torch.native.mapper import NativeMapper  # noqa: E402
from ceph_tpu_torch.osd.carry import crush_from_reference  # noqa: E402
from ceph_tpu_torch.utils import crc32c as port_crc  # noqa: E402
from test_torch_cli import CASES, run_case  # noqa: E402
from test_torch_crush_mapper import crush_dict  # noqa: E402
from util_maps import build_flat, build_tree  # noqa: E402

NONE = 0x7FFFFFFF
REF_X = 96  # seeds also held to the port's mapper_ref (about 10 ms each)


def _both(m, ruleno: int, n_x: int, nr: int, weights, ca_key=None):
    """(port rows, JAX rows) of the same map, seeds 0..n_x-1."""
    pm = crush_from_reference(crush_dict(m))
    xs = np.arange(n_x, dtype=np.uint32)
    port_ca = pm.choose_args[ca_key] if ca_key is not None else None
    jax_ca = m.choose_args[ca_key] if ca_key is not None else None
    got = NativeMapper(pm, choose_args=port_ca).map_batch(
        ruleno, xs, nr, weights)
    want = JaxNativeMapper(m, choose_args=jax_ca).map_batch(
        ruleno, xs, nr, weights)
    return pm, got, want


def _held_to_ref(pm, ruleno, rows, nr, weights, firstn=True, ca=None):
    for x in range(min(REF_X, len(rows))):
        want = mapper_ref.do_rule(pm, ruleno, x, nr, weights,
                                  choose_args=ca)
        got = ([o for o in rows[x] if o != NONE] if firstn
               else list(rows[x][:len(want)]))
        assert got == want, x


# -- the CRUSH mapper -----------------------------------------------------------

@pytest.mark.parametrize("alg", [BucketAlg.STRAW2, BucketAlg.STRAW,
                                 BucketAlg.LIST, BucketAlg.TREE,
                                 BucketAlg.UNIFORM])
def test_flat_map_rows(alg):
    m, root = build_flat(16, alg=alg)
    ruleno = m.make_replicated_rule(root, 0)
    weights = [0x10000] * 16
    pm, got, want = _both(m, ruleno, 400, 3, weights)
    assert np.array_equal(got, want)
    _held_to_ref(pm, ruleno, got, 3, weights)


@pytest.mark.parametrize("mode", ["firstn", "indep"])
def test_hierarchy_rows(mode, rng):
    m, root = build_tree(rng, n_host=8, osd_per_host=4)
    ruleno = (m.make_replicated_rule(root, 1) if mode == "firstn"
              else m.make_erasure_rule(root, 1))
    weights = [0x10000] * 32
    weights[3] = 0  # out
    weights[17] = 0x8000  # down-weighted
    pm, got, want = _both(m, ruleno, 600, 4, weights)
    assert np.array_equal(got, want)
    _held_to_ref(pm, ruleno, got, 4, weights, firstn=mode == "firstn")


def test_legacy_tunables(rng):
    m, root = build_tree(rng, n_host=4, osd_per_host=4,
                         tunables=Tunables.profile("bobtail"))
    ruleno = m.make_replicated_rule(root, 1)
    weights = [0x10000] * 16
    pm, got, want = _both(m, ruleno, 200, 3, weights)
    assert np.array_equal(got, want)
    _held_to_ref(pm, ruleno, got, 3, weights)


def test_choose_args(rng):
    m, root = build_flat(8)
    ruleno = m.make_replicated_rule(root, 0)
    ca = ChooseArgs()
    ca.weight_sets[root] = [[0x20000] + [0x10000] * 7]  # osd 0 doubled
    m.choose_args[-1] = ca
    weights = [0x10000] * 8
    pm, got, want = _both(m, ruleno, 300, 2, weights, ca_key=-1)
    assert np.array_equal(got, want)
    plain = NativeMapper(pm).map_batch(ruleno, np.arange(300), 2, weights)
    assert not np.array_equal(got, plain)  # the weight set was applied
    _held_to_ref(pm, ruleno, got, 2, weights, ca=pm.choose_args[-1])


def test_choose_args_rows_must_match_the_bucket():
    m, root = build_flat(8)
    m.make_replicated_rule(root, 0)
    pm = crush_from_reference(crush_dict(m))
    ca = ChooseArgs()
    ca.weight_sets[root] = [[0x10000] * 7]
    with pytest.raises(ValueError, match="exactly 8 entries"):
        NativeMapper(pm, choose_args=ca)


def test_multithreaded_equals_single(rng):
    m, root = build_tree(rng, n_host=8, osd_per_host=4)
    ruleno = m.make_replicated_rule(root, 1)
    pm = crush_from_reference(crush_dict(m))
    nm = NativeMapper(pm)
    xs = np.arange(5000, dtype=np.uint32)
    one = nm.map_batch(ruleno, xs, 3, [0x10000] * 32, n_threads=1)
    assert np.array_equal(one, nm.map_batch(ruleno, xs, 3, [0x10000] * 32,
                                            n_threads=8))
    assert np.array_equal(one, nm.map_batch(ruleno, xs, 3, [0x10000] * 32))


def test_map_batch_checks_its_rule():
    m, root = build_flat(4)
    m.make_replicated_rule(root, 0)
    nm = NativeMapper(crush_from_reference(crush_dict(m)))
    with pytest.raises(ValueError, match="rule 5"):
        nm.map_batch(5, np.arange(4), 2, [0x10000] * 4)
    with pytest.raises(ValueError, match="result_max"):
        nm.map_batch(0, np.arange(4), 0, [0x10000] * 4)


# -- crushtool --backend native ------------------------------------------------

TEST_CASES = sorted(
    name for name, steps in CASES.items()
    if any(s[0] == "crushtool" and "--test" in s[1] and "--simulate"
           not in s[1] for s in steps))


def _native_steps(steps):
    return [(s[0], s[1] + ["--backend", "native"], s[2])
            if s[0] == "crushtool" and "--test" in s[1] else s
            for s in steps]


@pytest.mark.parametrize("name", TEST_CASES)
def test_crushtool_native_equals_jax_cli(name, tmp_path, monkeypatch):
    """The cli_corpus maps' `--test` steps with `--backend native` (the
    `--show-choose-tries` step goes through the host oracle): stdout,
    stderr and exit codes equal the JAX CLI's."""
    steps = _native_steps(CASES[name])
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    pd.mkdir()
    want = run_case("jax", steps, jd, monkeypatch)
    got = run_case("port", steps, pd, monkeypatch)
    assert got == want
    assert any(out for _, out, _ in got)


# -- the GF engine ----------------------------------------------------------------

def test_matvec_equals_numpy(rng):
    M = matrices.vandermonde_rs(8, 4)
    data = rng.integers(0, 256, (8, 100_003)).astype(np.uint8)
    assert np.array_equal(NativeEngine().matmul(M, data),
                          NumpyEngine().matmul(M, data))
    R = rng.integers(0, 256, (5, 3)).astype(np.uint8)
    d = rng.integers(0, 256, (3, 17)).astype(np.uint8)
    assert np.array_equal(NativeEngine().matmul(R, d), gf_matvec_data(R, d))


def test_mul_region(rng):
    lib = native.load_gf()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    src = rng.integers(0, 256, 1000).astype(np.uint8)
    dst = np.zeros(1000, np.uint8)
    for c in (0, 1, 2, 0x53, 255):
        lib.gf_native_mul_region(c, src.ctypes.data_as(u8p),
                                 dst.ctypes.data_as(u8p), 1000, 0)
        assert np.array_equal(dst, GF_MUL_TABLE[c, src]), c
        acc = dst.copy()
        lib.gf_native_mul_region(c, src.ctypes.data_as(u8p),
                                 acc.ctypes.data_as(u8p), 1000, 1)
        assert not acc.any(), c  # dst ^= c*src over dst == c*src
    assert lib.gf_native_simd_level() in (0, 1, 2)


def test_native_engine_refuses_a_tensor_off_the_host():
    import torch

    eng = NativeEngine()
    t = torch.zeros((2, 8), dtype=torch.uint8)
    M = matrices.vandermonde_rs(2, 1)
    assert isinstance(eng.matmul(M, t), torch.Tensor)
    with pytest.raises(ValueError, match="runs on the host"):
        eng.matmul(M, torch.empty((2, 8), dtype=torch.uint8, device="meta"))


@pytest.mark.parametrize("profile", [
    {"plugin": "jerasure", "k": "5", "m": "3"},
    {"plugin": "isa", "k": "8", "m": "4", "technique": "cauchy"},
    {"plugin": "clay", "k": "4", "m": "2", "d": "5"},
    {"plugin": "shec", "k": "4", "m": "3", "c": "2"},
], ids=lambda p: p["plugin"])
def test_backend_native_bytes_equal_jax(profile, rng):
    prof = dict(profile, backend="native")
    code = create_erasure_code(dict(prof), device="cpu")
    jcode = jax_create(dict(prof))
    assert isinstance(code.engine, NativeEngine)
    n = code.get_chunk_count()
    payload = rng.integers(0, 256, 4000).astype(np.uint8).tobytes()
    want = jcode.encode(set(range(n)), payload)
    got = code.encode(set(range(n)), payload)
    assert sorted(got) == sorted(want)
    for i in want:
        assert np.array_equal(np.asarray(got[i]), np.asarray(want[i])), i
    lost = [0, n - 1]
    have = {i: c for i, c in want.items() if i not in lost}
    dec = code.decode(set(range(n)), dict(have))
    jdec = jcode.decode(set(range(n)), dict(have))
    for i in lost:
        assert np.array_equal(np.asarray(dec[i]), np.asarray(jdec[i])), i
    assert code.decode_concat(dict(have))[:4000] == payload


# -- CRC-32C ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 4096 + 3, 1 << 20])
def test_crc32c_native_equals_python_and_jax(n, rng):
    b = rng.integers(0, 256, n).astype(np.uint8).tobytes()
    for seed in (0xFFFFFFFF, 0, 0x12345678):
        want = port_crc._crc_bytes(b, seed) & 0xFFFFFFFF
        assert port_crc.crc32c(b, seed) == want == jax_crc32c(b, seed)
    if n >= 256:
        lib = native.load_crc()
        assert int(lib.ceph_tpu_crc32c(0xFFFFFFFF, b, n)) == \
            port_crc.crc32c_fast(b)
        # streaming across the native and the Python paths
        cut = n // 3
        assert port_crc.crc32c(b[cut:], port_crc.crc32c(b[:cut])) == \
            port_crc.crc32c(b)


# -- the build ----------------------------------------------------------------------

def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails (`false`) raises with the command, and no
    caller falls back: not the GF engine, not a CRC of 256 bytes, not
    the mapper."""
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="false .*failed"):
        native.load_gf()
    with pytest.raises(RuntimeError, match="failed"):
        create_erasure_code({"plugin": "jerasure", "backend": "native"},
                            device="cpu")
    with pytest.raises(RuntimeError, match="failed"):
        port_crc.crc32c(bytes(256))
    assert port_crc.crc32c(bytes(255)) == jax_crc32c(bytes(255))
    m, root = build_flat(4)
    m.make_replicated_rule(root, 0)
    with pytest.raises(RuntimeError, match="failed"):
        NativeMapper(crush_from_reference(crush_dict(m)))
    assert not list(tmp_path.iterdir())  # no torn or partial library


def test_library_named_by_source_flags_and_compiler(monkeypatch):
    paths = {name: native.library_path(name) for name in native.LIBRARIES}
    assert len(set(paths.values())) == 3
    assert all(p.parent == native.BUILD_DIR for p in paths.values())
    monkeypatch.setenv("CXX", "clang++")
    assert native.library_path("gf") != paths["gf"]


def test_native_arch_library_named_by_host_cpu(monkeypatch):
    """gf (built with -march=native) is named by what that flag selects
    on this host, so a build directory moved to another CPU builds anew;
    crc and crush are not."""
    paths = {name: native.library_path(name) for name in native.LIBRARIES}
    listing = native.native_target(native.compiler())
    assert "-march=" in listing
    monkeypatch.setitem(native._TARGETS, native.compiler(),
                        listing.replace("-march=", "-march=other"))
    assert native.library_path("gf") != paths["gf"]
    assert native.library_path("crc") == paths["crc"]
    assert native.library_path("crush") == paths["crush"]


def test_first_load_from_threads_builds_once(monkeypatch, tmp_path):
    """Eight threads load the CRC library at once into an empty build
    directory: one build, one library, every thread the same handle."""
    import threading

    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_SECONDS", {})
    got, errors = [], []

    def load():
        try:
            got.append(native.load_crc())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=load) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(got) == 8
    assert all(lib is got[0] for lib in got)
    assert [p.name for p in tmp_path.iterdir()] == [
        native.library_path("crc").name]
    assert list(native.BUILD_SECONDS) == ["crc"]
