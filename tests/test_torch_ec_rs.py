"""The port's erasure-coding slice as a whole (`ceph_tpu_torch.ec` and
`ceph_tpu_torch.cli.ec_benchmark`) held against `ceph_tpu`, the frozen
corpus, and the port's own rules.

Byte-exact throughout.  The JAX side takes the Pallas kernel (interpret
mode) wherever it takes a device engine; the port runs on the CPU
(`device="cpu"`), where its device engine computes the kernel's plain
PyTorch version.
"""

import ast
import hashlib
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu.ec import create_erasure_code as jax_create  # noqa: E402
from ceph_tpu_torch.cli import ec_benchmark  # noqa: E402
from ceph_tpu_torch.ec import ErasureCodeProfileError  # noqa: E402
from ceph_tpu_torch.ec import create_erasure_code  # noqa: E402
from ceph_tpu_torch.ec.carry import code_from_reference  # noqa: E402
from ceph_tpu_torch.ec.rs import NumpyEngine  # noqa: E402
from ceph_tpu_torch.ec.torch_backend import TorchEngine  # noqa: E402
from tools import ec_corpus  # noqa: E402

# (plugin, technique or None, k, m, backend or None); backend None is the
# plugin's default engine (jax: the device engine; jerasure/isa: numpy)
PROFILES = [
    ("jax", None, 8, 4, None),
    ("jax", "cauchy_good", 4, 2, None),
    ("jerasure", "reed_sol_van", 8, 4, None),
    ("jerasure", "reed_sol_van", 8, 4, "jax"),
    ("jerasure", "reed_sol_r6_op", 6, 2, "jax"),
    ("jerasure", "cauchy_orig", 7, 3, "jax"),
    ("jerasure", "cauchy_good", 4, 2, None),
    ("isa", "reed_sol_van", 8, 4, "jax"),
    ("isa", "cauchy", 4, 2, None),
]


def _profile_id(p):
    plugin, tech, k, m, backend = p
    return f"{plugin}-{tech or 'default'}-k{k}m{m}-{backend or 'default'}"


def _profiles(p):
    """(JAX package profile, port profile) for one case."""
    plugin, tech, k, m, backend = p
    prof = {"plugin": plugin, "k": str(k), "m": str(m)}
    if tech:
        prof["technique"] = tech
    if backend:
        prof["backend"] = backend
    jprof = dict(prof)
    if plugin == "jax" or backend == "jax":
        jprof["strategy"] = "pallas"
    return jprof, prof


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for i in want:
        assert np.array_equal(_np(got[i]), _np(want[i])), i


# -- the slice against ceph_tpu -----------------------------------------------

@pytest.mark.parametrize("p", PROFILES, ids=_profile_id)
def test_encode_decode_equal(p):
    jprof, prof = _profiles(p)
    jcode = jax_create(jprof)
    code = create_erasure_code(prof, device="cpu")
    if p[4] or p[0] == "jax":
        assert isinstance(code.engine, TorchEngine)
    else:
        assert isinstance(code.engine, NumpyEngine)
    assert np.array_equal(code.C, jcode.C)
    n = code.get_chunk_count()
    payload = np.random.default_rng(n).integers(0, 256, 5000, np.uint8)
    want = jcode.encode(set(range(n)), payload.tobytes())
    got = code.encode(set(range(n)), payload.tobytes())
    _assert_same(got, want)
    for erased in ec_corpus.decode_patterns(n, code.m):
        have = {i: c for i, c in want.items() if i not in erased}
        _assert_same(
            code.decode(set(range(n)), dict(have)),
            jcode.decode(set(range(n)), dict(have)),
        )
    data = b"".join(got[i].tobytes() for i in range(code.k))
    have = {i: c for i, c in got.items() if i >= code.m}
    assert code.decode_concat(have) == data


@pytest.mark.parametrize("p", PROFILES[:2] + PROFILES[4:7], ids=_profile_id)
def test_batch_paths_equal(p):
    jprof, prof = _profiles(p)
    jcode = jax_create(jprof)
    code = create_erasure_code(prof, device="cpu")
    k, n = code.k, code.get_chunk_count()
    rng = np.random.default_rng(7 * n)
    stripes = rng.integers(0, 256, (3, k, 1000)).astype(np.uint8)
    want = np.asarray(jcode.encode_batch(stripes))
    got = code.encode_batch(stripes)
    assert isinstance(got, np.ndarray) and np.array_equal(got, want)
    got_t = code.encode_batch(torch.from_numpy(stripes))
    assert isinstance(got_t, torch.Tensor)
    assert np.array_equal(got_t.numpy(), want)
    for erased in ([0], list(range(n - code.m, n)), [1, n - 1]):
        have = {i: want[:, i] for i in range(n) if i not in erased}
        _assert_same(
            code.decode_batch(set(range(n)), dict(have), 1000),
            jcode.decode_batch(set(range(n)), dict(have), 1000),
        )


def test_tensors_stay_tensors():
    prof = {"plugin": "jax", "k": "4", "m": "2"}
    code = create_erasure_code(prof, device="cpu")
    jcode = jax_create(dict(prof, strategy="pallas"))
    data = np.random.default_rng(5).integers(0, 256, (4, 700), np.uint8)
    enc = code.encode_chunks(torch.from_numpy(data))
    assert isinstance(enc, torch.Tensor) and enc.shape == (6, 700)
    assert np.array_equal(enc.numpy(), np.asarray(jcode.encode_chunks(data)))
    parity = code.encode_parity(torch.from_numpy(data))
    assert isinstance(parity, torch.Tensor)
    assert np.array_equal(parity.numpy(), enc.numpy()[4:])
    have = {i: enc[i] for i in (1, 2, 4, 5)}
    dec = code.decode({0, 3}, have)
    assert all(isinstance(v, torch.Tensor) for v in dec.values())
    assert np.array_equal(dec[0].numpy(), data[0])
    assert np.array_equal(dec[3].numpy(), data[3])
    # an object given as a tensor is split on its own device
    obj = torch.from_numpy(data.reshape(-1)[:2000].copy())
    chunks = code.encode_prepare(obj)
    assert isinstance(chunks, torch.Tensor)
    want = jcode.encode_prepare(obj.numpy().tobytes())
    assert np.array_equal(chunks.numpy(), want)


def test_numpy_engine_keeps_to_the_host():
    """The host engine computes CPU tensors and refuses a tensor on any
    other device (a `meta` tensor stands in for one on the card)."""
    code = create_erasure_code({"plugin": "jerasure", "k": "4", "m": "2"},
                               device="cpu")
    assert isinstance(code.engine, NumpyEngine)
    data = np.random.default_rng(6).integers(0, 256, (4, 900), np.uint8)
    enc = code.encode_chunks(torch.from_numpy(data))
    assert isinstance(enc, torch.Tensor) and enc.device.type == "cpu"
    assert np.array_equal(enc.numpy(), code.encode_chunks(data))
    elsewhere = torch.empty((4, 900), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="runs on the host"):
        code.encode_chunks(elsewhere)
    with pytest.raises(ValueError, match="runs on the host"):
        code.encode_parity(elsewhere)
    have = {i: elsewhere[0] for i in (1, 2, 4, 5)}
    with pytest.raises(ValueError, match="runs on the host"):
        code.decode_chunks({0}, have, 900)


@pytest.mark.parametrize("want,available", [
    ({0, 1}, {0, 1, 2, 3, 4, 5}),
    ({0, 4}, {1, 2, 3, 5}),
    ({5}, {0, 1, 3, 4}),
    ({0}, {1, 2, 3}),
])
def test_minimum_to_decode_equal(want, available):
    prof = {"plugin": "jax", "k": "4", "m": "2"}
    code = create_erasure_code(prof, device="cpu")
    jcode = jax_create(prof)
    if len(available) < code.k and not want <= available:
        with pytest.raises(ValueError):
            code.minimum_to_decode(want, available)
        with pytest.raises(ValueError):
            jcode.minimum_to_decode(want, available)
        return
    assert code.minimum_to_decode(want, available) == \
        jcode.minimum_to_decode(want, available)


def test_example_plugin_equal():
    prof = {"plugin": "example", "k": "3", "m": "1"}
    code = create_erasure_code(prof, device="cpu")
    jcode = jax_create(prof)
    payload = bytes(range(256)) * 5
    want = jcode.encode({0, 1, 2, 3}, payload)
    _assert_same(code.encode({0, 1, 2, 3}, payload), want)
    have = {i: want[i] for i in (0, 2, 3)}
    _assert_same(code.decode({1}, have), jcode.decode({1}, have))


# -- frozen corpus ------------------------------------------------------------

RS_ENTRIES = ("rs_k8m4_reed_sol_van", "rs_k6m2_reed_sol_r6_op",
              "rs_k4m2_cauchy_good", "isa_k8m4_reed_sol_van")


def _corpus_entry(name):
    entries = json.loads(ec_corpus.DEFAULT_CORPUS.read_text())["entries"]
    return next(e for e in entries if e["name"] == name)


def _digest(rows):
    h = hashlib.sha256()
    for row in rows:
        h.update(_np(row).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("name", RS_ENTRIES)
def test_corpus_digests(name, backend):
    entry = _corpus_entry(name)
    code = create_erasure_code(
        dict(entry["profile"], backend=backend), device="cpu"
    )
    L = entry["chunk_bytes"]
    data = ec_corpus._data_for(name, code.k, L)
    if backend == "torch":
        data = torch.from_numpy(data)
    enc = code.encode_chunks(data)
    assert _digest(enc) == entry["digest"]
    n = entry["n_chunks"]
    for case in entry["decode"]:
        erased = case["erased"]
        avail = {i: enc[i] for i in range(n) if i not in erased}
        dec = code.decode_chunks(set(erased), avail, L)
        assert _digest(dec[i] for i in erased) == case["digest"], erased


# -- carried state ------------------------------------------------------------

@pytest.mark.parametrize("p", [PROFILES[0], PROFILES[4], PROFILES[8]],
                         ids=_profile_id)
def test_code_from_reference(p):
    jprof, prof = _profiles(p)
    jcode = jax_create(jprof)
    code = code_from_reference(prof, jcode.C, device="cpu")
    assert np.array_equal(code.C, jcode.C)
    data = np.random.default_rng(9).integers(0, 256, (code.k, 4096), np.uint8)
    assert np.array_equal(
        _np(code.encode_chunks(data)), np.asarray(jcode.encode_chunks(data))
    )


def test_code_from_reference_checks_matrix():
    prof = {"plugin": "jax", "k": "4", "m": "2"}
    C = jax_create(prof).C
    with pytest.raises(TypeError):
        code_from_reference(prof, C.astype(np.int32), device="cpu")
    with pytest.raises(TypeError):
        code_from_reference(prof, torch.from_numpy(C), device="cpu")
    with pytest.raises(ValueError):
        code_from_reference(prof, C[:1], device="cpu")
    with pytest.raises(ErasureCodeProfileError):
        code_from_reference({"plugin": "example", "k": "4", "m": "1"},
                            C[:1], device="cpu")


# -- the CLI ------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["-w", "encode"], ["-w", "decode", "-e", "2"],
    ["-w", "decode", "-N", "0", "-N", "5"],
])
def test_cli_runs_on_cpu(extra):
    argv = ["--plugin", "jax", "-P", "k=8", "-P", "m=4", "--size", "65536",
            "--iterations", "2", "--device", "cpu", *extra]
    out = io.StringIO()
    dt = ec_benchmark.run(ec_benchmark._parse(argv), out=out)
    seconds, kib = out.getvalue().strip().split("\t")
    assert float(seconds) == pytest.approx(dt, rel=1e-3) and dt > 0
    assert kib == "128"


def test_cli_main_subprocess():
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.cli.ec_benchmark",
         "--plugin", "jax", "-P", "k=4", "-P", "m=2", "--size", "10000",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.strip().split("\t")) == 2


# -- the port's rules ---------------------------------------------------------

def _port_sources():
    return sorted((ROOT / "ceph_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"
    ]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ceph_tpu")


def test_port_imports_neither_jax_nor_ceph_tpu():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert len(_port_sources()) > 10
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    """In a fresh interpreter (this one has jax from conftest)."""
    code = (
        "import sys, ceph_tpu_torch.ec, ceph_tpu_torch.cli.ec_benchmark\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'ceph_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    prof = {"plugin": "jax", "k": "4", "m": "2"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_erasure_code(prof)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_erasure_code({"plugin": "jerasure"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ec_benchmark.run(ec_benchmark._parse(["--plugin", "jax"]),
                         out=io.StringIO())


@pytest.mark.parametrize("profile,match", [
    ({"plugin": "jax", "strategy": "pallas"}, "not yet ported"),
    ({"plugin": "jerasure", "strategy": "xor"}, "not yet ported"),
    ({"plugin": "jerasure", "backend": "native"}, "not yet ported"),
    ({"plugin": "clay", "k": "4", "m": "2", "d": "5"}, "not yet ported"),
    ({"plugin": "shec", "k": "4", "m": "3", "c": "2"}, "not yet ported"),
    ({"plugin": "lrc", "k": "4", "m": "2", "l": "3"}, "not yet ported"),
    ({"plugin": "nope"}, "unknown plugin"),
    ({"plugin": "jerasure", "backend": "tpu"}, "unknown ec backend"),
    ({"plugin": "jerasure", "technique": "liberation"}, "unknown technique"),
    ({"plugin": "jerasure", "technique": "reed_sol_r6_op", "m": "3"},
     "m=2"),
])
def test_profile_errors(profile, match):
    with pytest.raises(ErasureCodeProfileError, match=match):
        create_erasure_code(profile, device="cpu")
