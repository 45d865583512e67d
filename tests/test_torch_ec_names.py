"""The last ErasureCodeInterface and registry names of the JAX package
that the port lacked, held against it: `ErasureCode.chunk_index` and
`minimum_to_decode_with_cost`, `ec.registry.register_plugin` and
`list_plugins` (exported from `ec`), `ec.matrices.is_mds` and
`native.mapper.available`.  Each answers, on the same inputs, what the
JAX function of that name answers."""

import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu import ec as jax_ec  # noqa: E402
from ceph_tpu.ec import matrices as jax_matrices  # noqa: E402
from ceph_tpu.ec import registry as jax_registry  # noqa: E402
from ceph_tpu.native import mapper as jax_native_mapper  # noqa: E402
from ceph_tpu_torch import ec  # noqa: E402
from ceph_tpu_torch.ec import matrices, registry  # noqa: E402
from ceph_tpu_torch.native import mapper as native_mapper  # noqa: E402
from test_ec import KM_GRID  # noqa: E402

LRC_LAYERED = {
    "plugin": "lrc",
    "mapping": "__DD__DD",
    "layers": '[["_cDD_cDD", ""], ["cDDD____", ""], ["____cDDD", ""]]',
}
MAPPED = {
    "lrc_layered": LRC_LAYERED,
    "lrc_kml": {"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
    "jerasure_mapped": {"plugin": "jerasure", "k": "3", "m": "2",
                        "mapping": "_DD_D"},
    "jerasure": {"plugin": "jerasure", "k": "4", "m": "2"},
}


def both(profile):
    return (jax_registry.create_erasure_code(dict(profile)),
            registry.create_erasure_code(dict(profile), device="cpu"))


@pytest.mark.parametrize("name", sorted(MAPPED))
def test_chunk_index_equals_jax(name):
    j, p = both(MAPPED[name])
    n = j.get_chunk_count()
    assert p.get_chunk_count() == n
    assert [p.chunk_index(i) for i in range(n)] == \
        [j.chunk_index(i) for i in range(n)]
    if "mapping" in MAPPED[name]:
        assert [p.chunk_index(i) for i in range(n)] != list(range(n))


COST_PROFILES = {
    "rs_8_4": {"plugin": "jerasure", "k": "8", "m": "4"},
    "isa_4_2": {"plugin": "isa", "k": "4", "m": "2"},
    "clay_4_2": {"plugin": "clay", "k": "4", "m": "2", "d": "5"},
    "clay_8_4": {"plugin": "clay", "k": "8", "m": "4", "d": "11"},
}


@pytest.mark.parametrize("name", sorted(COST_PROFILES))
def test_minimum_to_decode_with_cost_equals_jax(name):
    j, p = both(COST_PROFILES[name])
    n = j.get_chunk_count()
    rng = np.random.default_rng(len(name))
    cases = 0
    for lost in itertools.chain.from_iterable(
            itertools.combinations(range(n), r) for r in range(3)):
        available = {c: int(rng.integers(1, 9)) for c in range(n)
                     if c not in lost}
        for want in ({0}, set(lost) or {1}, set(range(j.k)),
                     {n - 1, 0}):
            try:
                w = j.minimum_to_decode_with_cost(set(want), dict(available))
            except Exception as e:  # the same refusal in both
                with pytest.raises(type(e)):
                    p.minimum_to_decode_with_cost(set(want),
                                                  dict(available))
                continue
            assert p.minimum_to_decode_with_cost(
                set(want), dict(available)) == w, (lost, want)
            cases += 1
    assert cases > 20


def mds_matrices():
    out = {f"vandermonde_{k}_{m}": (k, m, "vandermonde_rs")
           for k, m in KM_GRID}
    for k, m in [(3, 2), (4, 2), (5, 3), (8, 4)]:
        out[f"cauchy_orig_{k}_{m}"] = (k, m, "cauchy_orig")
        out[f"cauchy_good_{k}_{m}"] = (k, m, "cauchy_good")
    for k, m in [(3, 2), (4, 2), (8, 4)]:
        out[f"isa_cauchy_{k}_{m}"] = (k, m, "isa_cauchy")
    out["r6_5"] = (5, None, "rs_r6")
    return out


MDS = mds_matrices()


@pytest.mark.parametrize("name", sorted(MDS))
def test_is_mds_equals_jax(name):
    """tests/test_ec.py::TestMatrices's matrices, each built by both
    packages, and each with one entry zeroed (no longer MDS)."""
    k, m, fn = MDS[name]
    args = (k,) if m is None else (k, m)
    jc = getattr(jax_matrices, fn)(*args)
    pc = getattr(matrices, fn)(*args)
    np.testing.assert_array_equal(pc, jc)
    assert matrices.is_mds(pc) is jax_matrices.is_mds(jc) is True
    broken = pc.copy()
    broken[-1, 0] = 0
    assert matrices.is_mds(broken) is jax_matrices.is_mds(broken.copy()) \
        is False


def test_list_plugins_equals_jax_and_register_plugin():
    assert set(ec.list_plugins()) == set(jax_ec.list_plugins())
    assert ec.list_plugins() == registry.list_plugins() == \
        sorted(ec.list_plugins())
    assert "jax" in ec.list_plugins()
    name = "t_names_xor"
    saved = (dict(registry._PLUGINS), dict(jax_registry._PLUGINS))
    try:
        registry.register_plugin(name, registry._PLUGINS["example"])
        jax_registry.register_plugin(name, jax_registry._PLUGINS["example"])
        assert set(ec.list_plugins()) == set(jax_ec.list_plugins())
        p = registry.create_erasure_code({"plugin": name, "k": "2"},
                                         device="cpu")
        j = jax_registry.create_erasure_code({"plugin": name, "k": "2"})
        assert (p.k, p.m) == (j.k, j.m)
    finally:
        for d, old in zip((registry._PLUGINS, jax_registry._PLUGINS), saved):
            d.clear()
            d.update(old)


def test_native_available_equals_jax():
    assert native_mapper.available() is jax_native_mapper.available() \
        is True


def test_native_available_false_where_the_build_fails(tmp_path):
    """With no compiler ($CXX false) the build fails: `available` says
    False, as the JAX package's does, and NativeMapper raises with the
    compiler's error."""
    code = ("from ceph_tpu_torch.native import mapper\n"
            "print(mapper.available())\n"
            "from ceph_tpu_torch.osd.osdmap import build_hierarchical\n"
            "try:\n"
            "    mapper.NativeMapper(build_hierarchical(2, 2).crush)\n"
            "except RuntimeError as e:\n"
            "    print('raised', 'false' in str(e))\n")
    env = dict(os.environ, CXX="false", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split("\n")[:2] == ["False", "raised True"], out.stderr
