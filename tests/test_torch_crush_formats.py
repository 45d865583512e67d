"""The port's map formats against the JAX package's: the crushmap text
compiler (`compile_text`, `decompile`), the binary crushmap codec
(`encode_crushmap`, `decode_crushmap`) and the binary OSDMap codec
(`encode_osdmap`, `decode_osdmap`) give the same text and bytes on the
same maps, and what one package writes the other reads back to the same
text and bytes.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from ceph_tpu.cli import crushtool as jax_crushtool  # noqa: E402
from ceph_tpu.crush import codec as jax_codec  # noqa: E402
from ceph_tpu.crush import compiler as jax_compiler  # noqa: E402
from ceph_tpu.osd import codec as jax_osd_codec  # noqa: E402
from ceph_tpu.osd import osdmap as jax_osdmap  # noqa: E402
from ceph_tpu.osd import types as jax_types  # noqa: E402
from ceph_tpu_torch.cli import crushtool  # noqa: E402
from ceph_tpu_torch.crush import codec, compiler  # noqa: E402
from ceph_tpu_torch.crush.types import ChooseArgs  # noqa: E402
from ceph_tpu_torch.osd import codec as osd_codec  # noqa: E402
from ceph_tpu_torch.osd import osdmap, types  # noqa: E402
from ceph_tpu_torch.utils.crc32c import crc32c  # noqa: E402
from test_compiler import CLASSED, SAMPLE  # noqa: E402

LEGACY = (ROOT / "tests" / "data" / "legacy_crushmap.txt").read_text()

LAYERS = {
    "straw2": [("host", "straw2", 4), ("root", "straw2", 0)],
    "straw_hosts": [("host", "straw", 4), ("root", "straw2", 0)],
    "legacy_mix": [("host", "uniform", 3), ("rack", "tree", 3),
                   ("row", "list", 2), ("root", "straw", 0)],
}


def with_choose_args(text: str) -> str:
    """The text of a map with a 2-position weight set and ids on its first
    bucket (compiled and decompiled by the JAX package)."""
    m = jax_compiler.compile_text(text)
    from ceph_tpu.crush.types import ChooseArgs as JaxChooseArgs

    bid = max(m.buckets)
    b = m.buckets[bid]
    m.choose_args[-1] = JaxChooseArgs(
        weight_sets={bid: [[0x8000 + i for i in range(b.size)],
                           [0x18000] * b.size]},
        ids={bid: [i + 100 for i in b.items]})
    return jax_compiler.decompile(m)


TEXTS = {"sample": SAMPLE, "classed": CLASSED, "legacy": LEGACY,
         "choose_args": with_choose_args(SAMPLE)}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_text_maps(name):
    """compile_text -> decompile and encode_crushmap agree, and the port
    decodes the JAX package's bytes back to the same text and bytes."""
    text = TEXTS[name]
    jm, pm = jax_compiler.compile_text(text), compiler.compile_text(text)
    assert compiler.decompile(pm) == jax_compiler.decompile(jm)
    blob = jax_codec.encode_crushmap(jm)
    assert codec.encode_crushmap(pm) == blob
    assert codec.looks_like_crushmap(blob)
    back = codec.decode_crushmap(blob)
    assert codec.encode_crushmap(back) == blob
    assert compiler.decompile(back) == jax_compiler.decompile(
        jax_codec.decode_crushmap(blob))


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_built_maps(name):
    """crushtool --build's maps (every bucket algorithm) in both formats."""
    jm = jax_crushtool.build_map(24, LAYERS[name])
    pm = crushtool.build_map(24, LAYERS[name])
    text = jax_compiler.decompile(jm)
    assert compiler.decompile(pm) == text
    blob = jax_codec.encode_crushmap(jm)
    assert codec.encode_crushmap(pm) == blob
    assert compiler.decompile(compiler.compile_text(text)) == text
    assert codec.encode_crushmap(codec.decode_crushmap(blob)) == blob


def test_port_choose_args_round_trip():
    """A weight set built in the port survives both of its formats."""
    pm = compiler.compile_text(SAMPLE)
    bid = min(pm.buckets)
    pm.choose_args[3] = ChooseArgs(
        weight_sets={bid: [[0x10000, 0x4000]]}, ids={bid: [-7, -8]})
    for m2 in (compiler.compile_text(compiler.decompile(pm)),
               codec.decode_crushmap(codec.encode_crushmap(pm))):
        assert m2.choose_args[3].weight_sets == pm.choose_args[3].weight_sets
        assert m2.choose_args[3].ids == pm.choose_args[3].ids


def _osdmaps(pkg_osdmap, pkg_types):
    """The same OSDMaps built with one package's builders."""
    pool = pkg_types.PgPool(type=pkg_types.PoolType.REPLICATED, size=3,
                            crush_rule=0, pg_num=128, pgp_num=128)
    hier = pkg_osdmap.build_hierarchical(8, 4, n_rack=2, pool=pool)
    hier.pg_upmap_items[pkg_types.PgId(0, 3)] = [(1, 2)]
    hier.pg_upmap[pkg_types.PgId(0, 4)] = [5, 9, 13]
    hier.pg_temp[pkg_types.PgId(0, 5)] = [7, 8, 9]
    hier.primary_temp[pkg_types.PgId(0, 6)] = 11
    hier.set_primary_affinity(3, 0x8000)
    hier.mark_down(4)
    hier.mark_out(6)
    ec = pkg_osdmap.build_hierarchical(
        6, 2, pool=pkg_types.PgPool(type=pkg_types.PoolType.ERASURE,
                                    size=4, crush_rule=0, pg_num=32,
                                    pgp_num=32))
    ec.erasure_code_profiles["p"] = {"k": "2", "m": "2"}
    return {"simple": pkg_osdmap.build_simple(12, pg_bits=3),
            "hierarchical": hier, "erasure": ec}


@pytest.mark.parametrize("name", ["simple", "hierarchical", "erasure"])
def test_osdmap_bytes(name):
    """encode_osdmap of the same map is the same bytes, and each package
    reads the other's back to them."""
    blob = jax_osd_codec.encode_osdmap(_osdmaps(jax_osdmap, jax_types)[name])
    assert osd_codec.encode_osdmap(_osdmaps(osdmap, types)[name]) == blob
    assert osd_codec.looks_like_osdmap(blob)
    m = osd_codec.decode_osdmap(blob)
    assert osd_codec.encode_osdmap(m) == blob
    assert jax_osd_codec.encode_osdmap(
        jax_osd_codec.decode_osdmap(osd_codec.encode_osdmap(m))) == blob
    want = jax_osd_codec.decode_osdmap(blob)
    for f in ("epoch", "max_osd", "osd_state", "osd_weight",
              "osd_primary_affinity", "pool_name", "pool_max",
              "erasure_code_profiles"):
        assert getattr(m, f) == getattr(want, f), f
    for f in ("pg_temp", "primary_temp", "pg_upmap", "pg_upmap_items"):
        assert {str(k): v for k, v in getattr(m, f).items()} == \
            {str(k): v for k, v in getattr(want, f).items()}, f
    assert sorted(m.pools) == sorted(want.pools)
    for pid in m.pools:
        assert vars(m.pools[pid]) == vars(want.pools[pid])


def test_crc32c_matches():
    from ceph_tpu.utils.crc32c import crc32c as jax_crc32c

    for n in (0, 1, 7, 255, 256, 1000, 4099):
        data = bytes((i * 131 + 7) % 256 for i in range(n))
        assert crc32c(data) == jax_crc32c(data)
        assert crc32c(data, 0) == jax_crc32c(data, 0)
