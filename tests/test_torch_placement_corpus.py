"""The frozen placement corpus (tests/data/placement_corpus.json): maps
made by `ceph_tpu`'s builders, carried as plain data, with the sha256
digest of every PG's placement from `ceph_tpu`'s `PoolMapper.map_all()`.
The same file keeps the JAX package's rows of the rule cases of
tests/test_torch_crush_mapper.py ("rule_cases"), which that file checks.

The test holds both sides to each digest: `ceph_tpu` still gives it from
the same builder, and the port's `PoolMapper` (on the CPU, the rule's
plain version) gives it from the carried map.  `chip_smoke.py` checks the
same digests through the kernel on the card.

    python tests/test_torch_placement_corpus.py   # rewrites the JSON
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from ceph_tpu.crush.types import ChooseArgs  # noqa: E402
from ceph_tpu.osd.osdmap import build_hierarchical  # noqa: E402
from ceph_tpu.osd.pipeline_jax import PoolMapper as JaxPoolMapper  # noqa: E402
from ceph_tpu.osd.types import PgId, PgPool, PoolType  # noqa: E402
from ceph_tpu_torch.osd.carry import osdmap_from_reference  # noqa: E402
from ceph_tpu_torch.osd.pipeline import PoolMapper  # noqa: E402
from test_torch_crush_mapper import CASES, rule_case_entry  # noqa: E402
from test_torch_pipeline import osdmap_dict  # noqa: E402

CORPUS = ROOT / "tests" / "data" / "placement_corpus.json"
OSD_PER_HOST = 8  # bench.py's


def digest(up, up_primary, acting, acting_primary) -> str:
    """sha256 of the int32 bytes of up ‖ up_primary ‖ acting ‖
    acting_primary."""
    h = hashlib.sha256()
    for a in (up, up_primary, acting, acting_primary):
        h.update(np.ascontiguousarray(a, np.int32).tobytes())
    return h.hexdigest()


def bench_map(n_pgs: int, n_osds: int):
    """bench.py::build_map: hosts of 8 OSDs, racks of 16 hosts, one
    replicated size-3 pool with chooseleaf firstn over host."""
    n_host = max(1, n_osds // OSD_PER_HOST)
    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                  pg_num=n_pgs, pgp_num=n_pgs)
    return build_hierarchical(n_host, OSD_PER_HOST,
                              n_rack=max(1, n_host // 16), pool=pool)


def _config1(rng):
    return bench_map(1000, 32)  # BASELINE config 1: 1k PGs / 32 OSDs


def _config2_4096(rng):
    return bench_map(4096, 1024)  # BASELINE config 2's map, pg_num 4096


def _ec_k4m2_degraded(rng):
    pool = PgPool(type=PoolType.ERASURE, size=6, min_size=5, pg_num=512,
                  crush_rule=1)
    m = build_hierarchical(10, 4, pool=pool)
    m.crush.make_erasure_rule(
        min(m.crush.buckets, key=lambda b: -m.crush.buckets[b].type), 1)
    for o in rng.choice(m.max_osd, 5, replace=False):
        m.mark_down(int(o))
    for o in rng.choice(m.max_osd, 4, replace=False):
        m.mark_out(int(o))
    return m


def _fractional_weights(rng):
    m = build_hierarchical(
        24, 4, n_rack=4, pool=PgPool(pg_num=1024, size=3),
        weight_fn=lambda i: int(rng.integers(0x4000, 0x10001)))
    for o in rng.choice(m.max_osd, 40, replace=False):
        m.osd_weight[int(o)] = int(rng.integers(0x2000, 0x10000))
    return m


def _overlays_affinity(rng):
    m = build_hierarchical(
        12, 4, n_rack=3, pool=PgPool(pg_num=512, size=3),
        weight_fn=lambda i: int(rng.integers(1, 4)) * 0x8000)
    for o in range(m.max_osd):
        if rng.integers(0, 4) == 0:
            m.set_primary_affinity(o, int(rng.integers(0, 0x10001)))
    for o in rng.choice(m.max_osd, 6, replace=False):
        m.mark_down(int(o))
    for o in rng.choice(m.max_osd, 4, replace=False):
        m.mark_out(int(o))
    for ps in rng.choice(512, 96, replace=False):
        ps, k = int(ps), int(rng.integers(0, 4))
        osds = [int(o) for o in rng.choice(m.max_osd, 3, replace=False)]
        if k == 0:
            m.pg_upmap[PgId(0, ps)] = osds
        elif k == 1:
            m.pg_upmap_items[PgId(0, ps)] = [(osds[0], osds[1]),
                                             (osds[2], osds[0])]
        elif k == 2:
            m.pg_temp[PgId(0, ps)] = osds
        else:
            m.primary_temp[PgId(0, ps)] = osds[0]
    return m


def _choose_args_positions(rng):
    m = build_hierarchical(8, 4, n_rack=2, pool=PgPool(pg_num=512, size=3))
    ca = ChooseArgs()
    for bid, b in m.crush.buckets.items():
        ca.weight_sets[bid] = [
            [int(w) for w in rng.integers(1, 3 * 0x10000, b.size)]
            for _ in range(3)
        ]
    m.crush.choose_args[0] = ca
    return m


def _nonhashpspool_non_pow2(rng):
    return build_hierarchical(
        16, 4, n_rack=4, pool=PgPool(pg_num=300, pgp_num=300, size=3,
                                     flags=0))


ENTRIES = {
    "config1_1000pg_32osd": _config1,
    "config2_4096pg_1024osd": _config2_4096,
    "ec_k4m2_indep_down_out": _ec_k4m2_degraded,
    "fractional_weights_retry": _fractional_weights,
    "overlays_primary_affinity": _overlays_affinity,
    "choose_args_3_positions": _choose_args_positions,
    "nonhashpspool_pg300": _nonhashpspool_non_pow2,
}


def build_entry(name: str):
    return ENTRIES[name](np.random.default_rng(
        int.from_bytes(hashlib.sha256(name.encode()).digest()[:8], "big")))


def corpus_entry(name: str) -> dict:
    m = build_entry(name)
    return {"name": name, "pool_id": 0, "map": osdmap_dict(m),
            "digest": digest(*JaxPoolMapper(m, 0).map_all())}


def load_corpus() -> dict:
    return {e["name"]: e for e in json.loads(CORPUS.read_text())["entries"]}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_corpus_digest(name):
    entry = load_corpus()[name]
    m = build_entry(name)
    # the stored map is what the builder makes, and ceph_tpu still gives
    # the stored digest from it
    assert json.loads(json.dumps(osdmap_dict(m))) == entry["map"]
    assert digest(*JaxPoolMapper(m, entry["pool_id"]).map_all()) == \
        entry["digest"]
    # the port gives it from the carried map
    pm = PoolMapper(osdmap_from_reference(entry["map"]), entry["pool_id"],
                    device="cpu")
    assert digest(*pm.map_all()) == entry["digest"]


def test_corpus_holds_every_entry():
    assert sorted(load_corpus()) == sorted(ENTRIES)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    CORPUS.write_text(json.dumps(
        {"entries": [corpus_entry(n) for n in ENTRIES],
         "rule_cases": [rule_case_entry(n) for n in sorted(CASES)]},
        separators=(",", ":")
    ) + "\n")
    print(f"wrote {CORPUS}")
