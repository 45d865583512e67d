"""The port's rule interpreter held element-exact against the JAX package:
`crush_rule_plain` (the plain version of the Hopper kernel) against both
`mapper_ref.do_rule` and `compile_batched` on the straw2 cases of
tests/test_mapper_jax.py.  Maps are built with tests/util_maps.py and
carried across as plain data (`osd.carry.crush_from_reference`).

The JAX package's rows of every case are computed once and kept in
tests/data/placement_corpus.json ("rule_cases", written by
`python tests/test_torch_placement_corpus.py`);
`test_stored_rows_are_the_jax_packages` holds both JAX-package mappers to
them, and the port's tests compare against them.  `CASES`, `port_case`
and `stored_rows` also serve tests/test_torch_crush_kernel_host.py.
"""

import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu.crush.mapper_jax import compile_batched  # noqa: E402
from ceph_tpu.crush.mapper_ref import do_rule  # noqa: E402
from ceph_tpu.crush.soa import build_arrays as jax_build_arrays  # noqa: E402
from ceph_tpu.crush.types import (  # noqa: E402
    BucketAlg,
    ChooseArgs,
    ITEM_NONE,
    Rule,
    RuleOp,
    Tunables,
)
from ceph_tpu_torch.crush import mapper, soa  # noqa: E402
from ceph_tpu_torch.osd.carry import crush_from_reference  # noqa: E402
from util_maps import HOST, RACK, build_flat, build_tree  # noqa: E402

N_X = 65  # seeds per case (the JAX tests take 257; the Python oracle
          # mapper_ref costs about 10 ms a seed)
CA_KEY = "test"  # where a case's choose_args ride in the carried map
CORPUS = ROOT / "tests" / "data" / "placement_corpus.json"


def crush_dict(m) -> dict:
    """A ceph_tpu CrushMap as the plain data `crush_from_reference` reads
    (JSON-able)."""
    t = m.tunables
    return {
        "tunables": {k: int(getattr(t, k)) for k in (
            "choose_local_tries", "choose_local_fallback_tries",
            "choose_total_tries", "chooseleaf_descend_once",
            "chooseleaf_vary_r", "chooseleaf_stable",
            "straw_calc_version")},
        "max_devices": int(m.max_devices),
        "buckets": [
            {"id": bid, "alg": int(b.alg), "type": int(b.type),
             "items": [int(i) for i in b.items],
             "weights": [int(w) for w in b.weights],
             "name": m.item_names.get(bid)}
            for bid, b in sorted(m.buckets.items(), reverse=True)
        ],
        "rules": [
            None if r is None else {
                "steps": [[int(op), int(a1), int(a2)]
                          for op, a1, a2 in r.steps],
                "ruleset": r.ruleset, "type": r.type,
                "min_size": r.min_size, "max_size": r.max_size,
            }
            for r in m.rules
        ],
        "choose_args": [
            {"key": key,
             "weight_sets": [[bid, [[int(w) for w in ws] for ws in sets]]
                             for bid, sets in sorted(ca.weight_sets.items())],
             "ids": [[bid, [int(i) for i in ids]]
                     for bid, ids in sorted(ca.ids.items())]}
            for key, ca in m.choose_args.items()
        ],
    }


def xs_for(n_x: int) -> np.ndarray:
    return np.arange(n_x, dtype=np.uint32) * 2654435761 % (2**31)


def dev_weights(m, weights) -> np.ndarray:
    dev_w = np.zeros(max(m.max_devices, 1), np.uint32)
    dev_w[: len(weights)] = weights
    return dev_w


# -- the cases: (map, ruleno, device weights, result_max, n_x, choose_args) --

def _flat_firstn():
    m, root = build_flat(17, BucketAlg.STRAW2)
    return m, m.make_replicated_rule(root, 0), [0x10000] * 17, 3


def _flat_indep():
    m, root = build_flat(10, BucketAlg.STRAW2)
    r = m.add_rule(Rule([(RuleOp.TAKE, root, 0),
                         (RuleOp.CHOOSE_INDEP, 0, 0),
                         (RuleOp.EMIT, 0, 0)], type=3))
    return m, r, [0x10000] * 10, 4


def _weighted_straw2(rng):
    n = 25
    weights = [int(w) for w in rng.integers(1, 8 * 0x10000, n)]
    weights[3] = 0
    m, root = build_flat(n, BucketAlg.STRAW2, weights)
    r = m.make_replicated_rule(root, 0)
    return m, r, [int(w) for w in rng.integers(0, 0x10001, n)], 3


def _chooseleaf_firstn(rng):
    m, root = build_tree(rng, n_host=6, osd_per_host=4,
                         weight_fn=lambda i: 0x10000 + (i % 5) * 0x4000)
    w = [0x10000] * 24
    w[3] = 0
    w[10] = 0x8000
    return m, m.make_replicated_rule(root, HOST), w, 3


def _chooseleaf_indep(rng):
    m, root = build_tree(rng, n_host=8, osd_per_host=3)
    w = [0x10000] * 24
    w[7] = 0
    return m, m.make_erasure_rule(root, HOST), w, 6


def _three_level(rng):
    m, root = build_tree(rng, n_host=8, osd_per_host=3, n_rack=4)
    return m, m.make_replicated_rule(root, RACK), [0x10000] * 24, 3


def _choose_then_chooseleaf(rng):
    m, root = build_tree(rng, n_host=8, osd_per_host=3, n_rack=4)
    r = m.add_rule(Rule([(RuleOp.TAKE, root, 0),
                         (RuleOp.CHOOSE_FIRSTN, 2, RACK),
                         (RuleOp.CHOOSELEAF_FIRSTN, 2, HOST),
                         (RuleOp.EMIT, 0, 0)]))
    return m, r, [0x10000] * 24, 4


def _firefly(rng):
    m, root = build_tree(rng, n_host=5, osd_per_host=4,
                         tunables=Tunables.profile("firefly"),
                         weight_fn=lambda i: 0x10000 * (1 + i % 3))
    w = [0x10000] * 20
    w[2] = 0
    w[7] = 0x4000
    return m, m.make_replicated_rule(root, HOST), w, 3


def _vary_r_stable_off(rng):
    m, root = build_tree(rng, n_host=6, osd_per_host=4)
    r = m.add_rule(Rule([
        (RuleOp.SET_CHOOSELEAF_VARY_R, 0, 0),
        (RuleOp.SET_CHOOSELEAF_STABLE, 0, 0),
        (RuleOp.TAKE, root, 0),
        (RuleOp.CHOOSELEAF_FIRSTN, 0, HOST),
        (RuleOp.EMIT, 0, 0)]))
    w = [0x10000] * 24
    w[5] = 0
    return m, r, w, 3


def _choose_args(positions: int, with_ids: bool, indep: bool):
    def case(rng):
        m, root = build_tree(rng, n_host=4, osd_per_host=4)
        if indep:
            r = m.add_rule(Rule([(RuleOp.TAKE, root, 0),
                                 (RuleOp.CHOOSELEAF_INDEP, 0, HOST),
                                 (RuleOp.EMIT, 0, 0)], ruleset=1, type=3))
        else:
            r = m.make_replicated_rule(root, HOST)
        ca = ChooseArgs()
        for bid, b in m.buckets.items():
            ca.weight_sets[bid] = [
                [int(w) for w in rng.integers(1, 4 * 0x10000, b.size)]
                for _ in range(positions)
            ]
            if with_ids:
                ca.ids[bid] = [int(i) + 7 if i >= 0 else int(i)
                               for i in b.items]
        m.choose_args[CA_KEY] = ca
        return m, r, [0x10000] * 16, 3, 65, CA_KEY
    return case


def _degenerate(indep: bool):
    def case(rng):
        m, root = build_tree(rng, n_host=3, osd_per_host=2)
        rr = m.make_replicated_rule(root, HOST)
        re_ = m.make_erasure_rule(root, HOST)
        return (m, re_, [0x10000] * 6, 5) if indep else \
            (m, rr, [0x10000] * 6, 3)
    return case


def _all_out(rng):
    # every seed exhausts its tries (about 200 ms a seed in mapper_ref)
    m, root = build_tree(rng, n_host=4, osd_per_host=2)
    return m, m.make_replicated_rule(root, HOST), [0] * 8, 3, 17


def _indep_numrep_exceeds():
    m, root = build_flat(12, BucketAlg.STRAW2)
    r = m.add_rule(Rule([(RuleOp.TAKE, root, 0),
                         (RuleOp.CHOOSE_INDEP, 6, 0),
                         (RuleOp.EMIT, 0, 0)], type=3))
    w = [0x10000] * 12
    for i in (1, 4, 6):
        w[i] = 0
    return m, r, w, 3


def _firstn_numrep_exceeds():
    m, root = build_flat(12, BucketAlg.STRAW2)
    r = m.add_rule(Rule([(RuleOp.SET_CHOOSE_TRIES, 2, 0),
                         (RuleOp.TAKE, root, 0),
                         (RuleOp.CHOOSE_FIRSTN, 6, 0),
                         (RuleOp.EMIT, 0, 0)]))
    w = [0x10000] * 12
    for i in (0, 2, 3, 5, 7, 8, 10):
        w[i] = 0
    return m, r, w, 3


def _stale_out2():
    m, root = build_flat(8)
    r = m.add_rule(Rule([(RuleOp.TAKE, root, 0),
                         (RuleOp.CHOOSELEAF_INDEP, 4, 0),
                         (RuleOp.EMIT, 0, 0)], type=3))
    w = [0x10000] * 8
    for dead in (2, 5, 6):
        w[dead] = 0
    return m, r, w, 4, 64


CASES = {
    "flat_firstn": lambda rng: _flat_firstn(),
    "flat_indep": lambda rng: _flat_indep(),
    "weighted_straw2": _weighted_straw2,
    "chooseleaf_firstn": _chooseleaf_firstn,
    "chooseleaf_indep": _chooseleaf_indep,
    "three_level": _three_level,
    "choose_then_chooseleaf": _choose_then_chooseleaf,
    "firefly_tunables": _firefly,
    "vary_r_stable_off": _vary_r_stable_off,
    "choose_args_1pos": _choose_args(1, False, False),
    "choose_args_3pos_ids": _choose_args(3, True, False),
    "choose_args_3pos_ids_indep": _choose_args(3, True, True),
    "firstn_numrep_exceeds_hosts": _degenerate(False),
    "indep_numrep_exceeds_hosts": _degenerate(True),
    "all_out": _all_out,
    "indep_numrep_exceeds_result_max": lambda rng: _indep_numrep_exceeds(),
    "firstn_numrep_exceeds_result_max":
        lambda rng: _firstn_numrep_exceeds(),
    "chooseleaf_indep_type0_stale_out2": lambda rng: _stale_out2(),
}


def build_case(name: str):
    """(m, ruleno, weights, result_max, n_x, choose_args key) of a case,
    made from a seed."""
    got = CASES[name](np.random.default_rng(0xC3A5))
    m, ruleno, weights, rmax = got[:4]
    n_x = got[4] if len(got) > 4 else N_X
    ca_key = got[5] if len(got) > 5 else None
    return m, ruleno, weights, rmax, n_x, ca_key


def jax_rows(name: str) -> np.ndarray:
    """compile_batched's rows of a case (the exact loop kernel)."""
    m, ruleno, weights, rmax, n_x, ca_key = build_case(name)
    A = jax_build_arrays(m, m.choose_args.get(ca_key))
    fn = compile_batched(A, ruleno, rmax, path="loop")
    return np.asarray(fn(xs_for(n_x), dev_weights(m, weights)))


def ref_rows(name: str) -> np.ndarray:
    """mapper_ref.do_rule's rows of a case, ITEM_NONE-padded."""
    m, ruleno, weights, rmax, n_x, ca_key = build_case(name)
    ca = m.choose_args.get(ca_key)
    return np.array([
        (do_rule(m, ruleno, int(x), rmax, list(weights), ca)
         + [ITEM_NONE] * rmax)[:rmax]
        for x in xs_for(n_x)
    ], np.int32)


def rule_case_entry(name: str) -> dict:
    """A case's stored rows, made by both JAX-package mappers."""
    rows = jax_rows(name)
    np.testing.assert_array_equal(rows, ref_rows(name))
    return {"name": name, "rows": rows.tolist()}


@functools.cache
def _stored() -> dict:
    return {e["name"]: np.asarray(e["rows"], np.int32).reshape(
                len(e["rows"]), -1)
            for e in json.loads(CORPUS.read_text())["rule_cases"]}


def stored_rows(name: str) -> np.ndarray:
    """The JAX package's rows of a case, as stored."""
    return _stored()[name]


def port_case(name: str):
    """(port arrays, rule program, seeds, weights) of a case, carried."""
    m, ruleno, weights, rmax, n_x, ca_key = build_case(name)
    pm = crush_from_reference(crush_dict(m))
    A = soa.build_arrays(pm, pm.choose_args.get(ca_key))
    prog = mapper.compile_rule(A, ruleno, rmax)
    xs = torch.from_numpy(xs_for(n_x).astype(np.int64))
    w = torch.from_numpy(dev_weights(m, weights).astype(np.int64))
    return A, prog, xs, w


@pytest.mark.parametrize("name", sorted(CASES))
def test_stored_rows_are_the_jax_packages(name):
    """compile_batched and mapper_ref both still give the stored rows."""
    want = stored_rows(name)
    assert want.shape == (len(xs_for(build_case(name)[4])),
                          build_case(name)[3])
    np.testing.assert_array_equal(jax_rows(name), want)
    np.testing.assert_array_equal(ref_rows(name), want)


def test_stored_rows_hold_every_case():
    assert sorted(_stored()) == sorted(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_jax_package(name):
    A, prog, xs, w = port_case(name)
    rows, draws = mapper.crush_rule_plain(soa.to_device(A, "cpu"), prog,
                                          xs, w)
    assert rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), stored_rows(name))
    assert draws.shape == xs.shape and bool((draws >= 0).all())
    # every lane that placed something drew at least once
    assert bool((draws[(rows != ITEM_NONE).any(1)] > 0).all())
    # the CPU dispatch of map_rule is the plain version
    T = soa.to_device(A, "cpu")
    np.testing.assert_array_equal(
        mapper.map_rule(T, prog, xs, w).numpy(), rows.numpy())


def test_plain_chunks_agree():
    """Seeds split over several plain-version chunks give the same rows."""
    A, prog, xs, w = port_case("chooseleaf_firstn")
    T = soa.to_device(A, "cpu")
    whole, draws = mapper.crush_rule_plain(T, prog, xs, w)
    old = mapper.PLAIN_CHUNK
    try:
        mapper.PLAIN_CHUNK = 50
        parts, pdraws = mapper.crush_rule_plain(T, prog, xs, w)
    finally:
        mapper.PLAIN_CHUNK = old
    assert torch.equal(parts, whole) and torch.equal(pdraws, draws)


@pytest.mark.parametrize("alg", [BucketAlg.UNIFORM, BucketAlg.LIST,
                                 BucketAlg.TREE, BucketAlg.STRAW])
def test_legacy_bucket_algs_raise(alg):
    """The legacy bucket algorithms no longer raise: compile_rule takes
    them, and the plain version maps them as mapper_ref does (the legacy
    cases themselves are in tests/test_torch_crush_legacy.py)."""
    m, root = build_flat(6, alg)
    r = m.make_replicated_rule(root, 0)
    pm = crush_from_reference(crush_dict(m))
    prog = mapper.compile_rule(soa.build_arrays(pm), r, 3)
    xs = xs_for(N_X)
    rows, _ = mapper.crush_rule_plain(
        soa.to_device(soa.build_arrays(pm), "cpu"), prog,
        torch.from_numpy(xs.astype(np.int64)),
        torch.full((6,), 0x10000, dtype=torch.long))
    want = [do_rule(m, r, int(x), 3, [0x10000] * 6) for x in xs]
    assert rows.tolist() == want


def test_legacy_local_tries_raise():
    m, root = build_flat(6, tunables=Tunables.profile("argonaut"))
    r = m.make_replicated_rule(root, 0)
    pm = crush_from_reference(crush_dict(m))
    with pytest.raises(NotImplementedError, match="local-retry"):
        mapper.compile_rule(soa.build_arrays(pm), r, 3)


def test_kernel_wrapper_refuses_cpu_tensors():
    """A CPU tensor never reaches the kernel: the wrapper raises before
    building or launching anything."""
    A, prog, xs, w = port_case("flat_firstn")
    T = soa.to_device(A, "cpu")
    before = mapper.crush_rule_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        mapper.crush_rule_cuda(T, prog, xs.int(), w.int())
    assert mapper.crush_rule_cuda.launches == before


def test_u32_bits_round_trip():
    v = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF])
    bits = mapper.u32_bits(v)
    assert bits.dtype == torch.int32
    assert torch.equal(bits.long() & 0xFFFFFFFF, v)


def test_choose_with_no_replicas_clears_the_work_vector():
    """A choose step whose numrep stays <= 0 after adding result_max
    empties the work vector (reference src/crush/mapper.c:946-1063,
    mapper_ref.do_rule).  The port follows the reference; the JAX
    package's compile_rule skips the step and emits the TAKE bucket
    (ROADMAP, section C)."""
    m, root = build_flat(8)
    r = m.add_rule(Rule([(RuleOp.TAKE, root, 0),
                         (RuleOp.CHOOSE_FIRSTN, -5, 0),
                         (RuleOp.EMIT, 0, 0)]))
    xs = xs_for(8)
    assert all(do_rule(m, r, int(x), 3, [0x10000] * 8) == [] for x in xs)
    pm = crush_from_reference(crush_dict(m))
    A = soa.build_arrays(pm)
    rows, _ = mapper.crush_rule_plain(
        soa.to_device(A, "cpu"), mapper.compile_rule(A, r, 3),
        torch.from_numpy(xs.astype(np.int64)), torch.full((8,), 0x10000))
    assert bool((rows == ITEM_NONE).all())
