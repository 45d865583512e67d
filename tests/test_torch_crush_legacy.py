"""The legacy bucket draws (uniform, list, tree, straw) in the port's rule
interpreter, held element-exact against the JAX package.

The cases are those of tests/test_mapper_jax.py for the legacy
algorithms (flat firstn and indep, chooseleaf over hosts of each
algorithm), plus the places where a legacy draw can go wrong: a
choose_args weight set and ids on legacy buckets (the legacy draws ignore
them), uniform buckets drawn with r >= size, an indep rule whose numrep
divides a uniform bucket's size (the C's r stride changes there), and a
tree bucket of a size that is not a power of two.

The JAX package's rows (`compile_batched` and `mapper_ref.do_rule`
agreeing) are kept in tests/data/legacy_rule_cases.json, written by
`python tests/test_torch_crush_legacy.py`, with each case's inputs (the
map as `osd.carry.crush_from_reference` reads it, the rule, the seeds
and the reweights), so that `chip_smoke.py` holds the kernel on the
card to the same rows.  The port's plain version (`crush_rule_plain`),
the g++-built kernel body (staged and unstaged) and the port's own host
oracle (`crush/mapper_ref.py`) are held to them.
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
sys.path.insert(0, str(ROOT / "tests"))

from ceph_tpu.crush.types import (  # noqa: E402
    BucketAlg,
    ChooseArgs,
    ITEM_NONE,
    Rule,
    RuleOp,
)
from ceph_tpu_torch.crush import mapper, mapper_ref, soa  # noqa: E402
from ceph_tpu_torch.osd.carry import crush_from_reference  # noqa: E402
from test_torch_crush_kernel_host import body, run_body, stages  # noqa: E402,F401
from test_torch_crush_mapper import (  # noqa: E402
    CA_KEY,
    N_X,
    crush_dict,
    dev_weights,
    xs_for,
)
from util_maps import HOST, build_flat, build_tree  # noqa: E402

DATA = ROOT / "tests" / "data" / "legacy_rule_cases.json"
LEGACY = {"straw": BucketAlg.STRAW, "list": BucketAlg.LIST,
          "tree": BucketAlg.TREE, "uniform": BucketAlg.UNIFORM}


def _flat_firstn(alg):
    m, root = build_flat(17, alg)
    return m, m.make_replicated_rule(root, 0), [0x10000] * 17, 3


def _flat_indep(alg):
    m, root = build_flat(10, alg)
    r = m.add_rule(Rule([(RuleOp.TAKE, root, 0),
                         (RuleOp.CHOOSE_INDEP, 0, 0),
                         (RuleOp.EMIT, 0, 0)], type=3))
    return m, r, [0x10000] * 10, 4


def _chooseleaf_firstn(alg):
    def case(rng):
        m, root = build_tree(rng, n_host=6, osd_per_host=4, host_alg=alg,
                             weight_fn=lambda i: 0x10000 + (i % 5) * 0x4000)
        w = [0x10000] * 24
        w[3] = 0
        w[10] = 0x8000
        return m, m.make_replicated_rule(root, HOST), w, 3
    return case


def _chooseleaf_indep(alg):
    def case(rng):
        m, root = build_tree(rng, n_host=8, osd_per_host=3, host_alg=alg)
        w = [0x10000] * 24
        w[7] = 0
        return m, m.make_erasure_rule(root, HOST), w, 6
    return case


def _choose_args(alg):
    """Hosts of `alg` under a straw2 root, with a 3-position weight set
    and ids on every bucket: straw2 reads them, the legacy draws must
    not."""
    def case(rng):
        m, root = build_tree(rng, n_host=4, osd_per_host=4, host_alg=alg,
                             weight_fn=lambda i: 0x10000 + (i % 3) * 0x8000)
        r = m.make_replicated_rule(root, HOST)
        ca = ChooseArgs()
        for bid, b in m.buckets.items():
            ca.weight_sets[bid] = [
                [int(w) for w in rng.integers(1, 4 * 0x10000, b.size)]
                for _ in range(3)]
            ca.ids[bid] = [int(i) + 7 if i >= 0 else int(i)
                           for i in b.items]
        m.choose_args[CA_KEY] = ca
        return m, r, [0x10000] * 16, 3, N_X, CA_KEY
    return case


def _uniform_r_ge_size():
    """indep numrep 6 from a uniform bucket of 4: r runs past the size."""
    m, root = build_flat(4, BucketAlg.UNIFORM)
    r = m.add_rule(Rule([(RuleOp.TAKE, root, 0),
                         (RuleOp.CHOOSE_INDEP, 6, 0),
                         (RuleOp.EMIT, 0, 0)], type=3))
    return m, r, [0x10000, 0, 0x10000, 0x8000], 6


def _uniform_firstn_retry():
    """firstn retries on a uniform bucket of 5 with devices out."""
    m, root = build_flat(5, BucketAlg.UNIFORM)
    r = m.make_replicated_rule(root, 0)
    return m, r, [0x10000, 0, 0, 0x4000, 0x10000], 3


def _uniform_indep_divisible():
    """indep numrep 4 over a uniform bucket of 12: the C strides r by
    numrep + 1 per retry there (reference mapper.c:716-721)."""
    m, root = build_flat(12, BucketAlg.UNIFORM)
    r = m.add_rule(Rule([(RuleOp.TAKE, root, 0),
                         (RuleOp.CHOOSE_INDEP, 4, 0),
                         (RuleOp.EMIT, 0, 0)], type=3))
    w = [0x10000] * 12
    for i in (2, 5, 9):
        w[i] = 0
    return m, r, w, 4


def _uniform_leaf_indep_divisible(rng):
    """chooseleaf indep 3 over uniform hosts of 3, the leaf retried up to
    5 times: the stride changes in the leaf descent."""
    m, root = build_tree(rng, n_host=8, osd_per_host=3,
                         host_alg=BucketAlg.UNIFORM)
    r = m.add_rule(Rule([(RuleOp.SET_CHOOSELEAF_TRIES, 5, 0),
                         (RuleOp.TAKE, root, 0),
                         (RuleOp.CHOOSELEAF_INDEP, 3, HOST),
                         (RuleOp.EMIT, 0, 0)], type=3))
    w = [0x10000] * 24
    for i in (1, 4, 7):
        w[i] = 0
    return m, r, w, 3


def _tree_not_pow2():
    """A tree bucket of 11 unequal items."""
    m, root = build_flat(11, BucketAlg.TREE,
                         [0x10000 * (1 + i % 4) for i in range(11)])
    return m, m.make_replicated_rule(root, 0), [0x10000] * 11, 3


CASES = {}
for _n, _a in LEGACY.items():
    CASES[f"flat_firstn_{_n}"] = functools.partial(
        lambda a, rng: _flat_firstn(a), _a)
    CASES[f"flat_indep_{_n}"] = functools.partial(
        lambda a, rng: _flat_indep(a), _a)
    CASES[f"chooseleaf_firstn_{_n}"] = _chooseleaf_firstn(_a)
    CASES[f"chooseleaf_indep_{_n}"] = _chooseleaf_indep(_a)
    CASES[f"choose_args_{_n}"] = _choose_args(_a)
CASES.update({
    "uniform_r_ge_size": lambda rng: _uniform_r_ge_size(),
    "uniform_firstn_retry": lambda rng: _uniform_firstn_retry(),
    "uniform_indep_divisible": lambda rng: _uniform_indep_divisible(),
    "uniform_leaf_indep_divisible": _uniform_leaf_indep_divisible,
    "tree_not_pow2": lambda rng: _tree_not_pow2(),
})


def build_case(name: str):
    """(m, ruleno, weights, result_max, n_x, choose_args key), seeded."""
    got = CASES[name](np.random.default_rng(0xC3A5))
    m, ruleno, weights, rmax = got[:4]
    n_x = got[4] if len(got) > 4 else N_X
    ca_key = got[5] if len(got) > 5 else None
    return m, ruleno, weights, rmax, n_x, ca_key


def jax_rows(name: str) -> np.ndarray:
    """The JAX package's rows of a case: compile_batched's, held equal to
    mapper_ref's."""
    from ceph_tpu.crush.mapper_jax import compile_batched
    from ceph_tpu.crush.mapper_ref import do_rule
    from ceph_tpu.crush.soa import build_arrays

    m, ruleno, weights, rmax, n_x, ca_key = build_case(name)
    ca = m.choose_args.get(ca_key)
    fn = compile_batched(build_arrays(m, ca), ruleno, rmax, path="loop")
    rows = np.asarray(fn(xs_for(n_x), dev_weights(m, weights)))
    ref = np.array([(do_rule(m, ruleno, int(x), rmax, list(weights), ca)
                     + [ITEM_NONE] * rmax)[:rmax] for x in xs_for(n_x)],
                   np.int32)
    np.testing.assert_array_equal(rows, ref)
    return rows


@functools.cache
def _entries() -> dict:
    return {e["name"]: e for e in json.loads(DATA.read_text())["cases"]}


@functools.cache
def _stored() -> dict:
    return {name: np.asarray(e["rows"], np.int32)
            for name, e in _entries().items()}


def case_inputs(name: str) -> dict:
    """A case's inputs as stored beside its rows (JSON-able)."""
    m, ruleno, weights, rmax, n_x, ca_key = build_case(name)
    return {"map": crush_dict(m), "ruleno": ruleno, "result_max": rmax,
            "xs": xs_for(n_x).tolist(),
            "weights": dev_weights(m, weights).tolist(),
            "choose_args": ca_key}


def port_case(name: str):
    """(port arrays, rule program, seeds, weights, carried map, ruleno,
    choose_args key) of a case."""
    m, ruleno, weights, rmax, n_x, ca_key = build_case(name)
    pm = crush_from_reference(crush_dict(m))
    A = soa.build_arrays(pm, pm.choose_args.get(ca_key))
    prog = mapper.compile_rule(A, ruleno, rmax)
    xs = torch.from_numpy(xs_for(n_x).astype(np.int64))
    w = torch.from_numpy(dev_weights(m, weights).astype(np.int64))
    return A, prog, xs, w, pm, ca_key


def test_stored_rows_hold_every_case():
    assert sorted(_stored()) == sorted(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_stored_inputs_are_the_cases(name):
    e = _entries()[name]
    assert json.loads(json.dumps(case_inputs(name))) == \
        {k: e[k] for k in case_inputs(name)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_stored_rows_are_the_jax_packages(name):
    """compile_batched and mapper_ref still give the stored rows."""
    np.testing.assert_array_equal(jax_rows(name), _stored()[name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_jax_package(name):
    A, prog, xs, w, _, _ = port_case(name)
    rows, hashes = mapper.crush_rule_plain(soa.to_device(A, "cpu"), prog,
                                           xs, w, by_alg=True)
    np.testing.assert_array_equal(rows.numpy(), _stored()[name])
    # the lanes hashed in the legacy buckets they drew from, and only there
    algs = set(A.alg[A.size > 0].tolist())
    for a in range(mapper.N_ALGS):
        assert (int(hashes[:, a].sum()) > 0) == (a in algs), a
    _, draws = mapper.crush_rule_plain(soa.to_device(A, "cpu"), prog, xs, w)
    assert torch.equal(draws, hashes[:, BucketAlg.STRAW2])


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_mapper_ref_equals_jax_package(name):
    """The port's host oracle (the C's stateful uniform permutation)."""
    _, prog, xs, w, pm, ca_key = port_case(name)
    rmax = prog.result_max
    got = np.array([(mapper_ref.do_rule(pm, prog.ruleno, int(x), rmax,
                                        w.tolist(),
                                        pm.choose_args.get(ca_key))
                     + [ITEM_NONE] * rmax)[:rmax] for x in xs.tolist()],
                   np.int32)
    np.testing.assert_array_equal(got, _stored()[name])


@pytest.mark.parametrize("stage", ["none", "level", "split", "all"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_body_equals_jax_package(body, name, stage):  # noqa: F811
    """The g++-built kernel body, with no, part and all of the records
    staged."""
    A, prog, xs, w, _, _ = port_case(name)
    n_staged = 0 if stage == "none" else stages(A)[stage]
    got = run_body(body, A, prog, xs.numpy().astype(np.uint32),
                   w.numpy().astype(np.uint32), n_staged)
    np.testing.assert_array_equal(got, _stored()[name])


def test_uniform_draw_on_a_large_bucket(body):  # noqa: F811
    """A uniform bucket of 3000 items with r up to 60: the body's
    backward trace of the shuffle (no permutation in memory) equals the
    plain version and the host oracle's forward shuffle."""
    from ceph_tpu_torch.crush.types import BucketAlg as PBucketAlg
    from ceph_tpu_torch.crush.types import CrushMap, Rule as PRule

    m = CrushMap()
    root = m.add_bucket(PBucketAlg.UNIFORM, 1, list(range(3000)),
                        [0x10000] * 3000)
    r = m.add_rule(PRule([(RuleOp.TAKE, root, 0),
                          (RuleOp.CHOOSE_INDEP, 20, 0),
                          (RuleOp.EMIT, 0, 0)], type=3))
    A = soa.build_arrays(m)
    prog = mapper.compile_rule(A, r, 20)
    xs = np.arange(40, dtype=np.uint32) * 2654435761 % (2**31)
    w = np.full(3000, 0x10000, np.uint32)
    w[::3] = 0  # retries push r past 20
    got = run_body(body, A, prog, xs, w)
    plain, _ = mapper.crush_rule_plain(
        soa.to_device(A, "cpu"), prog, torch.from_numpy(xs.astype(np.int64)),
        torch.from_numpy(w.astype(np.int64)))
    np.testing.assert_array_equal(got, plain.numpy())
    ref = np.array([(mapper_ref.do_rule(m, r, int(x), 20, w.tolist())
                     + [ITEM_NONE] * 20)[:20] for x in xs], np.int32)
    np.testing.assert_array_equal(got, ref)


def test_packed_legacy_records():
    """pack_buckets: a legacy bucket's records hold its own items and
    weights at every weight-set position (not the choose_args ones), with
    straw's straws and list's sum_weights as the magic word, and a tree's
    node weights beside the records."""
    A, _, _, _, _, _ = port_case("choose_args_tree")
    pk = soa.pack_buckets(A)
    P = A.positions
    assert P == 3
    for s in np.nonzero(A.size)[0]:
        off, n = int(pk.headers[s]["offset"]), int(A.size[s])
        rec = pk.records[P * off: P * (off + n)].reshape(P, n)
        if A.alg[s] == BucketAlg.STRAW2:
            np.testing.assert_array_equal(rec["arg_id"][0], A.arg_ids[s, :n])
            continue
        for p in range(P):
            np.testing.assert_array_equal(rec["arg_id"][p], A.items[s, :n])
            np.testing.assert_array_equal(rec["weight"][p], A.weights[s, :n])
        nn = int(pk.headers[s]["num_nodes"])
        assert nn == A.num_nodes[s] >= 2
        at = int(pk.headers[s]["spare"])
        np.testing.assert_array_equal(pk.nodes[at:at + nn],
                                      A.node_weights[s, :nn])
    for name, field in (("choose_args_straw", "straws"),
                        ("choose_args_list", "sum_weights")):
        A = port_case(name)[0]
        pk = soa.pack_buckets(A)
        for s in np.nonzero(A.alg == LEGACY[name.split("_")[-1]])[0]:
            off, n = int(pk.headers[s]["offset"]), int(A.size[s])
            np.testing.assert_array_equal(
                pk.records[A.positions * off:][:n]["magic"],
                getattr(A, field)[s, :n])


def write_data() -> None:
    """Rewrite tests/data/legacy_rule_cases.json from the JAX package."""
    cases = []
    for name in sorted(CASES):
        cases.append({"name": name, **case_inputs(name),
                      "rows": jax_rows(name).tolist()})
        print(name)
    DATA.write_text(json.dumps({
        "about": "the JAX package's rows (compile_batched == mapper_ref) of "
                 "the legacy-bucket cases of "
                 "tests/test_torch_crush_legacy.py; written by `python "
                 "tests/test_torch_crush_legacy.py`",
        "cases": cases}) + "\n")


if __name__ == "__main__":
    write_data()
