"""The grouped GF(2^8) product and Clay's product plans, held to the
products run one by one and to the JAX package on the CPU.

- `gf_grouped_plain` (the plain version of one launch over a
  `ProductList`) equals its products run in order, one `gf_matmul_plain`
  each; a list whose products depend on one another is refused.
- Clay's layered plans (`ClayCode._plan`, encode and decode) and the
  plans of a repair with aloof nodes: every product of a run is free of
  the others' writes (a hypothesis property over erasure sets), and the
  runs, replayed one grouped product each, give the products' bytes in
  their order; encode, decode and repair through the plans equal
  `ceph_tpu`'s bytes, the EC corpus digests and
  tests/data/clay_config4.json.
- The launches each path makes on the card, counted here on the CPU with
  `chip_smoke.py`'s own counter (`cpu_launches`): the numbers that
  script holds the card to.
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ceph_tpu.ec import create_erasure_code as jax_create  # noqa: E402
from ceph_tpu_torch.ec import create_erasure_code  # noqa: E402
from ceph_tpu_torch.ec import torch_backend as tb  # noqa: E402
from ceph_tpu_torch.ec.clay import _cut_runs  # noqa: E402
from ceph_tpu_torch.ec.torch_backend import (  # noqa: E402
    BASE1,
    Product,
    ProductList,
)

CORPUS = ROOT / "tests" / "data" / "ec_corpus.json"
CONFIG4 = ROOT / "tests" / "data" / "clay_config4.json"
WIDE = ROOT / "tests" / "data" / "ec_wide.json"


def _clay(k, m, d, device="cpu", **kw):
    return create_erasure_code({"plugin": "clay", "k": str(k), "m": str(m),
                                "d": str(d), **kw}, device=device)


def _digest(rows) -> str:
    h = hashlib.sha256()
    for row in rows:
        h.update(np.asarray(row, np.uint8).tobytes())
    return h.hexdigest()


# -- the grouped plain version ------------------------------------------------

def _random_products(rng, n):
    """n products reading anywhere in buffer 0 and writing disjoint rows
    of buffer 1, each 7 bytes past the last."""
    products, at = [], 3
    for _ in range(n):
        R, S = int(rng.integers(1, 9)), int(rng.integers(1, 12))
        L = int(rng.integers(1, 3000))
        ins = tuple(int(v) for v in rng.integers(0, 20_000, S))
        outs = []
        for _ in range(R):
            outs.append(BASE1 | at)
            at += L + 7
        products.append(Product(rng.integers(0, 256, (R, S), np.uint8),
                                ins, tuple(outs), L))
    return products, at


@pytest.mark.parametrize("n", [1, 5, 12, 40])
def test_grouped_plain_equals_the_products_in_order(n):
    rng = np.random.default_rng([1, n])
    products, size = _random_products(rng, n)
    b0 = torch.from_numpy(rng.integers(0, 256, 20_000 + 3007, np.uint8))
    b1 = torch.from_numpy(rng.integers(0, 256, size, np.uint8))
    want = b1.clone()
    for p in products:
        X = torch.stack([b0[off:off + p.length] for off in p.ins])
        Y = tb.gf_matmul_plain(p.M, X)
        for r, row in enumerate(p.outs):
            start = row & (BASE1 - 1)
            want[start:start + p.length] = Y[r]
    before = b0.clone()
    tb.gf_grouped_plain(ProductList(products), b0, b1)
    assert torch.equal(b1, want) and torch.equal(b0, before)


def test_grouped_plain_through_the_engine_product():
    """The engine's grouped entry on the CPU runs each product through
    the engine (`_run`): every strategy gives the plain version's bytes."""
    rng = np.random.default_rng(2)
    products, size = _random_products(rng, 6)
    b0 = torch.from_numpy(rng.integers(0, 256, 20_000 + 3007, np.uint8))
    want = torch.zeros(size, dtype=torch.uint8)
    tb.gf_grouped_plain(ProductList(products), b0, want)
    for strategy in tb.STRATEGIES:
        b1 = torch.zeros(size, dtype=torch.uint8)
        tb.TorchEngine("cpu", strategy).matmul_grouped(
            ProductList(products), b0, b1)
        assert torch.equal(b1, want), strategy


def test_auto_runs_a_list_under_one_strategy():
    """Under `auto` a list resolves once, from its largest product (one
    autotune), and every product runs under that strategy: on the card a
    list that resolves to `pallas` is one launch."""
    rng = np.random.default_rng(3)
    products, size = _random_products(rng, 8)
    plist = ProductList(products)
    b0 = torch.from_numpy(rng.integers(0, 256, 20_000 + 3007, np.uint8))
    want = torch.zeros(size, dtype=torch.uint8)
    tb.gf_grouped_plain(plist, b0, want)
    eng = tb.TorchEngine("cpu", "auto")
    before = chip_smoke.counts("ec")["autotunes"]
    b1 = torch.zeros(size, dtype=torch.uint8)
    with chip_smoke.engine_launches() as log:
        eng.matmul_grouped(plist, b0, b1)
    assert torch.equal(b1, want)
    largest = max(products, key=lambda p: p.M.size * p.length)
    picked = eng.autotune[tb.matrix_key(largest.M)]["strategy"]
    assert [e[0] for e in log] == ["group"] and log[0][-1] == picked
    assert eng.list_strategy(plist, b0, b1) == picked
    assert chip_smoke.counts("ec")["autotunes"] - before <= 1
    assert eng._resolved_strategy == picked


@pytest.mark.parametrize("case", ["read_after_write", "write_after_read",
                                  "write_after_write", "own_rows"])
def test_a_list_with_a_hazard_is_refused(case):
    M = np.ones((1, 1), np.uint8)
    a = Product(M, (0,), (BASE1 | 0,), 64)
    second = {
        "read_after_write": Product(M, (BASE1 | 32,), (BASE1 | 100,), 64),
        "write_after_read": Product(M, (200,), (10,), 64),
        "write_after_write": Product(M, (200,), (BASE1 | 63,), 64),
        "own_rows": Product(M, (BASE1 | 500,), (BASE1 | 540,), 64),
    }[case]
    products = [second] if case == "own_rows" else [a, second]
    with pytest.raises(ValueError, match="hazard"):
        ProductList(products)


@pytest.mark.parametrize("items, fit, grid", [
    (1, 396, 1), (384, 396, 384), (396, 396, 396), (512, 396, 256),
    (8192, 396, 391), (800, 396, 267)])
def test_grid_takes_items_in_even_rounds(monkeypatch, items, fit, grid):
    """The kernel's persistent grid: every block that fits while the items
    take one round; past that, the fewest blocks that take them in as many
    rounds, so no block takes a last item alone."""
    monkeypatch.setattr(tb, "_blocks", lambda device, max_cols: fit)
    assert tb._grid(torch.device("cuda"), 8, items) == grid
    rounds = -(-items // fit)
    assert -(-items // grid) == rounds and grid <= fit


def test_buffers_are_checked():
    M = np.ones((1, 1), np.uint8)
    plist = ProductList([Product(M, (0,), (BASE1 | 10,), 64)])
    b0 = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="reaches"):
        tb.gf_grouped_plain(plist, b0, torch.zeros(70, dtype=torch.uint8))
    with pytest.raises(ValueError, match="overlap"):
        big = torch.zeros(200, dtype=torch.uint8)
        tb.gf_grouped_plain(plist, big[:100], big[50:])
    with pytest.raises(TypeError):
        tb.gf_grouped_plain(plist, b0.int(),
                            torch.zeros(80, dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        tb.gf_grouped_cuda(plist, b0, torch.zeros(80, dtype=torch.uint8))


# -- Clay's plans ---------------------------------------------------------------

def _hazard_free(run) -> bool:
    for i, (_, ins, outs) in enumerate(run):
        others = [p for j, p in enumerate(run) if j != i]
        written = {row for _, _, o in others for row in o}
        touched = written | {row for _, n, _ in others for row in n}
        if set(ins) & written or set(outs) & touched:
            return False
    return True


def _in_order(products, runs) -> bool:
    """Every product comes after each earlier product it depends on."""
    run_of = {id(p): r for r, run in enumerate(runs) for p in run}
    sets = [(set(ins), set(outs)) for _, ins, outs in products]
    for j, (ins, outs) in enumerate(sets):
        for i, (ins2, outs2) in enumerate(sets[:j]):
            depends = (ins | outs) & outs2 or outs & ins2
            if depends and run_of[id(products[i])] >= run_of[id(products[j])]:
                return False
    return True


@pytest.mark.parametrize("second, runs", [
    (([5], [6]), [[0, 1]]),      # independent: one run
    (([2], [6]), [[0], [1]]),    # reads what the first writes
    (([5], [1]), [[0], [1]]),    # writes what the first reads
    (([5], [2]), [[0], [1]]),    # writes what the first writes
])
def test_cut_runs_orders_each_hazard(second, runs):
    """The first product reads row 1 and writes row 2; the second joins
    its run only when neither touches a row the other writes."""
    M = np.ones((1, 1), np.uint8)
    products = [(M, [1], [2]), (M, *second)]
    got = _cut_runs(products)
    assert [[products.index(p) for p in run] for run in got] == runs


PROFILES = [(4, 2, 5), (4, 3, 5), (6, 3, 7), (8, 4, 11), (5, 4, 6)]


@settings(max_examples=25, deadline=None)
@given(st.sampled_from(PROFILES), st.data())
def test_runs_hold_no_row_written_by_another_product(profile, data):
    k, m, d = profile
    code = _clay(k, m, d, backend="numpy")
    n = k + m
    lost = data.draw(st.sets(st.integers(0, n - 1), min_size=1,
                             max_size=m))
    plan = code._plan(("layered", frozenset(code._node(i) for i in lost)))
    products = code._layered_products(
        frozenset(code._node(i) for i in lost))
    assert sum(len(r) for r in plan.runs) == len(products)
    assert all(_hazard_free(run) for run in plan.runs)
    runs = _cut_runs(products)
    assert _in_order(products, runs)
    if d < n - 1:  # a repair with aloof nodes
        i = data.draw(st.integers(0, n - 1))
        helpers = code.minimum_to_repair({i}, set(range(n)) - {i})
        aloof = frozenset(code._node(j) for j in range(n)
                          if j != i and j not in helpers)
        products = code._aloof_products(code._node(i), aloof)
        runs = _cut_runs(products)
        assert all(_hazard_free(run) for run in runs)
        assert _in_order(products, runs)


def _jax_stripe(k, m, d, nbytes=4096, seed=3):
    jcode = jax_create({"plugin": "clay", "k": k, "m": m, "d": d})
    payload = np.random.default_rng(seed).integers(0, 256, nbytes, np.uint8)
    return jcode, jcode.encode(set(range(k + m)), payload.tobytes())


@pytest.mark.parametrize("k, m, d", PROFILES)
def test_clay_through_the_plans_equals_jax(k, m, d):
    """Encode, every decode of one and of m lost chunks, and each
    chunk's repair through the plans (the device engine's grouped
    products, on the CPU) == ceph_tpu."""
    jcode, want = _jax_stripe(k, m, d)
    code = _clay(k, m, d)
    n = k + m
    data = np.stack([want[i] for i in range(k)])
    got = code.encode_chunks(data)
    assert all(np.array_equal(got[i], want[i]) for i in range(n))
    for lost in [{0}, {n - 1}, set(range(m)), set(range(n - m, n))]:
        have = {i: c for i, c in want.items() if i not in lost}
        dec = code.decode_chunks(lost, have, len(want[0]))
        jdec = jcode.decode_chunks(lost, dict(have), len(want[0]))
        assert all(np.array_equal(dec[i], jdec[i]) for i in lost), lost
    cs = len(want[0])
    for i in range(n):
        need = code.minimum_to_repair({i}, set(range(n)) - {i})
        helpers = {}
        for h, runs in need.items():
            planes = [z for ind, cnt in runs for z in range(ind, ind + cnt)]
            helpers[h] = want[h].reshape(code.get_sub_chunk_count(),
                                         -1)[planes].reshape(-1)
        rep = code.repair({i}, dict(helpers), cs)
        assert np.array_equal(rep[i], jcode.repair({i}, dict(helpers),
                                                   cs)[i]), i


def test_clay_corpus_and_config4_through_the_plans():
    """The EC corpus's Clay entry and BASELINE config 4's stripes: the
    stored JAX digests, through the plans on CPU tensors."""
    for entry in json.loads(CORPUS.read_text())["entries"]:
        if entry["profile"]["plugin"] != "clay":
            continue
        code = create_erasure_code(dict(entry["profile"]), device="cpu")
        data = torch.from_numpy(chip_smoke._data_for(
            entry["name"], code.k, entry["chunk_bytes"]))
        enc = code.encode_chunks(data)
        assert _digest(enc) == entry["digest"]
        for case in entry["decode"]:
            have = {i: enc[i] for i in range(entry["n_chunks"])
                    if i not in case["erased"]}
            dec = code.decode_chunks(set(case["erased"]), have,
                                     entry["chunk_bytes"])
            assert _digest(dec[i] for i in case["erased"]) == case["digest"]
    stored = json.loads(CONFIG4.read_text())
    code = create_erasure_code(dict(stored["profile"]), device="cpu")
    stripe = stored["stripes"][0]
    data = np.random.default_rng(stripe["seed"]).integers(
        0, 256, (code.k, stripe["chunk_bytes"]), dtype=np.uint8)
    assert _digest(code.encode_chunks(torch.from_numpy(data))) == \
        stripe["digest"]


def test_plans_replay_the_products_in_order():
    """A plan's runs as grouped products (reads before writes within a
    run) == its products one by one in the reference's order, on a
    workspace of random bytes (so a missing cut would show)."""
    code = _clay(8, 4, 10, backend="numpy")
    rng = np.random.default_rng(5)
    sc = 64
    for key in [("layered", frozenset({1, 5, 11})),
                ("aloof", 2, frozenset({code._node(11)}))]:
        make = (code._layered_products if key[0] == "layered"
                else code._aloof_products)
        products = make(*key[1:])
        n = 1 + max(max((r & (BASE1 - 1)) for p in products
                        for r in p[1] + p[2]), 0)
        B0 = rng.integers(0, 256, (n, sc), np.uint8)
        B1 = rng.integers(0, 256, (n, sc), np.uint8)
        want0, want1 = B0.copy(), B1.copy()

        def at(row, b0, b1):
            return (b1, row & (BASE1 - 1)) if row & BASE1 else (b0, row)

        for M, ins, outs in products:
            X = np.stack([buf[i] for buf, i in
                          (at(r, want0, want1) for r in ins)])
            Y = tb.gf_matmul_plain(M, torch.from_numpy(X)).numpy()
            for r, y in zip(outs, Y):
                buf, i = at(r, want0, want1)
                buf[i] = y
        t0, t1 = torch.from_numpy(B0.copy()), torch.from_numpy(B1.copy())
        for plist in code._plan(key).lists(sc):
            tb.gf_grouped_plain(plist, t0, t1)
        assert np.array_equal(t0.numpy(), want0), key
        assert np.array_equal(t1.numpy(), want1), key


# -- the launches of each path ------------------------------------------------------

def test_launches_per_path():
    """What chip_smoke.py holds the card to, counted on the CPU by its own
    counter: config 4's encode is 3 launches (352 products: the
    decouplings, the inner solves, the recouplings), its repair 13 (no
    aloof node: the batched repair's 12 pair products and its one solve);
    ec_wide's Clay(2,33,19) 38 and RS(70,4) 4 (one a product)."""
    stored = json.loads(CONFIG4.read_text())
    code = create_erasure_code(dict(stored["profile"]), device="cpu")
    data = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (8, 64 * 64), dtype=np.uint8))
    with chip_smoke.engine_launches() as log:
        enc = code.encode_chunks(data)
    assert chip_smoke.launches_of(log) == 3
    assert [len(e[1].products) for e in log] == [192, 64, 96]
    helpers = chip_smoke.repair_helpers(code, enc, 2)
    assert chip_smoke.cpu_launches(
        lambda: code.repair({2}, helpers, 64 * 64)) == 13
    wide = json.loads(WIDE.read_text())
    got = {name: chip_smoke.cpu_launches(
        lambda: chip_smoke.run_wide(case, "cpu"))
        for name, case in wide.items()}
    assert got == {"clay_k2m33_d19": 38, "rs_k70m4": 4}
