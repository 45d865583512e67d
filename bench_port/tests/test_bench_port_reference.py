"""The plain reference agrees with the port's CPU path on a small map and
on small batches.  (The tests call the port; the reference never does.)"""

import numpy as np
import pytest
import torch

from bench_port import system
from bench_port.drivers import churn
from bench_port.reference import gf, placement

SMALL = {"hosts": 34, "osds_per_host": 8, "racks": 4,
         "ec_profile": {"plugin": "jerasure", "technique": "reed_sol_van",
                        "k": "8", "m": "4"}}
POOLS = {"replicated": {"type": "replicated", "size": 3, "pg_num": 3000},
         "erasure": {"type": "erasure", "size": 12, "pg_num": 1024}}
PARAMS = {"cycle": ["host_down", "host_out", "reweight", "restore"],
          "reweight_osds": 4, "reweight_to": 0.95}


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_rows_equal_the_port_epoch_by_epoch(pool):
    cfg = dict(SMALL, pool=POOLS[pool])
    st = system.cluster_state(cfg, "cpu")
    ref = placement.PoolReference(cfg, "cpu")
    ms = placement.MapState(ref.tree.n_devices, "cpu")
    deltas = churn.cycle_deltas(cfg, PARAMS, 77)
    for d in [{}] + deltas + deltas[:2]:
        if d:
            st.apply(system.incremental(st.m.epoch + 1, d))
            ms.apply(d)
        want, _ = ref.rows(ms)
        assert torch.equal(st.rows(0)[0].long(), want)
        # the base rows with the touched PGs walked again == a full walk
        full, _ = ref.walk(torch.arange(ref.pg_num), ms.weight)
        assert torch.equal(placement.up_rows(full, ms.up, ref.shift), want)


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_draws_equal_the_port_rule_plain_version(pool):
    from ceph_tpu_torch.crush import mapper

    cfg = dict(SMALL, pool=POOLS[pool])
    pm = system.cluster_state(cfg, "cpu").mapper(0)
    n = POOLS[pool]["pg_num"]
    x = pm.placement_seeds(torch.arange(n))
    rows, draws = mapper.crush_rule_plain(pm.tables, pm.prog, x,
                                          pm.rule_weights())
    raw, ref_draws = placement.PoolReference(cfg, "cpu").base()
    assert torch.equal(draws, ref_draws)
    assert torch.equal(rows.long(), raw)


def test_keep_down_control_differs_only_where_an_osd_is_down():
    cfg = dict(SMALL, pool=POOLS["replicated"])
    ref = placement.PoolReference(cfg, "cpu")
    ms = placement.MapState(ref.tree.n_devices, "cpu")
    ms.apply({"down": list(range(8))})
    good, _ = ref.rows(ms)
    bad, _ = ref.rows(ms, keep_down=True)
    raw, _ = ref.base()
    touched = torch.isin(raw, torch.arange(8)).any(1)
    assert torch.equal((good != bad).any(1), touched) and touched.any()


@pytest.mark.parametrize("k,m", [(8, 4), (3, 2), (6, 3), (10, 4)])
def test_reed_sol_van_is_jerasures_construction(k, m):
    """jerasure's matrix is the extended Vandermonde matrix brought to
    systematic form (V_bottom . V_top^-1), its columns and rows then
    scaled: coding row 0 and column 0 all ones, every ratio to the
    unscaled form a product e_i * d_j, and the code MDS."""
    C = gf.reed_sol_van(k, m)
    V = gf.extended_vandermonde(k + m, k)
    X = gf.matmul(V[k:], gf.invert(V[:k]))
    assert (C[0] == 1).all() and (C[:, 0] == 1).all()
    assert (X != 0).all()
    R = np.array([[gf.MUL[C[i, j], gf.inv(int(X[i, j]))] for j in range(k)]
                  for i in range(m)])
    for i in range(m):
        for j in range(k):
            assert gf.MUL[R[i, j], R[0, 0]] == gf.MUL[R[i, 0], R[0, j]]
    assert gf.unrecoverable_sets(C) == 0


def _port_batch(seed=3):
    code = system.erasure_code(SMALL, "cpu")
    g = torch.Generator().manual_seed(seed)
    data = torch.randint(0, 256, (6, 8, 256), generator=g,
                         dtype=torch.uint8)
    return code, data, code.encode_batch(data)


def test_port_chunks_follow_one_mds_code():
    """The check's reading of the port's chunks: the code it infers from
    one stripe is the port's own matrix, every byte of the batch follows
    it, and every 8 of the 12 chunks give back the data."""
    code, data, out = _port_batch()
    C = gf.infer_code(data[0], out[0, 8:])
    assert np.array_equal(C, code.C)
    assert gf.off_columns(C, data, out) == 0
    assert gf.unrecoverable_sets(C) == 0
    assert torch.equal(out[:, 8:], gf.apply(C, data, block=4))


@pytest.mark.parametrize("lost", [(2, 9), (0, 5), (3, 11), (8, 11)])
def test_port_decode_gives_back_the_data(lost):
    code, data, out = _port_batch()
    chunks = {i: out[:, i] for i in range(12) if i not in lost}
    got = code.decode_batch(set(range(8)), chunks, 256)
    C = gf.infer_code(data[0], out[0, 8:])
    use = sorted(chunks)[:8]
    missing = [i for i in lost if i < 8]
    R = gf.recover(C, use, missing)
    mine = gf.apply(R, torch.stack([chunks[i] for i in use], 1))
    for row, i in enumerate(missing):
        assert torch.equal(got[i], data[:, i])
        assert torch.equal(mine[:, row], data[:, i])


@pytest.mark.parametrize("where", ["data", "parity", "first_stripe"])
def test_off_columns_counts_an_altered_byte(where):
    code, data, out = _port_batch()
    C = gf.infer_code(data[0], out[0, 8:])
    bad = out.clone()
    if where == "data":
        bad[4, 1, 7] ^= 0x40
    elif where == "parity":
        bad[5, 10, 200] ^= 1
    else:  # the stripe the code is read from: another code, every stripe off
        bad[0, 9, :] ^= 1
        C = gf.infer_code(data[0], bad[0, 8:])
    n = gf.off_columns(C, data, bad)
    assert n == 1 if where != "first_stripe" else n > 5 * 256


def test_a_code_with_two_parity_rows_repeated_loses_sets():
    C = gf.reed_sol_van(8, 4).copy()
    C[2:] = C[:2]
    assert gf.unrecoverable_sets(C) > 0
