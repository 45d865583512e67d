"""The traffic generators are fixed by the seed."""

import json

import numpy as np
import torch

from bench_port import ecdata
from bench_port.drivers import churn, ec_degraded_read
from bench_port.keep import Kept
from bench_port.tests.conftest import BENCH

CFG5 = json.loads((BENCH / "configs" / "c5_rep3.json").read_text())
CFG_EC = json.loads((BENCH / "configs" / "c5_ec84.json").read_text())
CHURN = json.loads((BENCH / "traffic" / "c5_rep3.churn.json").read_text())
READ = json.loads(
    (BENCH / "traffic" / "c5_ec84.degraded_read.json").read_text())
SEEDS = (1, 2**31 + 7, 987654321)


def test_churn_cycle_is_fixed_by_the_seed():
    for seed in SEEDS:
        a = churn.cycle_deltas(CFG5, CHURN["params"], seed)
        assert a == churn.cycle_deltas(CFG5, CHURN["params"], seed)
    hosts = {churn.cycle_deltas(CFG5, CHURN["params"], s)[0]["down"][0]
             for s in SEEDS}
    assert len(hosts) == len(SEEDS)


def test_churn_cycle_shape():
    down, out, rw, back = churn.cycle_deltas(CFG5, CHURN["params"], 5)
    host = down["down"]
    assert len(host) == 8 and host[0] % 8 == 0
    assert host == list(range(host[0], host[0] + 8))
    # the host and the reweighted OSDs lie under the root's racks
    assert host[-1] < 78 * 16 * 8
    assert out == {"weight": {o: 0 for o in host}}
    assert len(rw["weight"]) == 4 and set(rw["weight"].values()) == {62259}
    assert not set(rw["weight"]) & set(host)
    assert max(rw["weight"]) < 78 * 16 * 8
    assert back["up"] == host
    assert back["weight"] == {o: 0x10000 for o in host + list(rw["weight"])}


def test_lost_pairs_fixed_by_seed_and_same_work_for_every_seed():
    for seed in SEEDS:
        p = ec_degraded_read.lost_pairs(8, 4, 8, 4, seed)
        assert p == ec_degraded_read.lost_pairs(8, 4, 8, 4, seed)
        assert len(set(p)) == 8
        assert sum(1 for a, b in p if b < 8) == 4
        assert all(a < 8 for a, _ in p)
    assert ec_degraded_read.lost_pairs(8, 4, 8, 4, 1) != \
        ec_degraded_read.lost_pairs(8, 4, 8, 4, 2)


def test_batches_fixed_by_the_seed():
    assert ecdata.geometry(CFG_EC, READ["params"]) == (8, 32768, 8, 4096)
    small = dict(CFG_EC, object_bytes=8 * 64 * 2, stripe_unit=64)
    params = dict(READ["params"], objects_per_batch=3)
    a = ecdata.batches(small, params, 2**31 + 7, "cpu")
    assert a.shape == (8, 6, 8, 64) and a.dtype == torch.uint8
    assert torch.equal(a, ecdata.batches(small, params, 2**31 + 7, "cpu"))
    assert not torch.equal(a, ecdata.batches(small, params, 3, "cpu"))


def test_kept_sample_fixed_by_the_seed():
    def kept(seed):
        k = Kept(4, 3, seed)
        for i in range(100):
            k.add(i, i)
        return [i for i, _ in k.items()]
    a = kept(11)
    assert a == kept(11) and a != kept(12)
    assert a[-3:] == [97, 98, 99] and len(a) <= 7
    assert np.all(np.diff(a) > 0)
