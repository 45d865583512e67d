"""The lifetime simulator's three data-plane programs, three ways.

The epoch stats (`sim/lifetime.py::_stats_torch`), the recovery drain
(`recovery/queue.py::drain_pool_torch`) and the client traffic and
contention (`sim/workload.py::workload_pool_torch`, `contention_torch`)
are torch ops in the port.  On random inputs with ITEM_NONE holes,
negative lanes, empty rows, padded rows past n, OSD ids past the vector
bound, OSDs without slots, a capacity that runs out, ties, and an int64
product that wraps, each equals, bit for bit:

- the JAX package's jitted program (`_build_stats_account`,
  `_build_drain`, `_build_wl`, `contention_jnp`), run on the CPU;
- the JAX package's numpy mirror (`_stats_np`, `drain_pool_np`,
  `workload_pool_np`, `contention_np`), which the port keeps verbatim and
  runs on its "ref" backend.

The first-live-lane pick and the spare slot DV of the [DV + 1] scatter
buffers have cases of their own (`first_lane_and_spare_slot`: primaries
on the last real slot DV - 1 beside rows with no primary).  Also: the
stream-rate formula, the workload draws, and RecoveryQueue's
checkpoint state, against the JAX package.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu_torch.crush.types import ITEM_NONE  # noqa: E402
from ceph_tpu_torch.recovery import queue  # noqa: E402
from ceph_tpu_torch.sim import lifetime, workload  # noqa: E402


def _rows(rng, N, W, n_osd, holes=0.2, neg=0.0, empty=0.0, past=0.0,
          dup=0.0):
    rows = rng.integers(0, n_osd, size=(N, W)).astype(np.int32)
    rows[rng.random((N, W)) < holes] = ITEM_NONE
    rows[rng.random((N, W)) < neg] = -1
    rows[rng.random(N) < empty] = ITEM_NONE
    rows[rng.random((N, W)) < past] = n_osd + 7
    d = rng.random(N) < dup
    if W > 1:
        rows[d, 1] = rows[d, 0]
    return rows


def _case(name):
    """(rows, prev, n, size, tol, backlog, moved, cap, slots, shard,
    stream, t_us): one drain/stats input set."""
    rng = np.random.default_rng(CASE_SEEDS[name])
    N, W, n_osd = 600, 3, 40
    DV = 64
    kw = {}
    cap_v, slot_v = 10 ** 9, 2
    shard, stream, t_us = 333_333_333, 3_000_000_000, 30_000_000
    backlog_hi = 4 * 10 ** 9
    if name == "holes":
        kw = dict(holes=0.3, neg=0.05)
    elif name == "empty_rows":
        kw = dict(empty=0.2)
    elif name == "zero_slots":
        slot_v = None  # per-OSD 0/1/3
    elif name == "cap_runs_out":
        cap_v, stream = 5_000, 10 ** 12
    elif name == "ties":
        n_osd, W = 3, 2
        backlog_hi = 1  # every queued PG carries the same backlog
    elif name == "wrap":
        backlog_hi, t_us = 1 << 60, 1 << 40  # num = min(b0, share) * t_us
        shard, stream, cap_v = 1 << 58, 1 << 61, 1 << 61
    elif name == "first_lane_and_spare_slot":
        n_osd, DV = 64, 64  # primaries reach DV - 1, the last real slot
        kw = dict(holes=0.5, empty=0.1, past=0.05)
    elif name == "ec_width":
        W, kw = 6, dict(holes=0.15, dup=0.05)
    rows = _rows(rng, N, W, n_osd, **kw)
    if name == "first_lane_and_spare_slot":
        rows[:40, 0] = ITEM_NONE
        rows[:40, 1] = DV - 1  # first live lane is lane 1, on DV - 1
    prev = rows.copy()
    change = rng.random((N, W)) < 0.25
    prev[change] = rng.integers(0, n_osd, size=int(change.sum()))
    prev[rng.random(N) < 0.05] = ITEM_NONE
    n = N - 37  # padded rows past n
    size = W
    tol = 1 if W == 3 else 2
    backlog = rng.integers(0, backlog_hi + 1, size=N).astype(np.int64)
    backlog[rng.random(N) < 0.5] = 0
    backlog[n:] = 0
    moved = rng.integers(0, W + 1, size=N).astype(np.int64)
    moved[rng.random(N) < 0.6] = 0
    cap = np.full(DV, cap_v, np.int64)
    cap[rng.random(DV) < 0.1] = 0
    if slot_v is None:
        slots = rng.choice(np.array([0, 1, 3], np.int64), size=DV)
    else:
        slots = np.full(DV, slot_v, np.int64)
    return dict(rows=rows, prev=prev, n=n, size=size, tol=tol,
                backlog=backlog, moved=moved, cap=cap, slots=slots,
                shard=shard, stream=stream, t_us=t_us)


CASE_SEEDS = {"holes": 1, "empty_rows": 2, "zero_slots": 3,
              "cap_runs_out": 4, "ties": 5, "wrap": 6,
              "first_lane_and_spare_slot": 7, "ec_width": 8}
CASES = sorted(CASE_SEEDS)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the epoch stats ----------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_stats_three_ways(name):
    import jax.numpy as jnp

    from ceph_tpu.sim import lifetime as jl

    c = _case(name)
    want, want_moved = lifetime._stats_np(c["prev"], c["rows"], c["n"],
                                          c["size"], c["tol"])
    jout, jmoved = jl._build_stats_account()(
        jnp.asarray(c["prev"]), jnp.asarray(c["rows"]), jnp.uint32(c["n"]),
        jnp.int32(c["size"]), jnp.int32(c["tol"]))
    got, moved = lifetime._stats_torch(_t(c["prev"]), _t(c["rows"]),
                                       c["n"], c["size"], c["tol"])
    assert np.asarray(jout).tolist() == want == got.tolist()
    assert moved.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(jmoved), want_moved)
    np.testing.assert_array_equal(moved.numpy(), want_moved)
    assert np.array_equal(lifetime._stats_np(c["prev"], c["rows"], c["n"],
                                             c["size"], c["tol"])[1],
                          jl._stats_np(c["prev"], c["rows"], c["n"],
                                       c["size"], c["tol"])[1])


# -- the recovery drain ---------------------------------------------------------

def _drain_args(c):
    return dict(shard_bytes=c["shard"], stream_bytes=c["stream"],
                t_us=c["t_us"], n=c["n"], size=c["size"], tol=c["tol"])


@pytest.mark.parametrize("moved_none", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_drain_three_ways(name, moved_none):
    import jax.numpy as jnp

    from ceph_tpu.recovery import queue as jq

    c = _case(name)
    moved = None if moved_none else c["moved"]
    b_np, cap_np, slots_np, scal_np = queue.drain_pool_np(
        c["backlog"], moved, c["rows"], c["cap"], c["slots"],
        **_drain_args(c))
    jmoved = jnp.zeros(c["rows"].shape[0], jnp.int64) if moved is None \
        else jnp.asarray(moved)
    jb, jcap, jslots, jscal = jq._build_drain()(
        jnp.asarray(c["backlog"]), jmoved, jnp.asarray(c["rows"]),
        jnp.asarray(c["cap"]), jnp.asarray(c["slots"]),
        np.int64(c["shard"]), np.int64(c["stream"]), np.int64(c["t_us"]),
        np.uint32(c["n"]), np.int32(c["size"]), np.int32(c["tol"]))
    tb, tcap, tslots, tscal = queue.drain_pool_torch(
        _t(c["backlog"]), None if moved is None else _t(moved),
        _t(c["rows"]), _t(c["cap"]), _t(c["slots"]), **_drain_args(c))
    want = [scal_np[k] for k in queue.DRAIN_KEYS]
    assert np.asarray(jscal).tolist() == want == tscal.tolist()
    for np_v, j_v, t_v in ((b_np, jb, tb), (cap_np, jcap, tcap),
                           (slots_np, jslots, tslots)):
        assert t_v.dtype == torch.int64
        np.testing.assert_array_equal(np.asarray(j_v), np_v)
        np.testing.assert_array_equal(t_v.numpy(), np_v)
    # conservation, as the engine books it
    prev = int((c["backlog"] * (np.arange(len(c["backlog"])) < c["n"]))
               .sum())
    if name != "wrap":
        assert prev + scal_np["enqueued"] == \
            scal_np["drained"] + scal_np["backlog"]
    if name == "cap_runs_out":
        assert (cap_np == 0).sum() > (c["cap"] == 0).sum()
    if name == "zero_slots":
        assert scal_np["queued"] > scal_np["completed"]


def test_drain_inputs_are_not_written():
    c = _case("holes")
    args = [_t(c[k]) for k in ("backlog", "moved", "rows", "cap", "slots")]
    snaps = [a.clone() for a in args]
    queue.drain_pool_torch(*args, **_drain_args(c))
    for a, s in zip(args, snaps):
        assert torch.equal(a, s)


@pytest.mark.parametrize("name", ["first_lane_and_spare_slot", "holes"])
def test_primary_slots_take_the_first_live_lane(name):
    """The first live lane of each row, by a plain Python walk; DV where
    the row has none or it lies past the vectors."""
    c = _case(name)
    DV = c["cap"].shape[0]
    want = []
    for row in c["rows"]:
        live = [int(o) for o in row if o != ITEM_NONE and o >= 0]
        want.append(live[0] if live and live[0] < DV else DV)
    got = queue.primary_slots(_t(c["rows"]), DV)
    assert got.tolist() == want
    assert (got == DV).any()
    if name == "first_lane_and_spare_slot":
        assert (got == DV - 1).any()


# -- the client traffic ---------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("with_backlog", [True, False])
def test_traffic_three_ways(name, with_backlog):
    import jax.numpy as jnp

    from ceph_tpu.sim import workload as jw

    c = _case(name)
    rng = np.random.default_rng(CASE_SEEDS[name] + 100)
    S = 257
    seeds = workload.zipf_pg_seeds(rng.random(S), c["n"], 4.0)
    read = rng.random(S) < 0.75
    DV = c["cap"].shape[0]
    kw = dict(wq=13, obj_bytes=65536, DV=DV, size=c["size"], tol=c["tol"])
    backlog = c["backlog"] if with_backlog else None
    cl_np, sc_np = workload.workload_pool_np(c["rows"], backlog, seeds,
                                             read, **kw)
    jb = jnp.asarray(backlog if with_backlog
                     else np.zeros(c["rows"].shape[0], np.int64))
    jcl, jsc = jw._build_wl()(
        jnp.asarray(c["rows"]), jb, jnp.asarray(seeds), jnp.asarray(read),
        np.int64(kw["wq"]), np.int64(kw["obj_bytes"]), DV,
        np.int32(c["size"]), np.int32(c["tol"]))
    tcl, tsc = workload.workload_pool_torch(
        _t(c["rows"]), None if backlog is None else _t(backlog),
        _t(seeds), _t(read), **kw)
    want = [sc_np[k] for k in workload.WL_KEYS]
    assert np.asarray(jsc).tolist() == want == tsc.tolist()
    np.testing.assert_array_equal(np.asarray(jcl), cl_np)
    np.testing.assert_array_equal(tcl.numpy(), cl_np)
    assert cl_np.sum() > 0

    cap_bytes = int(np.percentile(cl_np[cl_np > 0], 50))
    r_np, th_np, co_np = workload.contention_np(cl_np, cap_bytes)
    r_j, th_j, co_j = jw.contention_jnp(jnp.asarray(cl_np), cap_bytes)
    r_t, th_t, co_t = workload.contention_torch(tcl, cap_bytes)
    assert (th_np, co_np) == (th_j, co_j) == (th_t, co_t)
    assert th_np > 0 and co_np > 0
    np.testing.assert_array_equal(np.asarray(r_j), r_np)
    np.testing.assert_array_equal(r_t.numpy(), r_np)


def test_workload_draws_and_rates_equal_jax():
    from ceph_tpu.sim import workload as jw

    kw = dict(seed=9, base_qps=1234.5, read_fraction=0.6, zipf_a=3.0,
              hot_pool=1.3, diurnal_amp=0.4, diurnal_period=17, obj_kb=32,
              sample=64, interval_s=30.0)
    a, b = workload.WorkloadGen(**kw), jw.WorkloadGen(**kw)
    for e in (1, 8, 17, 40):
        assert a.qps(e) == b.qps(e)
        assert a.pool_requests(e, [0, 1, 5]) == b.pool_requests(e, [0, 1, 5])
        for (s1, r1), (s2, r2) in [(a.draws(e, 5, 100), b.draws(e, 5, 100))]:
            np.testing.assert_array_equal(s1, s2)
            np.testing.assert_array_equal(r1, r2)
    assert workload.pool_rank_weights(4, 1.5) == jw.pool_rank_weights(4, 1.5)


@pytest.mark.parametrize("pipelined", [False, True])
def test_stream_rates_equal_jax(pipelined):
    from ceph_tpu.recovery import queue as jq

    for mbps in (2.0, 100.0, 250.0, 4000.0):
        for gbps in (0.0, 0.05, 1.6, 12.5):
            for t_us in (10_000_000, 30_000_000):
                assert queue.stream_bytes_per_epoch(
                    mbps, t_us, gbps, pipelined) == \
                    jq.stream_bytes_per_epoch(mbps, t_us, gbps, pipelined)


def test_recovery_queue_state_round_trips_with_jax():
    """A drained port queue's checkpoint state restores in the JAX
    package's RecoveryQueue and back, with the same backlogs, totals and
    summary."""
    from ceph_tpu.recovery import queue as jq

    kw = dict(pg_gb=1.0, recovery_mbps=50.0, interval_s=30.0,
              max_backfills=1, osd_mbps=125.0, pipeline_repair=1,
              ec_gbps=0.5)
    c = _case("holes")
    rq = queue.RecoveryQueue(**kw, device=torch.device("cpu"))
    rq.ensure(0, c["rows"].shape[0])
    cap, slots = _t(c["cap"]), _t(c["slots"])
    for _ in range(3):
        cap, slots, scal = rq.drain_device(
            0, _t(c["moved"]), _t(c["rows"]), cap, slots, n=c["n"],
            size=c["size"], tol=c["tol"], is_erasure=True)
        assert rq.book(0, scal)
    rq.end_epoch()
    st = rq.state()
    j = jq.RecoveryQueue(**kw)
    j.restore(st)
    assert j.state() == st
    assert j.summary() == rq.summary()
    back = queue.RecoveryQueue(**kw, device=torch.device("cpu"))
    back.restore(j.state())
    np.testing.assert_array_equal(back.host_backlog(0), rq.host_backlog(0))
    assert back.summary() == rq.summary()
