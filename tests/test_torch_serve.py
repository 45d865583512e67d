"""The placement service of the port (`ceph_tpu_torch.serve`) held
against the JAX package's (`ceph_tpu.serve`), on the CPU.

- `CASES` are fixed scripts (a map, epoch swaps, queries) that run on a
  fresh service of either package; each records the rows it got (raw or
  as a sha256), the `sample_digest`, the epoch and the swap counts.  The
  JAX package's records are stored in tests/data/serve_corpus.json
  (`python tests/test_torch_serve.py` rewrites it, about 3 min) and
  `test_case_equals_jax` runs each script on the port
  (`device="cpu"`, the rule's plain version) and asks for the same
  record;
- the cases of tests/test_serve.py, on the port: micro-batching,
  admission control, deadlines, epoch swaps, a device loss answered
  through the host oracle as the JAX service answers it,
  crash-restart, the bulk edge, mixed-pool submits, shutdown, the status
  surface and the replicated front, each also held to the host oracle
  (the mesh case is tests/test_torch_multichip.py's);
- checkpoints across the packages, both ways, give the same digest;
- value-only and structural swaps count `swap_delta_applies` /
  `swap_full_restages`, and no tensor of a buffer a reader captured is
  written after a flip.

The front's cases count replies and states, not wall-clock bounds.
"""

import hashlib
import json
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu_torch.crush.types import ITEM_NONE  # noqa: E402
from ceph_tpu_torch.osd import state as port_state  # noqa: E402
from ceph_tpu_torch.runtime import faults  # noqa: E402
from ceph_tpu_torch.serve import service as port_service  # noqa: E402

CORPUS = ROOT / "tests" / "data" / "serve_corpus.json"

N_PGS = 256
N_OSDS = 16
OBJECT = "rbd_data.1f3a.0000000000000007"


def port_pkg():
    from ceph_tpu_torch.osd import osdmap, state, types
    from ceph_tpu_torch.osd.incremental import Incremental
    from ceph_tpu_torch.serve import front, meshcheck, service

    return SimpleNamespace(
        name="port", osdmap=osdmap, types=types, state=state,
        Incremental=Incremental, service=service, front=front,
        meshcheck=meshcheck, faults=faults, extra={"device": "cpu"},
        counters=service.dump)


def jax_pkg():
    from ceph_tpu import obs
    from ceph_tpu.osd import osdmap, state, types
    from ceph_tpu.osd.incremental import Incremental
    from ceph_tpu.runtime import faults as jfaults
    from ceph_tpu.serve import front, meshcheck, service

    return SimpleNamespace(
        name="jax", osdmap=osdmap, types=types, state=state,
        Incremental=Incremental, service=service, front=front,
        meshcheck=meshcheck, faults=jfaults, extra={},
        counters=lambda: dict(obs.perf_dump().get("serve") or {}))


def _map(P):
    t = P.types
    pool = t.PgPool(type=t.PoolType.REPLICATED, size=3, crush_rule=0,
                    pg_num=N_PGS, pgp_num=N_PGS)
    return P.osdmap.build_hierarchical(4, 4, n_rack=1, pool=pool)


def _cfg(P, **kw):
    base = dict(window_s=0.02, block=64, fill=512, max_queue=8,
                deadline_s=5.0, bulk_max=256, degraded_batches=1)
    if P.name == "jax":  # the JAX service's compile prewarm (no output
        # in the scripts)
        base.update(prewarm=False)
    base.update(kw)
    return P.service.ServeConfig(**base)


def _svc(P, m, name, **kw):
    kw.setdefault("config", _cfg(P))
    return P.service.PlacementService(m, name=name, **kw, **P.extra)


def _rows(r) -> dict:
    """A reply's rows as lists (small replies)."""
    return {k: np.asarray(getattr(r, k)).tolist()
            for k in ("up", "up_primary", "acting", "acting_primary")}


def _sha(r) -> str:
    """sha256 over a (bulk) reply's statuses, if any, and its rows."""
    h = hashlib.sha256()
    if hasattr(r, "statuses"):
        h.update(np.ascontiguousarray(r.statuses).tobytes())
    for k in ("up", "up_primary", "acting", "acting_primary"):
        h.update(np.ascontiguousarray(getattr(r, k)).tobytes())
    return h.hexdigest()


def _reweight(P, epoch, osd, frac):
    inc = P.Incremental(epoch=epoch)
    inc.new_weight[osd] = int(0x10000 * frac)
    return inc


def _swap_counts(P, before) -> dict:
    after = P.counters()
    return {k: int(after.get(k, 0)) - int(before.get(k, 0))
            for k in ("swap_delta_applies", "swap_full_restages",
                      "epoch_swaps", "swap_rejected")}


# -- the scripts both packages run -------------------------------------------

def case_base(P):
    svc = _svc(P, _map(P), "corpus.base")
    try:
        seeds = np.random.default_rng(7).integers(0, N_PGS, 500)
        return {
            "epoch": svc.epoch,
            "lookup": _rows(svc.lookup_batch(0, [0, 1, 42, 137, 255])),
            "object": _rows(svc.lookup_object(0, OBJECT)),
            "block": _sha(svc.query_block(0, seeds.astype(np.uint32))),
            "digest": svc.sample_digest(),
        }
    finally:
        svc.close()


def case_reweight(P):
    """One value-only swap, then three more while nothing reads."""
    svc = _svc(P, _map(P), "corpus.reweight")
    try:
        c0 = P.counters()
        assert svc.apply(_reweight(P, svc.epoch + 1, 3, 0.5))["ok"]
        out = {"rows": _sha(svc.query_block(0, np.arange(64))),
               "digest1": svc.sample_digest()}
        for _ in range(3):
            assert svc.apply(_reweight(P, svc.epoch + 1, 5, 0.9))["ok"]
        out.update(epoch=svc.epoch, digest=svc.sample_digest(),
                   counts=_swap_counts(P, c0))
        return out
    finally:
        svc.close()


def _overlay_inc(P, m, epoch):
    """A value-only Incremental that upmaps PG 0.7's first OSD to the
    lowest OSD not in its row, and PG 0.9's second."""
    inc = P.Incremental(epoch=epoch)
    for seed, j in ((7, 0), (9, 1)):
        _, _, act, _ = m.pg_to_up_acting_osds(P.types.PgId(0, seed))
        to = min(set(range(N_OSDS)) - set(act))
        inc.new_pg_upmap_items[P.types.PgId(0, seed)] = [(act[j], to)]
    return inc


def case_swaps(P):
    """An overlay epoch and a down OSD (value-only), then a max_osd
    growth (structural), then a map adopted wholesale."""
    svc = _svc(P, _map(P), "corpus.swaps")
    try:
        c0 = P.counters()
        seeds = np.arange(N_PGS, dtype=np.uint32)
        out = {}
        assert svc.apply(_overlay_inc(P, svc._active.m, svc.epoch + 1))["ok"]
        out["overlay"] = _sha(svc.query_block(0, seeds))
        inc = P.Incremental(epoch=svc.epoch + 1)
        inc.new_state[2] = 1 << 1  # XOR of the UP bit: marked down
        assert svc.apply(inc)["ok"]
        out["down"] = _sha(svc.query_block(0, seeds))
        out["value_counts"] = _swap_counts(P, c0)
        c1 = P.counters()
        inc = P.Incremental(epoch=svc.epoch + 1)
        inc.new_max_osd = svc._active.m.max_osd + 4
        assert svc.apply(inc)["ok"]
        out["structural"] = _sha(svc.query_block(0, seeds))
        m2 = P.state.value_copy_map(svc._active.m)
        m2.epoch += 1
        m2.pg_upmap_items = dict(m2.pg_upmap_items)
        m2.pg_upmap_items[P.types.PgId(0, 1)] = [(0, 0), (1, 1)]
        assert svc.adopt_map(m2, reason="test")["ok"]
        out["adopted"] = _sha(svc.query_block(0, seeds))
        out["structural_counts"] = _swap_counts(P, c1)
        out.update(epoch=svc.epoch, digest=svc.sample_digest())
        return out
    finally:
        svc.close()


def case_checkpoint(P, ck):
    """Two swaps with a checkpoint, then the stored entry."""
    svc = _svc(P, _map(P), "corpus.ck", checkpoint=str(ck))
    try:
        for _ in range(2):
            assert svc.apply(_reweight(P, svc.epoch + 1, 1, 0.75))["ok"]
        out = {"epoch": svc.epoch, "digest": svc.sample_digest(),
               "spot": _sha(svc.lookup_batch(0, np.arange(16)))}
    finally:
        svc.close()
    entry = json.loads(Path(ck).read_text())["serve"]
    out["ck"] = {k: entry[k] for k in ("epoch", "map_b64")}
    return out


def case_shed(P):
    """The bulk edge sheds the lanes past its capacity."""
    svc = _svc(P, _map(P), "corpus.shed")
    try:
        cap = svc.config.max_queue * svc.config.block
        r = svc.query_block(0, (np.arange(cap + 488) * 3) % N_PGS)
        return {"counts": r.counts(), "rows": _sha(r)}
    finally:
        svc.close()


def case_two_pools(P):
    """The meshcheck witness map: submit_many over both pools, the
    placement digest, the sample digest."""
    m = P.meshcheck.build_default(pgs=64, osds=8)
    svc = _svc(P, m, "corpus.two")
    try:
        rng = np.random.default_rng(23)
        p0, p1 = sorted(m.pools)[:2]
        pools = rng.choice([p0, p1], 240)
        seeds = rng.integers(0, 32, 240).astype(np.uint32)
        digest, oracle = P.meshcheck.placement_digest(svc, m)
        return {"mixed": _sha(svc.submit_many(pools, seeds)),
                "one": _sha(svc.submit_many([p0], seeds[:16])),
                "placement_digest": digest, "oracle_match": oracle,
                "digest": svc.sample_digest()}
    finally:
        svc.close()


def case_background(P):
    """Two continuous-balancing rounds on a skewed map (a device_loop
    plan applied as a value-only overlay epoch), then the answers."""
    m = _map(P)
    for o in (2, 7, 11):
        m.osd_weight[o] = int(0x10000 * 0.7)
    svc = _svc(P, m, "corpus.bg")
    try:
        c0 = P.counters()
        rounds = []
        for _ in range(2):
            r = svc.background_balance(max_deviation=1, max_iter=8,
                                       candidate_batch=8)
            rounds.append({k: r[k] for k in ("ok", "epoch", "num_changed")}
                          | {k: round(r[k], 9)
                             for k in ("stddev", "max_deviation")})
        items = sorted((pg.pool, pg.seed, [list(p) for p in v]) for pg, v
                       in svc._active.m.pg_upmap_items.items())
        return {"rounds": rounds, "items": [list(i) for i in items],
                "counts": _swap_counts(P, c0),
                "rows": _sha(svc.query_block(0, np.arange(N_PGS))),
                "digest": svc.sample_digest()}
    finally:
        svc.close()


def case_front(P):
    """A two-replica front: a block, a staggered swap, the block again."""
    f = P.front.ServeFront(_map(P), replicas=2, config=_cfg(P),
                           name="corpus.front", **P.extra)
    try:
        seeds = np.random.default_rng(3).integers(0, N_PGS, 300)
        out = {"block": _sha(f.query_block(0, seeds))}
        res = f.apply(_reweight(P, f.epoch + 1, 3, 0.5))
        out.update(ok=res["ok"], epochs=[r.epoch for r in f.replicas],
                   block2=_sha(f.query_block(0, seeds)),
                   lookup=_rows(f.lookup(0, int(seeds[0]))))
    finally:
        f.close()
    m = P.meshcheck.build_default(pgs=64, osds=8)
    f = P.front.ServeFront(m, replicas=3, config=_cfg(P),
                           name="corpus.front3", **P.extra)
    try:
        rng = np.random.default_rng(29)
        pools = rng.choice(sorted(m.pools), 300)
        seeds = rng.integers(0, 32, 300).astype(np.uint32)
        out["mixed"] = _sha(f.submit_many(pools, seeds))
        return out
    finally:
        f.close()


CASES = {
    "background": case_background,
    "base": case_base,
    "reweight": case_reweight,
    "swaps": case_swaps,
    "shed": case_shed,
    "two_pools": case_two_pools,
    "front": case_front,
}


def _corpus() -> dict:
    return json.loads(CORPUS.read_text())


@pytest.fixture(autouse=True)
def _clean():
    """The observers are process-global: a burn one service raised must
    not leak into another test's summary."""
    from ceph_tpu import obs as jobs
    from ceph_tpu_torch import obs

    yield
    faults.disarm_all()
    for o in (obs, jobs):
        o.health.reset()
        o.timeline.reset()


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_equals_jax(name):
    assert CASES[name](port_pkg()) == _corpus()["cases"][name]


def test_checkpoint_case_equals_jax(tmp_path):
    got = case_checkpoint(port_pkg(), tmp_path / "ck.json")
    want = _corpus()["checkpoint"]
    assert {k: got[k] for k in ("epoch", "digest", "spot")} == \
        {k: want[k] for k in ("epoch", "digest", "spot")}
    # the map blob each package writes is the same bytes
    assert got["ck"] == want["ck"]


def test_port_resumes_a_jax_checkpoint(tmp_path):
    want = _corpus()["checkpoint"]
    ck = tmp_path / "jax_ck.json"
    ck.write_text(json.dumps({"stages_done": [], "serve": want["ck"]}))
    P = port_pkg()
    svc = P.service.PlacementService(config=_cfg(P), checkpoint=str(ck),
                                     resume=True, name="test.resume",
                                     device="cpu")
    try:
        assert svc.resumed_from == want["epoch"] == svc.epoch
        assert svc.sample_digest() == want["digest"]
        assert _sha(svc.lookup_batch(0, np.arange(16))) == want["spot"]
    finally:
        svc.close()


def test_jax_resumes_a_port_checkpoint(tmp_path):
    ck = tmp_path / "port_ck.json"
    got = case_checkpoint(port_pkg(), ck)
    J = jax_pkg()
    svc = J.service.PlacementService(config=_cfg(J), checkpoint=str(ck),
                                     resume=True, name="test.jresume")
    try:
        assert svc.resumed_from == got["epoch"] == svc.epoch
        assert svc.sample_digest() == got["digest"] == \
            _corpus()["checkpoint"]["digest"]
    finally:
        svc.close()


# -- tests/test_serve.py's cases on the port --------------------------------

@pytest.fixture(scope="module")
def svc():
    P = port_pkg()
    s = _svc(P, _map(P), "test.serve")
    yield s
    s.close()


@pytest.fixture(scope="module")
def svc2():
    P = port_pkg()
    s = _svc(P, P.meshcheck.build_default(pgs=64, osds=8), "test.serve2")
    yield s
    s.close()


def _oracle_rows(m, pid, seeds, width):
    from ceph_tpu_torch.osd.types import PgId

    up = np.full((len(seeds), width), ITEM_NONE, np.int32)
    act = np.full((len(seeds), width), ITEM_NONE, np.int32)
    upp = np.full(len(seeds), -1, np.int32)
    actp = np.full(len(seeds), -1, np.int32)
    for i, s in enumerate(seeds):
        u, u_p, a, a_p = m.pg_to_up_acting_osds(PgId(pid, int(s)))
        up[i, : len(u)] = u[:width]
        act[i, : len(a)] = a[:width]
        upp[i], actp[i] = u_p, a_p
    return up, upp, act, actp


def _held_to_oracle(r, m, pid, seeds):
    up, upp, act, actp = _oracle_rows(m, pid, seeds, r.up.shape[1])
    assert np.array_equal(r.up, up)
    assert np.array_equal(r.up_primary, upp)
    assert np.array_equal(r.acting, act)
    assert np.array_equal(r.acting_primary, actp)


def test_lookup_matches_host_oracle_and_jax(svc):
    seeds = np.asarray([0, 1, 42, 137, 255], np.uint32)
    r = svc.lookup_batch(0, seeds)
    assert r.ok and r.source == "device" and r.epoch == svc.epoch
    _held_to_oracle(r, svc._active.m, 0, seeds)
    if svc.epoch == 1:
        assert _rows(r) == _corpus()["cases"]["base"]["lookup"]


def test_object_query_matches_osdmaptool_semantics(svc):
    r = svc.lookup_object(0, OBJECT)
    assert r.ok
    pool = svc._active.m.pools[0]
    ps = pool.hash_key(OBJECT)
    mask = (1 << (pool.pg_num - 1).bit_length()) - 1
    seed = ps & mask if (ps & mask) < pool.pg_num else ps & (mask >> 1)
    want = svc.lookup(0, seed)
    assert np.array_equal(r.acting, want.acting)
    assert r.acting_primary[0] == want.acting_primary[0]


def test_unknown_pool_answers_efault(svc):
    r = svc.lookup(99, 0)
    assert r.status == "EFAULT" and "no pool" in r.error
    assert svc.query_block(99, [0, 1]).counts() == {"EFAULT": 2}
    assert svc.lookup_batch(0, []).status == "EFAULT"


def test_micro_batching_coalesces_concurrent_requests(svc):
    svc.pause()
    out: list = []
    ths = [threading.Thread(
        target=lambda i=i: out.append(
            svc.lookup_batch(0, np.arange(i * 10, i * 10 + 10))))
        for i in range(6)]
    for t in ths:
        t.start()
    deadline = time.time() + 5
    while len(svc._q) < 6 and time.time() < deadline:
        time.sleep(0.01)
    before = port_service.COUNTERS["batches"]
    svc.unpause()
    for t in ths:
        t.join(timeout=30)
    assert len(out) == 6 and all(r.ok for r in out)
    # six concurrent requests coalesced into ONE dispatch batch
    assert port_service.COUNTERS["batches"] - before == 1


def test_admission_control_sheds_with_ebusy_never_drops(svc):
    svc.pause()
    replies: list = []
    lock = threading.Lock()

    def go():
        r = svc.lookup_batch(0, [1, 2, 3], deadline_s=10.0)
        with lock:
            replies.append(r)

    n = svc.config.max_queue + 4
    ths = [threading.Thread(target=go) for _ in range(n)]
    for t in ths:
        t.start()
    deadline = time.time() + 5
    while time.time() < deadline:
        with lock:
            shed = len(replies)
        if len(svc._q) + shed >= n:
            break
        time.sleep(0.01)
    svc.unpause()
    for t in ths:
        t.join(timeout=30)
    by: dict = {}
    for r in replies:
        by[r.status] = by.get(r.status, 0) + 1
    assert len(replies) == n
    assert by.get("EBUSY") == 4, by
    assert by.get("ok") == svc.config.max_queue, by


def test_expired_deadline_answers_etimedout(svc):
    svc.pause()
    try:
        t0 = time.perf_counter()
        r = svc.lookup(0, 7, deadline_s=0.05)
        assert r.status == "ETIMEDOUT"
        assert time.perf_counter() - t0 < 2.0  # the watchdogged wait
    finally:
        svc.unpause()


def test_epoch_swap_forks_the_state_and_serves_the_new_map(svc):
    e0 = svc.epoch
    c0 = dict(port_service.COUNTERS)
    s0 = dict(port_state.COUNTERS)
    res = svc.apply(_reweight(port_pkg(), e0 + 1, 3, 0.5))
    assert res["ok"] and svc.epoch == e0 + 1
    seeds = np.arange(64, dtype=np.uint32)
    r = svc.lookup_batch(0, seeds)
    assert r.ok and r.epoch == e0 + 1
    _held_to_oracle(r, svc._active.m, 0, seeds)
    # a value-only swap forks: no rebuild, only the scatter block goes up
    assert port_service.COUNTERS["swap_delta_applies"] - \
        c0["swap_delta_applies"] == 1
    assert port_service.COUNTERS["swap_full_restages"] == \
        c0["swap_full_restages"]
    assert port_state.COUNTERS["full_rebuilds"] == s0["full_rebuilds"]
    assert port_state.COUNTERS["value_forks"] - s0["value_forks"] == 1
    assert 0 < port_state.COUNTERS["device_put_bytes"] - \
        s0["device_put_bytes"] <= 32 * 15
    assert port_service.dump()["swap_stall_seconds"]["count"] >= 1


def test_readers_drain_during_swap(svc):
    stop = threading.Event()
    replies: list = []

    def reader():
        while not stop.is_set():
            replies.append(svc.lookup_batch(0, np.arange(32)))

    t = threading.Thread(target=reader)
    t.start()
    try:
        for _ in range(3):
            assert svc.apply(_reweight(port_pkg(), svc.epoch + 1, 5,
                                       0.9))["ok"]
    finally:
        stop.set()
        t.join(timeout=30)
    assert replies and all(r.ok for r in replies)


def test_epoch_swap_fault_leaves_old_epoch_serving(svc):
    e0 = svc.epoch
    faults.arm("epoch_swap", "fail", "staging blew up", 1)
    try:
        res = svc.apply(port_pkg().Incremental(epoch=e0 + 1))
    finally:
        faults.disarm("epoch_swap")
    assert not res["ok"] and "staging blew up" in res["error"]
    assert svc.epoch == e0
    r = svc.lookup(0, 3)
    assert r.ok and r.epoch == e0


def test_failed_structural_stage_is_a_rejected_swap(svc, monkeypatch):
    """A stage that raises (here the ClusterState build) rejects the swap
    and leaves the old epoch serving: nothing serves without a state."""
    e0 = svc.epoch
    rejected = port_service.COUNTERS["swap_rejected"]

    def broken(*a, **kw):
        raise RuntimeError("state build failed")

    monkeypatch.setattr(port_state, "ClusterState", broken)
    inc = port_pkg().Incremental(epoch=e0 + 1)
    inc.new_max_osd = svc._active.m.max_osd + 1
    res = svc.apply(inc)
    assert not res["ok"] and "state build failed" in res["error"]
    assert svc.epoch == e0
    assert port_service.COUNTERS["swap_rejected"] == rejected + 1
    assert svc.lookup(0, 3).ok


def test_first_stage_failure_raises(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("state build failed")

    monkeypatch.setattr(port_state, "ClusterState", broken)
    P = port_pkg()
    with pytest.raises(RuntimeError, match="state build failed"):
        _svc(P, _map(P), "test.broken")


def _loss_script(P, svc, kind: str) -> dict:
    """A device loss mid-traffic on either package's service
    (`degraded_batches=1`): the lost batch, the spell, the return; the
    replies' sources and rows, the provenance and the counter deltas."""
    seeds = np.asarray([5, 9, 100, 200], np.uint32)
    d0 = P.counters()
    point = ("serve_dispatch" if kind == "lookup"
             else f"serve_dispatch.{svc.name}")
    call = ((lambda: svc.lookup_batch(0, seeds)) if kind == "lookup"
            else (lambda: svc.query_block(0, seeds)))
    base = call()
    P.faults.arm(point, "lost", "mid-traffic loss", 1)
    try:
        replies = [call() for _ in range(3)]  # lost, spell, device again
        left = svc.status()["degraded_batches_left"]
    finally:
        P.faults.disarm(point)
    d = P.counters()
    prov = svc.provenance()
    return {
        "sources": [base.source] + [r.source for r in replies],
        "ok": [bool(r.ok) for r in replies],
        "rows": [_rows(r) for r in replies],
        "equal_to_base": [_rows(r) == _rows(base) for r in replies],
        "fallbacks": prov["device_loss_fallbacks"],
        "events": [e.split(": ", 1)[-1] if e.startswith("recovered")
                   else e.rsplit(" -> ", 1)[-1]
                   for e in prov["fallback_events"]],
        "backend": prov["backend"],
        "degraded_answered": int(d.get("degraded_answered", 0))
        - int(d0.get("degraded_answered", 0)),
        "device_recoveries": int(d.get("device_recoveries", 0))
        - int(d0.get("device_recoveries", 0)),
        "left": left,
    }


@pytest.mark.parametrize("kind", ["lookup", "bulk"])
def test_device_loss_degrades_like_jax(kind):
    """On a service placed on the host (device "cpu") a lost dispatch
    is answered through the host oracle, as is the next
    `degraded_batches` batch, then the device answers again: the
    port's replies, sources, fallback events and counters equal the JAX
    service's under the same armed fault, and the degraded rows equal
    the device's."""
    got = {}
    for P in (port_pkg(), jax_pkg()):
        m = _map(P)
        s = _svc(P, m, f"test.loss.{P.name}.{kind}")
        try:
            got[P.name] = _loss_script(P, s, kind)
        finally:
            s.close()
    port, jax = got["port"], got["jax"]
    assert port == jax
    assert port["sources"] == ["device", "host", "host", "device"]
    assert all(port["ok"]) and all(port["equal_to_base"])
    assert port["fallbacks"] == 1
    assert port["events"] == ["host mapper",
                              "device dispatch healthy again"]
    assert port["degraded_answered"] == 8
    assert port["device_recoveries"] == 1


def test_device_loss_answers_efault_and_recovers():
    """On a card a lost dispatch answers its lanes EFAULT (the JAX
    service answers them through the host oracle: a difference by
    design, ROADMAP C.3), is recorded, and the next batch is answered by
    the device; nothing is answered by the host.  The service's device
    reads "cuda" here while its mapper stays on the host: the decision
    reads the device, the lanes need no card."""
    P = port_pkg()
    svc = _svc(P, _map(P), "test.card_loss")
    svc.device = torch.device("cuda")
    try:
        seeds = np.asarray([5, 9, 100, 200], np.uint32)
        base = svc.lookup_batch(0, seeds)
        assert base.ok and base.source == "device"
        d0 = dict(port_service.COUNTERS)
        faults.arm("serve_dispatch", "lost", "mid-traffic loss", 1)
        try:
            r1 = svc.lookup_batch(0, seeds)  # the lost batch: EFAULT
            r2 = svc.lookup_batch(0, seeds)  # the device again
        finally:
            faults.disarm("serve_dispatch")
        assert r1.status == "EFAULT" and "DeviceLostError" in r1.error
        assert r2.ok and r2.source == "device"
        assert _rows(r2) == _rows(base)
        prov = svc.provenance()
        assert prov["backend"] == "device"
        assert prov["device_loss_fallbacks"] == 1
        assert prov["fallback_events"][-2].endswith("-> EFAULT")
        assert prov["fallback_events"][-1].startswith("recovered")
        assert svc.status()["degraded_batches_left"] == 0
        faults.arm(f"serve_dispatch.{svc.name}", "lost", "bulk loss", 1)
        try:
            b1 = svc.query_block(0, seeds)
            b2 = svc.query_block(0, seeds)
        finally:
            faults.disarm(f"serve_dispatch.{svc.name}")
        assert b1.counts() == {"EFAULT": len(seeds)} and b1.source == ""
        assert b2.ok and b2.source == "device"
        assert _rows(b2) == _rows(base)
        assert svc.provenance()["device_loss_fallbacks"] == 2
        d = port_service.COUNTERS
        assert d["degraded_answered"] == d0["degraded_answered"]
        assert d["device_recoveries"] - d0["device_recoveries"] == 2
    finally:
        svc.close()


def test_kernel_errors_are_not_a_device_loss(svc, monkeypatch):
    """An error that is not a device loss (the rule kernel's own raises
    a builtin RuntimeError) answers EFAULT; nothing degrades."""
    from ceph_tpu_torch.osd import pipeline

    def failing(*a, **kw):
        raise RuntimeError("crush_rule kernel launch failed: boom")

    monkeypatch.setattr(pipeline, "map_rule", failing)
    d0 = port_service.COUNTERS["degraded_answered"]
    r = svc.lookup_batch(0, [1, 2])
    b = svc.query_block(0, [1, 2])
    assert r.status == "EFAULT" and "boom" in r.error
    assert b.counts() == {"EFAULT": 2} and "boom" in b.error
    assert port_service.COUNTERS["degraded_answered"] == d0
    assert svc.provenance()["backend"] == "device"


def test_status_dump_lists_live_services(svc):
    st = port_service.status_dump()["services"]["test.serve"]
    assert st["epoch"] == svc.epoch
    assert st["queries"] > 0
    assert 0 in st["pools"]
    assert st["config"]["block"] == svc.config.block


def test_checkpoint_restart_resumes_epoch_and_answers_identically(
        tmp_path):
    P = port_pkg()
    ck = str(tmp_path / "serve_ck.json")
    s1 = _svc(P, _map(P), "test.ck1", checkpoint=ck)
    try:
        for _ in range(2):
            assert s1.apply(_reweight(P, s1.epoch + 1, 1, 0.75))["ok"]
        epoch = s1.epoch
        digest = s1.sample_digest()
        spot = s1.lookup_batch(0, np.arange(16))
    finally:
        s1.close()
    s2 = P.service.PlacementService(config=_cfg(P), checkpoint=ck,
                                    resume=True, name="test.ck2",
                                    device="cpu")
    try:
        assert s2.resumed_from == epoch and s2.epoch == epoch
        assert s2.sample_digest() == digest
        again = s2.lookup_batch(0, np.arange(16))
        assert _rows(again) == _rows(spot)
    finally:
        s2.close()


def test_resume_without_state_raises(tmp_path):
    P = port_pkg()
    with pytest.raises(ValueError, match="needs a map"):
        P.service.PlacementService(
            config=_cfg(P), checkpoint=str(tmp_path / "empty.json"),
            resume=True, device="cpu")


def test_query_block_matches_host_oracle(svc):
    rng = np.random.default_rng(7)
    seeds = rng.integers(0, N_PGS, 500).astype(np.uint32)
    r = svc.query_block(0, seeds)
    assert r.ok and r.source == "device" and r.epoch == svc.epoch
    _held_to_oracle(r, svc._active.m, 0, seeds)
    for i in (0, 137, 499):  # the scalar edge gives the same answers
        s = svc.submit(0, int(seeds[i]))
        assert s.ok
        assert np.array_equal(s.acting[0], r.acting[i])
        assert int(s.acting_primary[0]) == int(r.acting_primary[i])


def test_bulk_partial_shed_answers_every_lane(svc):
    cap = svc.config.max_queue * svc.config.block
    n = cap + 488
    seeds = (np.arange(n, dtype=np.uint32) * 3) % N_PGS
    r = svc.query_block(0, seeds)
    assert r.counts() == {"ok": cap, "EBUSY": n - cap}
    assert "capacity" in r.error
    _, _, act, actp = _oracle_rows(svc._active.m, 0, seeds[:cap],
                                   r.up.shape[1])
    assert np.array_equal(r.acting[:cap], act)
    assert np.array_equal(r.acting_primary[:cap], actp)
    assert (r.acting[cap:] == ITEM_NONE).all()
    assert (r.acting_primary[cap:] == -1).all()


def test_bulk_deadline_expiry_answers_etimedout_remainder(svc):
    sub = max(svc.config.bulk_max, svc.config.block)
    seeds = np.arange(2 * sub, dtype=np.uint32) % N_PGS
    faults.arm("serve_dispatch.test.serve", "stall", "0.5", 1)
    try:
        r = svc.query_block(0, seeds, deadline_s=0.25)
    finally:
        faults.disarm("serve_dispatch.test.serve")
    assert r.counts() == {"ok": sub, "ETIMEDOUT": sub}
    assert "deadline" in r.error
    _, _, act, actp = _oracle_rows(svc._active.m, 0, seeds[:sub],
                                   r.up.shape[1])
    assert np.array_equal(r.acting[:sub], act)
    assert np.array_equal(r.acting_primary[:sub], actp)


def test_bulk_and_scalar_interleave_equivalence(svc):
    rng = np.random.default_rng(11)
    scalar_out: list = []
    stop = threading.Event()

    def scalar_client():
        srng = np.random.default_rng(12)
        while not stop.is_set():
            s = int(srng.integers(0, N_PGS))
            scalar_out.append((s, svc.submit(0, s)))

    t = threading.Thread(target=scalar_client)
    t.start()
    try:
        m = svc._active.m
        for _ in range(3):
            seeds = rng.integers(0, N_PGS, 300).astype(np.uint32)
            r = svc.query_block(0, seeds)
            assert r.ok
            _held_to_oracle(r, m, 0, seeds)
    finally:
        stop.set()
        t.join(timeout=30)
    assert scalar_out and all(rep.ok for _, rep in scalar_out)
    for s, rep in scalar_out[:20]:
        _held_to_oracle(rep, svc._active.m, 0, np.asarray([s]))


def test_submit_many_mixed_pools_scatters_in_input_order(svc2):
    m = svc2._active.m
    p0, p1 = sorted(m.pools)[:2]
    rng = np.random.default_rng(23)
    pools = rng.choice([p0, p1], 240)
    lo = min(m.pools[p0].pg_num, m.pools[p1].pg_num)
    seeds = rng.integers(0, lo, 240).astype(np.uint32)
    r = svc2.submit_many(pools, seeds)
    assert r.ok and r.epoch == svc2.epoch
    W = r.up.shape[1]
    assert W == max(m.pools[p0].size, m.pools[p1].size)
    for pid in (p0, p1):
        mask = pools == pid
        up, upp, act, actp = _oracle_rows(m, pid, seeds[mask], W)
        assert np.array_equal(r.up[mask], up)
        assert np.array_equal(r.acting[mask], act)
        assert np.array_equal(r.acting_primary[mask], actp)
    one = svc2.submit_many([p0], seeds[:16])
    assert one.ok and one.up.shape[1] == m.pools[p0].size
    bad = svc2.submit_many(pools[:5], seeds[:7])
    assert bad.counts() == {"EFAULT": 7} and "mismatch" in bad.error


def test_closed_service_answers_eshutdown():
    P = port_pkg()
    s = _svc(P, P.meshcheck.build_default(pgs=64, osds=8), "test.shut")
    s.close()
    assert s.query_block(0, np.arange(8)).counts() == {"ESHUTDOWN": 8}
    assert s.lookup(0, 0).status == "ESHUTDOWN"
    assert "test.shut" not in port_service.status_dump()["services"]


def test_serve_status_carries_bulk_and_swap_surface(svc):
    st = svc.status()
    assert st["bulk_blocks"] >= 1
    assert st["bulk_lookups"] >= 1
    assert st["structural_swap_stalls"] == 0
    # nothing is compiled: no overlay variant to prewarm (by design)
    assert "prewarmed_structures" not in st
    assert st["config"]["bulk_max"] == svc.config.bulk_max
    assert st["batch_fill_p50"] is not None
    assert st["batch_fill_p99"] is not None
    assert st["mesh"]["devices"] == 1


def test_structural_and_value_swaps_count_and_stage(svc):
    """Value-only epochs fork (`swap_delta_applies`), structural ones
    restage on the staging stream (`swap_full_restages`,
    `warm_stages`), each answering the host oracle after its flip."""
    P = port_pkg()
    c0 = dict(port_service.COUNTERS)
    seeds = np.arange(N_PGS, dtype=np.uint32)
    assert svc.apply(_overlay_inc(P, svc._active.m, svc.epoch + 1))["ok"]
    _held_to_oracle(svc.query_block(0, seeds), svc._active.m, 0, seeds)
    inc = P.Incremental(epoch=svc.epoch + 1)
    inc.new_max_osd = svc._active.m.max_osd + 2
    assert svc.apply(inc)["ok"]
    _held_to_oracle(svc.query_block(0, seeds), svc._active.m, 0, seeds)
    d = {k: port_service.COUNTERS[k] - c0[k] for k in (
        "swap_delta_applies", "swap_full_restages", "warm_stages",
        "structural_swap_stalls", "epoch_swaps")}
    assert d == {"swap_delta_applies": 1, "swap_full_restages": 1,
                 "warm_stages": 1, "structural_swap_stalls": 0,
                 "epoch_swaps": 2}


def _buffer_tensors(buf) -> dict:
    out = {}
    st = buf.state
    for k, v in st._vec_buf.items():
        out[f"vec.{k}"] = v
    for key, T in st._tables.items():
        for f, v in vars(T).items():
            if isinstance(v, torch.Tensor):
                out[f"table.{key}.{f}"] = v
    for pid, pm in buf._mappers.items():
        for k, v in pm._ov.items():
            out[f"ov.{pid}.{k}"] = v
        for k, v in pm.dev.items():
            out[f"dev.{pid}.{k}"] = v
    return out


def test_captured_buffer_is_never_written_after_a_flip(svc):
    """A reader that captured a buffer keeps its bytes: the value-only
    forks copy the vectors before their scatter, the structural stage
    builds new tables, and no tensor of the captured buffer changes."""
    P = port_pkg()
    assert svc.apply(_overlay_inc(P, svc._active.m, svc.epoch + 1))["ok"]
    buf = svc._active
    seeds = np.arange(N_PGS, dtype=np.uint32)
    before = buf.mapper(0).map_batch(seeds)
    snap = {k: v.clone() for k, v in _buffer_tensors(buf).items()}
    assert any(k.startswith("ov.") for k in snap)
    incs = [_reweight(P, buf.epoch + 1, 3, 0.25)]
    down = P.Incremental(epoch=buf.epoch + 2)
    down.new_state[4] = 1 << 1
    incs.append(down)
    incs.append(_overlay_inc(P, buf.m, buf.epoch + 3))
    grow = P.Incremental(epoch=buf.epoch + 4)
    grow.new_max_osd = buf.m.max_osd + 1
    incs.append(grow)
    for inc in incs:
        assert svc.apply(inc)["ok"]
    assert svc._active is not buf
    after = _buffer_tensors(buf)
    assert sorted(after) == sorted(snap)
    for k, v in snap.items():
        assert torch.equal(after[k], v), k
    for a, b in zip(before, buf.mapper(0).map_batch(seeds)):
        assert np.array_equal(a, b)


def test_front_bit_identical_and_staggered_fanout():
    P = port_pkg()
    f = P.front.ServeFront(_map(P), replicas=2, config=_cfg(P),
                           name="test.front", device="cpu")
    try:
        seeds = np.random.default_rng(3).integers(0, N_PGS, 300)
        r = f.query_block(0, seeds)
        assert r.ok and r.epoch == f.epoch
        _held_to_oracle(r, f.replicas[0]._active.m, 0, seeds)
        sc = f.lookup(0, int(seeds[0]))
        assert sc.ok and np.array_equal(sc.acting[0], r.acting[0])
        e0 = f.epoch
        res = f.apply(_reweight(P, e0 + 1, 3, 0.5))
        assert res["ok"] and f.epoch == e0 + 1
        assert [rep.epoch for rep in f.replicas] == [e0 + 1, e0 + 1]
        st = f.status()
        assert st["front_staggered_swaps"] >= 1 and st["staging"] == []
        r2 = f.query_block(0, seeds)
        assert r2.ok and r2.epoch == e0 + 1
        _held_to_oracle(r2, f.replicas[0]._active.m, 0, seeds)
        # answers are the same whichever replica answers
        for rep in f.replicas:
            assert _sha(rep.query_block(0, seeds)) == _sha(r2)
    finally:
        f.close()


def test_front_sheds_stalled_replica(monkeypatch):
    """An injected stall on ONE replica is absorbed: the front sheds it,
    remaps only its lanes, and every block answers ok with the rows the
    other replica gives."""
    P = port_pkg()
    f = P.front.ServeFront(_map(P), replicas=2, config=_cfg(P),
                           name="test.shed", device="cpu")
    try:
        seeds = np.arange(64, dtype=np.uint32)
        ref = f.replicas[0].query_block(0, seeds)
        t0 = time.perf_counter()
        for _ in range(3):  # settle both replicas' latency EWMA
            assert f.query_block(0, seeds).ok
        # the stall outweighs a block 30 times over, whatever the speed
        # of this machine, so one stalled block breaches SHED_FACTOR
        stall = max(0.5, 10 * (time.perf_counter() - t0))
        # the shed replica's hold scales with the same measured interval:
        # it outlasts the five blocks after the stall (about a sixth of
        # the stall on any machine), so they route around the replica
        monkeypatch.setattr(P.front, "SHED_PROBE_S", 2 * stall)
        st0 = f.status()
        faults.arm("serve_dispatch.test.shed.r1", "stall", str(stall), 1)
        try:
            replies = [f.query_block(0, seeds) for _ in range(6)]
        finally:
            faults.disarm("serve_dispatch.test.shed.r1")
        assert len(replies) == 6
        assert all(r.ok and _sha(r) == _sha(ref) for r in replies)
        st = f.status()
        assert st["front_replica_sheds"] > st0["front_replica_sheds"]
        assert st["front_shed_routes"] > st0["front_shed_routes"]
    finally:
        f.close()


def test_front_rendezvous_moves_only_the_excluded_lanes():
    """Excluding a replica remaps only the lanes it owned (the
    rendezvous property), with the JAX front's hash."""
    P, J = port_pkg(), jax_pkg()
    seeds = np.arange(4096, dtype=np.uint32)
    x = seeds.astype(np.uint64)
    assert np.array_equal(P.front._mix64(x), J.front._mix64(x))
    f = P.front.ServeFront(_map(P), replicas=3, config=_cfg(P),
                           name="test.rdv", device="cpu")
    try:
        full = f._owners(0, seeds, [0, 1, 2])
        part = f._owners(0, seeds, [0, 2])
        assert set(np.unique(full)) == {0, 1, 2}
        moved = full != part
        assert (full[moved] == 1).all() and not (part == 1).any()
    finally:
        f.close()


if __name__ == "__main__":
    import tempfile

    sys.path.insert(0, str(ROOT / "tests"))
    import conftest  # noqa: F401  (JAX on the CPU)

    from test_torch_serve_cli import jax_cli_outputs

    J = jax_pkg()
    with tempfile.TemporaryDirectory() as tmp:
        ck = case_checkpoint(J, Path(tmp) / "ck.json")
    out = {"cases": {name: fn(J) for name, fn in sorted(CASES.items())},
           "checkpoint": ck}
    CORPUS.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    with tempfile.TemporaryDirectory() as tmp:
        out["cli"] = jax_cli_outputs(Path(tmp))
    CORPUS.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote {CORPUS}")
