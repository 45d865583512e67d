"""Placement-decision observability: the surface over the CRUSH
diagnostics.

The port of `ceph_tpu/obs/placement.py`.  The rule kernel fuses millions
of `crush_do_rule` calls into one launch, and every decision inside it
(retries, collisions, out-of-weight rejections, bad mappings) is
invisible from the outside.  The kernel's diagnostics variant
re-exposes them, as device planes (`crush/mapper.py::diag_rule`) or
added up into a summary inside the launch
(`crush_rule_diag_summary_cuda`, which `PoolMapper.diagnose` runs);
this module is where those summaries become operator-visible state:

- the JAX package's `placement` perf group: the decision tallies summed
  over every recorded summary and the `choose_tries` histogram (bucket
  value == retry count), read by `COUNTERS` (`choose_tries` there as
  its list of buckets);
- a per-source snapshot store (`record()` / `dump()`): the latest
  summary per producer ("pool0", "sim", "mgr.<plan>");
- an explainer registry (`register_explainer()` / `explain()`): a
  PoolMapper publishes a host-oracle replay closure so `explain
  <pool>.<seed>` answers for the maps it serves.

`prometheus_gauges()` exposes the per-source numbers, `dump()` is the
admin socket's `bad dump`.  No torch at module load: the summaries are
plain Python here.  Unlike the JAX package's, `reset()` also zeroes
the group.
"""

from __future__ import annotations

import threading

from ceph_tpu_torch.obs.prometheus import escape_label
from ceph_tpu_torch.utils.perf_counters import logger_for

# retry counts are small non-negative ints; integer bounds make the
# histogram exact (value == bound), and 0..63 covers every tunable
# default (choose_total_tries=50) with headroom for SET_CHOOSE_TRIES
TRIES_BOUNDS = list(range(64))

_L = logger_for("placement")
_L.add_u64("pgs_diagnosed",
           "PGs run through the instrumented (with_diag) pipeline")
_L.add_u64("bad_mappings",
           "diagnosed PGs whose CRUSH result was shorter than numrep "
           "(the tester's bad-mapping test, on device)")
_L.add_u64("retry_exhausted",
           "diagnostics lanes left unplaced (-1 retry marker): the "
           "choose walk ran out of tries or candidates")
_L.add_u64("collisions",
           "duplicate-item rejections across diagnosed choose draws")
_L.add_u64("rejections_out",
           "out-of-weight (is_out) rejections across diagnosed draws")
_L.add_u64("skips",
           "skip_rep draws (dead source bucket / wrong item type / "
           "exhausted count) across diagnosed choose walks")
_L.add_u64("unresolved_masked",
           "diagnosed lanes excluded from the planes because the fast "
           "window flagged them (rescued exactly elsewhere)")
_L.add_histogram(
    "choose_tries", TRIES_BOUNDS,
    "per-placement retry histogram folded from the device diagnostics "
    "planes (the reference collect_choose_tries shape; bucket value == "
    "retry count)")
_L.add_quantile(
    "diagnose_seconds",
    "instrumented-pipeline dispatch wall time per diagnose() block")
_U64 = ("pgs_diagnosed", "bad_mappings", "retry_exhausted", "collisions",
        "rejections_out", "skips", "unresolved_masked")


def __getattr__(name: str):
    """`COUNTERS`: the group's tallies, `choose_tries` as its buckets."""
    if name == "COUNTERS":
        d = _L.dump()
        out = {k: d[k] for k in _U64}
        out["choose_tries"] = d["choose_tries"]["buckets"][:len(TRIES_BOUNDS)]
        return out
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_lock = threading.Lock()
_snapshots: dict[str, dict] = {}
_explainers: dict[str, object] = {}


def fold_summary(agg: dict, s: dict) -> dict:
    """Elementwise-fold one diagnostics summary into an aggregate (the
    per-epoch shape sim/ and the balancer book): scalar tallies sum,
    retry histograms sum index-wise, diag_exact ANDs.  Returns `agg` (for
    chaining)."""
    for k in ("pgs", "bad_mappings", "retry_exhausted", "collisions",
              "rejections", "skips", "unresolved"):
        agg[k] = agg.get(k, 0) + int(s.get(k, 0))
    hist = s.get("tries_histogram") or []
    ah = agg.setdefault("tries_histogram", [])
    if len(ah) < len(hist):
        ah.extend([0] * (len(hist) - len(ah)))
    for i, v in enumerate(hist):
        ah[i] += int(v)
    agg["diag_exact"] = bool(agg.get("diag_exact", True)
                             and s.get("diag_exact", False))
    return agg


def record(source: str, summary: dict) -> dict:
    """Book one diagnostics summary into the perf group and the
    snapshot store.  `summary` is the plain-python dict PoolMapper.diagnose
    produces: pgs, bad_mappings, retry_exhausted, collisions,
    rejections, skips, unresolved, tries_histogram (list[int], index ==
    retry count), diag_exact.  Returns the summary (for chaining)."""
    _L.inc("pgs_diagnosed", int(summary.get("pgs", 0)))
    _L.inc("bad_mappings", int(summary.get("bad_mappings", 0)))
    _L.inc("retry_exhausted", int(summary.get("retry_exhausted", 0)))
    _L.inc("collisions", int(summary.get("collisions", 0)))
    _L.inc("rejections_out", int(summary.get("rejections", 0)))
    _L.inc("skips", int(summary.get("skips", 0)))
    _L.inc("unresolved_masked", int(summary.get("unresolved", 0)))
    hist = summary.get("tries_histogram")
    if hist:
        _L.merge_histogram("choose_tries", list(hist))
    with _lock:
        _snapshots[source] = dict(summary)
    return summary


def dump() -> dict:
    """The daemon `bad dump` payload: latest snapshot per source plus
    the aggregate perf-group values."""
    with _lock:
        sources = {k: dict(v) for k, v in _snapshots.items()}
    return {
        "sources": sources,
        "counters": _L.dump(),
        "explainers": sorted(_explainers),
    }


def reset() -> None:
    """Test isolation: drop snapshots and explainers, zero the group."""
    with _lock:
        _snapshots.clear()
        _explainers.clear()
    _L.reset_values()


def register_explainer(key: str, fn) -> None:
    """Publish a replay closure `fn(x: int) -> dict` (the host-oracle
    decision log for one placement seed) under `key`: PoolMapper
    registers "pool<id>"."""
    with _lock:
        _explainers[key] = fn


def explain(pgid: str) -> dict:
    """`pgid` is "<pool>.<seed>" (the reference pgid spelling) or
    "<pool> <seed>".  Replays through the explainer registered under
    "pool<pool>"."""
    parts = pgid.replace(".", " ").split()
    if len(parts) != 2:
        return {"error": f"pgid {pgid!r} not of the form <pool>.<seed>"}
    key, x = f"pool{parts[0]}", parts[1]
    with _lock:
        fn = _explainers.get(key)
    if fn is None:
        with _lock:
            known = sorted(_explainers)
        return {"error": f"no explainer registered for {key!r}",
                "registered": known}
    try:
        return fn(int(x))
    except Exception as e:  # an operator's query reports, never raises
        return {"error": f"{type(e).__name__}: {e}"[:200]}


def prometheus_gauges() -> str:
    """Gauges for the snapshot-only numbers (per-source bad mappings /
    retry exhaustion); the placement perf-group counters render through
    the registry exposition."""
    with _lock:
        items = sorted(_snapshots.items())
    if not items:
        return ""
    lines = [
        "# HELP ceph_tpu_placement_source_bad_mappings latest diagnosed "
        "bad-mapping count per source",
        "# TYPE ceph_tpu_placement_source_bad_mappings gauge",
    ]
    for src, s in items:
        lines.append(
            "ceph_tpu_placement_source_bad_mappings"
            f'{{source="{escape_label(src)}"}} '
            f'{int(s.get("bad_mappings", 0))}'
        )
    lines += [
        "# HELP ceph_tpu_placement_source_retry_exhausted latest "
        "unplaced-lane count per source",
        "# TYPE ceph_tpu_placement_source_retry_exhausted gauge",
    ]
    for src, s in items:
        lines.append(
            "ceph_tpu_placement_source_retry_exhausted"
            f'{{source="{escape_label(src)}"}} '
            f'{int(s.get("retry_exhausted", 0))}'
        )
    return "\n".join(lines) + "\n"
