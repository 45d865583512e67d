"""Placement-decision observability: the surface over the CRUSH
diagnostics.

The port of `ceph_tpu/obs/placement.py`.  The rule kernel fuses millions
of `crush_do_rule` calls into one launch, and every decision inside it
(retries, collisions, out-of-weight rejections, bad mappings) is
invisible from the outside.  The kernel's diagnostics variant
(`crush/mapper.py::diag_rule`) re-exposes them as device planes, and
`PoolMapper.diagnose` reduces them to a summary; this module is where
those summaries become operator-visible state:

- `COUNTERS`, the decision tallies summed over every recorded summary
  (the JAX package's `placement` perf group's counters, with its
  `choose_tries` histogram as a list, index == retry count);
- a per-source snapshot store (`record()` / `dump()`): the latest
  summary per producer ("pool0", "sim", "mgr.<plan>");
- an explainer registry (`register_explainer()` / `explain()`): a
  PoolMapper publishes a host-oracle replay closure so `explain
  <pool>.<seed>` answers for the maps it serves.

Prometheus gauges and the admin socket wait for the rest of `obs/`.
No torch at module load: the summaries are plain Python here.
"""

from __future__ import annotations

import threading

# retry counts are small non-negative ints; integer bounds make the
# histogram exact (value == bound), and 0..63 covers every tunable
# default (choose_total_tries=50) with headroom for SET_CHOOSE_TRIES
TRIES_BOUNDS = list(range(64))

COUNTERS: dict = dict.fromkeys((
    "pgs_diagnosed", "bad_mappings", "retry_exhausted", "collisions",
    "rejections_out", "skips", "unresolved_masked"), 0)
COUNTERS["choose_tries"] = [0] * len(TRIES_BOUNDS)

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
    """Book one diagnostics summary into COUNTERS and the snapshot
    store.  `summary` is the plain-python dict PoolMapper.diagnose
    produces: pgs, bad_mappings, retry_exhausted, collisions,
    rejections, skips, unresolved, tries_histogram (list[int], index ==
    retry count), diag_exact.  Returns the summary (for chaining)."""
    with _lock:
        for key, name in (("pgs_diagnosed", "pgs"),
                          ("bad_mappings", "bad_mappings"),
                          ("retry_exhausted", "retry_exhausted"),
                          ("collisions", "collisions"),
                          ("rejections_out", "rejections"),
                          ("skips", "skips"),
                          ("unresolved_masked", "unresolved")):
            COUNTERS[key] += int(summary.get(name, 0))
        hist = COUNTERS["choose_tries"]
        for i, v in enumerate(summary.get("tries_histogram") or []):
            if i < len(hist):
                hist[i] += int(v)
        _snapshots[source] = dict(summary)
    return summary


def dump() -> dict:
    """The latest snapshot per source, the counters and the registered
    explainers."""
    with _lock:
        return {
            "sources": {k: dict(v) for k, v in _snapshots.items()},
            "counters": {k: list(v) if isinstance(v, list) else v
                         for k, v in COUNTERS.items()},
            "explainers": sorted(_explainers),
        }


def reset() -> None:
    """Test isolation: drop snapshots and explainers, zero COUNTERS."""
    with _lock:
        _snapshots.clear()
        _explainers.clear()
        for k, v in COUNTERS.items():
            COUNTERS[k] = [0] * len(v) if isinstance(v, list) else 0


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
