"""Cluster health model: Ceph-coded checks over already-fetched state.

The port of `ceph_tpu/obs/health.py`.  The reference's `ceph status`
collapses cluster state into HEALTH_OK/WARN/ERR plus coded checks
(OSD_DOWN, PG_DEGRADED, ...).  This module is that model: a registry of
check codes, a process-global table of the raised checks, and an
`evaluate()` helper the lifetime simulator and `osdmaptool --health` feed
with host integers they already computed.

Health evaluation is a pure observer: it launches no device work, forces
no fetch and feeds no replay digest.  `CEPH_TPU_HEALTH=0` turns it off,
and that changes no digest.

Muting mirrors `ceph health mute`: codes listed in `CEPH_TPU_HEALTH_MUTE`
(comma-separated) still evaluate and dump, but do not count in the
summarized status.

It books the JAX package's `health` perf group (`COUNTERS` reads it)
and `health.raised` / `health.cleared` instants; `prometheus_gauges()`
is the JAX exposition of the raised checks.
"""

from __future__ import annotations

import threading

from ceph_tpu_torch.obs import trace
from ceph_tpu_torch.obs.prometheus import escape_label
from ceph_tpu_torch.utils import knobs
from ceph_tpu_torch.utils.perf_counters import counters_attr, logger_for

# The check registry: code -> what raises it (the JAX package's).
HEALTH_CHECKS: dict[str, str] = {
    "OSD_DOWN": "existing OSDs are down (exists bit set, up bit clear)",
    "PG_DEGRADED": "PGs have fewer valid replicas/shards than pool size",
    "PG_UNMAPPED": "PGs have no valid mapping at all (data unavailable)",
    "PG_AT_RISK": "PGs lost more shards than the EC profile tolerates",
    "RECOVERY_BACKLOG": "recovery queue holds unrecovered bytes",
    "SLO_BURN": "serve SLO error budget is burning (see serve/slo.py)",
    "DEVICE_DEGRADED": "runtime fell back to host mapping after device loss",
    "DATA_LOSS": "PGs lost more chunks than tolerance before recovery "
                 "drained — irreversible; never auto-clears (raised "
                 "directly, outside evaluate(), so only an explicit "
                 "operator clear()/reset() removes it)",
}

OK = "HEALTH_OK"
WARN = "HEALTH_WARN"
ERR = "HEALTH_ERR"
_RANK = {OK: 0, WARN: 1, ERR: 2}

_L = logger_for("health")
_L.add_u64("checks_raised", "health checks raised (OK->non-OK transitions)")
_L.add_u64("checks_cleared", "health checks cleared (non-OK->OK transitions)")
_L.add_u64("evaluations", "evaluate() calls over already-fetched state")
__getattr__ = counters_attr("health", __name__, (
    "checks_raised", "checks_cleared", "evaluations"))

_lock = threading.Lock()
# code -> {"severity", "summary", "count", "detail": [..]}
_checks: dict[str, dict] = {}


def enabled() -> bool:
    return knobs.get("CEPH_TPU_HEALTH", "1") != "0"


def rank(severity: str) -> int:
    """Numeric rank of a status string (OK=0, WARN=1, ERR=2), the
    encoding timelines and Prometheus gauges record."""
    return _RANK[severity]


def muted() -> frozenset[str]:
    raw = knobs.get("CEPH_TPU_HEALTH_MUTE", "")
    return frozenset(c.strip() for c in raw.split(",") if c.strip())


def raise_check(code: str, severity: str, summary: str,
                detail: tuple[str, ...] = (), count: int = 0) -> bool:
    """Raise (or refresh) a check; True on the OK->raised transition."""
    if code not in HEALTH_CHECKS:
        raise KeyError(f"undeclared health check code {code!r}")
    if severity not in (WARN, ERR):
        raise ValueError(f"severity must be {WARN} or {ERR}, got {severity!r}")
    with _lock:
        fresh = code not in _checks
        _checks[code] = {
            "severity": severity,
            "summary": summary,
            "count": int(count),
            "detail": list(detail)[:8],
        }
    if fresh:
        _L.inc("checks_raised")
        trace.instant("health.raised", code=code, severity=severity)
    return fresh


def clear(code: str) -> bool:
    """Clear a check; True on the raised->OK transition."""
    if code not in HEALTH_CHECKS:
        raise KeyError(f"undeclared health check code {code!r}")
    with _lock:
        was = _checks.pop(code, None) is not None
    if was:
        _L.inc("checks_cleared")
        trace.instant("health.cleared", code=code)
    return was


def _set(code: str, active: bool, severity: str, summary: str,
         count: int = 0, detail: tuple[str, ...] = ()) -> None:
    if active:
        raise_check(code, severity, summary, detail=detail, count=count)
    else:
        clear(code)


def evaluate(*, osds_down: int = 0, osd_count: int = 0, degraded: int = 0,
             unmapped: int = 0, at_risk: int = 0, backlog_gb: float = 0.0,
             device_degraded: int = 0,
             detail: tuple[str, ...] = ()) -> str:
    """Map standard host-side reductions onto the standard checks and
    return the summarized status.  Every argument is a plain int/float
    the caller already holds.

    Latched checks (DATA_LOSS) are not evaluated here: `_set` would clear
    them on the first healthy epoch.  Callers raise them directly with
    `raise_check`, and the returned status still reflects them."""
    if not enabled():
        return OK
    _L.inc("evaluations")
    _set("OSD_DOWN", osds_down > 0, WARN,
         f"{osds_down}/{osd_count} osds down", count=osds_down, detail=detail)
    _set("PG_DEGRADED", degraded > 0, WARN,
         f"{degraded} pgs degraded", count=degraded)
    _set("PG_UNMAPPED", unmapped > 0, ERR,
         f"{unmapped} pgs unmapped", count=unmapped)
    _set("PG_AT_RISK", at_risk > 0, ERR,
         f"{at_risk} pgs past EC tolerance", count=at_risk)
    _set("RECOVERY_BACKLOG", backlog_gb > 0, WARN,
         f"{backlog_gb:.3f} GB awaiting recovery", count=int(backlog_gb))
    _set("DEVICE_DEGRADED", device_degraded > 0, WARN,
         f"{device_degraded} device-loss fallback(s) to host mapping",
         count=device_degraded)
    return status()


def checks() -> dict[str, dict]:
    """Snapshot of the currently-raised checks (copies)."""
    with _lock:
        return {c: dict(v) for c, v in _checks.items()}


def status() -> str:
    """Worst severity among currently-raised, non-muted checks."""
    m = muted()
    worst = OK
    with _lock:
        for code, v in _checks.items():
            if code in m:
                continue
            if _RANK[v["severity"]] > _RANK[worst]:
                worst = v["severity"]
    return worst


def summary() -> dict:
    """The `ceph status`-shaped view: status + per-check one-liners."""
    snap = checks()
    m = muted()
    return {
        "status": status(),
        "checks": {
            code: {
                "severity": v["severity"],
                "summary": v["summary"],
                "count": v["count"],
                "muted": code in m,
            }
            for code, v in sorted(snap.items())
        },
    }


def dump() -> dict:
    """Full detail view: summary() plus each check's detail lines, the
    muted codes and the registry."""
    out = summary()
    snap = checks()
    for code, v in out["checks"].items():
        v["detail"] = snap[code]["detail"]
    out["muted"] = sorted(muted())
    out["registry"] = dict(HEALTH_CHECKS)
    return out


def reset() -> None:
    with _lock:
        _checks.clear()


def prometheus_gauges() -> str:
    """`ceph_tpu_health_status` (0/1/2) plus one labelled gauge per
    raised check.  Check summaries embed operator-visible strings, so
    label values go through the shared escaper."""
    snap = checks()
    m = muted()
    lines = [
        "# HELP ceph_tpu_health_status cluster health (0=OK 1=WARN 2=ERR)",
        "# TYPE ceph_tpu_health_status gauge",
        f"ceph_tpu_health_status {_RANK[status()]}",
        "# HELP ceph_tpu_health_check per-check count (labels: code, "
        "severity, summary, muted)",
        "# TYPE ceph_tpu_health_check gauge",
    ]
    for code, v in sorted(snap.items()):
        lines.append(
            f'ceph_tpu_health_check{{code="{escape_label(code)}",'
            f'severity="{escape_label(v["severity"])}",'
            f'summary="{escape_label(v["summary"])}",'
            f'muted="{int(code in m)}"}} {int(v["count"])}'
        )
    return "\n".join(lines) + "\n"
