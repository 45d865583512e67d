"""Pareto-front reduction over per-cluster fleet outcomes.

The port of `ceph_tpu/fleet/pareto.py` (pure functions, copied: the same
points give the same front and the same triage table, byte for byte).

A fleet run turns N clusters into N outcome points; the interesting
output is not any single point but the non-dominated *front* over

    cluster_years_per_hour   higher is better (simulation throughput)
    served_qps               higher is better (client traffic kept)
    pg_lost                  lower is better  (irreversible data loss)
    exposure                 lower is better  (PG-epochs spent past
                                               tolerance)

Dominated points are kept with full accounting — which front point
dominated them — because the triage question for a dominated
configuration is always "what should this cluster have been instead".
"""

from __future__ import annotations

from dataclasses import dataclass, field

# (key, higher_is_better) in headline order
OBJECTIVES: tuple[tuple[str, bool], ...] = (
    ("cluster_years_per_hour", True),
    ("served_qps", True),
    ("pg_lost", False),
    ("exposure", False),
)


@dataclass
class Point:
    """One cluster's outcome: its fleet index, pinned spec, and the
    objective values."""

    index: int
    spec: str
    values: dict[str, float]
    dominated_by: int | None = None  # front point index, set by reduce
    front: bool = field(default=False)

    @classmethod
    def from_summary(cls, index: int, spec: str, summary: dict)\
            -> "Point":
        par = summary.get("pareto") or {}
        dur = summary.get("durability") or {}
        return cls(index=index, spec=spec, values={
            "cluster_years_per_hour": float(
                par.get("cluster_years_per_hour",
                        summary.get("cluster_years_per_hour", 0.0))),
            "served_qps": float(par.get("served_qps", 0.0)),
            "pg_lost": float(dur.get("pg_lost", 0)),
            "exposure": float(dur.get("exposure_pg_epochs",
                                      dur.get("exposure", 0))),
        })


def dominates(a: dict, b: dict) -> bool:
    """True when `a` is at least as good as `b` on every objective and
    strictly better on at least one."""
    strict = False
    for key, higher in OBJECTIVES:
        av, bv = a[key], b[key]
        if higher:
            if av < bv:
                return False
            strict = strict or av > bv
        else:
            if av > bv:
                return False
            strict = strict or av < bv
    return strict


def pareto_front(points: list[Point]) -> tuple[list[Point],
                                               list[Point]]:
    """Split points into (front, dominated); each dominated point's
    `dominated_by` names one front point that dominates it."""
    front: list[Point] = []
    dominated: list[Point] = []
    for p in points:
        p.front = not any(dominates(q.values, p.values)
                          for q in points if q is not p)
    for p in points:
        if p.front:
            front.append(p)
            continue
        for q in points:
            if q.front and dominates(q.values, p.values):
                p.dominated_by = q.index
                break
        dominated.append(p)
    return front, dominated


def triage_table(points: list[Point], max_spec: int = 48) -> str:
    """Human triage view: front members first, then dominated points
    with the front index that beats them."""
    front, dominated = ([p for p in points if p.front],
                        [p for p in points if not p.front])
    head = ("idx", "front", "cyrs/h", "qps", "pg_lost", "exposure",
            "beaten-by", "spec")
    rows = [head]
    for p in sorted(points, key=lambda p: (not p.front, p.index)):
        v = p.values
        spec = p.spec if len(p.spec) <= max_spec \
            else p.spec[:max_spec - 1] + "…"
        rows.append((
            str(p.index), "*" if p.front else "",
            f"{v['cluster_years_per_hour']:.3f}",
            f"{v['served_qps']:.1f}",
            f"{int(v['pg_lost'])}", f"{int(v['exposure'])}",
            "" if p.dominated_by is None else str(p.dominated_by),
            spec,
        ))
    widths = [max(len(r[c]) for r in rows) for c in range(len(head))]
    lines = ["  ".join(cell.ljust(w) for cell, w in zip(r, widths))
             .rstrip() for r in rows]
    lines.append(f"front {len(front)} / dominated {len(dominated)} "
                 f"of {len(points)} clusters")
    return "\n".join(lines)
