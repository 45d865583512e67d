"""Prometheus text exposition (format 0.0.4) over the perf registry.

The port of `ceph_tpu/obs/prometheus.py`: the same kind mapping, names
(`ceph_tpu_<group>_<key>`, so dashboards read either package) and
escaping.

Mapping from perf-counter kinds (the kind comes from the declaration
schema — `perf_schema()` — never from duck-typing the dump's value
shapes, which broke the moment two kinds shared a shape):

    u64        -> counter      ceph_tpu_<group>_<key>
    avg        -> summary      _sum / _count
    time_avg   -> summary      _sum / _count (seconds)
    histogram  -> histogram    cumulative _bucket{le=...} / _sum / _count
    quantile   -> histogram    same series (Prometheus-side quantile
                               estimation stays possible); the in-process
                               p50/p90/p99 estimates live in `perf dump`

Group and key names are sanitized to the Prometheus metric charset
([a-zA-Z_][a-zA-Z0-9_]*); '.' and '-' become '_'.
"""

from __future__ import annotations

import re

from ceph_tpu_torch.utils.perf_counters import perf_schema

_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _name(group: str, key: str) -> str:
    return _BAD.sub("_", f"ceph_tpu_{group}_{key}")


def escape_label(label: str) -> str:
    """Prometheus label-value escaping (`\\`, `"`, newline).  Any gauge
    whose label embeds an operator- or user-chosen string (plan names,
    health summaries, timeline series) must route through this — raw
    interpolation corrupts the exposition on the first quote."""
    return (label.replace("\\", "\\\\")
                 .replace('"', '\\"')
                 .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    if isinstance(v, float) and v != v:  # NaN
        return "NaN"
    return repr(v) if isinstance(v, float) else str(v)


def _infer_kind(v) -> str | None:
    """Fallback for dumps with no schema entry (foreign snapshots, e.g.
    a BENCH_partial.json perf blob rendered offline).  Registry-backed
    dumps always resolve through the schema instead.  None means 'not a
    counter value, skip it' — a saved `perf dump` reply also carries the
    embedded executables registry section, whose dicts are not
    counters."""
    if isinstance(v, dict):
        if "buckets" in v:
            return "quantile" if "p50" in v else "histogram"
        if "avgcount" in v and "sum" in v:
            return "avg"
        return None
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return "u64"
    return None


def prometheus_text(dump: dict, schema: dict | None = None) -> str:
    """Render a perf_dump() dict; `schema` (perf_schema()) supplies the
    authoritative kinds and HELP strings."""
    schema = schema if schema is not None else perf_schema()
    lines: list[str] = []
    for group in sorted(dump):
        grp = dump[group]
        if not isinstance(grp, dict) or group == "executables":
            # a saved admin-socket `perf dump` reply embeds the
            # executables registry section; it has its own exposition
            # (executables.prometheus_gauges) — rendering its scalar
            # fields as counters here would collide with those series
            continue
        for key in sorted(grp):
            v = grp[key]
            name = _name(group, key)
            meta = (schema.get(group) or {}).get(key, {})
            desc = meta.get("description") or f"{group}.{key}"
            kind = meta.get("type") or _infer_kind(v)
            if kind is None:
                continue
            lines.append(f"# HELP {name} {desc}")
            if kind == "u64":
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {_fmt(v)}")
            elif kind in ("avg", "time_avg"):
                lines.append(f"# TYPE {name} summary")
                lines.append(f"{name}_sum {_fmt(float(v['sum']))}")
                lines.append(f"{name}_count {v['avgcount']}")
            elif kind in ("histogram", "quantile"):
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for bound, n in zip(v["bounds"], v["buckets"]):
                    cum += n
                    lines.append(
                        f'{name}_bucket{{le="{_fmt(float(bound))}"}} {cum}'
                    )
                lines.append(f'{name}_bucket{{le="+Inf"}} {sum(v["buckets"])}')
                lines.append(f"{name}_sum {_fmt(float(v['sum']))}")
                lines.append(f"{name}_count {v['count']}")
            else:  # an unknown declared kind is a schema bug: say so
                lines.append(f"# TYPE {name} untyped")
                lines.append(f"{name} NaN")
    return "\n".join(lines) + "\n"
