"""Fleet sweep grammar: one string expands into N pinned clusters.

The port of `ceph_tpu/fleet/spec.py`, over the port's `Scenario`: the
same grammar, registries, expansion order and error messages.  The
`backend` knob takes torch|jax|ref, with jax an alias of torch as in
`LifetimeSim`'s `BACKENDS`; a member keeps the spelling it was given (a
fleet checkpoint written with `backend=jax` resumes in either package).

A fleet spec is a semicolon-separated directive list:

    base=<scenario items>      the Scenario every member starts from
                               (comma-separated key=value, the exact
                               `Scenario.parse` grammar)
    axis=<key>:v1|v2|...       sweep axis: the cross-product over every
                               `axis=` directive (in declaration order)
                               expands into one member per combination
    clusters=N                 cycle the expanded combinations up to N
                               members; repetition r offsets `seed` by
                               r so repeated combinations stay
                               heterogeneous (never applied when seed
                               is itself a swept axis value of the
                               member — the pinned spec() wins)
    cluster=<i>:k=v,k=v        explicit post-expansion overrides for
                               member i (any Scenario field, or a
                               fleet-level knob)
    backend=torch|jax|ref      fleet-level knob: every member's engine
                               backend (per-member override via
                               `cluster=i:backend=...`); default torch

Example:

    base=epochs=16,pgs=64,ec=2+1;axis=seed:1|2|3;axis=p_death:0.02|0.1;
    clusters=12;backend=torch;cluster=0:correlated=1

Expansion yields `FleetMember`s whose `scenario.spec()` strings are
PINNED: the fleet checkpoint stores them verbatim, and resume refuses
any drift (count, order, or any single member's spec) with a
per-cluster diff — a resumed fleet can never silently mix
configurations.

`SWEEP_AXES` is the curated axis registry, a dict literal equal to the
JAX package's: every key names a `Scenario` field, and an `axis=`
directive outside the registry is a parse error, so the registry is the
sweep surface.  `FLEET_KNOBS` are the fleet-level keys that are not
Scenario fields.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, fields

from ceph_tpu_torch.sim.lifetime import BACKENDS, Scenario

# Curated sweep axes: key -> why you would sweep it (the JAX package's
# registry); every key is a `dataclasses.fields(Scenario)` name.
SWEEP_AXES: dict[str, str] = {
    "seed": "chaos trajectory replicas of one configuration",
    "epochs": "lifetime length (shorter screening vs longer soak)",
    "pgs": "replicated-pool scale (pg_num of the base pool)",
    "ec": "erasure profile k+m (redundancy vs overhead frontier)",
    "ec_pgs": "EC-pool scale",
    "hosts": "initial cluster width (failure-domain count)",
    "p_flap": "transient-failure pressure",
    "p_death": "permanent-loss pressure (durability stressor)",
    "correlated": "independent vs correlated failure regime",
    "recovery_mbps": "recovery-pipe budget (the repair/risk trade)",
    "max_backfills": "per-OSD recovery concurrency budget",
    "osd_mbps": "per-OSD bandwidth clients and recovery share",
    "balance_every": "mgr balancer cadence (0 disables)",
    "workload": "client traffic on/off (served_qps pareto axis)",
    "base_qps": "client load level",
}

# Fleet-level member keys that are NOT Scenario fields (the JAX
# package's; a knob never shadows a Scenario field).
FLEET_KNOBS: dict[str, str] = {
    "backend": "per-member engine backend: jax (device accounting, "
               "rides the stacked fleet dispatch) or ref (host mirror)",
}


@dataclass
class FleetMember:
    """One pinned cluster of the fleet: an index, a fully-resolved
    Scenario, and its engine backend."""

    index: int
    scenario: Scenario
    backend: str = "torch"

    def spec(self) -> str:
        return self.scenario.spec()


def _scenario_keys() -> set:
    return {f.name for f in fields(Scenario)}


def _split_axis(value: str) -> tuple[str, list[str]]:
    key, sep, vals = value.partition(":")
    key = key.strip()
    if not sep or not vals:
        raise ValueError(
            f"bad axis directive {value!r}: want axis=key:v1|v2|...")
    out = [v.strip() for v in vals.split("|") if v.strip()]
    if not out:
        raise ValueError(f"axis {key!r} sweeps no values")
    known = set(SWEEP_AXES) | set(FLEET_KNOBS)
    if key not in known:
        raise ValueError(
            f"unknown sweep axis {key!r} (declared axes: "
            f"{sorted(known)}; add new ones to fleet/spec.py "
            "SWEEP_AXES)")
    return key, out


def parse_fleet(spec: str) -> list[FleetMember]:
    """Expand one fleet spec string into its pinned members."""
    base_items = ""
    axes: list[tuple[str, list[str]]] = []
    overrides: dict[int, dict[str, str]] = {}
    clusters = None
    fleet_kv: dict[str, str] = {"backend": "torch"}
    for directive in (spec or "").split(";"):
        directive = directive.strip()
        if not directive:
            continue
        key, sep, val = directive.partition("=")
        key, val = key.strip(), val.strip()
        if not sep:
            raise ValueError(f"bad fleet directive {directive!r}")
        if key == "base":
            base_items = val
        elif key == "axis":
            axes.append(_split_axis(val))
        elif key == "clusters":
            clusters = int(val)
            if clusters < 1:
                raise ValueError(f"clusters={clusters}: want >= 1")
        elif key == "cluster":
            idx_s, sep2, items = val.partition(":")
            if not sep2:
                raise ValueError(
                    f"bad cluster override {directive!r}: want "
                    "cluster=<index>:k=v,k=v")
            kv = overrides.setdefault(int(idx_s), {})
            for item in items.split(","):
                item = item.strip()
                if not item:
                    continue
                k, s3, v = item.partition("=")
                if not s3:
                    raise ValueError(
                        f"bad cluster override item {item!r}")
                kv[k.strip()] = v.strip()
        elif key in FLEET_KNOBS:
            fleet_kv[key] = val
        else:
            raise ValueError(
                f"unknown fleet directive {key!r} (known: base, axis, "
                f"clusters, cluster, {sorted(FLEET_KNOBS)})")

    sc_keys = _scenario_keys()
    combos = [dict()]
    if axes:
        combos = [
            dict(zip((k for k, _ in axes), vals))
            for vals in itertools.product(*(v for _, v in axes))
        ]
    total = clusters if clusters is not None else len(combos)
    members: list[FleetMember] = []
    for i in range(total):
        combo = combos[i % len(combos)]
        rep = i // len(combos)
        items = [base_items] if base_items else []
        items += [f"{k}={v}" for k, v in combo.items()
                  if k in sc_keys]
        backend = fleet_kv["backend"]
        if "backend" in combo:
            backend = combo["backend"]
        sc = Scenario.parse(",".join(items))
        if rep and "seed" not in combo:
            sc.seed += rep  # repetition offset: stay heterogeneous
        ov = overrides.get(i, {})
        if ov:
            merged = {k: v for k, v in
                      (it.split("=", 1)
                       for it in sc.spec().split(","))}
            for k, v in ov.items():
                if k in FLEET_KNOBS:
                    continue
                if k not in sc_keys:
                    raise ValueError(
                        f"cluster={i} override {k!r} is neither a "
                        "Scenario field nor a fleet knob")
                merged[k] = v
            sc = Scenario.parse(
                ",".join(f"{k}={v}" for k, v in merged.items()))
            if "backend" in ov:
                backend = ov["backend"]
        if backend not in BACKENDS:
            raise ValueError(
                f"cluster={i}: backend={backend!r} (want jax or ref, "
                "or torch)")
        members.append(FleetMember(index=i, scenario=sc,
                                   backend=backend))
    for i in overrides:
        if i >= total:
            raise ValueError(
                f"cluster={i} override targets a member beyond the "
                f"fleet size {total}")
    return members
