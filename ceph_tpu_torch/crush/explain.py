"""Explain replay and device-vs-host first-divergence triage.

The port of `ceph_tpu/crush/explain.py`.  Two halves of one debugging
workflow:

1. `explain_seed` / `explain_pool_pg`: replay ONE placement through the
   instrumented host oracle (`mapper_ref.do_rule(recorder=...)`) and
   return the full decision log: bucket descents, straw2 draw
   winners and losers, collision / out-of-weight / skip rejections, leaf
   recursions, per-step work vectors.  `render_text` formats it the way
   `crushtool explain` prints it.

2. `first_divergence`: run a batch of seeds through both the rule
   kernel's diagnostics variant (`crush/mapper.py::diag_rule`, whose
   `steps` plane records the work vector after every choose step) and the
   host oracle, and pin any disagreement to the earliest differing choose
   step: the triage entry point when a tunable or a map edit makes the
   kernel drift from the reference.  The device half is one call (one
   launch per 2^24 seeds); only the step planes are fetched.

`diag_batch` (the planes) and `device_choose_tries` (the summary mode:
only the histogram leaves the launch) run the diagnostics variant for a
CrushArrays; its records keep the JAX package's keys (`"jax"` is the
device's work vector), so records and `crushtool` output compare equal.
Every lane of the port's kernel is exact: nothing is flagged unresolved.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.crush import mapper, mapper_ref
from ceph_tpu_torch.crush.soa import to_device
from ceph_tpu_torch.crush.types import CrushMap, ITEM_NONE, RuleOp
from ceph_tpu_torch.device import resolve_device

_OPS = {
    int(RuleOp.CHOOSE_FIRSTN): "choose firstn",
    int(RuleOp.CHOOSELEAF_FIRSTN): "chooseleaf firstn",
    int(RuleOp.CHOOSE_INDEP): "choose indep",
    int(RuleOp.CHOOSELEAF_INDEP): "chooseleaf indep",
}


class ExplainRecorder:
    """Decision recorder the host oracle emits into (see
    mapper_ref.do_rule).  `events` is the flat chronological log (each
    dict carries the recursion `depth` it was emitted at); `steps` holds
    the work vector after every choose step, the host half of the
    first-divergence comparison.

    detail=False skips the straw2 per-item draw dumps (the only
    expensive payload), which is what the batch locator uses."""

    __slots__ = ("events", "steps", "depth", "detail")

    def __init__(self, detail: bool = True):
        self.events: list[dict] = []
        self.steps: list[list[int]] = []
        self.depth = 0
        self.detail = detail

    def emit(self, **kw) -> None:
        kw["depth"] = self.depth
        self.events.append(kw)

    def step_result(self, w: list[int]) -> None:
        self.steps.append(list(w))


def explain_seed(
    m: CrushMap,
    ruleno: int,
    x: int,
    result_max: int,
    weight: list[int],
    choose_args=None,
    detail: bool = True,
) -> dict:
    """Replay one mapping through the instrumented host oracle."""
    rec = ExplainRecorder(detail=detail)
    result = mapper_ref.do_rule(
        m, ruleno, int(x), result_max, weight, choose_args, recorder=rec
    )
    return {
        "x": int(x),
        "ruleno": ruleno,
        "result": [int(v) for v in result],
        "steps": rec.steps,
        "events": rec.events,
    }


def explain_pool_pg(m_osd, pool_id: int, seed: int) -> dict:
    """Replay one PG of an OSDMap pool: the pipeline's stage-1 seed
    mixing (ps -> pps) on the host, then the CRUSH walk: the payload
    behind `placement.explain("<pool>.<seed>")`."""
    from ceph_tpu_torch.osd.types import PgId

    pool = m_osd.pools.get(pool_id)
    if pool is None:
        return {"error": f"no pool {pool_id}"}
    if not (0 <= seed < pool.pg_num):
        return {"error": f"seed {seed} outside pg_num {pool.pg_num}"}
    pps = pool.raw_pg_to_pps(PgId(pool_id, seed))
    ruleno = mapper_ref.find_rule(
        m_osd.crush, pool.crush_rule, int(pool.type), pool.size
    )
    ca = m_osd.crush.choose_args.get(
        pool_id, m_osd.crush.choose_args.get(-1)
    )
    out = explain_seed(
        m_osd.crush, ruleno, pps, pool.size, list(m_osd.osd_weight), ca
    )
    up, up_p, _, _ = m_osd.pg_to_up_acting_osds(PgId(pool_id, seed))
    out.update(pool=pool_id, seed=seed, pps=int(pps),
               up=[int(v) for v in up], up_primary=int(up_p))
    return out


def render_text(ex: dict, item_names: dict | None = None) -> str:
    """Human formatting of an explain record (the `crushtool explain`
    output): one line per decision, indented by recursion depth."""
    if "error" in ex:
        return f"explain: {ex['error']}\n"

    def name(it):
        if it is None:
            return "?"
        if item_names and it in item_names:
            return f"{it} ({item_names[it]})"
        return str(it)

    lines = []
    head = f"explain x={ex['x']} rule {ex['ruleno']}"
    if "pool" in ex:
        head = (f"explain pg {ex['pool']}.{ex['seed']} (pps={ex['pps']}) "
                f"rule {ex['ruleno']}")
    lines.append(head)
    step = -1
    for ev in ex["events"]:
        pad = "  " * (ev.get("depth", 0) + 1)
        kind = ev["ev"]
        if kind == "take":
            lines.append(f"{pad}take {name(ev['item'])}"
                         + ("" if ev.get("valid", True) else " [invalid]"))
        elif kind == "choose":
            step += 1
            op = _OPS.get(ev.get("op"), "choose")
            lines.append(
                f"{pad}step {step}: {op} numrep={ev['numrep']} "
                f"type={ev['type']} from {ev['sources']}"
            )
        elif kind == "straw2":
            order = sorted(ev["draws"], key=lambda d: -d[1])
            top = ", ".join(
                f"{name(it)}:{d}" for it, d in order[:3]
            )
            lines.append(
                f"{pad}  straw2 bucket {ev['bucket']} r={ev['r']} -> "
                f"{name(ev['winner'])}  [top draws: {top}]"
            )
        elif kind == "draw":
            lines.append(
                f"{pad}  rep {ev['rep']} r={ev['r']} ftotal={ev['ftotal']}"
                f" bucket {ev['bucket']} -> {name(ev.get('item'))} "
                f"[{ev['status']}]"
            )
        elif kind == "leaf_enter":
            lines.append(f"{pad}  rep {ev['rep']}: descend to leaf in "
                         f"bucket {ev['bucket']} (r={ev['r']})")
        elif kind == "leaf_exit":
            lines.append(f"{pad}  leaf descent "
                         f"{'ok' if ev['ok'] else 'REJECTED'}")
        elif kind == "place":
            lines.append(
                f"{pad}  PLACE rep {ev['rep']} -> {name(ev['item'])} "
                f"(retries={ev['ftotal']}, slot {ev['outpos']})"
            )
        elif kind == "emit":
            lines.append(f"{pad}emit -> {ev['result']}")
    if "up" in ex:
        lines.append(f"  up={ex['up']} primary={ex['up_primary']}")
    else:
        lines.append(f"  result={ex['result']}")
    return "\n".join(lines) + "\n"


# -- device side -------------------------------------------------------------

def diag_batch(A, ruleno: int, result_max: int, device=None):
    """Memoized diagnostics runner over one CrushArrays on `device` (None:
    the card): run(xs, weights) -> (rows, unresolved, planes), tensors on
    the device (planes: tries [N, lanes], coll / rej / skip / bad [N],
    steps [N, S, RMAX]; unresolved is all False: the kernel is exact).
    The map is uploaded once per device.  The runner carries the plan
    facts (`diag_exact`, `diag_tries_bound`, `diag_steps`, `diag_lanes`)."""
    device = resolve_device(device)
    memo = A.__dict__.get("_diag_batch_memo")
    if memo is None:
        memo = {}
        object.__setattr__(A, "_diag_batch_memo", memo)  # frozen dataclass
    mkey = (ruleno, result_max, device)
    if mkey in memo:
        return memo[mkey]
    prog = mapper.compile_rule(A, ruleno, result_max)
    tables = to_device(A, device)

    def run(xs, weights):
        x, w = _inputs(xs, weights, device)
        rows, planes = mapper.diag_rule(tables, prog, x, w)
        return rows, torch.zeros(x.numel(), dtype=torch.bool,
                                 device=device), planes

    run.prog = prog
    run.tables = tables
    run.diag_exact = prog.diag_exact
    run.diag_tries_bound = prog.diag_tries_bound
    run.diag_steps = prog.diag_steps
    run.diag_lanes = prog.diag_lanes
    memo[mkey] = run
    return run


def _inputs(xs, weights, device):
    """Seeds and reweights (u32 values) as int64 tensors on `device`."""
    return tuple(torch.as_tensor(np.asarray(v, np.int64) & 0xFFFFFFFF,
                                 device=device) for v in (xs, weights))


def device_choose_tries(A, ruleno: int, result_max: int, xs, weights,
                        hist_len: int, device=None):
    """The per-placement retry histogram of the seeds xs (`crushtool
    --test --show-choose-tries`) from the diagnostics kernel's summary
    mode (`mapper.diag_summary`; on the CPU its plain version): only the
    hist_len counts and the five sums leave the device.  Returns
    (hist int64[hist_len], unresolved_idx int64[0]): every lane is exact,
    so no seed is left for the host."""
    run = diag_batch(A, ruleno, result_max, device)
    x, w = _inputs(xs, weights, run.tables.device)
    got = mapper.diag_summary(run.tables, run.prog, x, w, hist_len - 1)
    return got[:hist_len].cpu().numpy(), np.zeros(0, np.int64)


def first_divergence(
    m_host: CrushMap,
    A,
    ruleno: int,
    xs,
    result_max: int,
    weights: list[int],
    choose_args=None,
    device=None,
) -> dict | None:
    """Locate the earliest choose step where the device kernel (built
    from `A`) and the host oracle (walking `m_host`) disagree, over a
    batch of seeds.  Returns None when every step of every seed agrees;
    otherwise a record naming the first divergent (step, x) with both
    work vectors (`"jax"` is the device's) and the host decision log for
    that seed.

    `m_host` and `A` are passed separately on purpose: triage compares
    the device kernel against a DIFFERENT host map (perturbed tunables, a
    candidate map edit) as readily as against its own source.  The host
    half walks the oracle once per seed."""
    xs = np.asarray(xs)
    run = diag_batch(A, ruleno, result_max, device)
    _, flg_d, planes = run(xs, np.asarray(weights, np.int64))
    steps_d = planes["steps"].cpu().numpy()  # [N, S, RMAX]
    flg = flg_d.cpu().numpy()
    S = steps_d.shape[1]

    best: tuple[int, int] | None = None  # (step, batch index)
    host_steps_at_best: list[list[int]] | None = None
    n_divergent = 0
    for b, x in enumerate(xs):
        rec = ExplainRecorder(detail=False)
        mapper_ref.do_rule(m_host, ruleno, int(x), result_max,
                           list(weights), choose_args, recorder=rec)
        div_step = None
        for s in range(S):
            host = rec.steps[s] if s < len(rec.steps) else []
            host_p = (host + [ITEM_NONE] * result_max)[:result_max]
            if list(steps_d[b, s]) != host_p:
                div_step = s
                break
        if div_step is None:
            continue
        n_divergent += 1
        if best is None or div_step < best[0]:
            best = (div_step, b)
            host_steps_at_best = rec.steps
    if best is None:
        return None
    s, b = best
    host = host_steps_at_best[s] if s < len(host_steps_at_best) else []
    return {
        "step": s,
        "x": int(xs[b]),
        "batch_index": b,
        "jax": [int(v) for v in steps_d[b, s]],
        "host": (host + [ITEM_NONE] * result_max)[:result_max],
        "n_divergent": n_divergent,
        "n_checked": int(len(xs) - flg.sum()),
        "n_unresolved_skipped": int(flg.sum()),
        "host_log": explain_seed(
            m_host, ruleno, int(xs[b]), result_max, list(weights),
            choose_args,
        ),
    }
