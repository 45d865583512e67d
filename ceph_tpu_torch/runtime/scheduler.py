"""Deadline-budgeted stage scheduler with atomic checkpoint/resume.

The port of `ceph_tpu/runtime/scheduler.py`.

- **`Checkpoint`**: a JSON store written atomically (a temporary file,
  then a rename), so a run killed mid-flush leaves the previous complete
  file.  Each flush embeds `obs.perf_dump()` under `"perf"`, keyed by
  perf group as the JAX file's is, and writes the trace file when
  tracing is on.  The lifetime simulator keeps its whole state under the
  `"lifetime"` key in the JAX package's layout, so each package resumes
  the other's file.

- **Priority scheduling against the deadline.**  Stages declare a
  priority and a cost estimate; the scheduler runs them highest priority
  first and *skips* (recording why) any stage whose minimum budget no
  longer fits in the remaining deadline.

- **Resume.**  Every completed stage is checkpointed; reopening the
  checkpoint with `resume=True` skips stages already done.

- **Watchdogged dispatch.**  A stage runs on a worker thread; if it
  exceeds its soft timeout the scheduler records the overrun, abandons
  the thread (daemonized: a wedged device call cannot be cancelled, but
  it no longer owns the run), and moves on.  Late results from an
  abandoned stage are discarded, never checkpointed.

Fault points (runtime.faults): `stage[.<name>]` fires on the stage
thread as it starts (arm `overrun:<s>` to trip the watchdog, `lost` for
a mid-stage device loss); `stage_end[.<name>]` fires after the
checkpoint flush (arm `exit:<rc>` for kill/resume runs).  Each stage
runs under a `stage.<name>` span and books the `runtime` group's stage
keys.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

from ceph_tpu_torch.runtime import faults
from ceph_tpu_torch.utils.dout import subsys_logger
from ceph_tpu_torch.utils.perf_counters import logger_for, perf_dump

_log = subsys_logger("runtime")


def _counters():
    L = logger_for("runtime")
    L.add_u64("stages_run", "stages executed to completion")
    L.add_u64("stages_failed", "stages that raised")
    L.add_u64("stages_skipped_budget", "stages skipped: deadline budget")
    L.add_u64("stages_skipped_resume", "stages skipped: already done")
    L.add_u64("stage_overruns", "stages abandoned by the watchdog")
    return L


def perf_snapshot() -> dict:
    """The perf registry (`perf_dump()`), as a Checkpoint embeds it."""
    return json.loads(json.dumps(perf_dump()))


class Checkpoint:
    """Atomic JSON stage store (the JAX package's layout).

    `resume=True` loads an existing file so a re-run can skip completed
    stages and continue partial ones."""

    def __init__(self, path: Path | str, resume: bool = False):
        self.path = Path(path)
        self.data: dict = {"stages_done": []}
        self._lock = threading.RLock()
        if resume:
            try:
                prev = json.loads(self.path.read_text())
            except (OSError, ValueError):
                prev = None
            if isinstance(prev, dict) and "stages_done" in prev:
                self.data = prev
                self.data["resumed"] = self.data.get("resumed", 0) + 1

    def done(self, name: str) -> bool:
        with self._lock:
            return name in self.data["stages_done"]

    def put(self, name: str, value) -> None:
        """A stage's result: stored, marked done and flushed."""
        with self._lock:
            if isinstance(value, dict):
                value = dict(value, perf=perf_snapshot())
            self.data[name] = value
            if name not in self.data["stages_done"]:
                self.data["stages_done"].append(name)
            self.flush()

    def progress(self, name: str, value) -> None:
        """Mid-stage partial result: stored and flushed, NOT marked done
        (a killed run keeps the partial; resume continues it)."""
        with self._lock:
            self.data[name] = value
            self.flush()

    def fail(self, name: str, err: BaseException | str) -> None:
        msg = (err if isinstance(err, str)
               else f"{type(err).__name__}: {err}"[:300])
        with self._lock:
            self.data.setdefault("errors", {})[name] = msg
            self.flush()
        _log(1, f"stage {name} FAILED: {msg[:200]}")

    def flush(self) -> None:
        from ceph_tpu_torch.obs import trace

        with self._lock:
            self.data["perf"] = perf_snapshot()
            try:
                # a run killed later keeps the spans recorded so far
                tp = trace.flush()
                if tp:
                    self.data["trace"] = tp
            except OSError as e:
                # a bad CEPH_TPU_TRACE path must not kill the run
                self.data["trace_error"] = f"{type(e).__name__}: {e}"[:200]
            tmp = self.path.with_suffix(".tmp")
            tmp.write_text(json.dumps(self.data))
            tmp.replace(self.path)


@dataclass
class Stage:
    name: str
    fn: Callable[["StageHandle"], object]
    priority: int = 50  # higher runs earlier
    est_s: float = 30.0  # cost estimate (budgeting)
    min_budget_s: float | None = None  # default: est_s
    soft_timeout_s: float | None = None  # None = rest of the deadline
    reserve_s: float = 0.0  # deadline left for LATER stages: the
    # watchdog abandons this stage early enough that reserve_s of
    # wall-clock survives it
    order: int = 0  # declaration order (priority tiebreak)


class StageHandle:
    """What a running stage sees: progress flushing and the remaining
    budget, both safe against the stage being abandoned."""

    def __init__(self, sched: "StageScheduler", stage: Stage):
        self._sched = sched
        self._stage = stage
        self.abandoned = threading.Event()

    @property
    def name(self) -> str:
        return self._stage.name

    def remaining(self) -> float:
        return self._sched.remaining()

    def progress(self, value) -> None:
        if not self.abandoned.is_set():
            self._sched.checkpoint.progress(self._stage.name, value)


class StageScheduler:
    """Run declared stages by priority under one wall-clock deadline."""

    def __init__(self, checkpoint: Checkpoint, deadline_s: float,
                 t0: float | None = None):
        self.checkpoint = checkpoint
        self.deadline_s = deadline_s
        self.t0 = time.time() if t0 is None else t0
        self.stages: list[Stage] = []

    def add(self, name: str, fn, *, priority: int = 50, est_s: float = 30.0,
            min_budget_s: float | None = None,
            soft_timeout_s: float | None = None,
            reserve_s: float = 0.0) -> None:
        self.stages.append(Stage(
            name, fn, priority=priority, est_s=est_s,
            min_budget_s=min_budget_s, soft_timeout_s=soft_timeout_s,
            reserve_s=reserve_s, order=len(self.stages),
        ))

    def remaining(self) -> float:
        return self.deadline_s - (time.time() - self.t0)

    def run(self) -> dict:
        L = _counters()
        ck = self.checkpoint
        for st in sorted(self.stages, key=lambda s: (-s.priority, s.order)):
            if ck.done(st.name):
                L.inc("stages_skipped_resume")
                ck.data.setdefault("resumed_stages", [])
                if st.name not in ck.data["resumed_stages"]:
                    ck.data["resumed_stages"].append(st.name)
                _log(5, f"stage {st.name}: already checkpointed, skipping")
                continue
            rem = self.remaining()
            need = st.min_budget_s if st.min_budget_s is not None else st.est_s
            if rem < need:
                L.inc("stages_skipped_budget")
                ck.put(f"{st.name}_skipped", {
                    "remaining_s": round(rem, 1), "needed_s": need,
                })
                _log(1, f"stage {st.name}: skipped, {rem:.0f}s left < "
                        f"{need:.0f}s budget")
                continue
            self._run_one(st, rem, L)
        ck.flush()
        return ck.data

    def _run_one(self, st: Stage, rem: float, L) -> None:
        from ceph_tpu_torch.obs import trace

        handle = StageHandle(self, st)
        box: dict = {}

        def target():
            try:
                faults.check("stage", qual=st.name)
                box["result"] = st.fn(handle)
            except BaseException as e:  # checkpointed, not swallowed
                box["error"] = e

        timeout = min(st.soft_timeout_s or rem, rem - st.reserve_s, rem)
        if timeout <= 0:
            L.inc("stages_skipped_budget")
            self.checkpoint.put(f"{st.name}_skipped", {
                "remaining_s": round(rem, 1),
                "needed_s": st.reserve_s,
            })
            _log(1, f"stage {st.name}: skipped, {rem:.0f}s left <= "
                    f"{st.reserve_s:.0f}s reserved for later stages")
            return
        t = threading.Thread(
            target=target, name=f"stage-{st.name}", daemon=True)
        _log(5, f"stage {st.name}: start (budget {timeout:.0f}s)")
        with trace.span(f"stage.{st.name}", priority=st.priority):
            t.start()
            t.join(timeout)
        if t.is_alive():
            handle.abandoned.set()
            L.inc("stage_overruns")
            self.checkpoint.fail(
                st.name,
                f"overrun: still running after {timeout:.0f}s; abandoned")
            trace.instant("stage.overrun", stage=st.name)
            return
        if "error" in box:
            L.inc("stages_failed")
            self.checkpoint.fail(st.name, box["error"])
        else:
            L.inc("stages_run")
            self.checkpoint.put(st.name, box["result"])
        # after the checkpoint flush: `stage_end.<name>=exit:<rc>` dies
        # here with the stage durably recorded (the resume hook)
        faults.check("stage_end", qual=st.name)
