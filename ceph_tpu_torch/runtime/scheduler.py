"""Atomic checkpoint/resume: the `Checkpoint` of the JAX package's stage
scheduler.

The port of `ceph_tpu/runtime/scheduler.py::Checkpoint`.  A JSON store
written atomically (a temporary file, then a rename), so a run killed
mid-flush leaves the previous complete file.  The lifetime simulator
keeps its whole state under the `"lifetime"` key in the JAX package's
layout, so each package resumes the other's file.

Each flush embeds `obs.perf_dump()` under `"perf"`, keyed by perf group
as the JAX file's is, and writes the trace file when tracing is on.
The deadline-budgeted `StageScheduler`, the backend ladder and the
preflight probe are not ported.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

from ceph_tpu_torch.utils.perf_counters import perf_dump


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
