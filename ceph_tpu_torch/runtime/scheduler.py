"""Atomic checkpoint/resume: the `Checkpoint` of the JAX package's stage
scheduler.

The port of `ceph_tpu/runtime/scheduler.py::Checkpoint`.  A JSON store
written atomically (a temporary file, then a rename), so a run killed
mid-flush leaves the previous complete file.  The lifetime simulator
keeps its whole state under the `"lifetime"` key in the JAX package's
layout, so each package resumes the other's file.

Each flush embeds a snapshot of the port's counters (`COUNTERS` of
`osd.state`, `runtime.faults`, `recovery.queue`, `sim.workload` and
`sim.lifetime`, where those modules are loaded) under `"perf"`, where
the JAX file embeds its perf registry.  The deadline-budgeted
`StageScheduler`, the backend ladder and the preflight probe are not
ported.
"""

from __future__ import annotations

import json
import sys
import threading
from pathlib import Path

# modules whose COUNTERS a flush snapshots (those already imported)
_COUNTER_MODULES = (
    "ceph_tpu_torch.osd.state",
    "ceph_tpu_torch.runtime.faults",
    "ceph_tpu_torch.recovery.queue",
    "ceph_tpu_torch.sim.workload",
    "ceph_tpu_torch.sim.lifetime",
    "ceph_tpu_torch.obs.health",
    "ceph_tpu_torch.obs.timeline",
)


def perf_snapshot() -> dict:
    """{group: counters} of the loaded port modules that keep COUNTERS."""
    out = {}
    for name in _COUNTER_MODULES:
        mod = sys.modules.get(name)
        c = getattr(mod, "COUNTERS", None)
        if isinstance(c, dict):
            out[name.rsplit(".", 1)[-1]] = json.loads(json.dumps(c))
    return out


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
        with self._lock:
            self.data["perf"] = perf_snapshot()
            tmp = self.path.with_suffix(".tmp")
            tmp.write_text(json.dumps(self.data))
            tmp.replace(self.path)
