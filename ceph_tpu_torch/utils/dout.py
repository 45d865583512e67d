"""Leveled, per-subsystem debug logging (the `dout/ldout` pattern,
reference src/common/dout.h + per-subsystem levels in src/common/subsys.h).

The port of `ceph_tpu/utils/dout.py`: the same subsystems, levels, line
shape and `CEPH_TPU_DEBUG` syntax.

Usage:
    log = subsys_logger("crush")
    log(10, "descend into", bucket_id)   # printed iff level(crush) >= 10

Line shape follows the reference log format (src/common/LogEntry.cc):

    2026-08-02T10:11:12.345678+0000 7f3a00c0 10 crush: descend into -2

i.e. ISO timestamp with microseconds and UTC offset, thread id (hex),
level, subsystem.  Levels follow the reference convention: 0/1 important,
5 normal detail, 10/20/30 increasingly verbose internals.  Configure
globally via set_subsys_level / CEPH_TPU_DEBUG env ("crush=10,osd=5"
syntax like --debug-crush).

The output stream is resolved at EVERY log call (never captured at logger
construction), so `set_output` redirects loggers created before the call.
"""

from __future__ import annotations

import sys
import threading
import time

from ceph_tpu_torch.utils import knobs

SUBSYS_DEFAULTS = {
    "crush": 1,
    "osd": 1,
    "ec": 1,
    "balancer": 1,
    "tester": 1,
    "native": 1,
    "sim": 1,
    "obs": 1,
    "runtime": 1,
    "serve": 1,
}

_levels = dict(SUBSYS_DEFAULTS)
_out = None  # None = sys.stderr resolved at call time


def _parse_env() -> None:
    spec = knobs.get("CEPH_TPU_DEBUG", "")
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, lvl = part.partition("=")
        try:
            _levels[name.strip()] = int(lvl)
        except ValueError:
            pass


_parse_env()


def set_subsys_level(subsys: str, level: int) -> None:
    _levels[subsys] = level


def get_subsys_level(subsys: str) -> int:
    return _levels.get(subsys, 1)


def set_output(stream) -> None:
    """Redirect ALL subsystem loggers (including ones already created);
    None restores the default (current sys.stderr)."""
    global _out
    _out = stream


def _current_out():
    return _out if _out is not None else sys.stderr


def _timestamp() -> str:
    t = time.time()
    base = time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(t))
    tz = time.strftime("%z") or "+0000"
    return f"{base}.{int(t % 1 * 1e6):06d}{tz}"


class subsys_logger:
    __slots__ = ("subsys",)

    def __init__(self, subsys: str):
        if subsys not in _levels:
            _levels[subsys] = 1
        self.subsys = subsys

    def __call__(self, level: int, *args) -> None:
        if level <= _levels.get(self.subsys, 1):
            print(
                f"{_timestamp()} {threading.get_ident():x} "
                f"{level:2d} {self.subsys}:",
                *args,
                file=_current_out(),
            )

    def enabled(self, level: int) -> bool:
        return level <= _levels.get(self.subsys, 1)
