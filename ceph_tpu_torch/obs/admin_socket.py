"""Admin socket — query a LIVE process's perf registry from the outside.

The port of `ceph_tpu/obs/admin_socket.py`: the same commands, protocol
and server.  Every command answers from the port's modules; `cache dump`
is the kernel registry (`obs.executables`: launches, enqueue quantiles,
nvcc seconds and ptxas rows) and `runtime` the backend ladder's
provenance and default ladder, the armed fault points and the process's
device.  No command
waits for the card: a live query answers while the device works.

The reference exposes every daemon's internals on a UNIX stream socket
(`ceph daemon <name> perf dump`, reference src/common/admin_socket.cc:
one command line per connection, JSON reply, connection closed).  Same
protocol here:

    client: "perf dump\\n"      server: perf-dump JSON (+ an `executables`
                                section: the kernel registry, records
                                only — no file reads)
    client: "perf schema\\n"    server: perf-schema JSON
    client: "perf reset\\n"     server: {"ok": true} (values zeroed)
    client: "metrics\\n"        server: Prometheus text exposition
    client: "cache dump\\n"     server: kernel registry with each kernel's
                                source hash and ptxas rows
    client: "trace flush\\n"    server: {"path": <trace file or null>}
    client: "bad dump\\n"       server: placement-diagnostics snapshots
                                (per-source bad-mapping / retry planes
                                booked by PoolMapper.diagnose)
    client: "explain 1.42\\n"   server: host-oracle decision log for PG
                                42 of pool 1 (an explainer must have
                                been registered by a PoolMapper of that
                                pool in THIS process)
    client: "runtime\\n"        server: backend provenance, default
                                ladder, armed fault points, device
    client: "serve status\\n"   server: live placement-service status
                                (epoch, queue depth, shed/degraded
                                counters, swap-stall tail) per service
    client: "health\\n"         server: summarized HEALTH_OK/WARN/ERR +
                                raised checks (obs/health.py)
    client: "timeline dump\\n"  server: every recorded timeline series,
                                both retention tiers, chronological
    client: "help\\n"           server: command list JSON

Env-gated like tracing: set `CEPH_TPU_ADMIN_SOCKET=/path/x.asok` and any
process that imports ceph_tpu_torch.obs serves on it; then from another
shell:

    python -m ceph_tpu_torch.cli.daemon --sock /path/x.asok perf dump
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import threading

from ceph_tpu_torch.utils import knobs
from ceph_tpu_torch.utils.dout import subsys_logger

_log = subsys_logger("obs")

_server: "AdminSocket | None" = None

COMMANDS = (
    "perf dump", "perf schema", "perf reset", "metrics", "cache dump",
    "bad dump", "explain <pool>.<seed>", "trace flush", "runtime",
    "serve status", "health", "timeline dump", "help",
)

# concurrent per-connection handler threads (beyond this, accepts wait):
# a slow `cache dump` analysis must not block a concurrent `perf dump` —
# the always-answers diagnostic path — but a flood of clients must not
# spawn unbounded threads either
MAX_HANDLERS = 8


def handle_command(cmd: str) -> str:
    """Execute one admin command against this process; returns the reply
    text.  Shared by the socket server and the in-process CLI path."""
    from ceph_tpu_torch import obs
    from ceph_tpu_torch.obs import executables, trace
    from ceph_tpu_torch.utils import perf_counters as pc

    cmd = " ".join(cmd.split())
    if cmd == "perf dump":
        # analyze=False: a live query answers from the records alone
        d = pc.perf_dump()
        d["executables"] = executables.dump(analyze=False)
        return json.dumps(d, indent=1, sort_keys=True)
    if cmd == "perf schema":
        return json.dumps(pc.perf_schema(), indent=1, sort_keys=True)
    if cmd == "perf reset":
        pc.reset_values()
        return json.dumps({"ok": True})
    if cmd == "metrics":
        # the one exposition recipe lives in obs.prometheus_text()
        # (counters + executable-registry gauges)
        return obs.prometheus_text()
    if cmd == "cache dump":
        # short analysis budget: a live diagnostic must answer promptly
        return json.dumps(executables.dump(analyze=True, budget_s=5.0),
                          indent=1, sort_keys=True)
    if cmd == "bad dump":
        # the placement flight-recorder surface: latest diagnostics
        # snapshot per source + the aggregate placement counters
        from ceph_tpu_torch.obs import placement

        return json.dumps(placement.dump(), indent=1, sort_keys=True)
    if cmd.startswith("explain"):
        from ceph_tpu_torch.obs import placement

        arg = cmd[len("explain"):].strip()
        if not arg:
            return json.dumps(
                {"error": "usage: explain <pool>.<seed>"})
        return json.dumps(placement.explain(arg), indent=1)
    if cmd == "trace flush":
        return json.dumps({"path": trace.flush()})
    if cmd == "runtime":
        # backend-acquisition provenance (None until something walked
        # the ladder), the ladder, the armed fault points and the device
        from ceph_tpu_torch import runtime

        return json.dumps({
            "provenance": runtime.last_provenance(),
            "default_ladder": runtime.default_ladder(),
            "faults_armed": runtime.faults.active(),
            "device": _device_info(),
        }, indent=1, sort_keys=True)
    if cmd == "serve status":
        # the placement-serving daemon's live status (epoch, queue
        # depth, shed/degraded counters, swap-stall tail) — empty
        # `services` when this process runs none
        from ceph_tpu_torch.serve import service as serve_service

        return json.dumps(serve_service.status_dump(), indent=1,
                          sort_keys=True)
    if cmd == "health":
        # the `ceph status` analogue: summarized status + raised checks
        from ceph_tpu_torch.obs import health

        return json.dumps(health.dump(), indent=1, sort_keys=True)
    if cmd == "timeline dump":
        # the flight recorder: every recorded series, both tiers,
        # chronological
        from ceph_tpu_torch.obs import timeline

        return json.dumps(timeline.dump(), indent=1, sort_keys=True)
    if cmd == "help":
        return json.dumps(list(COMMANDS))
    return json.dumps({"error": f"unknown command {cmd!r}", "help": list(COMMANDS)})


def _device_info() -> dict:
    """The card this process sees (none: the port's entry points then
    run only where the caller asks for the CPU)."""
    import torch

    if not torch.cuda.is_available():
        return {"cuda": False, "count": 0, "name": None}
    return {"cuda": True, "count": torch.cuda.device_count(),
            "name": torch.cuda.get_device_name(0)}


class AdminSocket:
    """Threaded UNIX stream server; one command per connection.

    Each accepted connection runs on its own handler thread (bounded by
    MAX_HANDLERS): a slow command does not block a concurrent `perf
    dump` — the diagnostic path must always answer."""

    def __init__(self, path: str):
        self.path = path
        if os.path.exists(path):
            os.unlink(path)
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind(path)
        self.sock.listen(4)
        self._stop = False
        self._handlers = threading.Semaphore(MAX_HANDLERS)
        self.thread = threading.Thread(
            target=self._serve, name="ceph-tpu-asok", daemon=True
        )
        self.thread.start()

    def _serve(self) -> None:
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self._handlers.acquire()
            threading.Thread(
                target=self._handle, args=(conn,),
                name="ceph-tpu-asok-conn", daemon=True,
            ).start()

    def _handle(self, conn) -> None:
        cmd = "<no command read>"
        try:
            conn.settimeout(5)
            buf = b""
            while b"\n" not in buf:
                chunk = conn.recv(4096)
                if not chunk:
                    break
                buf += chunk
            cmd = buf.split(b"\n", 1)[0].decode("utf-8", "replace")
            if cmd:
                try:
                    reply = handle_command(cmd)
                except Exception as e:
                    # the client must see the failure, not an empty
                    # reply that reads as success
                    reply = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}
                    )
                conn.sendall(reply.encode())
        except Exception as e:
            # send failures / recv timeouts: the peer is gone or stuck,
            # but a silent pass here hides every such failure from the
            # operator diagnosing exactly this path
            _log(1, f"admin socket connection failed serving "
                    f"{cmd!r}: {type(e).__name__}: {e}")
        finally:
            self._handlers.release()
            conn.close()

    def close(self) -> None:
        self._stop = True
        try:
            self.sock.close()
        finally:
            if os.path.exists(self.path):
                try:
                    os.unlink(self.path)
                except OSError:
                    pass


def client_command(path: str, cmd: str, timeout: float = 10.0) -> str:
    """Send one command to a live process's admin socket."""
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.connect(path)
        s.sendall(cmd.encode() + b"\n")
        s.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            out += chunk
        return out.decode()
    finally:
        s.close()


def start(path: str) -> AdminSocket:
    """Start (or replace) this process's admin socket server."""
    global _server
    if _server is not None:
        _server.close()
    _server = AdminSocket(path)
    return _server


def release() -> None:
    """Stop serving and free the socket path.

    For supervisor/worker process pairs sharing one environment: the
    UNIX path can only name one server, and the interesting registry
    lives in the worker — the supervisor calls this before spawning, so
    the worker's own `maybe_start_from_env` binds the path uncontested."""
    global _server
    if _server is not None:
        _server.close()
        _server = None


def _path_serving(path: str) -> bool:
    """True if a live server already answers on `path` (a stale socket
    file left by a killed process refuses the connect)."""
    if not os.path.exists(path):
        return False
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(0.5)
    try:
        s.connect(path)
        return True
    except OSError:
        return False
    finally:
        s.close()


def maybe_start_from_env() -> AdminSocket | None:
    path = knobs.get("CEPH_TPU_ADMIN_SOCKET")
    if path and _server is None:
        # never steal a live server's path: a client shell with the env
        # var still exported imports obs too, and must not unlink the
        # socket of the process it is about to query
        if _path_serving(path):
            return None
        try:
            return start(path)
        except OSError as e:
            # a bad socket path (missing dir, unwritable, too long) must
            # not crash every module that imports obs
            _log(1, f"cannot serve admin socket {path}: {e}")
            return None
    return _server


def _cleanup() -> None:
    if _server is not None:
        _server.close()


atexit.register(_cleanup)
