"""The port's admin socket, on the CPU: tests/test_obs.py's six cases
(round trip, `perf reset`, a slow command beside a concurrent client, a
stale socket file reclaimed, a live server's path never stolen, a
connection error logged), each waiting on events rather than fixed
sleeps, and a live process queried while it maps: `perf dump` through
`python -m ceph_tpu_torch.cli.daemon --sock` shows `pgs_mapped` grow.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu_torch import obs  # noqa: E402
from ceph_tpu_torch.obs import admin_socket  # noqa: E402
from ceph_tpu_torch.utils import dout  # noqa: E402


@pytest.fixture
def sock_dir():
    # AF_UNIX paths are short (108 bytes): a pytest tmp_path may not fit
    import tempfile

    with tempfile.TemporaryDirectory(prefix="asok") as d:
        yield Path(d)


def test_admin_socket_roundtrip(sock_dir):
    # the modules whose wrappers register the three kernels
    from ceph_tpu_torch.crush import mapper  # noqa: F401
    from ceph_tpu_torch.ec import torch_backend  # noqa: F401

    name = f"t_sock_{uuid.uuid4().hex[:6]}"
    L = obs.logger_for(name)
    L.add_u64("n")
    L.inc("n", 4)
    srv = admin_socket.start(str(sock_dir / "x.asok"))
    try:
        out = admin_socket.client_command(srv.path, "perf dump")
        d = json.loads(out)
        assert d[name]["n"] == 4
        assert {e["kernel"] for e in d["executables"]["entries"]} >= {
            "gf_matmul", "crush_rule", "crush_rule_diag"}
        out = admin_socket.client_command(srv.path, "metrics")
        assert f"ceph_tpu_{name}_n 4" in out
        out = admin_socket.client_command(srv.path, "bogus")
        assert "unknown command" in json.loads(out)["error"]
        rt = json.loads(admin_socket.client_command(srv.path, "runtime"))
        assert set(rt) == {"provenance", "default_ladder", "faults_armed",
                           "device"}
        assert rt["default_ladder"] == ["cuda"]
        assert rt["device"]["cuda"] in (True, False)
        cd = json.loads(admin_socket.client_command(srv.path, "cache dump"))
        assert all(len(e["source_hash"]) == 16 for e in cd["entries"])
        for cmd in ("health", "timeline dump", "bad dump", "serve status",
                    "perf schema", "help", "trace flush"):
            assert isinstance(
                json.loads(admin_socket.client_command(srv.path, cmd)),
                (dict, list)), cmd
        assert "usage" in json.loads(
            admin_socket.client_command(srv.path, "explain"))["error"]
    finally:
        srv.close()
        admin_socket._server = None


def test_handle_command_perf_reset():
    name = f"t_reset_{uuid.uuid4().hex[:6]}"
    L = obs.logger_for(name)
    L.add_u64("n")
    L.inc("n", 2)
    assert json.loads(admin_socket.handle_command("perf reset")) == \
        {"ok": True}
    assert obs.perf_dump()[name]["n"] == 0


def test_admin_socket_slow_command_does_not_block_concurrent_client(
        sock_dir, monkeypatch):
    """Per-connection handler threads: a slow command holds its thread
    while a concurrent `perf dump` answers."""
    orig = admin_socket.handle_command
    started, release = threading.Event(), threading.Event()

    def slowable(cmd):
        if cmd == "t_slow":
            started.set()
            assert release.wait(30)
            return json.dumps({"slow": True})
        return orig(cmd)

    monkeypatch.setattr(admin_socket, "handle_command", slowable)
    srv = admin_socket.start(str(sock_dir / "conc.asok"))
    try:
        box: dict = {}

        def slow_client():
            box["slow"] = admin_socket.client_command(
                srv.path, "t_slow", timeout=30)

        t = threading.Thread(target=slow_client)
        t.start()
        assert started.wait(30)  # the slow handler holds its thread
        out = admin_socket.client_command(srv.path, "perf dump",
                                          timeout=10)
        assert json.loads(out)  # answered while the slow one waits
        assert t.is_alive() and "slow" not in box
        release.set()
        t.join(timeout=30)
        assert json.loads(box["slow"]) == {"slow": True}
    finally:
        release.set()
        srv.close()
        admin_socket._server = None


def test_admin_socket_reclaims_stale_socket_file(sock_dir, monkeypatch):
    """A dead process's leftover socket file does not stop the next
    process from serving the path."""
    path = str(sock_dir / "stale.asok")
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.bind(path)
    s.close()  # no unlink: the killed-process shape — file, no listener
    assert os.path.exists(path)
    assert not admin_socket._path_serving(path)
    monkeypatch.setenv("CEPH_TPU_ADMIN_SOCKET", path)
    monkeypatch.setattr(admin_socket, "_server", None)
    srv = admin_socket.maybe_start_from_env()
    try:
        assert srv is not None
        out = admin_socket.client_command(path, "help")
        assert "perf dump" in json.loads(out)
    finally:
        if srv is not None:
            srv.close()
        admin_socket._server = None


def test_admin_socket_never_steals_live_servers_path(sock_dir, monkeypatch):
    """A client shell with CEPH_TPU_ADMIN_SOCKET still exported must not
    unlink the socket of the live process it is about to query."""
    path = str(sock_dir / "live.asok")
    srv = admin_socket.start(path)
    try:
        monkeypatch.setenv("CEPH_TPU_ADMIN_SOCKET", path)
        monkeypatch.setattr(admin_socket, "_server", None)
        assert admin_socket._path_serving(path)
        assert admin_socket.maybe_start_from_env() is None
        assert os.path.exists(path)
        out = admin_socket.client_command(path, "help")
        assert "perf dump" in json.loads(out)
    finally:
        monkeypatch.setattr(admin_socket, "_server", srv)
        srv.close()
        admin_socket._server = None


class _Watch:
    """A dout stream that signals when a wanted text was written."""

    def __init__(self, want: str):
        self.want, self.text = want, ""
        self.seen = threading.Event()
        self._lock = threading.Lock()

    def write(self, s: str) -> int:
        with self._lock:
            self.text += s
            if self.want in self.text:
                self.seen.set()
        return len(s)

    def flush(self) -> None:
        pass


def test_admin_socket_connection_error_logged_not_swallowed(
        sock_dir, monkeypatch):
    """A per-connection failure (the peer vanished before the reply)
    lands in the dout log with the command."""
    orig = admin_socket.handle_command
    closed = threading.Event()

    def delayed(cmd):
        if cmd == "t_err":
            # reply only once the client has reset the connection, and
            # more than the dead socket's buffer holds: sendall fails
            assert closed.wait(30)
            return "x" * (1 << 22)
        return orig(cmd)

    watch = _Watch("admin socket connection failed")
    monkeypatch.setattr(admin_socket, "handle_command", delayed)
    dout.set_output(watch)
    srv = admin_socket.start(str(sock_dir / "err.asok"))
    try:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.connect(srv.path)
        c.sendall(b"t_err\n")
        # SO_LINGER(0): close sends RST — the server's send must error
        c.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
        c.close()
        closed.set()
        assert watch.seen.wait(30), watch.text[-500:]
        assert "t_err" in watch.text
    finally:
        dout.set_output(None)
        srv.close()
        admin_socket._server = None


_LIVE_CHILD = r"""
import sys, time
import numpy as np
from ceph_tpu_torch import obs  # serves CEPH_TPU_ADMIN_SOCKET
from ceph_tpu_torch.osd.osdmap import build_hierarchical
from ceph_tpu_torch.osd.pipeline import PoolMapper
from ceph_tpu_torch.osd.types import PgPool
m = build_hierarchical(4, 4, pool=PgPool(pg_num=128, size=3))
pm = PoolMapper(m, 0, device="cpu", overlays=False)
print("ready", flush=True)
t_end = time.time() + 120
while time.time() < t_end:
    pm.map_batch(np.arange(128))
"""


def _daemon(*argv: str) -> str:
    env = dict(os.environ)
    env.pop("CEPH_TPU_ADMIN_SOCKET", None)
    out = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.cli.daemon", *argv],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-800:]
    return out.stdout


def test_live_process_answers_while_it_maps(sock_dir):
    path = str(sock_dir / "live.asok")
    env = dict(os.environ, CEPH_TPU_ADMIN_SOCKET=path,
               PYTHONPATH=str(ROOT))
    child = subprocess.Popen(
        [sys.executable, "-c", _LIVE_CHILD], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert child.stdout.readline().strip() == "ready"
        counts = []
        for _ in range(2):
            d = json.loads(_daemon("--sock", path, "perf dump"))
            counts.append(d["pipeline"]["pgs_mapped"])
            deadline = time.time() + 60
            while time.time() < deadline:  # until the child mapped more
                d = json.loads(admin_socket.client_command(
                    path, "perf dump"))
                if d["pipeline"]["pgs_mapped"] > counts[-1]:
                    break
        assert counts[1] > counts[0] > 0, counts
        assert child.poll() is None  # still mapping while answering
    finally:
        child.kill()
        child.wait(timeout=30)


def test_daemon_sock_unreachable_exits_1(sock_dir):
    env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.cli.daemon", "--sock",
         str(sock_dir / "none.asok"), "help"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 1
    assert "cannot reach" in out.stderr
