"""Device preflight: probe a backend rung without betting the process on it.

The port of `ceph_tpu/runtime/preflight.py`.  CUDA initialisation can
block for minutes (a wedged CUDA stack, a stale process holding the card),
and an in-process `torch.cuda.init()` cannot be cancelled.  So the probe
runs in a *child process* under a watchdog: a hang costs exactly the
configured timeout, a crash costs an exit code, and the parent stays
healthy either way.

    res = probe("cuda", timeout_s=120)   # watchdogged child probe
    res = probe("cpu", watchdog=False)   # in-process (library fast path)

The child is `python -m ceph_tpu_torch.runtime.preflight --child cuda`:
it fires the `init[.cuda]` fault point before torch is imported (an
injected hang is cheap to kill), prints an "imported" marker once torch
is loaded, then runs `torch.cuda.init()`, reads the device's name and
count, makes one allocation, synchronises, and prints one JSON line.

Rungs: `cuda` (the card), `cpu` (torch on the host: always there) and
`native` (no torch at all: the C++ host engines; the ladder handles it
without a probe).

On failure, `diagnose_init_failure()` gathers best-effort evidence of
*why*: a live process holding `/dev/nvidia*` open and the
`CUDA_VISIBLE_DEVICES` the child saw, so the provenance record says
"card device /dev/nvidia0 held by pid 1234 (python3)" instead of
"timeout".

`prewarm_compile_cache()` is the JAX persistent-compile-cache hook's
counterpart: the port compiles nothing at call time, so it builds the
hand kernels (`build.build_all()`) and returns the build directory.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from ceph_tpu_torch.runtime import faults
from ceph_tpu_torch.utils import knobs
from ceph_tpu_torch.utils.dout import subsys_logger

_log = subsys_logger("runtime")

DEFAULT_TIMEOUT_S = float(knobs.get("CEPH_TPU_INIT_TIMEOUT", "120"))

# device nodes a CUDA process holds open; a stale holder is the classic
# "init hangs until the old run is killed" cause
_CARD_DEVICE_PREFIXES = ("/dev/nvidia",)

# interpreter start + torch import in the probe child is real work, not
# a hang: it gets its own grace period so timeout_s stays tight around
# the thing that actually wedges (device init)
IMPORT_GRACE_S = 60.0


@dataclass
class ProbeResult:
    ok: bool
    platform: str  # requested rung ("cuda", "cpu", ...)
    backend: str = ""  # what torch reports on success
    device: str = ""
    n_devices: int = 0
    init_s: float = 0.0
    error: str = ""  # failure reason ("" on success)
    timed_out: bool = False
    diagnosis: list[str] = field(default_factory=list)


def _card_holders() -> list[str]:
    """Best-effort scan for live processes holding a card device node
    open (requires /proc; never raises)."""
    holders = []
    try:
        for pid_dir in Path("/proc").iterdir():
            if not pid_dir.name.isdigit() or int(pid_dir.name) == os.getpid():
                continue
            try:
                for fd in (pid_dir / "fd").iterdir():
                    tgt = os.readlink(fd)
                    if tgt.startswith(_CARD_DEVICE_PREFIXES):
                        comm = (pid_dir / "comm").read_text().strip()
                        holders.append(
                            f"card device {tgt} held by pid "
                            f"{pid_dir.name} ({comm})")
                        break
            except OSError:
                continue  # permission / raced exit
    except OSError:
        pass
    return holders


def diagnose_init_failure(platform: str) -> list[str]:
    """Why might device init have failed or hung?  Returns readable
    findings (never empty); pure observation, never raises."""
    finds = _card_holders()
    for var in ("CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER"):
        val = os.environ.get(var)
        if val is not None:
            finds.append(f"env {var}={val}")
    if not finds:
        finds.append(f"no local cause found for platform={platform!r} "
                     "(no card, or the CUDA stack is down?)")
    return finds


def prewarm_compile_cache(cache_dir: str | None = None) -> str | None:
    """Build every hand kernel now (`build.build_all()`), so no later
    call pays nvcc; returns the build directory, or None when a build
    failed (the failure is logged; the first launch raises it again)."""
    from ceph_tpu_torch import build

    try:
        build.build_all()
    except Exception as e:  # noqa: BLE001 - reported, raised at launch
        _log(1, f"kernel prebuild failed: {type(e).__name__}: {e}")
        return None
    return str(build.BUILD_DIR)


# ------------------------------------------------------------------ probes

def _init(platform: str) -> dict:
    """Initialise `platform` in this process and describe it."""
    import torch

    if platform == "cpu":
        return {"backend": "cpu", "device": "cpu", "n_devices": 1}
    if platform != "cuda":
        raise RuntimeError(f"unknown backend rung {platform!r} "
                           "(cuda, cpu or native)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' (CLI: --device cpu) to run on the host, or name "
            "a lower rung in CEPH_TPU_LADDER")
    torch.cuda.init()
    n = torch.cuda.device_count()
    x = torch.ones(1024, device="cuda")
    torch.cuda.synchronize()
    del x
    return {"backend": "cuda", "device": torch.cuda.get_device_name(0),
            "n_devices": n}


def _probe_inprocess(platform: str) -> ProbeResult:
    t0 = time.perf_counter()
    try:
        faults.check("init", qual=platform)
        info = _init(platform)
        return ProbeResult(
            ok=True, platform=platform, backend=info["backend"],
            device=info["device"], n_devices=info["n_devices"],
            init_s=time.perf_counter() - t0)
    except Exception as e:  # torch's errors, FaultInjected, ...
        return ProbeResult(
            ok=False, platform=platform,
            error=f"{type(e).__name__}: {e}"[:250],
            init_s=time.perf_counter() - t0)


def _kill_group(proc: subprocess.Popen) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except OSError:
        proc.kill()
    proc.wait()


def _probe_subprocess(platform: str, timeout_s: float) -> ProbeResult:
    """Watchdogged two-phase probe.  The child prints an "imported"
    marker once torch is loaded, then initialises the device and prints
    the result; the parent allows IMPORT_GRACE_S to reach the marker and
    timeout_s from the marker to the result, killing the whole process
    group when either budget runs out.  So timeout_s bounds *device
    init*, the phase that hangs, not interpreter start."""
    import select
    import tempfile

    t0 = time.perf_counter()
    # the parent may import the package off sys.path (a checkout, not an
    # installed package): the child must find it the same way
    pkg_root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, env.get("PYTHONPATH")) if p)
    # stderr goes to a spooled file, not a pipe: a chatty init would
    # fill a pipe buffer and block the child, which the watchdog would
    # then misreport as a hang
    errf = tempfile.TemporaryFile()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.runtime.preflight",
         "--child", platform],
        stdout=subprocess.PIPE, stderr=errf, env=env,
        start_new_session=True,  # kill the group, helpers included
    )
    info: dict = {}
    imported = False
    deadline = time.monotonic() + IMPORT_GRACE_S
    timed_out = False
    while True:
        wait = deadline - time.monotonic()
        if wait <= 0:
            timed_out = True
            _kill_group(proc)
            break
        r, _, _ = select.select([proc.stdout], [], [], min(wait, 0.25))
        if r:
            line = proc.stdout.readline()
            if not line:  # EOF: the child finished (or died)
                proc.wait()
                break
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            if msg.get("phase") == "imported":
                imported = True
                deadline = time.monotonic() + timeout_s
            else:
                info = msg
        elif proc.poll() is not None:
            break
    init_s = time.perf_counter() - t0
    if timed_out:
        res = ProbeResult(
            ok=False, platform=platform, timed_out=True,
            error=(f"device init hung > {timeout_s:g}s "
                   "(watchdog killed probe)" if imported else
                   f"probe hung > {IMPORT_GRACE_S:g}s before loading "
                   "torch (watchdog killed probe)"),
            init_s=init_s)
    elif proc.returncode == 0 and info:
        res = ProbeResult(
            ok=True, platform=platform, backend=info.get("backend", ""),
            device=info.get("device", ""),
            n_devices=int(info.get("n_devices", 0)), init_s=init_s)
    else:
        try:
            errf.seek(0)
            err = errf.read()
        except OSError:
            err = b""
        tail = err.decode(errors="replace").strip().splitlines()[-3:]
        res = ProbeResult(
            ok=False, platform=platform,
            error=(f"probe exited rc={proc.returncode}: "
                   + " | ".join(tail))[:300],
            init_s=init_s)
    if proc.stdout:
        proc.stdout.close()
    errf.close()
    if not res.ok:
        res.diagnosis = diagnose_init_failure(platform)
    return res


def probe(platform: str, timeout_s: float = DEFAULT_TIMEOUT_S,
          watchdog: bool = True) -> ProbeResult:
    """Check that `platform` can initialise.  watchdog=True runs the
    check in a killable child process (entry points); watchdog=False
    runs it in-process (library fast path: it cannot be cancelled)."""
    from ceph_tpu_torch.obs import trace

    with trace.span("runtime.probe", platform=platform, watchdog=watchdog):
        if watchdog:
            return _probe_subprocess(platform, timeout_s)
        return _probe_inprocess(platform)


def _child_main(platform: str) -> int:
    """Probe-child entry.  The `init` fault point fires before torch is
    imported, so an injected hang sits where a real one does and is
    killed after timeout_s; then the "imported" marker arms the
    parent's device-init watchdog."""
    t0 = time.perf_counter()
    faults.check("init", qual=platform)
    import torch  # noqa: F401 - the import is the phase being timed

    print(json.dumps({"phase": "imported"}), flush=True)
    info = _init(platform)
    info["init_s"] = round(time.perf_counter() - t0, 2)
    print(json.dumps(info), flush=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--child"]:
        args = args[1:]
    raise SystemExit(_child_main(args[0] if args else "cuda"))
