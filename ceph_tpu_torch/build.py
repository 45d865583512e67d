"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one source `<module>/csrc/<name>.cu` of this package (see
SOURCES), with a plain C interface and no PyTorch header, so a build
takes seconds.  It is compiled, at first use, into
`ceph_tpu_torch/build/lib<name>-<hash>.so`; the hash covers the source,
every header it includes (`#include "..."`, followed through the headers
it reaches, wherever they lie in the package) and the flags, so an edited
source or header builds anew.  `build_all()` starts one nvcc per source at once and waits for
them all.  ptxas reports each kernel's registers, stack, spills and
static shared memory (-Xptxas=-v); the report is kept beside the library
(`ptxas_report`).  Building and loading are thread-safe: one lock covers
every build and first load, so two threads that first use a kernel at
once run one nvcc, and each temporary file is named by process and
thread.

The build needs the CUDA toolkit (`nvcc` on PATH, or under CUDA_HOME,
default /usr/local/cuda).  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE / "build"
SOURCES = ("ec/csrc/gf_matmul.cu", "crush/csrc/crush_rule.cu",
           "crush/csrc/crush_rule_diag.cu", "balancer/csrc/upmap_loop.cu",
           "osd/csrc/pipeline.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# nvcc wall seconds of each source this process built (from its start to
# its end; sources built together overlap); absent when already built
BUILD_SECONDS: dict[str, float] = {}
# held across every build and first load (re-entered by load -> build)
_LOCK = threading.RLock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    path = home / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (not on PATH, nor under CUDA_HOME): the CUDA "
            "kernels build only where the CUDA toolkit is installed"
        )
    return str(path)


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def headers(source: str) -> list[Path]:
    """The headers `source` includes with quotes, and those they include,
    resolved against the including file's directory (as the compiler
    resolves them), each once, in a fixed order."""
    seen: list[Path] = []
    todo = [PACKAGE / source]
    while todo:
        f = todo.pop()
        for name in _INCLUDE.findall(f.read_text()):
            h = (f.parent / name).resolve()
            if h.exists() and h not in seen:
                seen.append(h)
                todo.append(h)
    return sorted(seen)


def library_path(source: str) -> Path:
    """Where `source` (a path under the package, e.g.
    "ec/csrc/gf_matmul.cu") builds to."""
    src = PACKAGE / source
    digest = hashlib.sha256(src.read_bytes())
    for header in headers(source):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def _start(source: str) -> tuple[subprocess.Popen, Path, Path, float] | None:
    lib = library_path(source)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(
        f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(PACKAGE / source)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, tmp, lib, time.perf_counter()


def _finish(source: str, job) -> None:
    if job is None:
        return
    proc, tmp, lib, t0 = job
    out, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc {source} failed (rc {proc.returncode}):"
                           f"\n{err}")
    lib.with_suffix(".ptxas").write_text(out + err)
    os.replace(tmp, lib)
    BUILD_SECONDS[source] = time.perf_counter() - t0


def build(source: str) -> Path:
    """Compile `source` unless it is built already; returns the
    library's path."""
    with _LOCK:
        _finish(source, _start(source))
        return library_path(source)


def build_all() -> dict[str, Path]:
    """Build every source of SOURCES, one nvcc each, all started together;
    returns {source: library path}.  Every job is waited for before the
    first failure is raised."""
    errors = []
    with _LOCK:
        jobs = {source: _start(source) for source in SOURCES}
        for source, job in jobs.items():
            try:
                _finish(source, job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {source: library_path(source) for source in SOURCES}


def source_hash(source: str) -> str:
    """The hash that names `source`'s library (source, headers, flags)."""
    return library_path(source).stem.rsplit("-", 1)[1]


def built(source: str) -> bool:
    return library_path(source).exists()


def ptxas_report(source: str) -> dict[str, dict]:
    """What ptxas said of each kernel of the built `source`: {entry
    function: {"registers", "stack", "spill_stores", "spill_loads",
    "smem"}} (bytes; smem is the static shared memory of a block)."""
    text = library_path(source).with_suffix(".ptxas").read_text()
    out: dict[str, dict] = {}
    name = None
    for line in text.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name = m.group(1)
            out.setdefault(name, {"smem": 0})
        elif name and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads", line)):
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
            if s := re.search(r"(\d+) bytes smem", line):
                out[name]["smem"] = int(s.group(1))
    return out


def load(source: str) -> ctypes.CDLL:
    """The built library of `source`, building it first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(source)
            if lib is None:
                lib = ctypes.CDLL(str(build(source)))
                _LIBS[source] = lib
    return lib
