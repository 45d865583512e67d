"""Build the port's CUDA kernel with nvcc and load it with ctypes.

The source `ec/csrc/<name>.cu` is compiled, at first use, into
`ceph_tpu_torch/build/lib<name>-<hash>.so` (the hash covers the source
and the flags, so an edited source builds anew).  The source has a plain
C interface and includes no PyTorch header, so a build takes seconds.

The build needs the CUDA toolkit (`nvcc` on PATH, or under CUDA_HOME,
default /usr/local/cuda).  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}


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


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless it is built already; returns the
    library's path."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc {name}.cu failed (rc {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The built library of `name`, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib
