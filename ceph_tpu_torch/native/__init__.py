"""Native (C++) host engines, built with g++ at first use.

Port of `ceph_tpu/native/`: the same three C++ sources, one library
each (their headers hold the design notes):
- `gf.cpp`: GF(2^8) SIMD region kernels (the isa-l / gf-complete role),
  the engine of `backend=native` (`ec/rs.py::NativeEngine`);
- `crush.cpp`: the threaded batch CRUSH mapper (the ParallelPGMapper
  role), `native/mapper.py::NativeMapper`, behind `crushtool --backend
  native` and the multicore CPU baseline;
- `crc.cpp`: CRC-32C (the SSE4.2 instruction where the CPU has it),
  behind `utils/crc32c.py` for buffers of 256 bytes and more.

Each is compiled with `$CXX` (default g++), `-O3 -std=c++17 -fPIC
-shared` and its own flags (`-march=native` for gf, `-pthread` for
crush), into `ceph_tpu_torch/build/libnative_<name>-<hash>.so`; the hash
covers the compiler, the flags and the source, so an edited source builds
anew, and for `-march=native` also what that flag resolves to on this
host, so a build directory carried to another CPU builds anew too.  One lock covers every build and first load, and each temporary
file is named by process and thread and renamed into place: two threads
build once, and two processes never load a torn library.  A library is
published only after its ctypes signatures are set.

A failed build raises with the compiler's stderr.  Nothing falls back to
numpy or Python: the caller asked for a native engine by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ceph_tpu_torch.build import BUILD_DIR

HERE = Path(__file__).resolve().parent
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
# library name -> (source beside this file, its own flags)
LIBRARIES = {
    "gf": ("gf.cpp", ("-march=native",)),
    "crc": ("crc.cpp", ()),
    "crush": ("crush.cpp", ("-pthread",)),
}
# seconds each library's compile took in this process (absent: it was
# built already)
BUILD_SECONDS: dict[str, float] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()
# compiler -> its `-march=native -Q --help=target` listing on this host
_TARGETS: dict[str, str] = {}


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def _command(name: str) -> list[str]:
    src, flags = LIBRARIES[name]
    return [compiler(), *CXX_FLAGS, *flags, str(HERE / src)]


def native_target(cxx: str) -> str:
    """The target options `-march=native` selects on this host, as `cxx`
    lists them.  A compiler that cannot list them gives its error text
    instead; building with it then fails and raises."""
    with _LOCK:
        target = _TARGETS.get(cxx)
        if target is None:
            cmd = [cxx, "-march=native", "-Q", "--help=target"]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
                target = proc.stdout + proc.stderr + f"rc {proc.returncode}"
            except OSError as e:
                target = str(e)
            _TARGETS[cxx] = target
        return target


def library_path(name: str) -> Path:
    """Where library `name` ("gf", "crc" or "crush") builds to."""
    src, flags = LIBRARIES[name]
    digest = hashlib.sha256((HERE / src).read_bytes())
    digest.update(" ".join(_command(name)[:-1]).encode())
    if "-march=native" in flags:
        digest.update(native_target(compiler()).encode())
    return BUILD_DIR / f"libnative_{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile library `name` unless it is built already; returns its
    path.  Raises RuntimeError with the compiler's stderr on failure."""
    with _LOCK:
        lib = library_path(name)
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(
            f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [*_command(name), "-o", str(tmp)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)} failed (rc "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        return lib


def _load(name: str, bind) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build(name)))
                bind(lib)
                _LIBS[name] = lib
    return lib


_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)
_UP = ctypes.POINTER(ctypes.c_uint)
_LLP = ctypes.POINTER(ctypes.c_longlong)


def _bind_gf(lib: ctypes.CDLL) -> None:
    lib.gf_native_simd_level.argtypes = []
    lib.gf_native_simd_level.restype = ctypes.c_int
    lib.gf_native_matvec.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, _U8P, _U8P, ctypes.c_longlong,
    ]
    lib.gf_native_matvec.restype = None
    lib.gf_native_mul_region.argtypes = [
        ctypes.c_int, _U8P, _U8P, ctypes.c_longlong, ctypes.c_int,
    ]
    lib.gf_native_mul_region.restype = None


def _bind_crc(lib: ctypes.CDLL) -> None:
    lib.ceph_tpu_crc32c.restype = ctypes.c_uint32
    lib.ceph_tpu_crc32c.argtypes = [
        ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.ceph_tpu_crc32c_hw.argtypes = []
    lib.ceph_tpu_crc32c_hw.restype = ctypes.c_int


def _bind_crush(lib: ctypes.CDLL) -> None:
    from ceph_tpu_torch.core.lntable import LL_TBL, RH_LH_TBL

    lib.cm_set_ln_tables.argtypes = [_LLP, _LLP]
    lib.cm_set_ln_tables.restype = None
    lib.cm_create.restype = ctypes.c_void_p
    lib.cm_create.argtypes = [ctypes.c_int] * 6
    lib.cm_add_bucket.restype = ctypes.c_int
    lib.cm_add_bucket.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _IP, _IP, _IP, _IP, ctypes.c_int, _IP,
    ]
    lib.cm_add_rule.restype = ctypes.c_int
    lib.cm_add_rule.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _IP, _IP, _IP,
    ]
    lib.cm_set_choose_args.restype = ctypes.c_int
    lib.cm_set_choose_args.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _UP, _IP, ctypes.c_int,
    ]
    lib.cm_set_max_devices.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cm_set_max_devices.restype = None
    lib.cm_map_batch.restype = ctypes.c_longlong
    lib.cm_map_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, _UP, ctypes.c_longlong, ctypes.c_int,
        _UP, ctypes.c_int, _IP, ctypes.c_int, ctypes.c_int,
    ]
    lib.cm_destroy.argtypes = [ctypes.c_void_p]
    lib.cm_destroy.restype = None
    # the fixed-point log tables, copied into the library once
    rh = np.ascontiguousarray(RH_LH_TBL, dtype=np.int64)
    ll = np.ascontiguousarray(LL_TBL, dtype=np.int64)
    lib.cm_set_ln_tables(rh.ctypes.data_as(_LLP), ll.ctypes.data_as(_LLP))


def load_gf() -> ctypes.CDLL:
    """The GF(2^8) region kernels (gf.cpp)."""
    return _load("gf", _bind_gf)


def load_crc() -> ctypes.CDLL:
    """The CRC-32C kernel (crc.cpp)."""
    return _load("crc", _bind_crc)


def load_crush() -> ctypes.CDLL:
    """The threaded batch CRUSH mapper (crush.cpp), its log tables set."""
    return _load("crush", _bind_crush)
