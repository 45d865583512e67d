"""Reed–Solomon family codes (matrix codes over GF(2^8)).

Port of `ceph_tpu/ec/rs.py`: the jerasure and isa techniques that are
plain generator-matrix codes.  Encode is C·data; decode inverts the
surviving rows of [I;C].  The per-stripe math runs on an engine: numpy on
the host, or `TorchEngine`, whose GF matmul is the Hopper kernel on a
CUDA tensor and its plain torch version on a CPU tensor.  The device
engine is the default (`DEFAULT_BACKEND`); `backend=numpy` is the
explicit host choice.

Numpy in gives numpy out, computed on the engine's device; tensors stay
tensors on their device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.ec.gf import gf_matvec_data
from ceph_tpu_torch.ec.interface import (
    ErasureCode,
    ErasureCodeProfileError,
    _is_tensor,
    _stack,
)
from ceph_tpu_torch.ec.torch_backend import TorchEngine
from ceph_tpu_torch.native import load_gf

COUNTERS: dict[str, int] = dict.fromkeys((
    "bytes_encoded",       # stripe bytes pushed through the encodes
    "bytes_decoded",       # chunk bytes rebuilt by the decodes
    "decode_plan_hits",    # decodes served by a cached per-pattern plan
    "decode_plan_misses",  # decode plans built (submatrix inverted)
), 0)


def _host(data, engine: str):
    """`data` as numpy for a host engine: numpy stays, a CPU tensor is
    viewed; a tensor on any other device is refused, never copied to
    the host behind the caller's back."""
    if _is_tensor(data):
        if data.device.type != "cpu":
            raise ValueError(
                f"the {engine} engine runs on the host, not on "
                f"{data.device}; use backend=torch for tensors on the "
                f"card"
            )
        return data.numpy()
    return data


class NumpyEngine:
    """Host GF matmul engine (table-driven).  It takes numpy arrays and CPU
    tensors; a tensor on any other device is refused."""

    def matmul(self, M: np.ndarray, data):
        out = gf_matvec_data(M, _host(data, "numpy"))
        return torch.from_numpy(out) if _is_tensor(data) else out


class NativeEngine:
    """C++ SIMD GF engine (native/gf.cpp, built with g++ at first use; a
    failed build raises).  It takes numpy arrays and CPU tensors; a
    tensor on any other device is refused."""

    def __init__(self):
        self.lib = load_gf()

    def matmul(self, M: np.ndarray, data):
        M = np.ascontiguousarray(M, np.uint8)
        d = np.ascontiguousarray(_host(data, "native"), np.uint8)
        m, k = M.shape
        if d.ndim != 2 or d.shape[0] != k:
            raise ValueError(f"data {d.shape} does not match M {M.shape}")
        out = np.empty((m, d.shape[1]), np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        self.lib.gf_native_matvec(
            M.ctypes.data_as(u8p), m, k, d.ctypes.data_as(u8p),
            out.ctypes.data_as(u8p), d.shape[1],
        )
        return torch.from_numpy(out) if _is_tensor(data) else out


# profile["backend"] -> engine; "jax" is the JAX package's name for the
# device engine, so its profiles carry over unchanged
_DEVICE_BACKENDS = ("torch", "jax")
# every plugin's engine when the profile names none: the device engine,
# on the code's device (the card unless the caller asked for the CPU)
DEFAULT_BACKEND = "torch"


def get_engine(name: str, strategy: str | None = None, device=None):
    """Build a per-stripe math engine: `numpy` or `native` (host), or
    `torch` (alias `jax`: the device engine on `device`).  `strategy`
    (the device engine only, as in the JAX package) picks one of
    ec.torch_backend.STRATEGIES; None defers to the engine's own
    resolution (the env override, then its default)."""
    if name in _DEVICE_BACKENDS:
        try:
            return TorchEngine(device, strategy)
        except ValueError as e:
            raise ErasureCodeProfileError(str(e))
    if name == "numpy":
        return NumpyEngine()
    if name == "native":
        return NativeEngine()
    raise ErasureCodeProfileError(f"unknown ec backend {name!r}")


# decode plans, shared across code instances with equal generators: an
# erasure pattern's recover matrix (one Gauss–Jordan inversion + a GF
# matmul) is pure in (C, surviving set, wanted set); its kernel tables are
# uploaded into the engine at the same moment.
_DECODE_PLANS: dict[tuple, np.ndarray] = {}


def decode_plan(C: np.ndarray, use: tuple, missing: tuple,
                engine=None) -> np.ndarray:
    key = (C.shape, C.tobytes(), use, missing)
    R = _DECODE_PLANS.get(key)
    if R is None:
        R = matrices.recover_matrix(C, list(use), list(missing))
        _DECODE_PLANS[key] = R
        COUNTERS["decode_plan_misses"] += 1
    else:
        COUNTERS["decode_plan_hits"] += 1
    if engine is not None and hasattr(engine, "prepare"):
        engine.prepare(R)
    return R


def _nbytes(data) -> int:
    return int(np.prod(np.shape(data)))


def _concat(a, b, dim: int):
    if _is_tensor(a):
        return torch.cat([a, b], dim=dim)
    return np.concatenate([np.asarray(a, np.uint8), b], axis=dim)


class RSErasureCode(ErasureCode):
    """Systematic matrix code; the technique sets the coding block."""

    TECHNIQUES = {
        "reed_sol_van": matrices.vandermonde_rs,
        "cauchy_orig": matrices.cauchy_orig,
        "cauchy_good": matrices.cauchy_good,
        "isa_reed_sol_van": matrices.isa_rs_vandermonde,
        "isa_cauchy": matrices.isa_cauchy,
    }

    def __init__(self, technique: str = "reed_sol_van"):
        super().__init__()
        self.technique = technique
        self.C: np.ndarray | None = None
        self.engine = None

    def parse(self, profile: dict) -> None:
        # jerasure defaults k=7,m=3 (reference ErasureCodeJerasure.h:89-91)
        self.k, self.m = 7, 3
        super().parse(profile)
        if self.w != 8:
            raise ErasureCodeProfileError(
                f"w={self.w}: only w=8 is supported (the reference default)"
            )
        if self.technique == "reed_sol_r6_op":
            if self.m != 2:
                raise ErasureCodeProfileError(
                    "reed_sol_r6_op requires m=2"
                )
            self.C = matrices.rs_r6(self.k)
        else:
            try:
                make = self.TECHNIQUES[self.technique]
            except KeyError:
                raise ErasureCodeProfileError(
                    f"unknown technique {self.technique!r}"
                )
            self.C = make(self.k, self.m)
        self.engine = get_engine(profile.get("backend", DEFAULT_BACKEND),
                                 profile.get("strategy"), self.device)
        # upload the encode matrix's kernel tables now, before any stripe
        if hasattr(self.engine, "prepare"):
            self.engine.prepare(self.C)

    def encode_chunks(self, data):
        """[k, cs] data rows -> [k+m, cs] all chunks."""
        if data.shape[0] != self.k:
            raise ValueError(f"{data.shape[0]} data rows, k={self.k}")
        if not _is_tensor(data):
            data = np.asarray(data, np.uint8)
        parity = self.engine.matmul(self.C, data)
        COUNTERS["bytes_encoded"] += _nbytes(data)
        return _concat(data, parity, 0)

    def decode_chunks(
        self, want_to_read: set[int], chunks: dict, chunk_size: int
    ) -> dict:
        present = sorted(chunks)
        if len(present) < self.k:
            raise ValueError(
                f"cannot decode: {len(present)} < k={self.k} chunks"
            )
        use = present[: self.k]
        missing = sorted(set(want_to_read) - set(chunks))
        out = dict(chunks)
        if missing:
            stack = _stack([chunks[i] for i in use], 0)
            R = decode_plan(self.C, tuple(use), tuple(missing), self.engine)
            rebuilt = self.engine.matmul(R, stack)
            for row, i in enumerate(missing):
                out[i] = rebuilt[row]
        COUNTERS["bytes_decoded"] += len(missing) * chunk_size
        return out

    def encode_parity(self, data):
        """Parity rows only: [k, cs] -> [m, cs], no stripe assembly.
        This is the reference benchmark's encode shape: its encoded data
        chunks alias the input (zero copy), so parity generation is the
        measured work."""
        if data.shape[0] != self.k:
            raise ValueError(f"{data.shape[0]} data rows, k={self.k}")
        parity = self.engine.matmul(self.C, data)
        COUNTERS["bytes_encoded"] += _nbytes(data)
        return parity

    # -- batched-stripe paths ----------------------------------------------
    def encode_batch(self, data):
        """[N, k, cs] stripes -> [N, k+m, cs], one kernel launch for the
        whole batch on the device engine."""
        if np.ndim(data) != 3 or data.shape[1] != self.k:
            raise ValueError(f"[N, k={self.k}, cs] expected, got "
                             f"{tuple(data.shape)}")
        if not hasattr(self.engine, "matmul_batch"):
            return _stack([self.encode_chunks(s) for s in data], 0)
        parity = self.engine.matmul_batch(self.C, data)
        COUNTERS["bytes_encoded"] += _nbytes(data)
        return _concat(data, parity, 1)

    def decode_batch(
        self, want_to_read: set[int], chunks: dict, chunk_size: int
    ) -> dict:
        """Batched decode: every chunk value is [N, cs] (N stripes, all
        with the same erasure pattern: one lost OSD means many stripes
        missing the same shard).  The cached decode plan is looked up once
        and applied to the whole batch in one launch."""
        present = sorted(chunks)
        if len(present) < self.k:
            raise ValueError(
                f"cannot decode: {len(present)} < k={self.k} chunks"
            )
        use = present[: self.k]
        missing = sorted(set(want_to_read) - set(chunks))
        out = dict(chunks)
        if missing:
            R = decode_plan(self.C, tuple(use), tuple(missing), self.engine)
            stack = _stack([chunks[i] for i in use], 1)  # [N, k, cs]
            if hasattr(self.engine, "matmul_batch"):
                rebuilt = self.engine.matmul_batch(R, stack)
            else:
                rebuilt = _stack(
                    [self.engine.matmul(R, s) for s in stack], 0
                )
            for row, i in enumerate(missing):
                out[i] = rebuilt[:, row]
        COUNTERS["bytes_decoded"] += (len(missing) * chunk_size
                                      * int(np.shape(chunks[use[0]])[0]))
        return out
