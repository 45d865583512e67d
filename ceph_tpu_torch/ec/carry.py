"""State carried over from the JAX package: a code's generator matrix.

An erasure code has no weights; what defines it is the m×k coding block C
of its systematic generator [I_k; C].  `code_from_reference` builds the
port's code for a profile and gives it the JAX code's C (`jax_code.C`, a
numpy u8[m, k]), so both encode with the same matrix by construction.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ec.interface import ErasureCodeProfileError
from ceph_tpu_torch.ec.registry import create_erasure_code
from ceph_tpu_torch.ec.rs import RSErasureCode


def code_from_reference(profile: dict, C: np.ndarray, device=None):
    """The port's RS code for `profile`, with coding block `C` (u8[m, k],
    as `ceph_tpu`'s `RSErasureCode.C`).  Raises on a C of another type or
    shape than the profile's k and m."""
    if not isinstance(C, np.ndarray) or C.dtype != np.uint8:
        raise TypeError(
            f"coding matrix must be a numpy uint8 array, got "
            f"{type(C).__name__} {getattr(C, 'dtype', '')}"
        )
    code = create_erasure_code(profile, device)
    if not isinstance(code, RSErasureCode):
        raise ErasureCodeProfileError(
            f"plugin {profile.get('plugin')!r} is not a matrix code"
        )
    if C.shape != (code.m, code.k):
        raise ValueError(
            f"coding matrix {C.shape} does not match the profile's "
            f"m={code.m}, k={code.k}"
        )
    code.C = C.copy()
    if hasattr(code.engine, "prepare"):
        code.engine.prepare(code.C)
    return code
