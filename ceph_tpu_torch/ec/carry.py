"""State carried over from the JAX package: a code's defining matrices.

An erasure code has no weights; what defines it is its coding matrices.
Each function here builds the port's code for a profile and gives it the
JAX code's matrices (numpy u8 arrays), so both packages compute with the
same matrices by construction:
- RS (jerasure, isa, jax): the m×k coding block C of [I_k; C]
  (`code_from_reference`);
- Clay: the inner MDS block `mds_C` and the pair code's C (`pft.C`);
- SHEC: its shingled C;
- LRC: each layer's C, in layer order.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ec.clay import ClayCode, _PairTransform
from ceph_tpu_torch.ec.interface import ErasureCodeProfileError
from ceph_tpu_torch.ec.lrc import LrcCode
from ceph_tpu_torch.ec.registry import create_erasure_code
from ceph_tpu_torch.ec.rs import RSErasureCode
from ceph_tpu_torch.ec.shec import ShecCode


def _checked(M: np.ndarray, shape: tuple, what: str) -> np.ndarray:
    """A copy of M, which must be a numpy uint8 array of `shape`."""
    if not isinstance(M, np.ndarray) or M.dtype != np.uint8:
        raise TypeError(
            f"{what} must be a numpy uint8 array, got "
            f"{type(M).__name__} {getattr(M, 'dtype', '')}"
        )
    if M.shape != shape:
        raise ValueError(f"{what} {M.shape} does not match the profile's "
                         f"{shape}")
    return M.copy()


def _code(profile: dict, cls, device):
    code = create_erasure_code(profile, device)
    if not isinstance(code, cls):
        raise ErasureCodeProfileError(
            f"plugin {profile.get('plugin')!r} is not a {cls.__name__}"
        )
    return code


def _set_C(code, C: np.ndarray, what: str) -> None:
    code.C = _checked(C, (code.m, code.k), what)
    if hasattr(code.engine, "prepare"):
        code.engine.prepare(code.C)


def code_from_reference(profile: dict, C: np.ndarray, device=None):
    """The port's RS code for `profile`, with coding block `C` (u8[m, k],
    as `ceph_tpu`'s `RSErasureCode.C`).  Raises on a C of another type or
    shape than the profile's k and m."""
    code = _code(profile, RSErasureCode, device)
    _set_C(code, C, "coding matrix")
    return code


def clay_from_reference(profile: dict, mds_C: np.ndarray,
                        pair_C: np.ndarray, device=None) -> ClayCode:
    """The port's Clay code with the JAX code's `mds_C` (u8[m, k+nu]) and
    pair code `pft.C` (u8[2, 2])."""
    code = _code(profile, ClayCode, device)
    code.mds_C = _checked(mds_C, (code.m, code.k + code.nu), "mds_C")
    code.pft = _PairTransform(_checked(pair_C, (2, 2), "pair C"))
    code._repair_plans.clear()  # the plans are built from both
    return code


def shec_from_reference(profile: dict, C: np.ndarray,
                        device=None) -> ShecCode:
    """The port's SHEC code with the JAX code's shingled C (u8[m, k])."""
    code = _code(profile, ShecCode, device)
    _set_C(code, C, "shingled matrix")
    return code


def lrc_from_reference(profile: dict, layer_Cs: list,
                       device=None) -> LrcCode:
    """The port's LRC code with each layer's C (the JAX code's
    `layers[i].code.C`, in layer order)."""
    code = _code(profile, LrcCode, device)
    if len(layer_Cs) != len(code.layers):
        raise ValueError(f"{len(layer_Cs)} matrices for "
                         f"{len(code.layers)} layers")
    for i, (layer, C) in enumerate(zip(code.layers, layer_Cs)):
        _set_C(layer.code, C, f"layer {i} coding matrix")
    return code
