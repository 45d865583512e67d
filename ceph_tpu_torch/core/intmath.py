"""Small integer helpers of the placement path, on torch int64 tensors.

The port of `ceph_tpu/core/intmath.py`:
- stable_mod: Ceph's power-of-two-friendly modulo that folds the object
  hash onto pg_num (reference src/include/rados.h:96-102);
- div_trunc_s64: C's s64 division, truncating toward zero (div64_s64 of
  straw2, reference src/crush/mapper.c:358).  Torch's `//` floors, and
  the straw2 numerator is negative, so it divides with
  rounding_mode="trunc".
"""

from __future__ import annotations

import torch


def pg_mask_for(b: int) -> int:
    """bmask = next_pow2(b) - 1, e.g. b=12 -> 15 (pg_num_mask semantics,
    reference src/osd/osd_types.h calc_pg_masks)."""
    if b <= 0:
        return 0
    return (1 << (int(b) - 1).bit_length()) - 1


def stable_mod(x: torch.Tensor, b: int, bmask: int) -> torch.Tensor:
    """ceph_stable_mod(x, b, bmask) on u32 values held in int64."""
    lo = x & bmask
    return torch.where(lo < b, lo, x & (bmask >> 1))


def div_trunc_int(a: int, w: int) -> int:
    """Scalar div64_s64 on Python ints: truncate toward zero."""
    q = abs(a) // abs(w)
    return -q if (a < 0) != (w < 0) else q


def div_trunc_s64(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a / w truncating toward zero, on int64 (a may be negative)."""
    return torch.div(a, w, rounding_mode="trunc")
