"""Robert Jenkins 32-bit integer mix hash, CRUSH's only RNG.

The port of `ceph_tpu/core/rjenkins.py`, bit-exact with the C reference
(reference src/crush/hash.c:12-89, CRUSH_HASH_RJENKINS1).  Torch has no
uint32 subtraction or shifts, so every value is an int64 lane holding a
u32 in [0, 2^32): subtractions and left shifts are masked back to 32
bits, right shifts of a non-negative int64 are logical.  The same `_mix`
runs on Python ints (the host hashes below).

The hashes broadcast: arguments may be tensors of any integer dtype (a
negative bucket id hashes as id & 0xffffffff, as C's cast to u32 does),
numpy arrays or Python ints.  They return int64 tensors.  `hash2_int`,
`hash3_int` and `hash4_int` are the same hashes on Python ints, for the
host oracle.
"""

from __future__ import annotations

import numpy as np
import torch

HASH_SEED = 1315423911  # 0x4E67C6A7, reference src/crush/hash.c:24
M32 = 0xFFFFFFFF
_X = 231232
_Y = 1232


def _u32(v) -> torch.Tensor:
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v, dtype=np.int64))
    return v.long() & M32


def _mix(a, b, c):
    """One round of Jenkins' 96-bit mix (reference src/crush/hash.c:12-22)."""
    a = (a - b - c) & M32
    a = a ^ (c >> 13)
    b = (b - c - a) & M32
    b = b ^ ((a << 8) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 13)
    a = (a - b - c) & M32
    a = a ^ (c >> 12)
    b = (b - c - a) & M32
    b = b ^ ((a << 16) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 5)
    a = (a - b - c) & M32
    a = a ^ (c >> 3)
    b = (b - c - a) & M32
    b = b ^ ((a << 10) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 15)
    return a, b, c


def crush_hash32(a) -> torch.Tensor:
    """hash of one u32 (reference src/crush/hash.c:26-35)."""
    a = _u32(a)
    h = HASH_SEED ^ a
    b, x, h = _mix(a, _X, h)
    _, _, h = _mix(_Y, a, h)
    return h


def crush_hash32_2(a, b) -> torch.Tensor:
    """hash of two u32s (reference src/crush/hash.c:37-46)."""
    a, b = _u32(a), _u32(b)
    h = HASH_SEED ^ a ^ b
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(_X, a, h)
    b, y, h = _mix(b, _Y, h)
    return h


def crush_hash32_3(a, b, c) -> torch.Tensor:
    """hash of three u32s (reference src/crush/hash.c:48-59)."""
    a, b, c = _u32(a), _u32(b), _u32(c)
    h = HASH_SEED ^ a ^ b ^ c
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, _X, h)
    y, a, h = _mix(_Y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def crush_hash32_4(a, b, c, d) -> torch.Tensor:
    """hash of four u32s (reference src/crush/hash.c:61-73)."""
    a, b, c, d = _u32(a), _u32(b), _u32(c), _u32(d)
    h = HASH_SEED ^ a ^ b ^ c ^ d
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, _X, h)
    y, b, h = _mix(_Y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def crush_hash32_5(a, b, c, d, e) -> torch.Tensor:
    """hash of five u32s (reference src/crush/hash.c:75-90)."""
    a, b, c, d, e = _u32(a), _u32(b), _u32(c), _u32(d), _u32(e)
    h = HASH_SEED ^ a ^ b ^ c ^ d ^ e
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    e, x, h = _mix(e, _X, h)
    y, a, h = _mix(_Y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    d, x, h = _mix(d, x, h)
    y, e, h = _mix(y, e, h)
    return h


def hash2_int(a: int, b: int) -> int:
    """crush_hash32_2 of two u32 Python ints, as a Python int (the host
    oracle's form, crush/mapper_ref.py)."""
    a, b = a & M32, b & M32
    h = HASH_SEED ^ a ^ b
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(_X, a, h)
    b, y, h = _mix(b, _Y, h)
    return h


def hash3_int(a: int, b: int, c: int) -> int:
    """crush_hash32_3 on Python ints."""
    a, b, c = a & M32, b & M32, c & M32
    h = HASH_SEED ^ a ^ b ^ c
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, _X, h)
    y, a, h = _mix(_Y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def hash4_int(a: int, b: int, c: int, d: int) -> int:
    """crush_hash32_4 on Python ints."""
    a, b, c, d = a & M32, b & M32, c & M32, d & M32
    h = HASH_SEED ^ a ^ b ^ c ^ d
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, _X, h)
    y, b, h = _mix(_Y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def str_hash_rjenkins(data: bytes) -> int:
    """ceph_str_hash_rjenkins over a byte string (object-name hashing,
    reference src/common/ceph_hash.cc): Jenkins' lookup2-style hash over
    12-byte blocks with the length folded into the tail mix.  Host code,
    on Python ints."""
    a = b = 0x9E3779B9
    c = 0
    n = len(data)
    i = 0
    while n - i >= 12:
        a = (a + int.from_bytes(data[i:i + 4], "little")) & M32
        b = (b + int.from_bytes(data[i + 4:i + 8], "little")) & M32
        c = (c + int.from_bytes(data[i + 8:i + 12], "little")) & M32
        a, b, c = _mix(a, b, c)
        i += 12
    # tail bytes: a gets bytes 0-3, b gets 4-7, c gets 8-10 shifted <<8
    # (byte 11 of c is reserved for the length, as in lookup2)
    pad = data[i:] + b"\x00" * (12 - (n - i))
    c = (c + n) & M32
    a = (a + int.from_bytes(pad[0:4], "little")) & M32
    b = (b + int.from_bytes(pad[4:8], "little")) & M32
    c = (c + (int.from_bytes(pad[8:11], "little") << 8)) & M32
    a, b, c = _mix(a, b, c)
    return c
