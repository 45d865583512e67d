"""CRC-32C (Castagnoli) — the checksum of every versioned encoding in the
reference (ceph_crc32c, reference src/common/crc32c.cc; used by
OSDMap::encode at src/osd/OSDMap.cc:3106 with initial value -1).

Table-driven, reflected, polynomial 0x1EDC6F41 (reversed 0x82F63B78).
Port of `ceph_tpu/utils/crc32c.py`: a byte-at-a-time loop for buffers
under 256 bytes, and the native kernel (native/crc.cpp: the SSE4.2 CRC32
instruction when the CPU has it, else slicing-by-8) for larger ones.  A
failed build of the native kernel raises; nothing falls back.
`crc32c_fast`, slicing-by-8 in Python (the reference's crc32c_sctp
technique, 8 lookup tables / 8 bytes per iteration), is the pure-Python
twin the tests hold the native kernel to.  Streaming:
crc32c(b2, crc32c(b1)) == crc32c(b1+b2).
"""

from __future__ import annotations

from ceph_tpu_torch.native import load_crc

_POLY = 0x82F63B78


def _make_tables(n: int = 8) -> list[list[int]]:
    t0 = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        t0.append(c)
    tables = [t0]
    for _ in range(1, n):
        prev = tables[-1]
        tables.append([t0[v & 0xFF] ^ (v >> 8) for v in prev])
    return tables


_TABLES = _make_tables()
_T0 = _TABLES[0]


def _crc_bytes(b: bytes, c: int) -> int:
    t0 = _T0
    for byte in b:
        c = (c >> 8) ^ t0[(c ^ byte) & 0xFF]
    return c


def crc32c_fast(data: bytes | bytearray | memoryview,
                crc: int = 0xFFFFFFFF) -> int:
    """Slicing-by-8: one 64-bit load + 8 table lookups per 8 input bytes
    (~8x the scalar loop on CPython)."""
    c = crc & 0xFFFFFFFF
    b = bytes(data)
    n8 = len(b) // 8 * 8
    t7, t6, t5, t4, t3, t2, t1, t0 = _TABLES[::-1]
    for i in range(0, n8, 8):
        q = int.from_bytes(b[i:i + 8], "little") ^ c
        c = (
            t7[q & 0xFF]
            ^ t6[(q >> 8) & 0xFF]
            ^ t5[(q >> 16) & 0xFF]
            ^ t4[(q >> 24) & 0xFF]
            ^ t3[(q >> 32) & 0xFF]
            ^ t2[(q >> 40) & 0xFF]
            ^ t1[(q >> 48) & 0xFF]
            ^ t0[(q >> 56) & 0xFF]
        )
    return _crc_bytes(b[n8:], c) & 0xFFFFFFFF


def crc32c(data: bytes | bytearray | memoryview,
           crc: int = 0xFFFFFFFF) -> int:
    """Streaming CRC-32C.  Note: the reference passes the raw initial value
    (usually -1 == 0xffffffff) and does NOT pre/post-invert — this matches
    ceph_crc32c's contract, not the zlib crc32 one.  Buffers of 256 bytes
    and more go through the native kernel (native/crc.cpp, the
    ceph_crc32c_intel_fast role), small ones through the Python table
    loop."""
    b = bytes(data)
    if len(b) >= 256:
        return int(load_crc().ceph_tpu_crc32c(crc & 0xFFFFFFFF, b, len(b)))
    return _crc_bytes(b, crc & 0xFFFFFFFF) & 0xFFFFFFFF
