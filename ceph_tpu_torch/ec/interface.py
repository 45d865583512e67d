"""Erasure-code interface and shared base logic.

Port of `ceph_tpu/ec/interface.py`: profile parsing, chunk-size and
alignment math, `encode_prepare` split+pad, the first-k-available
`minimum_to_decode`, and the encode/decode entry points.

Buffers: numpy uint8 arrays (or bytes) in give numpy out; torch tensors
in stay tensors on their device (the role of `rs.py:_is_device_array` in
the JAX package).  The per-stripe math is delegated to an engine (host
numpy, or `ec.torch_backend.TorchEngine`).
"""

from __future__ import annotations

import numpy as np
import torch


class ErasureCodeProfileError(ValueError):
    pass


def _get_int(profile: dict, key: str, default: int) -> int:
    v = profile.get(key, default)
    try:
        return int(v)
    except (TypeError, ValueError):
        raise ErasureCodeProfileError(f"{key}={v!r} is not an integer")


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _as_u8(x):
    """A chunk as uint8: tensors stay tensors, anything else -> numpy."""
    return x if _is_tensor(x) else np.asarray(x, np.uint8)


def _to_tensor(a, device) -> torch.Tensor:
    """Host bytes as a uint8 tensor on `device`."""
    a = np.ascontiguousarray(a, np.uint8)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _stack(chunks: list, dim: int):
    """Stack chunks; if any is a tensor the result is a tensor on its
    device (numpy chunks are uploaded there), else numpy."""
    dev = next((c.device for c in chunks if _is_tensor(c)), None)
    if dev is None:
        return np.stack([np.asarray(c, np.uint8) for c in chunks], axis=dim)
    return torch.stack(
        [c if _is_tensor(c) else _to_tensor(c, dev) for c in chunks], dim=dim
    )


class ErasureCode:
    """Base code: systematic, chunked; subclasses fill k/m and the chunk
    math."""

    def __init__(self):
        self.k = 0
        self.m = 0
        self.w = 8
        self.chunk_mapping: list[int] = []
        self.profile: dict = {}
        self.device = None  # where the device engine runs; None: the card

    # -- profile -----------------------------------------------------------
    def init(self, profile: dict) -> None:
        self.profile = dict(profile)
        self.parse(profile)

    def parse(self, profile: dict) -> None:
        self.k = _get_int(profile, "k", self.k or 2)
        self.m = _get_int(profile, "m", self.m or 1)
        self.w = _get_int(profile, "w", 8)
        if self.k < 1:
            raise ErasureCodeProfileError(f"k={self.k} must be >= 1")
        if self.m < 1:
            raise ErasureCodeProfileError(f"m={self.m} must be >= 1")
        mapping = profile.get("mapping")
        if mapping:
            # 'D' positions first (data), then the rest, in order
            # (reference src/erasure-code/ErasureCode.cc to_mapping)
            self.chunk_mapping = [
                i for i, c in enumerate(mapping) if c == "D"
            ] + [i for i, c in enumerate(mapping) if c != "D"]

    # -- geometry ----------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_coding_chunk_count(self) -> int:
        return self.m

    def get_sub_chunk_count(self) -> int:
        return 1

    def get_alignment(self) -> int:
        # jerasure reed_sol_van: k * w * sizeof(int)
        return self.k * self.w * 4

    def get_chunk_size(self, object_size: int) -> int:
        """Pad object to `alignment`, split into k (jerasure
        get_chunk_size semantics)."""
        alignment = self.get_alignment()
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        return padded // self.k

    # -- mapping -----------------------------------------------------------
    def chunk_index(self, i: int) -> int:
        """The position of chunk i under the profile's `mapping` (its data
        positions first), or i without one."""
        return self.chunk_mapping[i] if self.chunk_mapping else i

    # -- minimum sets ------------------------------------------------------
    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> set[int]:
        """First-k-available rule (reference ErasureCode.cc:103-120)."""
        if want_to_read <= available:
            return set(want_to_read)
        if len(available) < self.k:
            raise ValueError(
                f"need {self.k} chunks, only {len(available)} available"
            )
        return set(sorted(available)[: self.k])

    def minimum_to_decode_with_cost(
        self, want_to_read: set[int], available: dict[int, int]
    ) -> set[int]:
        """Cost-blind base version (reference ErasureCode.cc:122-133):
        `minimum_to_decode` over the chunks `available` (chunk -> cost)
        names."""
        return self.minimum_to_decode(want_to_read, set(available))

    # -- encode ------------------------------------------------------------
    def encode_prepare(self, data):
        """Split+zero-pad into k rows of chunk_size (reference
        ErasureCode.cc:151-186 encode_prepare).  A tensor is padded on its
        own device."""
        if _is_tensor(data):
            buf = data.reshape(-1)
            cs = self.get_chunk_size(buf.numel())
            out = torch.zeros(
                self.k * cs, dtype=torch.uint8, device=buf.device
            )
            out[: buf.numel()] = buf
            return out.view(self.k, cs)
        buf = np.frombuffer(bytes(data), np.uint8)
        cs = self.get_chunk_size(len(buf))
        out = np.zeros((self.k, cs), np.uint8)
        out.reshape(-1)[: len(buf)] = buf
        return out

    def encode(self, want_to_encode: set[int], data) -> dict:
        chunks = self.encode_prepare(data)
        encoded = self.encode_chunks(chunks)
        return {i: encoded[i] for i in want_to_encode}

    def encode_chunks(self, data):
        """[k, cs] data rows -> [k+m, cs] all chunks."""
        raise NotImplementedError

    # -- decode ------------------------------------------------------------
    def decode(
        self,
        want_to_read: set[int],
        chunks: dict,
        chunk_size: int | None = None,
    ) -> dict:
        """reference ErasureCode.cc _decode: trivial path if all present,
        else delegate to decode_chunks."""
        if want_to_read <= set(chunks):
            return {i: _as_u8(chunks[i]) for i in want_to_read}
        if chunk_size is None:
            chunk_size = len(next(iter(chunks.values())))
        full = self.decode_chunks(want_to_read, chunks, chunk_size)
        return {i: full[i] for i in want_to_read}

    def decode_chunks(
        self, want_to_read: set[int], chunks: dict, chunk_size: int
    ) -> dict:
        raise NotImplementedError

    def decode_concat(self, chunks: dict) -> bytes:
        """Reassemble the original object bytes from data chunks
        (reference ErasureCode.cc decode_concat)."""
        out = self.decode(set(range(self.k)), chunks)
        return b"".join(
            (out[i].cpu().numpy() if _is_tensor(out[i]) else out[i])
            .tobytes()
            for i in range(self.k)
        )
