"""SHEC: Shingled Erasure Code (k, m, c).

Port of `ceph_tpu/ec/shec.py` (the reference's shec plugin,
src/erasure-code/shec/ErasureCodeShec.{h,cc}): a Vandermonde RS coding
matrix with runs of entries zeroed so each parity covers only a "shingle"
of the data chunks.  Local repair reads fewer chunks, at the cost of
tolerating only c (not m) arbitrary failures.  The multiple-shingle layout
splits the parities into two groups (m1,c1)/(m2,c2) chosen to minimise
the reference's recovery-efficiency metric
(shec_calc_recovery_efficiency1).

Defaults k=4, m=3, c=2 (reference ErasureCodeShec.h:47-57), on the
device engine (with the profile's `strategy`) unless the profile names
a host engine, `backend=numpy` or `backend=native`.  Numpy in gives
numpy out, the JAX package's bytes, each product's operands uploaded to
the engine's device; tensors stay on their device.  Every product goes
through the engine.
"""

from __future__ import annotations

import itertools

import numpy as np

from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.ec.gf import gf_invert_matrix, gf_matmul
from ceph_tpu_torch.ec.interface import (
    ErasureCode,
    ErasureCodeProfileError,
    _as_u8,
    _stack,
)
from ceph_tpu_torch.ec.rs import DEFAULT_BACKEND, _concat, get_engine


def _zero_shingles(M: np.ndarray, rows: range, mm: int, cc: int) -> None:
    """Zero matrix entries outside each parity row's shingle (the loop of
    reference shec_reedsolomon_coding_matrix)."""
    k = M.shape[1]
    for ri, rr in enumerate(rows):
        end = ((ri * k) // mm) % k
        start = (((ri + cc) * k) // mm) % k
        ccol = start
        while ccol != end:
            M[rr, ccol] = 0
            ccol = (ccol + 1) % k


def _recovery_efficiency1(k: int, m1: int, m2: int, c1: int, c2: int) -> float:
    """reference shec_calc_recovery_efficiency1."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [10**8] * k
    r_e1 = 0.0
    for mm, cc in ((m1, c1), (m2, c2)):
        for rr in range(mm):
            start = ((rr * k) // mm) % k
            end = (((rr + cc) * k) // mm) % k
            ccol, first = start, True
            while first or ccol != end:
                first = False
                r_eff_k[ccol] = min(
                    r_eff_k[ccol],
                    ((rr + cc) * k) // mm - (rr * k) // mm,
                )
                ccol = (ccol + 1) % k
            r_e1 += ((rr + cc) * k) // mm - (rr * k) // mm
    return r_e1 + sum(r_eff_k)


def shec_matrix(k: int, m: int, c: int, single: bool = False) -> np.ndarray:
    """m×k shingled coding matrix."""
    if single:
        m1, c1 = 0, 0
    else:
        best = None
        m1 = c1 = 0
        for cc1 in range(c // 2 + 1):
            for mm1 in range(m + 1):
                cc2, mm2 = c - cc1, m - mm1
                if mm1 < cc1 or mm2 < cc2:
                    continue
                if (mm1 == 0) != (cc1 == 0) or (mm2 == 0) != (cc2 == 0):
                    continue
                r = _recovery_efficiency1(k, mm1, mm2, cc1, cc2)
                if r >= 0 and (best is None or r < best):
                    best, m1, c1 = r, mm1, cc1
    m2, c2 = m - m1, c - c1
    M = matrices.vandermonde_rs(k, m)
    if m1:
        _zero_shingles(M, range(m1), m1, c1)
    if m2:
        _zero_shingles(M[m1:], range(m2), m2, c2)
    return M


class ShecCode(ErasureCode):
    """plugin=shec; profile: k=4, m=3, c=2, technique=multiple|single,
    backend=torch|numpy|native, strategy (the per-stripe products ride
    the engines of ec.rs; the device engine by default)."""

    def __init__(self):
        super().__init__()
        self.c = 0
        self.C: np.ndarray | None = None
        self.engine = None

    def parse(self, profile: dict) -> None:
        self.k, self.m = 4, 3
        super().parse(profile)
        try:
            self.c = int(profile.get("c", 2))
        except (TypeError, ValueError):
            raise ErasureCodeProfileError("c must be an integer")
        if not (0 < self.c <= self.m):
            raise ErasureCodeProfileError(
                f"c={self.c} must be within (0, m={self.m}]"
            )
        if self.w != 8:
            raise ErasureCodeProfileError("only w=8 is supported")
        technique = profile.get("technique", "multiple")
        if technique not in ("single", "multiple"):
            raise ErasureCodeProfileError(
                f"shec: unknown technique {technique!r}"
            )
        self.C = shec_matrix(
            self.k, self.m, self.c, single=(technique == "single")
        )
        self.engine = get_engine(profile.get("backend", DEFAULT_BACKEND),
                                 profile.get("strategy"), self.device)
        if hasattr(self.engine, "prepare"):
            self.engine.prepare(self.C)

    def encode_chunks(self, data):
        """[k, cs] data rows -> [k+m, cs] all chunks."""
        data = _as_u8(data)
        return _concat(data, self.engine.matmul(self.C, data), 0)

    # -- decoding: solve the shingled system --------------------------------
    def _plans(self, wanted: set[int], avail_parity: list[int],
               known_data: set[int]):
        """Solvable recovery plans in increasing read-cost order.

        A plan is (cost, rows, unknowns, need, inv): parity `rows` whose
        shingles touch exactly the erased-data `unknowns` ⊇ wanted
        (untouched erased columns stay out of the system), with the square
        submatrix C[rows, unknowns] invertible.  `need` is the known data
        the rows read; cost = |need| + |rows|: the minimal-read search of
        the reference's shec_make_decoding_matrix."""
        plans = []
        for u in range(max(len(wanted), 1), len(avail_parity) + 1):
            for rows in itertools.combinations(avail_parity, u):
                unknowns = set(wanted)
                need = set()
                for r in rows:
                    for j in range(self.k):
                        if not self.C[r, j]:
                            continue
                        if j in known_data:
                            need.add(j)
                        else:
                            unknowns.add(j)
                if len(unknowns) != u:
                    continue
                cols = sorted(unknowns)
                try:
                    inv = gf_invert_matrix(self.C[np.ix_(list(rows), cols)])
                except np.linalg.LinAlgError:
                    continue
                plans.append((len(need) + u, list(rows), cols, need, inv))
        plans.sort(key=lambda t: (t[0], t[1]))
        return plans

    def _apply_plan(self, rows, cols, inv, chunks: dict) -> dict:
        """Solve for the unknowns, inv · (parity - known contribution), as
        one engine product over [parity rows; known data] with the matrix
        inv · [I | C[rows, known]]: the bytes of the JAX package's host
        elimination then product (GF(2^8) is a field), and on a tensor no
        host table."""
        known = [
            j for j in range(self.k)
            if j not in cols and j in chunks and self.C[rows, j].any()
        ]
        M = gf_matmul(inv, np.concatenate(
            [np.eye(len(rows), dtype=np.uint8),
             self.C[np.ix_(rows, known)]], axis=1))
        sol = self.engine.matmul(M, _stack(
            [chunks[self.k + r] for r in rows] + [chunks[j] for j in known],
            0))
        return {d: sol[i] for i, d in enumerate(cols)}

    def decode_chunks(self, want_to_read: set[int], chunks: dict,
                      chunk_size: int) -> dict:
        out = {i: _as_u8(v) for i, v in chunks.items()}
        erased_data = {i for i in range(self.k) if i not in chunks}
        known = {i for i in range(self.k) if i in chunks}
        avail_parity = [r for r in range(self.m) if (self.k + r) in chunks]
        want_parity = {
            r for r in range(self.m)
            if (self.k + r) in want_to_read and (self.k + r) not in chunks
        }
        # erased parity re-encode needs the full data vector
        wanted = (
            set(erased_data) if want_parity
            else (want_to_read & erased_data)
        )
        if wanted:
            plans = self._plans(wanted, avail_parity, known)
            if not plans:
                raise ValueError(
                    f"shec: cannot recover chunks {sorted(wanted)} from "
                    f"{sorted(chunks)}"
                )
            _, rows, cols, _, inv = plans[0]
            out.update(self._apply_plan(rows, cols, inv, out))
        if want_parity:
            data = _stack([out[i] for i in range(self.k)], 0)
            par = self.engine.matmul(self.C[sorted(want_parity)], data)
            for row, r in zip(par, sorted(want_parity)):
                out[self.k + r] = row
        return out

    def minimum_to_decode(self, want_to_read: set[int],
                          available: set[int]) -> set[int]:
        """Prefer the smallest shingle read (the point of SHEC) over the
        base first-k rule.  Mirrors decode_chunks' planning so the set is
        decodable: re-encoding a wanted erased parity chunk needs the
        full data vector, so every erased data chunk is then an unknown."""
        if want_to_read <= available:
            return set(want_to_read)
        erased_data = {i for i in range(self.k) if i not in available}
        want_parity = {
            r for r in range(self.m)
            if (self.k + r) in want_to_read
            and (self.k + r) not in available
        }
        wanted = (
            set(erased_data) if want_parity
            else (want_to_read & erased_data)
        )
        avail_parity = [r for r in range(self.m) if (self.k + r) in available]
        known = {i for i in range(self.k) if i in available}
        base = want_to_read & available
        if want_parity:
            base = base | known  # re-encode reads all surviving data
        if not wanted:
            # only parity wanted, all data present: read all data
            # (want_to_read ⊄ available means a wanted erased chunk, and
            # with no erased data wanted it is a parity)
            assert want_parity
            return base
        for _, rows, _, need, _ in self._plans(wanted, avail_parity, known):
            return set(need) | {self.k + r for r in rows} | base
        raise ValueError(
            f"shec: cannot satisfy want={sorted(want_to_read)} from "
            f"available={sorted(available)}"
        )
