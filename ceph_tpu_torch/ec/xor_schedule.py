"""XOR-schedule compiler: lower a GF(2^8) code matrix to an XOR DAG.

Port of `ceph_tpu/ec/xor_schedule.py`.  Per "Accelerating XOR-based
Erasure Coding using Program Optimization Techniques" (PAPERS.md), any
GF(2^8) matrix product C·data decomposes into XORs of byte rows:
C[r,i]·x = XOR over the set bits j of C[r,i] of (2^j·x), and 2^j·x is j
applications of the carry-reduced doubling `xtime`.  So parity row r is
an XOR of "virtual rows" v[8i+j] = 2^j·data[i], with the term set read
straight off the GF(2) bit-matrix (gf.matrix_to_bitmatrix: bit j of
C[r,i] is B[8r+j, 8i]).

A matrix is lowered once, when a profile is parsed, into an
`XorSchedule`:

- `terms`: the naive per-output term lists (the bitmatrix rows), and
- `ops` / `outs`: the same program after greedy pairwise common-
  subexpression elimination (Paar's algorithm): the pair of operands
  shared by the most outputs becomes a temp, repeat to fixpoint.  For
  RS(8,4) reed_sol_van this cuts 106 XORs to 63.

Schedules are a function of the matrix bytes only, so they cache by
matrix key (`_SCHEDULES`).  The torch executors of both forms (the `xor`
and `xor_cse` strategies) are in ec.torch_backend; `host_apply` executes
the CSE DAG in numpy and is the oracle the tests hold both against.
`COUNTERS` holds the JAX package's `ec` counters of this module.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from ceph_tpu_torch.ec.gf import gf_xtime, matrix_to_bitmatrix

COUNTERS: dict[str, int] = {
    "xor_schedules_built": 0,      # XOR DAG lowerings (one per new matrix)
    "xor_schedule_cache_hits": 0,  # requests served from _SCHEDULES
}


def matrix_key(M: np.ndarray) -> tuple:
    """Structural identity of a code matrix (shape + content bytes)."""
    M = np.asarray(M, np.uint8)
    return (M.shape, M.tobytes())


@dataclass(frozen=True)
class XorSchedule:
    """Compiled XOR program for parity = M·data over virtual byte rows.

    Virtual row ids: 0..8k-1 are inputs (id 8i+j ≡ 2^j·data[i]); ids
    >= 8k are CSE temps in `ops` order.  `terms[r]` is the naive term
    list of output r; `outs[r]` the residual list after CSE (may
    reference temp ids)."""

    shape: tuple            # (m, k) of the source matrix
    key: tuple              # matrix_key(M), the structural cache key
    terms: tuple            # tuple[tuple[int, ...]] naive per-output
    ops: tuple              # tuple[(temp_id, a, b)] CSE temps
    outs: tuple             # tuple[tuple[int, ...]] post-CSE per-output
    max_power: tuple = field(default=())  # per input i: highest j used

    @property
    def n_inputs(self) -> int:
        return 8 * self.shape[1]

    @property
    def n_xors_naive(self) -> int:
        return sum(max(len(t) - 1, 0) for t in self.terms)

    @property
    def n_xors_cse(self) -> int:
        return len(self.ops) + sum(max(len(t) - 1, 0) for t in self.outs)

    def stats(self) -> dict:
        """How much the lowering saved."""
        return {
            "outputs": self.shape[0],
            "inputs": self.shape[1],
            "xors_naive": self.n_xors_naive,
            "xors_cse": self.n_xors_cse,
            "temps": len(self.ops),
        }


def bit_terms(M: np.ndarray) -> list[list[int]]:
    """Naive term lists: output r reads virtual row 8i+j iff bit j of
    M[r,i], i.e. iff matrix_to_bitmatrix(M)[8r+j, 8i] (the first column
    of each 8-wide block holds the bits of the untwisted constant)."""
    M = np.asarray(M, np.uint8)
    B = matrix_to_bitmatrix(M)
    m, k = M.shape
    return [
        [8 * i + j for i in range(k) for j in range(8) if B[8 * r + j, 8 * i]]
        for r in range(m)
    ]


def _paar_cse(term_sets: list[set[int]], next_id: int):
    """Greedy pairwise CSE (Paar): factor out the operand pair shared by
    the most outputs until no pair repeats.  Ties go to the lowest pair,
    so schedules are the same in every run."""
    ops: list[tuple[int, int, int]] = []
    while True:
        cnt: Counter = Counter()
        for s in term_sets:
            rs = sorted(s)
            for x in range(len(rs)):
                for y in range(x + 1, len(rs)):
                    cnt[(rs[x], rs[y])] += 1
        if not cnt:
            break
        (a, b), c = min(
            cnt.items(), key=lambda t: (-t[1], t[0][0], t[0][1])
        )
        if c < 2:
            break
        ops.append((next_id, a, b))
        for s in term_sets:
            if a in s and b in s:
                s -= {a, b}
                s.add(next_id)
        next_id += 1
    return ops, [tuple(sorted(s)) for s in term_sets]


_SCHEDULES: dict[tuple, XorSchedule] = {}


def build_schedule(M: np.ndarray) -> XorSchedule:
    """Lower M to its XOR schedule, cached per matrix content: the
    "derive once per profile" step; decode plans reuse it per erasure
    pattern because their recover matrices are matrices too."""
    key = matrix_key(M)
    sched = _SCHEDULES.get(key)
    if sched is not None:
        COUNTERS["xor_schedule_cache_hits"] += 1
        return sched
    terms = bit_terms(M)
    m, k = np.asarray(M).shape
    ops, outs = _paar_cse([set(t) for t in terms], 8 * k)
    used = {t for term in terms for t in term}
    max_power = tuple(
        max((j for j in range(8) if 8 * i + j in used), default=0)
        for i in range(k)
    )
    sched = XorSchedule(
        shape=(int(m), int(k)), key=key,
        terms=tuple(tuple(t) for t in terms),
        ops=tuple(ops), outs=tuple(outs), max_power=max_power,
    )
    _SCHEDULES[key] = sched
    COUNTERS["xor_schedules_built"] += 1
    return sched


def host_apply(sched: XorSchedule, data: np.ndarray) -> np.ndarray:
    """Execute the CSE DAG on the host (numpy): the bit-exact oracle of
    the torch executors, and a direct proof of the CSE pass (it runs
    `ops`/`outs`, not the naive `terms`)."""
    data = np.asarray(data, np.uint8)
    m, k = sched.shape
    if data.shape[0] != k:
        raise ValueError(f"data {data.shape} does not match the schedule's "
                         f"{k} inputs")
    vals: dict[int, np.ndarray] = {}
    for i in range(k):
        v = data[i]
        vals[8 * i] = v
        for j in range(1, sched.max_power[i] + 1):
            v = gf_xtime(v)
            vals[8 * i + j] = v
    for tid, a, b in sched.ops:
        vals[tid] = vals[a] ^ vals[b]
    out = np.zeros((m,) + data.shape[1:], np.uint8)
    for r, term in enumerate(sched.outs):
        acc = None
        for t in term:
            acc = vals[t] if acc is None else acc ^ vals[t]
        if acc is not None:
            out[r] = acc
    return out
