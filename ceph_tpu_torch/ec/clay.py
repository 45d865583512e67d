"""Clay (coupled-layer) MSR regenerating code.

Port of `ceph_tpu/ec/clay.py` (the reference's clay plugin,
src/erasure-code/clay/ErasureCodeClay.{h,cc}): an (k, m, d) MSR code built
by coupling q^t planes of an inner scalar MDS code, where q = d-k+1,
t = ceil((k+m)/q), nu = q*t-(k+m) virtual shortened nodes, and every chunk
splits into sub_chunk_no = q^t sub-chunks.  Single-chunk repair contacts d
helpers and reads a 1/q fraction of each (reference minimum_to_repair
:325, get_repair_subchunks :360).

- Chunks live as [sub_chunk_no, sc_size] arrays per node id of the padded
  q*t grid (external chunk i <-> node i for data, i+nu for parity); a
  layered decode keeps them, and the uncoupled symbols U, in a workspace
  of its own, never in a caller's tensor.
- The pair-wise coupling (the reference's "pft" k=2,m=2 code) is a (2,2)
  RS code over [c_lo, c_hi, u_lo, u_hi]: any two symbols give the rest.
- The inner MDS across a plane is RS(k+nu, m), Vandermonde by default.
- The layered decode walks planes in intersection-score order, the
  reference's schedule (decode_layered :647).  Its products, and those of
  a repair with aloof nodes, are planned once per erasure pattern, as
  rows of the workspace, and cut into runs of independent products
  (`_ProductPlan`); on the device engine each run is one grouped product,
  one kernel launch (config 4's encode: 352 products in 3 launches).

Where each product runs: every product goes through the engine, which is
the Hopper kernel on a CUDA tensor and its plain version on a CPU tensor;
the device engine (with the profile's `strategy`) is the default.
Tensors stay on their device.  Numpy in gives numpy out: with the device
engine a call uploads its input to the engine's device once and reads its
result back once; with `backend=numpy` or `backend=native` it computes on
the host as the JAX package does (a host engine refuses a CUDA tensor).
It books the JAX package's `ec` counters of this module (its repair
keys) and spans (`ec.clay_encode`, `ec.clay_decode`, `ec.clay_repair`);
`COUNTERS` reads them.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch import obs
from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.ec.gf import GF_MUL_TABLE
from ceph_tpu_torch.ec.interface import (
    ErasureCode,
    ErasureCodeProfileError,
    _as_u8,
    _is_tensor,
    _stack,
    _to_tensor,
)
from ceph_tpu_torch.ec.rs import DEFAULT_BACKEND, _concat, get_engine
from ceph_tpu_torch.ec.torch_backend import (
    BASE1,
    Product,
    ProductList,
    TorchEngine,
)
from ceph_tpu_torch.utils.perf_counters import counters_attr

_L = obs.logger_for("ec")
_L.add_u64("bytes_encoded", "stripe bytes pushed through encode_chunks")
_L.add_u64("bytes_decoded", "chunk bytes rebuilt by decode_chunks")
_L.add_time_avg("encode_seconds", "encode_chunks wall time")
_L.add_time_avg("decode_seconds", "decode_chunks wall time")
_L.add_u64("repair_bytes", "chunk bytes rebuilt by minimum-bandwidth repair")
_L.add_time_avg("repair_seconds", "repair wall time")
_L.add_avg("repair_read_fraction",
           "helper bytes read / full-stripe bytes, per repair")
_L.add_u64("repair_plan_hits",
           "batched repairs served by a cached product-matrix plan")
_L.add_u64("repair_plan_misses",
           "product-matrix repair plans built (one per lost node)")
__getattr__ = counters_attr("ec", __name__, (
    "bytes_encoded", "bytes_decoded", "repair_bytes",
    "repair_read_fraction", "repair_plan_hits", "repair_plan_misses"))


def _zeros(shape, like):
    """uint8 zeros of `shape`, a tensor on `like`'s device if it is one."""
    if _is_tensor(like):
        return torch.zeros(tuple(shape), dtype=torch.uint8,
                           device=like.device)
    return np.zeros(tuple(shape), np.uint8)


def _numel(x) -> int:
    return x.numel() if _is_tensor(x) else np.asarray(x).size


def _index(idx: np.ndarray, like):
    """An int64 index for `like`: the numpy array, or a long tensor on its
    device (never uint8, which torch would read as a mask)."""
    if _is_tensor(like):
        return torch.from_numpy(np.asarray(idx, np.int64)).to(like.device)
    return idx


def _put(A, idx, V) -> None:
    """A[idx] = V along dim 0."""
    if _is_tensor(A):
        A.index_copy_(0, idx, V)
    else:
        A[idx] = V


def _cut_runs(products: list[tuple]) -> list[list[tuple]]:
    """Products (M, input rows, output rows), in the order they must
    appear to run, cut into runs that each run as one grouped product: a
    product joins the first run after every run holding an earlier
    product that writes a row it reads or writes, or reads a row it
    writes.  So no row of a run is written by one of its products and
    touched by another, and running the runs in turn gives the bytes of
    running the products in order."""
    written, read = {}, {}  # row -> the last run that writes / reads it
    runs: list[list[tuple]] = []
    for product in products:
        _, ins, outs = product
        r = max([written.get(row, -1) + 1 for row in ins]
                + [max(written.get(row, -1), read.get(row, -1)) + 1
                   for row in outs])
        if r == len(runs):
            runs.append([])
        runs[r].append(product)
        for row in ins:
            read[row] = max(read.get(row, -1), r)
        for row in outs:
            written[row] = r
    return runs


class _ProductPlan:
    """The products of a layered decode (`ClayCode._layered_products`) or
    of a repair with aloof nodes (`ClayCode._aloof_products`), cut into
    runs (`_cut_runs`), and each run as a `ProductList` of rows of sc
    bytes, for the last few sub-chunk sizes it ran at."""

    SIZES = 4  # sub-chunk sizes whose lists are kept

    def __init__(self, products: list[tuple]):
        self.runs = _cut_runs(products)
        self._lists: dict[int, list[ProductList]] = {}

    def lists(self, sc: int) -> list[ProductList]:
        got = self._lists.get(sc)
        if got is None:
            if len(self._lists) >= self.SIZES:
                del self._lists[next(iter(self._lists))]

            def offsets(rows):
                return tuple((row & BASE1) | (row & (BASE1 - 1)) * sc
                             for row in rows)

            got = self._lists[sc] = [
                ProductList([Product(M, offsets(ins), offsets(outs), sc)
                             for M, ins, outs in run])
                for run in self.runs]
        return got


class _PairTransform:
    """(2,2) RS code over [c_lo, c_hi, u_lo, u_hi]; recovers any 2 missing
    symbols from the other 2 (the reference's pft scalar code).  Its
    recover matrices come from `matrices.recover_matrix`, which caches
    them by (present, want)."""

    def __init__(self, C: np.ndarray | None = None):
        self.C = matrices.vandermonde_rs(2, 2) if C is None else C

    def matrix(self, present: list[int], want: list[int]) -> np.ndarray:
        return matrices.recover_matrix(self.C, present, want)


class ClayCode(ErasureCode):
    """plugin=clay; profile: k, m, [d=k+m-1], [technique], [backend]."""

    def __init__(self):
        super().__init__()
        self.d = 0
        self.q = 0
        self.t = 0
        self.nu = 0
        self.sub_chunk_no = 0
        self.mds_C: np.ndarray | None = None
        self.pft: _PairTransform | None = None
        self.engine = None
        # lost node -> product-matrix repair plan (see _repair_plan)
        self._repair_plans: dict[int, dict] = {}
        # ("layered", erased nodes) or ("aloof", lost node, aloof nodes)
        # -> the product plan of that decode or repair (see _plan)
        self._plans: dict[tuple, _ProductPlan] = {}

    # -- profile -----------------------------------------------------------
    def parse(self, profile: dict) -> None:
        self.k, self.m = 4, 2  # reference DEFAULT_K/DEFAULT_M
        super().parse(profile)
        k, m = self.k, self.m
        try:
            self.d = int(profile.get("d", k + m - 1))
        except (TypeError, ValueError):
            raise ErasureCodeProfileError("d must be an integer")
        if not (k <= self.d <= k + m - 1):
            raise ErasureCodeProfileError(
                f"value of d {self.d} must be within [{k},{k + m - 1}]"
            )
        self.q = self.d - k + 1
        self.nu = (self.q - (k + m) % self.q) % self.q
        if k + m + self.nu > 254:
            raise ErasureCodeProfileError("k+m+nu must be <= 254")
        self.t = (k + m + self.nu) // self.q
        self.sub_chunk_no = self.q**self.t
        # inner MDS across each plane: (k+nu) data + m parity
        technique = profile.get("technique", "reed_sol_van")
        maker = {
            "reed_sol_van": matrices.vandermonde_rs,
            "cauchy_orig": matrices.cauchy_orig,
            "cauchy_good": matrices.cauchy_good,
            "cauchy": matrices.isa_cauchy,
        }.get(technique)
        if maker is None:
            raise ErasureCodeProfileError(
                f"clay: unsupported technique {technique!r}"
            )
        self.mds_C = maker(k + self.nu, m)
        self.pft = _PairTransform()
        self.engine = get_engine(profile.get("backend", DEFAULT_BACKEND),
                                 profile.get("strategy"), self.device)
        self._repair_plans.clear()  # geometry may have changed
        self._plans.clear()

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_alignment(self) -> int:
        # sub_chunk_no * k * inner alignment (reference get_chunk_size)
        return self.sub_chunk_no * self.k * self.w * 4

    def _uploads(self, chunks) -> bool:
        """Whether a call's input is host bytes for the device engine: the
        call then runs on tensors on the engine's device (`_upload`) and
        gives numpy back."""
        return isinstance(self.engine, TorchEngine) and not any(
            _is_tensor(c) for c in chunks)

    def _upload(self, chunks: dict) -> dict:
        return {i: _to_tensor(c, self.engine.device)
                for i, c in chunks.items()}

    # -- plane geometry ----------------------------------------------------
    def _z_vec(self, z: int) -> list[int]:
        """base-q digits of z, most-significant first (reference
        get_plane_vector :888)."""
        v = [0] * self.t
        for i in range(self.t):
            v[self.t - 1 - i] = z % self.q
            z //= self.q
        return v

    def _z_sw(self, z: int, x: int, y: int, z_vec: list[int]) -> int:
        return z + (x - z_vec[y]) * self.q ** (self.t - 1 - y)

    # canonical 4-tuple: positions 0/2 = coupled/uncoupled of the pair
    # node with LARGER x, 1/3 = the smaller-x node (the reference's
    # i0..i3 swap when z_vec[y] > x)
    def _pair_indices(self, x: int, zy: int) -> tuple[int, int, int, int]:
        """returns positions (c_xy, c_sw, u_xy, u_sw) in the 4-tuple."""
        if zy > x:
            return 1, 0, 3, 2
        return 0, 1, 2, 3

    # -- layered decode (reference decode_layered :647) --------------------
    def _slot(self, node: int) -> int:
        """node -> its chunk's place in a layered workspace: the external
        chunks in order, then the nu virtual nodes."""
        if node < self.k:
            return node
        if node < self.k + self.nu:
            return self.k + self.m + node - self.k
        return node - self.nu

    def _plan(self, key: tuple) -> _ProductPlan:
        plan = self._plans.get(key)
        if plan is None:
            make = (self._layered_products if key[0] == "layered"
                    else self._aloof_products)
            plan = self._plans[key] = _ProductPlan(make(*key[1:]))
        return plan

    def _layered_products(self, erased: frozenset) -> list[tuple]:
        """The engine products of the reference's layered decode of the
        erased nodes (decode_layered :647, decode_erasures :714,
        decode_uncoupled :742, the pair operations :775-871), in its
        order, as (M, input rows, output rows).  A row is sub-chunk z of a
        node's coupled chunk (buffer 0, row slot * P + z) or of its
        uncoupled symbols U (buffer 1, BASE1 | node * P + z).  Where z's
        digit y is the node's x (a hole-dot position) U is the coupled
        row itself: the reference copies one into the other there."""
        q, t, m, P = self.q, self.t, self.m, self.sub_chunk_no
        n = q * t
        erased = set(erased)
        for i in range(self.k + self.nu, n):
            if len(erased) >= m:
                break
            erased.add(i)
        assert len(erased) == m
        zvs = [self._z_vec(z) for z in range(P)]

        def C(node, z):
            return self._slot(node) * P + z

        def U(node, z):
            if zvs[z][node // q] == node % q:
                return C(node, z)
            return BASE1 | (node * P + z)

        products = []

        def pair(known: dict, want: list, outs: list):
            present = sorted(known)
            products.append((self.pft.matrix(present, want),
                             [known[i] for i in present[:2]], outs))

        order = [sum(1 for i in erased if i % q == zv[i // q]) for zv in zvs]
        for score in range(max(order, default=0) + 1):
            planes = [z for z in range(P) if order[z] == score]
            for z in planes:  # decode_erasures
                zv = zvs[z]
                for x in range(q):
                    for y in range(t):
                        node_xy, node_sw = q * y + x, q * y + zv[y]
                        if node_xy in erased or zv[y] == x or (
                                zv[y] > x and node_sw not in erased):
                            continue
                        # uncoupled from coupled (reference :844)
                        z_sw = self._z_sw(z, x, y, zv)
                        c_xy, c_sw, u_xy, _ = self._pair_indices(x, zv[y])
                        u = {u_xy: U(node_xy, z)}
                        pair({c_xy: C(node_xy, z), c_sw: C(node_sw, z_sw)},
                             [2, 3], [u.get(2, U(node_sw, z_sw)),
                                      u.get(3, U(node_sw, z_sw))])
                present = sorted(set(range(n)) - erased)[: self.k + self.nu]
                missing = sorted(erased)
                products.append((
                    matrices.recover_matrix(self.mds_C, present, missing),
                    [U(i, z) for i in present], [U(i, z) for i in missing]))
            for z in planes:
                zv = zvs[z]
                for node_xy in sorted(erased):
                    x, y = node_xy % q, node_xy // q
                    node_sw = y * q + zv[y]
                    if zv[y] == x:
                        continue
                    z_sw = self._z_sw(z, x, y, zv)
                    if node_sw not in erased:
                        # type 1 (reference :775): the erased coupled
                        # symbol from its live partner and own uncoupled
                        c_xy, c_sw, u_xy, _ = self._pair_indices(x, zv[y])
                        pair({c_sw: C(node_sw, z_sw), u_xy: U(node_xy, z)},
                             [c_xy], [C(node_xy, z)])
                    elif zv[y] < x:
                        # both coupled from both uncoupled (reference
                        # :806; no index swap: zv[y] < x)
                        pair({2: U(node_xy, z), 3: U(node_sw, z_sw)},
                             [0, 1], [C(node_xy, z), C(node_sw, z_sw)])
        return products

    def _run_plan(self, plan: _ProductPlan, B0, B1) -> None:
        """A plan in place on its two buffers ([rows, sc] each): its runs,
        one grouped product each on the device engine (one kernel launch
        on the card), product by product on a host engine."""
        sc = B0.shape[-1]
        if isinstance(self.engine, TorchEngine):
            for plist in plan.lists(sc):
                self.engine.matmul_grouped(plist, B0, B1)
            return
        B0, B1 = B0.reshape(-1, sc), B1.reshape(-1, sc)

        def at(row):
            return (B1, row & (BASE1 - 1)) if row & BASE1 else (B0, row)

        for run in plan.runs:
            for M, ins, outs in run:
                out = self.engine.matmul(
                    M, _stack([buf[i] for buf, i in map(at, ins)], 0))
                for row, value in zip(outs, out):
                    buf, i = at(row)
                    buf[i] = value

    def _workspace(self, chunks: dict, sc: int, like):
        """A layered plan's buffers: C (chunks, `_slot` order) and U, zeros
        but for the given external chunks, copied into C."""
        n, P = self.q * self.t, self.sub_chunk_no
        C, U = _zeros((n, P, sc), like), _zeros((n, P, sc), like)
        for i, c in chunks.items():
            C[i] = c.reshape(P, sc)
        return C, U

    # -- node/chunk plumbing ----------------------------------------------
    def _node(self, i: int) -> int:
        """external chunk id -> node id of the padded grid."""
        return i if i < self.k else i + self.nu

    # -- public API --------------------------------------------------------
    def encode_chunks(self, data):
        """[k, cs] data rows -> [k+m, cs] all chunks."""
        k, m = self.k, self.m
        data = _as_u8(data)
        if self._uploads([data]):
            return self.encode_chunks(
                _to_tensor(data, self.engine.device)).cpu().numpy()
        cs = data.shape[1]
        if data.shape[0] != k or cs % self.sub_chunk_no:
            raise ValueError(
                f"data {tuple(data.shape)}: k={k} rows of a multiple of "
                f"sub_chunk_no {self.sub_chunk_no} bytes expected"
            )
        with obs.span("ec.clay_encode", k=k, m=m, d=self.d,
                      bytes=_numel(data)), _L.time("encode_seconds"):
            C, U = self._workspace({i: data[i] for i in range(k)},
                                   cs // self.sub_chunk_no, data)
            self._run_plan(self._plan(("layered", frozenset(
                self._node(i) for i in range(k, k + m)))), C, U)
            out = C[:k + m].reshape(k + m, cs)
        _L.inc("bytes_encoded", _numel(data))
        return out

    def decode_chunks(self, want_to_read: set[int], chunks: dict,
                      chunk_size: int) -> dict:
        k, m = self.k, self.m
        if len(chunks) < k:
            raise ValueError(f"cannot decode: {len(chunks)} < k={k}")
        if self._uploads(chunks.values()):
            out = self.decode_chunks(want_to_read, self._upload(chunks),
                                     chunk_size)
            return {i: c.cpu().numpy() for i, c in out.items()}
        erased = {self._node(i) for i in range(k + m) if i not in chunks}
        with obs.span("ec.clay_decode", k=k, m=m, missing=len(erased),
                      bytes=len(erased) * chunk_size), \
                _L.time("decode_seconds"):
            chunks = {i: _as_u8(c) for i, c in chunks.items()}
            C, U = self._workspace(chunks, chunk_size // self.sub_chunk_no,
                                   next(iter(chunks.values())))
            self._run_plan(self._plan(("layered", frozenset(erased))), C, U)
            out = dict(chunks)
            for i in range(k + m):
                if i not in out:
                    out[i] = C[i].reshape(-1)
        _L.inc("bytes_decoded", len(erased) * chunk_size)
        return out

    # -- repair (minimum-bandwidth single-node recovery) -------------------
    def is_repair(self, want_to_read: set[int], available: set[int]) -> bool:
        """reference is_repair :305."""
        if want_to_read <= available:
            return False
        if len(want_to_read) > 1:
            return False
        i = next(iter(want_to_read))
        lost = self._node(i)
        for x in range(self.q):
            node = (lost // self.q) * self.q + x
            node = node if node < self.k else node - self.nu
            if node != i and node not in available:
                return False
        return len(available) >= self.d

    def get_repair_subchunks(self, lost_node: int) -> list[tuple[int, int]]:
        """(index, count) runs of the 1/q sub-chunks helpers must send
        (reference get_repair_subchunks :360)."""
        q, t = self.q, self.t
        y_lost, x_lost = lost_node // q, lost_node % q
        seq = q ** (t - 1 - y_lost)
        out = []
        index = x_lost * seq
        for _ in range(q**y_lost):
            out.append((index, seq))
            index += q * seq
        return out

    def minimum_to_repair(self, want_to_read: set[int],
                          available: set[int]) -> dict:
        """reference minimum_to_repair :325: d helpers + their sub-chunk
        ranges, preferring the lost node's q-column."""
        lost = self._node(next(iter(want_to_read)))
        sub_ind = self.get_repair_subchunks(lost)
        minimum: dict[int, list[tuple[int, int]]] = {}
        for j in range(self.q):
            if j != lost % self.q:
                rep = (lost // self.q) * self.q + j
                if rep < self.k:
                    minimum[rep] = sub_ind
                elif rep >= self.k + self.nu:
                    minimum[rep - self.nu] = sub_ind
        for c in sorted(available):
            if len(minimum) >= self.d:
                break
            minimum.setdefault(c, sub_ind)
        assert len(minimum) == self.d
        return minimum

    def minimum_to_decode(self, want_to_read: set[int],
                          available: set[int]) -> set[int]:
        if self.is_repair(want_to_read, available):
            return set(self.minimum_to_repair(want_to_read, available))
        return super().minimum_to_decode(want_to_read, available)

    def repair(self, want_to_read: set[int], helper_chunks: dict,
               chunk_size: int) -> dict:
        """Rebuild one chunk from d helpers' repair sub-chunks.  Helper
        arrays may be full chunks or just the repair sub-chunk runs
        (repair_blocksize = chunk_size/q).  reference repair :390 +
        repair_one_lost_chunk :462."""
        if len(want_to_read) != 1 or len(helper_chunks) != self.d:
            raise ValueError(
                f"repair rebuilds one chunk from d={self.d} helpers, got "
                f"{sorted(want_to_read)} from {len(helper_chunks)}"
            )
        if self._uploads(helper_chunks.values()):
            out = self.repair(want_to_read, self._upload(helper_chunks),
                              chunk_size)
            return {i: c.cpu().numpy() for i, c in out.items()}
        read_bytes = sum(_numel(b) for b in helper_chunks.values())
        with obs.span("ec.clay_repair", k=self.k, m=self.m, d=self.d,
                      helpers=len(helper_chunks), read_bytes=read_bytes), \
                _L.time("repair_seconds"):
            out = self._repair(want_to_read, helper_chunks, chunk_size)
        _L.inc("repair_bytes", len(want_to_read) * chunk_size)
        _L.observe("repair_read_fraction",
                   read_bytes / (self.k * chunk_size))
        return out

    def _repair(self, want_to_read: set[int], helper_chunks: dict,
                chunk_size: int) -> dict:
        q, t = self.q, self.t
        i = next(iter(want_to_read))
        lost = self._node(i)
        sub_ind = self.get_repair_subchunks(lost)
        repair_sub_count = sum(c for _, c in sub_ind)
        sc = chunk_size // self.sub_chunk_no
        repair_planes = [
            z for ind, cnt in sub_ind for z in range(ind, ind + cnt)
        ]

        # node-indexed helper data [repair_sub_count, sc]
        helpers: dict = {}
        for ext_i, buf in helper_chunks.items():
            arr = _as_u8(buf).reshape(-1, sc)
            if arr.shape[0] == self.sub_chunk_no:
                arr = arr[_index(np.asarray(repair_planes), arr)]
            if arr.shape[0] != repair_sub_count:
                raise ValueError(
                    f"helper {ext_i}: {arr.shape[0]} sub-chunks, expected "
                    f"{repair_sub_count} or {self.sub_chunk_no}"
                )
            helpers[self._node(ext_i)] = arr
        like = next(iter(helpers.values()))
        for j in range(self.k, self.k + self.nu):
            helpers[j] = _zeros((repair_sub_count, sc), like)

        aloof = {
            self._node(j) for j in range(self.k + self.m)
            if j != i and j not in helper_chunks
        }
        if not aloof:
            # the d = #helpers = k+m-1 case: every plane has the same
            # score and the whole repair batches over the plane axis
            return {i: self._repair_batched(lost, helpers, sc,
                                            repair_planes).reshape(-1)}

        # buffer 0: the rebuilt chunk's sub-chunks, then each node's
        # repair sub-chunks; buffer 1: U
        P, RP, n = self.sub_chunk_no, repair_sub_count, q * t
        B, U = _zeros((P + n * RP, sc), like), _zeros((n * P, sc), like)
        for nd, arr in helpers.items():
            B[P + nd * RP:P + (nd + 1) * RP] = arr
        self._run_plan(self._plan(("aloof", lost, frozenset(aloof))), B, U)
        return {i: B[:P].reshape(-1)}

    def _aloof_products(self, lost: int, aloof: frozenset) -> list[tuple]:
        """The engine products of the reference's single-chunk repair with
        aloof nodes (repair_one_lost_chunk :462-640), in its order, as
        (M, input rows, output rows).  Buffer 0 holds the rebuilt chunk
        (row z) and the helpers' repair sub-chunks (row P + node * RP +
        position), buffer 1 U (BASE1 | node * P + z).  U at a hole-dot
        position is a live node's helper row or, for the lost node, the
        rebuilt row, as the reference copies them; a pair decoupling
        computes only the one symbol the reference keeps of the two."""
        q, t, P = self.q, self.t, self.sub_chunk_no
        n = q * t
        repair_planes = [z for ind, cnt in self.get_repair_subchunks(lost)
                         for z in range(ind, ind + cnt)]
        RP, pos = len(repair_planes), {z: j for j, z in
                                       enumerate(repair_planes)}
        erasures = {lost - lost % q + x for x in range(q)} | set(aloof)
        zvs = [self._z_vec(z) for z in range(P)]

        def H(node, z):
            return P + node * RP + pos[z]

        def U(node, z):
            if zvs[z][node // q] == node % q:
                if node == lost:
                    return z
                if node not in erasures:
                    return H(node, z)
            return BASE1 | (node * P + z)

        def pair(known: dict, want: int, out: int):
            present = sorted(known)
            products.append((self.pft.matrix(present, [want]),
                             [known[i] for i in present], [out]))

        # planes by intersection score over the lost and aloof nodes
        ordered: dict[int, list[int]] = {}
        for z in repair_planes:
            score = sum(1 for nd in {lost} | set(aloof)
                        if nd % q == zvs[z][nd // q])
            assert score > 0
            ordered.setdefault(score, []).append(z)
        products: list[tuple] = []
        for score in sorted(ordered):
            for z in ordered[score]:
                zv = zvs[z]
                # phase 1: U of the live nodes
                for y in range(t):
                    for x in range(q):
                        node_xy, node_sw = y * q + x, y * q + zv[y]
                        if node_xy in erasures or (
                                node_sw not in aloof and zv[y] == x):
                            continue
                        z_sw = self._z_sw(z, x, y, zv)
                        c_xy, c_sw, u_xy, u_sw = self._pair_indices(x, zv[y])
                        known = ({c_xy: H(node_xy, z), u_sw: U(node_sw, z_sw)}
                                 if node_sw in aloof else
                                 {c_xy: H(node_xy, z), c_sw: H(node_sw, z_sw)})
                        pair(known, u_xy, U(node_xy, z))
                # phase 2: MDS across the plane
                present = sorted(set(range(n)) - erasures)[: self.k + self.nu]
                missing = sorted(erasures)
                products.append((
                    matrices.recover_matrix(self.mds_C, present, missing),
                    [U(i, z) for i in present], [U(i, z) for i in missing]))
                # phase 3: the coupled symbols of the lost column
                for nd in sorted(erasures - set(aloof)):
                    x, y = nd % q, nd // q
                    if x == zv[y]:
                        continue  # the rebuilt row is U's
                    c_xy, c_sw, u_xy, _ = self._pair_indices(x, zv[y])
                    pair({c_xy: H(nd, z), u_xy: U(nd, z)}, c_sw,
                         self._z_sw(z, x, y, zv))
        return products

    def _repair_batched(self, lost: int, helpers: dict, sc: int,
                        repair_planes: list[int]):
        """Plane-batched single-chunk repair for the no-aloof case.

        Same math as the per-plane loop in `repair` (reference
        repair_one_lost_chunk, ErasureCodeClay.cc:462-640) with the plane
        axis as a batch dimension: every helper lies in one [n*P, sc]
        array, per live node the pair decoupling is one engine product
        per index-swap case over gathered rows, and the inner MDS and the
        coupled recovery are one product with the cached product matrix.
        Every gather and scatter takes the plan's int64 index vectors, so
        a tensor repair never leaves its device."""
        n, P = self.q * self.t, len(repair_planes)
        plan = self._repair_plan(lost, repair_planes)
        like = next(iter(helpers.values()))
        idx = plan["index"]
        if _is_tensor(like):
            on = plan["device_index"]
            if like.device not in on:
                on[like.device] = {name: _index(v, like)
                                   for name, v in idx.items()}
            idx = on[like.device]
        H = _stack(
            [helpers[nd] if nd in helpers else _zeros((P, sc), like)
             for nd in range(n)], 0,
        ).reshape(n * P, sc)
        U = _zeros((n * P, sc), like)

        # phase 1: uncoupled symbols of the live nodes
        _put(U, idx["eq"], H[idx["eq"]])
        for s, R in enumerate(plan["pair_R"]):
            rows = idx[f"pair_gather{s}"]
            X = H[rows].reshape(2, -1)
            rec = self.engine.matmul(R, X).reshape(-1, sc)
            _put(U, idx[f"pair_scatter{s}"], rec)

        # phases 2+3 fused: one product with the plan's RB, whose row for
        # erased node nd composes the inner-MDS recovery (U[nd] =
        # R_mds[nd]·U[present]) with the pair uncoupling (rec =
        # ch·helpers[nd] ⊕ cu·U[nd]) into direct coefficients over
        # [helpers[col_others]; U[present]] (the product-matrix form of
        # "Fast Product-Matrix Regenerating Codes", PAPERS.md)
        U = U.reshape(n, P, sc)
        H = H.reshape(n, P, sc)
        X = _concat(H[idx["col_others"]], U[idx["present"]], 0)
        out = self.engine.matmul(plan["RB"], X.reshape(-1, P * sc))
        recovered = _zeros((self.sub_chunk_no, sc), like)
        _put(recovered, idx["z_dest"], out.reshape(-1, sc))
        return recovered

    def _repair_plan(self, lost: int, repair_planes: list[int]) -> dict:
        """Cached plan for the no-aloof batched repair of `lost`.

        The product matrix RB: input rows [helpers of the lost column's
        other nodes; uncoupled rows of the surviving nodes], output row ri
        rebuilds the coupled bytes scattered to planes z_dest[ri].  Beside
        it, phase 1's pair matrices and every index vector, as offsets
        node * P + position into the [n*P, sc] helper and U arrays."""
        plan = self._repair_plans.get(lost)
        if plan is not None:
            _L.inc("repair_plan_hits")
            return plan
        q, t = self.q, self.t
        n, P = q * t, len(repair_planes)
        x_lost, y_lost = lost % q, lost // q
        plane_pos = {z: j for j, z in enumerate(repair_planes)}
        zvs = np.array([self._z_vec(z) for z in repair_planes], np.int64)
        positions = np.arange(P, dtype=np.int64)

        # phase 1, per live node (x, y): positions whose partner digit is
        # x copy the coupled symbol; the others decouple against the
        # partner plane (digit y flipped to x, itself a repair plane since
        # y != y_lost), split by the <x / >x index-swap cases
        index: dict[str, np.ndarray] = {}
        eq_rows, pair_R = [], []
        for y in range(t):
            if y == y_lost:
                continue  # the lost column holds the erasures
            step = q ** (t - 1 - y)
            for x in range(q):
                zy = zvs[:, y]
                pos_sw = np.array(
                    [plane_pos[z + (x - int(zy[j])) * step]
                     for j, z in enumerate(repair_planes)], np.int64)
                here = (y * q + x) * P + positions
                part = (y * q + zy) * P + pos_sw
                eq = zy == x
                eq_rows.append(here[eq])
                for swap, sel in ((False, ~eq & (zy < x)),
                                  (True, ~eq & (zy > x))):
                    if not sel.any():
                        continue
                    # canonical 4-tuple positions (larger-x first): when
                    # zy > x our node holds position 1, the partner 0
                    rows = ((part[sel], here[sel]) if swap
                            else (here[sel], part[sel]))
                    s = len(pair_R)
                    pair_R.append(self.pft.matrix([0, 1], [3 if swap else 2]))
                    index[f"pair_gather{s}"] = np.concatenate(rows)
                    index[f"pair_scatter{s}"] = here[sel]
        index["eq"] = np.concatenate(eq_rows)

        erasures = {y_lost * q + x for x in range(q)}
        present = sorted(set(range(n)) - erasures)[: self.k + self.nu]
        missing = sorted(erasures)
        col_others = [nd for nd in missing if nd != lost]
        R_mds = matrices.recover_matrix(self.mds_C, present, missing)
        RB = np.zeros((len(missing), len(col_others) + len(present)),
                      np.uint8)
        z_dest = []
        for ri, nd in enumerate(missing):
            x = nd % q
            if x == x_lost:
                # hole-dot planes: uncoupled == coupled; the row is the
                # MDS recovery itself, landing on the repair planes
                RB[ri, len(col_others):] = R_mds[ri]
                z_dest.append(np.asarray(repair_planes, np.int64))
                continue
            c_xy, c_sw, u_xy, u_sw = self._pair_indices(x, x_lost)
            known_pos = sorted((c_xy, u_xy))
            R2 = self.pft.matrix(known_pos, [c_sw])
            ch = int(R2[0, known_pos.index(c_xy)])
            cu = int(R2[0, known_pos.index(u_xy)])
            RB[ri, col_others.index(nd)] = ch
            RB[ri, len(col_others):] = GF_MUL_TABLE[cu, R_mds[ri]]
            z_dest.append(np.asarray(repair_planes, np.int64)
                          + (x - x_lost) * q ** (t - 1 - y_lost))
        index["col_others"] = np.asarray(col_others, np.int64)
        index["present"] = np.asarray(present, np.int64)
        index["z_dest"] = np.concatenate(z_dest)
        # the index vectors as long tensors, per device they were used on
        plan = {"RB": RB, "pair_R": pair_R, "index": index,
                "device_index": {}}
        self._repair_plans[lost] = plan
        _L.inc("repair_plan_misses")
        return plan

    def decode(self, want_to_read: set[int], chunks: dict,
               chunk_size: int | None = None) -> dict:
        avail = set(chunks)
        if want_to_read <= avail:
            return {i: _as_u8(chunks[i]) for i in want_to_read}
        if chunk_size is not None and self.is_repair(want_to_read, avail):
            if chunk_size > _numel(next(iter(chunks.values()))):
                return self.repair(want_to_read, chunks, chunk_size)
        return super().decode(want_to_read, chunks, chunk_size)
