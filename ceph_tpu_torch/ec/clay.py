"""Clay (coupled-layer) MSR regenerating code.

Port of `ceph_tpu/ec/clay.py` (the reference's clay plugin,
src/erasure-code/clay/ErasureCodeClay.{h,cc}): an (k, m, d) MSR code built
by coupling q^t planes of an inner scalar MDS code, where q = d-k+1,
t = ceil((k+m)/q), nu = q*t-(k+m) virtual shortened nodes, and every chunk
splits into sub_chunk_no = q^t sub-chunks.  Single-chunk repair contacts d
helpers and reads a 1/q fraction of each (reference minimum_to_repair
:325, get_repair_subchunks :360).

- Chunks live as [sub_chunk_no, sc_size] arrays per node id of the padded
  q*t grid (external chunk i <-> node i for data, i+nu for parity).
- The pair-wise coupling (the reference's "pft" k=2,m=2 code) is a (2,2)
  RS code over [c_lo, c_hi, u_lo, u_hi]: any two symbols give the rest.
- The inner MDS across a plane is RS(k+nu, m), Vandermonde by default.
- The layered decode walks planes in intersection-score order, the
  reference's schedule (decode_layered :647).

Where each product runs: every product goes through the engine, which is
the Hopper kernel on a CUDA tensor and its plain version on a CPU tensor;
the device engine (with the profile's `strategy`) is the default.
Tensors stay on their device.  Numpy in gives numpy out: with the device
engine a call uploads its input to the engine's device once and reads its
result back once; with `backend=numpy` or `backend=native` it computes on
the host as the JAX package does (a host engine refuses a CUDA tensor).
`COUNTERS` holds the JAX package's `ec` counters of this module (its
repair group).
"""

from __future__ import annotations

import numpy as np
import torch

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
from ceph_tpu_torch.ec.torch_backend import TorchEngine

COUNTERS: dict = {
    "bytes_encoded": 0,       # stripe bytes pushed through encode_chunks
    "bytes_decoded": 0,       # chunk bytes rebuilt by decode_chunks
    "repair_bytes": 0,        # chunk bytes rebuilt by repair
    # helper bytes read / (k * chunk bytes), per repair (a JAX avg)
    "repair_read_fraction": {"avgcount": 0, "sum": 0.0},
    "repair_plan_hits": 0,    # batched repairs served by a cached plan
    "repair_plan_misses": 0,  # product-matrix repair plans built
}


def _zeros(shape, like):
    """uint8 zeros of `shape`, a tensor on `like`'s device if it is one."""
    if _is_tensor(like):
        return torch.zeros(tuple(shape), dtype=torch.uint8,
                           device=like.device)
    return np.zeros(tuple(shape), np.uint8)


def _copy(x):
    return x.clone() if _is_tensor(x) else np.array(x, np.uint8)


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


class _PairTransform:
    """(2,2) RS code over [c_lo, c_hi, u_lo, u_hi]; recovers any 2 missing
    symbols from the other 2 (the reference's pft scalar code).  Its
    recover matrices come from `matrices.recover_matrix`, which caches
    them by (present, want)."""

    def __init__(self, C: np.ndarray | None = None):
        self.C = matrices.vandermonde_rs(2, 2) if C is None else C

    def matrix(self, present: list[int], want: list[int]) -> np.ndarray:
        return matrices.recover_matrix(self.C, present, want)

    def recover(self, known: dict, want: list[int], product) -> list:
        present = sorted(known)
        R = self.matrix(present, want)
        stack = _stack([known[i] for i in present[:2]], 0)
        out = product(R, stack.reshape(2, -1))
        shp = known[present[0]].shape
        return [row.reshape(shp) for row in out]


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

    # -- inner MDS over a plane -------------------------------------------
    def _mds_recover(self, U: dict, z: int, erased: set[int]) -> None:
        """decode_uncoupled (reference :742): recover U[erased][z] from the
        other nodes' U[z]."""
        n = self.q * self.t
        present = sorted(set(range(n)) - erased)[: self.k + self.nu]
        missing = sorted(erased)
        R = matrices.recover_matrix(self.mds_C, present, missing)
        out = self.engine.matmul(R, _stack([U[i][z] for i in present], 0))
        for row, i in zip(out, missing):
            U[i][z] = row

    # -- layered decode (reference decode_layered :647) --------------------
    def _decode_layered(self, erased: set[int], chunks: dict) -> None:
        q, t, m = self.q, self.t, self.m
        n = q * t
        erased = set(erased)
        for i in range(self.k + self.nu, n):
            if len(erased) >= m:
                break
            erased.add(i)
        assert len(erased) == m

        U = {i: _zeros(chunks[0].shape, chunks[0]) for i in range(n)}
        order = [0] * self.sub_chunk_no
        for z in range(self.sub_chunk_no):
            zv = self._z_vec(z)
            order[z] = sum(1 for i in erased if i % q == zv[i // q])
        max_score = max(order, default=0)

        for score in range(max_score + 1):
            planes = [z for z in range(self.sub_chunk_no) if order[z] == score]
            for z in planes:
                self._decode_erasures(erased, z, chunks, U)
            for z in planes:
                zv = self._z_vec(z)
                for node_xy in sorted(erased):
                    x, y = node_xy % q, node_xy // q
                    node_sw = y * q + zv[y]
                    if zv[y] != x:
                        if node_sw not in erased:
                            self._recover_type1(chunks, U, x, y, z, zv)
                        elif zv[y] < x:
                            self._coupled_from_uncoupled(
                                chunks, U, x, y, z, zv
                            )
                    else:
                        chunks[node_xy][z] = U[node_xy][z]

    def _decode_erasures(self, erased: set[int], z: int, chunks: dict,
                         U: dict) -> None:
        """reference decode_erasures :714: fill U for live nodes, then MDS."""
        q, t = self.q, self.t
        zv = self._z_vec(z)
        for x in range(q):
            for y in range(t):
                node_xy = q * y + x
                node_sw = q * y + zv[y]
                if node_xy in erased:
                    continue
                if zv[y] < x:
                    self._uncoupled_from_coupled(chunks, U, x, y, z, zv)
                elif zv[y] == x:
                    U[node_xy][z] = chunks[node_xy][z]
                elif node_sw in erased:
                    self._uncoupled_from_coupled(chunks, U, x, y, z, zv)
        self._mds_recover(U, z, erased)

    # the three pair operations (reference :775-871)
    def _recover_type1(self, chunks, U, x, y, z, zv):
        """erased coupled symbol from live partner + own uncoupled."""
        q = self.q
        node_xy, node_sw = y * q + x, y * q + zv[y]
        z_sw = self._z_sw(z, x, y, zv)
        c_xy, c_sw, u_xy, u_sw = self._pair_indices(x, zv[y])
        known = {c_sw: chunks[node_sw][z_sw], u_xy: U[node_xy][z]}
        (rec,) = self.pft.recover(known, [c_xy], self.engine.matmul)
        chunks[node_xy][z] = rec

    def _coupled_from_uncoupled(self, chunks, U, x, y, z, zv):
        """both coupled symbols of the pair from both uncoupled."""
        q = self.q
        node_xy, node_sw = y * q + x, y * q + zv[y]
        z_sw = self._z_sw(z, x, y, zv)
        # no index swap here (reference get_coupled_from_uncoupled asserts
        # zv[y] < x): position 0 <-> node_xy, 1 <-> node_sw
        known = {2: U[node_xy][z], 3: U[node_sw][z_sw]}
        rec0, rec1 = self.pft.recover(known, [0, 1], self.engine.matmul)
        chunks[node_xy][z] = rec0
        chunks[node_sw][z_sw] = rec1

    def _uncoupled_from_coupled(self, chunks, U, x, y, z, zv):
        """both uncoupled symbols of the pair from both coupled."""
        q = self.q
        node_xy, node_sw = y * q + x, y * q + zv[y]
        z_sw = self._z_sw(z, x, y, zv)
        c_xy, c_sw, u_xy, u_sw = self._pair_indices(x, zv[y])
        known = {c_xy: chunks[node_xy][z], c_sw: chunks[node_sw][z_sw]}
        rec_lo, rec_hi = self.pft.recover(known, [2, 3], self.engine.matmul)
        rec = {2: rec_lo, 3: rec_hi}
        U[node_xy][z] = rec[u_xy]
        U[node_sw][z_sw] = rec[u_sw]

    # -- node/chunk plumbing ----------------------------------------------
    def _node(self, i: int) -> int:
        """external chunk id -> node id of the padded grid."""
        return i if i < self.k else i + self.nu

    def _to_nodes(self, ext: dict, sc_size: int) -> dict:
        """external chunk id -> padded node grid ([sub_chunk_no, sc])."""
        like = next(iter(ext.values()))
        shape = (self.sub_chunk_no, sc_size)
        nodes = {}
        for i in range(self.k + self.m):
            nodes[self._node(i)] = (
                _copy(ext[i].reshape(shape)) if i in ext
                else _zeros(shape, like)
            )
        for i in range(self.k, self.k + self.nu):
            nodes[i] = _zeros(shape, like)
        return nodes

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
        nodes = self._to_nodes({i: data[i] for i in range(k)},
                               cs // self.sub_chunk_no)
        self._decode_layered({self._node(i) for i in range(k, k + m)},
                             nodes)
        COUNTERS["bytes_encoded"] += _numel(data)
        return _stack(
            [nodes[self._node(i)].reshape(-1) for i in range(k + m)], 0
        )

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
        nodes = self._to_nodes({i: _as_u8(c) for i, c in chunks.items()},
                               chunk_size // self.sub_chunk_no)
        self._decode_layered(erased, nodes)
        out = dict(chunks)
        for i in range(k + m):
            if i not in out:
                out[i] = nodes[self._node(i)].reshape(-1)
        COUNTERS["bytes_decoded"] += len(erased) * chunk_size
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
        out = self._repair(want_to_read, helper_chunks, chunk_size)
        COUNTERS["repair_bytes"] += len(want_to_read) * chunk_size
        fraction = COUNTERS["repair_read_fraction"]
        fraction["avgcount"] += 1
        fraction["sum"] += (sum(_numel(b) for b in helper_chunks.values())
                            / (self.k * chunk_size))
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
        plane_pos = {z: j for j, z in enumerate(repair_planes)}

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

        recovered = _zeros((self.sub_chunk_no, sc), like)
        U = {n: _zeros((self.sub_chunk_no, sc), like) for n in range(q * t)}
        erasures = {lost - lost % q + x for x in range(q)} | aloof

        # order planes by intersection score over erasures+aloof
        ordered: dict[int, list[int]] = {}
        for z in repair_planes:
            zv = self._z_vec(z)
            score = sum(
                1 for nd in ({lost} | aloof) if nd % q == zv[nd // q]
            )
            assert score > 0
            ordered.setdefault(score, []).append(z)

        for score in sorted(ordered):
            for z in ordered[score]:
                zv = self._z_vec(z)
                # phase 1: fill U for live nodes
                for y in range(t):
                    for x in range(q):
                        node_xy = y * q + x
                        if node_xy in erasures:
                            continue
                        z_sw = self._z_sw(z, x, y, zv)
                        node_sw = y * q + zv[y]
                        c_xy, c_sw, u_xy, u_sw = self._pair_indices(
                            x, zv[y]
                        )
                        if node_sw in aloof:
                            # partner coupled unknown; use partner's U
                            known = {
                                c_xy: helpers[node_xy][plane_pos[z]],
                                u_sw: U[node_sw][z_sw],
                            }
                            (rec,) = self.pft.recover(
                                known, [u_xy], self.engine.matmul
                            )
                            U[node_xy][z] = rec
                        elif zv[y] != x:
                            known = {
                                c_xy: helpers[node_xy][plane_pos[z]],
                                c_sw: helpers[node_sw][plane_pos[z_sw]],
                            }
                            rec_lo, rec_hi = self.pft.recover(
                                known, [2, 3], self.engine.matmul
                            )
                            U[node_xy][z] = {2: rec_lo, 3: rec_hi}[u_xy]
                        else:
                            U[node_xy][z] = helpers[node_xy][plane_pos[z]]
                # phase 2: MDS across the plane
                assert len(erasures) <= self.m
                self._mds_recover(U, z, erasures)
                # phase 3: recover coupled symbols of erased nodes
                for nd in sorted(erasures):
                    if nd in aloof:
                        continue
                    x, y = nd % q, nd // q
                    z_sw = self._z_sw(z, x, y, zv)
                    c_xy, c_sw, u_xy, u_sw = self._pair_indices(x, zv[y])
                    if x == zv[y]:  # hole-dot pair
                        recovered[z] = U[nd][z]
                    else:
                        assert y * q + zv[y] == lost
                        known = {
                            c_xy: helpers[nd][plane_pos[z]],
                            u_xy: U[nd][z],
                        }
                        (rec,) = self.pft.recover(
                            known, [c_sw], self.engine.matmul
                        )
                        recovered[z_sw] = rec
        return {i: recovered.reshape(-1)}

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
            COUNTERS["repair_plan_hits"] += 1
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
        COUNTERS["repair_plan_misses"] += 1
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
