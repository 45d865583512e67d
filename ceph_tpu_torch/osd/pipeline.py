"""Batched PG→OSD pipeline: every PG of a pool through the placement stack.

The port of `ceph_tpu/osd/pipeline_jax.py` (reference src/osd/OSDMap.cc:
2435-2715):

    ps ──stable_mod──► pps ──CRUSH──► raw ──upmap──► up ──►
        primary affinity ──► (up, up_primary) ──pg_temp──► (acting, acting_primary)

On the card the whole chain is one hand-written kernel
(`osd/csrc/pipeline.cu`, body `pipeline.cuh`, wrapper `pipeline_cuda`):
one launch per block of up to `crush.mapper.BLOCK` seeds, in one of three
modes (all four planes, `up` only, the raw rows), the rule run by the
rule kernel's body.  A launch smaller than the card maps each PG with a
group of G lanes that split its straw2 draws (`group_size`: G from the
launch's shape alone, 1 at the large ones).  On the CPU the same function is its plain version,
`PoolMapper.pipeline_plain`: the rule's plain version
(`crush.mapper.map_rule`) and torch ops on [N, W] rows (W = the pool's
padded width), computed as `compile_pipeline` computes it.  `_raw`, `_up`
and `_rows` dispatch on the seeds' device.  The sparse overrides
(pg_upmap, pg_upmap_items, pg_temp, primary_temp) become dense per-PG
int32 tensors, uploaded once per mapper and read at the seeds.

Results equal `OSDMap.pg_to_up_acting_osds` of the JAX package for every
PG, padded to the width with ITEM_NONE (tests/test_torch_pipeline.py; the
kernel's body built with g++: tests/test_torch_pipeline_kernel_host.py).

`PoolMapper.diagnose` runs stages 1-2 through the rule kernel's
diagnostics variant in summary mode (`crush.mapper.
crush_rule_diag_summary_cuda`): the placement seed, the walk and the
reduction to the JAX package's placement-diagnostics summary in one
launch per block, no plane written.

The mapper books the JAX package's `pipeline` perf group (`pgs_mapped`,
`map_block_seconds`: the host time of one block's enqueue) and spans
(`pipeline.map_block`, `pipeline.diagnose`, `pipeline.fetch`), and the
pipeline kernel's launch account (`pipeline_launches`, ...).  Every
lane is exact, so `unresolved_pgs` and `rescue_invocations` stay 0: the
kernel has no fast window to rescue from.
"""

from __future__ import annotations

import copy
import ctypes
import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ceph_tpu_torch import build, obs
from ceph_tpu_torch.core.intmath import pg_mask_for, stable_mod
from ceph_tpu_torch.core.lntable import LL_TBL, RH_LH_TBL, ln_tables
from ceph_tpu_torch.core.rjenkins import M32, crush_hash32_2
from ceph_tpu_torch.crush.mapper import (
    BLOCK,
    RMAX_CAP,
    LaunchPlan,
    PoolSeeds,
    compile_rule,
    crush_rule_diag_summary_cuda,
    diag_summary_plain,
    find_rule,
    kernel_weights,
    map_rule,
    staged_records,
)
from ceph_tpu_torch.crush.soa import build_arrays, to_device
from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.osd.osdmap import (
    DEFAULT_PRIMARY_AFFINITY,
    MAX_PRIMARY_AFFINITY,
    OSDMap,
)
from ceph_tpu_torch.osd.types import FLAG_HASHPSPOOL, PgId
from ceph_tpu_torch.parallel.sharded import mesh_for
from ceph_tpu_torch.runtime import faults

_L = obs.logger_for("pipeline")
_L.add_u64("pgs_mapped",
           "placement seeds mapped through the batched pipeline")
_L.add_u64("unresolved_pgs",
           "fast-window inconclusive lanes (exact-loop rescued)")
_L.add_u64("rescue_invocations", "loop-kernel rescue passes")
_L.add_quantile("map_block_seconds",
                "per-block map_block dispatch wall-time distribution "
                "(host enqueue time of the block's kernel launches and "
                "torch ops; p50/p99 in the dump)")


@dataclass(frozen=True)
class PoolSpec:
    """The per-pool parameters of the pipeline."""

    pool_id: int
    size: int
    pg_num: int
    pgp_num: int
    can_shift: bool  # replicated pools compact; EC pools are positional
    hashpspool: bool
    ruleno: int
    max_osd: int  # OSDMap::max_osd (exists/upmap id bound)
    out_width: int  # padded output width (>= size)

    @classmethod
    def for_pool(
        cls, m: OSDMap, pool_id: int, extra_width: int = 0
    ) -> "PoolSpec":
        pool = m.pools[pool_id]
        ruleno = find_rule(
            m.crush, pool.crush_rule, int(pool.type), pool.size
        )
        return cls(
            pool_id=pool_id,
            size=pool.size,
            pg_num=pool.pg_num,
            pgp_num=pool.pgp_num,
            can_shift=pool.can_shift_osds(),
            hashpspool=bool(pool.flags & FLAG_HASHPSPOOL),
            ruleno=ruleno,
            max_osd=m.max_osd,
            out_width=max(pool.size, extra_width),
        )


@dataclass
class Overlays:
    """Dense per-PG override arrays for one pool ([N = pg_num] rows).
    A pool without an override has None in its fields."""

    upmap_full: np.ndarray | None = None  # [N, Wu] i32, NONE-padded
    upmap_len: np.ndarray | None = None  # [N] i32 (0 = no entry)
    upmap_pairs: np.ndarray | None = None  # [N, P, 2] i32, NONE-padded
    temp: np.ndarray | None = None  # [N, Wt] i32, NONE-padded
    temp_len: np.ndarray | None = None  # [N] i32 (-1 = no entry)
    primary_temp: np.ndarray | None = None  # [N] i32 (-1 = none)

    @property
    def any(self) -> bool:
        return any(v is not None for v in vars(self).values())

    @property
    def extra_width(self) -> int:
        w = 0
        if self.upmap_full is not None:
            w = max(w, self.upmap_full.shape[1])
        if self.temp is not None:
            w = max(w, self.temp.shape[1])
        return w


def build_overlays(m: OSDMap, pool_id: int) -> Overlays:
    """Freeze the sparse override dicts into dense per-PG arrays."""
    pool = m.pools[pool_id]
    n = pool.pg_num
    ov = Overlays()

    full = {
        pg.seed: v
        for pg, v in m.pg_upmap.items()
        if pg.pool == pool_id and pg.seed < n
    }
    if full:
        w = max(len(v) for v in full.values())
        ov.upmap_full = np.full((n, w), ITEM_NONE, np.int32)
        ov.upmap_len = np.zeros(n, np.int32)
        for s, v in full.items():
            ov.upmap_full[s, : len(v)] = v
            ov.upmap_len[s] = len(v)

    items = {
        pg.seed: v
        for pg, v in m.pg_upmap_items.items()
        if pg.pool == pool_id and pg.seed < n
    }
    if items:
        p = max(len(v) for v in items.values())
        ov.upmap_pairs = np.full((n, p, 2), ITEM_NONE, np.int32)
        for s, v in items.items():
            for j, (frm, to) in enumerate(v):
                ov.upmap_pairs[s, j] = (frm, to)

    temps = {
        pg.seed: v
        for pg, v in m.pg_temp.items()
        if pg.pool == pool_id and pg.seed < n
    }
    if temps:
        w = max((len(v) for v in temps.values()), default=1) or 1
        ov.temp = np.full((n, w), ITEM_NONE, np.int32)
        ov.temp_len = np.full(n, -1, np.int32)
        for s, v in temps.items():
            ov.temp[s, : len(v)] = v
            ov.temp_len[s] = len(v)

    prim = {
        pg.seed: v
        for pg, v in m.primary_temp.items()
        if pg.pool == pool_id and pg.seed < n
    }
    if prim:
        ov.primary_temp = np.full(n, -1, np.int32)
        for s, v in prim.items():
            ov.primary_temp[s] = v
    return ov


def _pad_lanes(v: torch.Tensor, width: int) -> torch.Tensor:
    n = v.shape[1]
    if n >= width:
        return v[:, :width]
    pad = torch.full((v.shape[0], width - n), ITEM_NONE, dtype=v.dtype,
                     device=v.device)
    return torch.cat([v, pad], 1)


def _compact(v: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Stable left-compaction of the kept lanes of each row, NONE-padded
    (the vector `erase` loops of reference src/osd/OSDMap.cc:2416-2427,
    2516-2522).  The dropped lanes go to a spare column."""
    N, W = v.shape
    idx = keep.long().cumsum(1) - 1
    out = torch.full((N, W + 1), ITEM_NONE, dtype=v.dtype, device=v.device)
    out.scatter_(1, torch.where(keep, idx, W),
                 torch.where(keep, v, ITEM_NONE))
    return out[:, :W]


def _first_index(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first true lane of each row, or the width if none."""
    col = torch.arange(mask.shape[1], device=mask.device)
    return torch.where(mask, col, mask.shape[1]).amin(1)


def _pick(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return v.gather(1, i.clamp(0, v.shape[1] - 1)[:, None])[:, 0]


def first_not_none(v: torch.Tensor) -> torch.Tensor:
    """_pick_primary (reference src/osd/OSDMap.cc:2455-2463)."""
    i = _first_index(v != ITEM_NONE)
    return torch.where(i < v.shape[1], _pick(v, i), -1)


# -- the kernel ---------------------------------------------------------------

MODES = {"rows": 0, "up": 1, "raw": 2}  # pipeline.cuh MODE_*


class _Pipe(ctypes.Structure):
    """pipeline.cuh Pipe: the pool's operands of one launch."""

    _fields_ = (
        [("ps", ctypes.c_void_p), ("n", ctypes.c_longlong)]
        + [(k, ctypes.c_void_p) for k in (
            "exists", "up", "weight", "affinity", "upmap_full", "upmap_len",
            "upmap_pairs", "temp", "temp_len", "primary_temp", "up_out",
            "up_primary_out", "acting_out", "acting_primary_out")]
        + [(k, ctypes.c_uint32) for k in ("pool_id", "pgp_num",
                                          "pgp_mask")]
        + [(k, ctypes.c_int32) for k in (
            "hashpspool", "can_shift", "has_rule", "with_affinity", "mode",
            "max_osd", "width", "wu", "n_pairs", "wt")])


def _pipeline_work(shape) -> tuple[int, int]:
    """(bytes, 0) of one launch of shape (T, prog, n, dv, mode, width,
    overlay words a PG): each input read once (seeds, the overlays at the
    seeds, the four per-OSD vectors, the map's tables, the rule's steps,
    the crush_ln tables), each output written once.  The operations are
    not reckoned."""
    T, prog, n, dv, mode, width, ov_words = shape
    tables = sum(t.numel() * t.element_size() for t in (
        T.headers, T.records, T.packed_items, T.nodes))
    steps = prog.steps.nbytes if prog is not None else 0
    out = 4 * n * (2 * width + 2 if mode == "rows" else width)
    return (8 * n + 4 * n * ov_words + 18 * dv + tables + steps
            + RH_LH_TBL.nbytes + LL_TBL.nbytes + out), 0


# the kernel's launches, enqueue times and first-call build, booked into
# the kernel registry, which the `pipeline` perf group reads
_ACCT = obs.LaunchAccount(_L, "pipeline", "osd/csrc/pipeline.cu",
                          work=_pipeline_work)
_LIB: list[ctypes.CDLL] = []
_LIB_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    """The kernel's library, loaded and declared once; published only
    once its signatures are set."""
    if _LIB:
        return _LIB[0]
    with _LIB_LOCK:
        if _LIB:
            return _LIB[0]
        lib = _ACCT.load(lambda: build.load("osd/csrc/pipeline.cu"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pipeline_launch.argtypes = [p] * 8 + [i] * 13 + [p, p]
        lib.pipeline_launch.restype = i
        lib.pipeline_plan.argtypes = [i, p]
        lib.pipeline_plan.restype = i
        lib.pipeline_group.argtypes = [ctypes.c_longlong, i, p]
        lib.pipeline_group.restype = i
        lib.pipeline_error_string.argtypes = [i]
        lib.pipeline_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
        return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().pipeline_error_string(rc).decode()
        raise RuntimeError(f"pipeline {what} failed: {msg}")


GROUPS = (1, 2, 4, 8, 16, 32)  # the kernel's instantiations (pipeline.cu)


@functools.cache
def launch_plan(device_index: int, group: int = 1) -> LaunchPlan:
    """The LaunchPlan (crush.mapper.LaunchPlan, from this build's
    registers) on one card of the kernel that maps a PG with `group`
    lanes; group 1's is every launch's block size."""
    if group not in GROUPS:
        raise ValueError(f"pipeline: group {group} not in {GROUPS}")
    out = (ctypes.c_int * 10)()
    with torch.cuda.device(device_index):
        _check(_lib().pipeline_plan(group, ctypes.addressof(out)), "plan")
    return LaunchPlan(*out)


def group_size(n: int, device_index: int | None = None) -> int:
    """The lanes a launch of n PGs on the card maps each PG with: the
    largest power of two G <= 32 with n * G <= the resident lanes of
    `launch_plan(device_index)` (the launch itself computes it in the same
    C function, from its shape alone)."""
    if device_index is None:
        device_index = torch.cuda.current_device()
    plan = launch_plan(device_index)
    out = ctypes.c_int()
    with torch.cuda.device(device_index):
        _check(_lib().pipeline_group(n, plan.threads, ctypes.addressof(out)),
               "group")
    return out.value


@functools.cache
def _ln_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return ln_tables(device)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def pipeline_cuda(pm: "PoolMapper", ps: torch.Tensor, mode: str = "rows",
                  stage: int | None = None) -> tuple:
    """Launch the pipeline kernel once: placement seeds ps int64 [N] on
    the mapper's card -> int32 tensors, (up [N, W], up_primary [N],
    acting [N, W], acting_primary [N]) for mode "rows", (up,) for "up"
    (no overlay read) and (raw,) for "raw" (the rows before the
    overlays), W = pm.spec.out_width; each PG mapped by `group_size(N)`
    lanes.  Runs on the current stream, unsynchronised.  With overlays in
    mode "rows" the seeds must lie in [0, pg_num) (`PoolMapper._seeds`
    checks the caller's).  `stage` is
    the number of records each block copies to shared memory (None:
    `staged_records` of this kernel's plan; every choice gives the same
    rows).  `pipeline_cuda.launches` counts the launches: the kernel's
    count in the kernel registry (`_pipeline_work` reckons their bytes)."""
    if mode not in MODES:
        raise ValueError(f"pipeline_cuda: mode {mode!r} not in "
                         f"{sorted(MODES)}")
    spec, T, prog, vec = pm.spec, pm.tables, pm.prog, pm.dev
    dev = T.device
    if dev.type != "cuda" or ps.device != dev:
        raise ValueError(f"pipeline_cuda: map on {dev}, seeds on "
                         f"{ps.device}; both must be on one CUDA device")
    if ps.dtype != torch.int64 or ps.dim() != 1 or not ps.is_contiguous():
        raise ValueError("pipeline_cuda: contiguous int64 seeds [N] "
                         "expected")
    dtypes = {"exists": torch.bool, "up": torch.bool,
              "weight": torch.int64, "primary_affinity": torch.int64}
    dv = vec["weight"].numel()
    for k, dt in dtypes.items():
        t = vec[k]
        if t.device != dev or t.dtype != dt or t.dim() != 1 \
                or t.numel() != dv or not t.is_contiguous():
            raise ValueError(f"pipeline_cuda: per-OSD vector {k!r} must "
                             f"be a contiguous {dt} [{dv}] on {dev}")
    if dv < max(spec.max_osd, T.max_devices, 1):
        raise ValueError(f"pipeline_cuda: per-OSD vectors of {dv} do not "
                         f"cover max_osd {spec.max_osd} and the map's "
                         f"{T.max_devices} devices")
    W = spec.out_width
    if not spec.size <= W <= RMAX_CAP:
        raise ValueError(f"pipeline_cuda: width {W} outside [{spec.size}, "
                         f"{RMAX_CAP}], the kernel's rows")
    ov = pm._ov if mode == "rows" else {}
    for k, t in ov.items():
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"pipeline_cuda: overlay {k!r} must be a "
                             f"contiguous int32 tensor on {dev}")
    out = _outputs(ps.numel(), W, mode, dev)
    if ps.numel() == 0:
        return out
    rh_lh, ll = _ln_on(dev)
    if T.records.data_ptr() % 16 or rh_lh.data_ptr() % 16 \
            or ll.data_ptr() % 16:
        raise ValueError("pipeline_cuda: records and crush_ln tables must "
                         "be 16-byte aligned")
    plan = launch_plan(dev.index if dev.index is not None
                       else torch.cuda.current_device())
    n_staged = staged_records(T, plan) if stage is None else stage
    if not 0 <= n_staged <= T.records.shape[0]:
        raise ValueError(f"pipeline_cuda: stage {n_staged} outside "
                         f"[0, {T.records.shape[0]}]")
    args, pipe, shape = launch_operands(pm, ps, mode, out, n_staged,
                                        plan.threads, rh_lh, ll)
    with torch.cuda.device(dev):
        rc = _ACCT.launch(_lib().pipeline_launch, *args,
                          ctypes.addressof(pipe),
                          torch.cuda.current_stream().cuda_stream,
                          shape=shape)
        _check(rc, "kernel launch")
    return out


def _outputs(n: int, width: int, mode: str, device) -> tuple:
    """The int32 outputs of a launch in `mode`, uninitialised."""
    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)
    if mode == "rows":
        return empty(n, width), empty(n), empty(n, width), empty(n)
    return (empty(n, width),)


def launch_operands(pm: "PoolMapper", ps: torch.Tensor, mode: str,
                    out: tuple, n_staged: int, threads: int,
                    rh_lh: torch.Tensor, ll: torch.Tensor):
    """What `pipeline_launch` takes for seeds ps of mapper pm, checked by
    the caller: (the rule's arguments, as crush_rule_launch's, through
    `threads`; the pool's `_Pipe`; the launch's shape for
    `_pipeline_work`).  The host build of the kernel's body
    (tests/test_torch_pipeline_kernel_host.py) takes the same."""
    spec, T, prog, vec = pm.spec, pm.tables, pm.prog, pm.dev
    ov = pm._ov if mode == "rows" else {}
    full, pairs, temp = (ov.get(k) for k in ("upmap_full", "upmap_pairs",
                                              "temp"))
    rows = mode == "rows"
    pipe = _Pipe(
        ps=ps.data_ptr(), n=ps.numel(), exists=_ptr(vec["exists"]),
        up=_ptr(vec["up"]), weight=_ptr(vec["weight"]),
        affinity=_ptr(vec["primary_affinity"]), upmap_full=_ptr(full),
        upmap_len=_ptr(ov.get("upmap_len")), upmap_pairs=_ptr(pairs),
        temp=_ptr(temp), temp_len=_ptr(ov.get("temp_len")),
        primary_temp=_ptr(ov.get("primary_temp")),
        up_out=out[0].data_ptr(),
        up_primary_out=_ptr(out[1]) if rows else None,
        acting_out=_ptr(out[2]) if rows else None,
        acting_primary_out=_ptr(out[3]) if rows else None,
        pool_id=spec.pool_id & M32, pgp_num=spec.pgp_num,
        pgp_mask=pg_mask_for(spec.pgp_num), hashpspool=spec.hashpspool,
        can_shift=spec.can_shift, has_rule=prog is not None,
        with_affinity=pm.with_primary_affinity, mode=MODES[mode],
        max_osd=spec.max_osd, width=spec.out_width,
        wu=full.shape[1] if full is not None else 0,
        n_pairs=pairs.shape[1] if pairs is not None else 0,
        wt=temp.shape[1] if temp is not None else 0)
    dv = vec["weight"].numel()
    tunables = ((prog.choose_total_tries, prog.chooseleaf_descend_once,
                 prog.chooseleaf_vary_r, prog.chooseleaf_stable)
                if prog is not None else (0, 0, 0, 0))
    args = [
        T.headers.data_ptr(), T.records.data_ptr(),
        T.packed_items.data_ptr(), T.nodes.data_ptr(),
        vec["weight"].data_ptr(), rh_lh.data_ptr(), ll.data_ptr(),
        _ptr(prog.steps_on(ps.device) if prog is not None else None),
        T.n_buckets, T.positions, T.max_devices, T.max_depth,
        min(T.max_devices, dv),
        len(prog.steps) if prog is not None else 0, spec.size, *tunables,
        n_staged, threads]
    ov_words = sum(t[0].numel() for t in ov.values() if t.numel())
    return args, pipe, (T, prog, ps.numel(), dv, mode, spec.out_width,
                        ov_words)


pipeline_cuda = _ACCT.entry(pipeline_cuda)


class PoolMapper:
    """Batched mapper for one pool of one OSDMap, on one device.

    Usage:
        pm = PoolMapper(osdmap, pool_id)            # on the card
        up, up_primary, acting, acting_primary = pm.map_all()

    `device=None` means the card (`device.resolve_device`): without one
    the constructor raises, unless the caller passes device="cpu", which
    runs the rule's plain version.  The map's CRUSH arrays, the per-OSD
    vectors and the overlays are uploaded once here; `refresh_dev`
    re-reads the per-OSD vectors after the map's OSD state changes.
    With `overlays=False` no overlay is frozen or uploaded: the mapper
    maps the map as if it had none (the balancer's and `map_all_device`'s
    form; callers scatter in `overlay_fixup_rows`).

    `state` (an `osd.state.ClusterState` of `m`) makes the mapper the
    state's: it runs on the state's device, takes the state's tables of
    its choose_args group and reads the state's per-OSD vectors, and
    uploads nothing of its own; `refresh_dev` rebinds the vectors.  It
    always runs the primary-affinity stage (on an all-default vector it
    changes nothing), so a first affinity delta is an operand update.

    `mesh` (a `parallel.sharded.Mesh`; default: the state's) splits every
    mapping launch over the mesh's devices: each maps its contiguous
    block of the seeds (one rule-kernel launch per block) with its own
    copy of the operands, and the rows are gathered onto the mapper's
    device, the mesh's first.  This is the only code that splits a
    launch; the rows equal the unsplit mapper's.
    """

    def __init__(self, m: OSDMap, pool_id: int, device=None,
                 overlays: bool = True, state=None, mesh=None):
        self._state = state
        if state is not None:
            self.device = state.device
            self.mesh = mesh if mesh is not None else state.mesh
        else:
            self.device, self.mesh = mesh_for(device, mesh, default=False)
        self.m = m
        self.pool_id = pool_id
        if state is not None:
            self.arrays = state.arrays_for(pool_id)
        else:
            ca = m.crush.choose_args.get(pool_id,
                                         m.crush.choose_args.get(-1))
            self.arrays = build_arrays(m.crush, ca)
        self.ov = build_overlays(m, pool_id) if overlays else Overlays()
        self.spec = PoolSpec.for_pool(
            m, pool_id, extra_width=self.ov.extra_width
        )
        self.prog = (compile_rule(self.arrays, self.spec.ruleno,
                                  self.spec.size)
                     if self.spec.ruleno >= 0 else None)
        self.tables = (state.device_tables_for(pool_id)
                       if state is not None
                       else to_device(self.arrays, self.device))
        self._ov = {k: torch.from_numpy(v).to(self.device)
                    for k, v in vars(self.ov).items() if v is not None}
        self.with_primary_affinity = (m.osd_primary_affinity is not None
                                      or state is not None)
        self.refresh_dev()

    def refresh_dev(self) -> None:
        """(Re)upload the padded per-OSD vectors from the map's current
        osd state, weight and primary affinity; a state's mapper rebinds
        the state's vectors instead."""
        if self._state is not None:
            self.dev = self._state.vectors
            return
        dv = self.m.frozen_vectors()
        DV = max(self.arrays.max_devices, self.m.max_osd, 1)

        def put(v, fill, dtype):
            v = np.asarray(v)[:DV]
            v = np.concatenate([v, np.full(DV - len(v), fill, v.dtype)])
            return torch.from_numpy(v).to(dtype).to(self.device)

        self.dev = {
            "exists": put(dv["exists"], False, torch.bool),
            "up": put(dv["up"], False, torch.bool),
            "weight": put(dv["weight"].astype(np.int64), 0, torch.long),
            "primary_affinity": put(
                dv["primary_affinity"].astype(np.int64),
                DEFAULT_PRIMARY_AFFINITY, torch.long),
        }

    def _seeds(self, ps) -> torch.Tensor:
        ps = torch.as_tensor(np.asarray(ps, np.int64)).to(self.device)
        if self.ov.any and ps.numel() and not (
                0 <= int(ps.min()) and int(ps.max()) < self.spec.pg_num):
            raise ValueError(f"placement seeds outside [0, "
                             f"{self.spec.pg_num}) with overlays")
        return ps

    def _osd_ok(self, v: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
        """valid OSDMap id with tbl true (exists()/is_up() lookups)."""
        return ((v >= 0) & (v < self.spec.max_osd)
                & tbl[v.clamp(0, tbl.numel() - 1)])

    def placement_seeds(self, ps: torch.Tensor) -> torch.Tensor:
        """Stage 1: the seeds fed to CRUSH, u32 values in int64
        (reference src/osd/osd_types.cc:1798-1814)."""
        spec = self.spec
        ps2 = stable_mod(ps.long() & M32, spec.pgp_num,
                         pg_mask_for(spec.pgp_num))
        pid = spec.pool_id & M32
        if spec.hashpspool:
            return crush_hash32_2(ps2, pid)
        return (ps2 + pid) & M32

    def pool_seeds(self) -> PoolSeeds:
        """Stage 1's inputs, for a kernel that computes the placement seed
        in the PG's lane."""
        spec = self.spec
        return PoolSeeds(spec.pool_id, spec.pgp_num,
                         pg_mask_for(spec.pgp_num), spec.hashpspool)

    def rule_weights(self) -> torch.Tensor:
        """The OSD reweights the rule reads (the first max_devices)."""
        return self.dev["weight"][:self.arrays.max_devices]

    def _pipeline(self, ps: torch.Tensor, mode: str) -> tuple:
        """The pipeline for seeds ps in one of `MODES`: on the card one
        `pipeline_cuda` launch per block of up to BLOCK seeds, int32; on
        the CPU its plain version."""
        if ps.device.type == "cuda":
            ps = ps.contiguous()
            blocks = [pipeline_cuda(self, ps[i:i + BLOCK], mode)
                      for i in range(0, max(ps.numel(), 1), BLOCK)]
            if len(blocks) == 1:
                return blocks[0]
            return tuple(torch.cat(p) for p in zip(*blocks))
        return self.pipeline_plain(ps, mode)

    def pipeline_plain(self, ps: torch.Tensor, mode: str = "rows") -> tuple:
        """The kernel's plain version, on any device: the rule's rows
        (`map_rule`; on the card the rule kernel) and the torch-op chain,
        int64 tensors, in the tuple `pipeline_cuda` gives for `mode`."""
        if mode == "raw":
            return (self._raw_plain(ps)[1],)
        if mode == "up":
            return self._up_plain(ps, {})[:1]
        if mode == "rows":
            return self._rows_plain(ps)
        raise ValueError(f"mode {mode!r} not in {sorted(MODES)}")

    def _raw(self, ps: torch.Tensor) -> torch.Tensor:
        """Stages 1-2 and _remove_nonexistent_osds: raw [N, W]."""
        return self._pipeline(ps, "raw")[0]

    def _up(self, ps: torch.Tensor) -> torch.Tensor:
        """Stages 1-5 without the overlays: up [N, W]."""
        return self._pipeline(ps, "up")[0]

    def _rows(self, ps: torch.Tensor) -> tuple:
        """(up, up_primary, acting, acting_primary) for seeds ps."""
        return self._pipeline(ps, "rows")

    def _raw_plain(self, ps: torch.Tensor):
        """Stages 1-2 and _remove_nonexistent_osds: (pps, raw [N, W])."""
        W = self.spec.out_width
        pps = self.placement_seeds(ps)
        # -- stage 2: CRUSH (reference src/osd/OSDMap.cc:2444-2447)
        if self.prog is None:
            raw = torch.full((ps.numel(), W), ITEM_NONE, dtype=torch.long,
                             device=ps.device)
        else:
            raw = _pad_lanes(map_rule(self.tables, self.prog, pps,
                                      self.rule_weights()).long(), W)
        # -- _remove_nonexistent_osds (reference src/osd/OSDMap.cc:2412)
        ok = self._osd_ok(raw, self.dev["exists"])
        if self.spec.can_shift:
            raw = _compact(raw, ok)
        else:
            raw = torch.where(ok | (raw == ITEM_NONE), raw, ITEM_NONE)
        return pps, raw

    def _up_plain(self, ps: torch.Tensor, ov: dict):
        """Stages 1-5: (up, up_primary) tensors for seeds ps, with the
        upmap overlays of `ov` (the mapper's dense overlays at ps)."""
        spec = self.spec
        W = spec.out_width
        lane = torch.arange(W, device=ps.device)
        weight = self.dev["weight"]
        upb = self.dev["up"]
        pps, raw = self._raw_plain(ps)

        # -- stage 3: upmap (reference src/osd/OSDMap.cc:2465-2509)
        def marked_out(v):
            """the reject guard: valid id AND weight 0 (OSDMap.cc:2472,2496)."""
            return ((v != ITEM_NONE) & (v >= 0) & (v < spec.max_osd)
                    & (weight[v.clamp(0, weight.numel() - 1)] == 0))

        # a pg_upmap entry with an out target aborts the whole _apply_upmap
        # (the early `return` at reference src/osd/OSDMap.cc:2474), skipping
        # pg_upmap_items as well
        aborted = torch.zeros_like(ps, dtype=torch.bool)
        if "upmap_full" in ov:
            row, rl = ov["upmap_full"], ov["upmap_len"]
            lane_u = torch.arange(row.shape[1], device=ps.device)
            bad = (marked_out(row) & (lane_u < rl[:, None])).any(1)
            aborted = (rl > 0) & bad
            ok = (rl > 0) & ~bad
            repl = torch.where(lane < rl[:, None], _pad_lanes(row, W),
                               ITEM_NONE)
            raw = torch.where(ok[:, None], repl, raw)
        if "upmap_pairs" in ov:
            pairs = ov["upmap_pairs"]
            for j in range(pairs.shape[1]):
                frm, to = pairs[:, j, 0], pairs[:, j, 1]
                present = (raw == to[:, None]).any(1)
                match = (raw == frm[:, None]) & ~marked_out(to)[:, None]
                pos = _first_index(match)
                do = (frm != ITEM_NONE) & ~present & (pos < W) & ~aborted
                raw = torch.where(do[:, None] & (lane == pos[:, None]),
                                  to[:, None], raw)

        # -- stage 4: raw → up (reference src/osd/OSDMap.cc:2512-2535)
        alive = self._osd_ok(raw, upb)
        if spec.can_shift:
            up = _compact(raw, alive)
        else:
            up = torch.where(alive, raw, ITEM_NONE)
        up_primary = first_not_none(up)

        # -- stage 5: primary affinity (reference src/osd/OSDMap.cc:2537)
        if self.with_primary_affinity:
            aff = self.dev["primary_affinity"]
            nonnone = up != ITEM_NONE
            a = aff[up.clamp(0, aff.numel() - 1)]
            gate = (nonnone & (a != DEFAULT_PRIMARY_AFFINITY)).any(1)
            h = crush_hash32_2(pps[:, None], up) >> 16
            accepted = nonnone & ~((a < MAX_PRIMARY_AFFINITY) & (h >= a))
            first_acc = _first_index(accepted)
            first_any = _first_index(nonnone)
            pos = torch.where(first_acc < W, first_acc,
                              torch.where(first_any < W, first_any, -1))
            do = gate & (pos >= 0)
            new_primary = torch.where(do, _pick(up, pos), up_primary)
            if spec.can_shift:
                prev = torch.cat([up[:, :1], up[:, :-1]], 1)
                shifted = torch.where((lane > 0) & (lane <= pos[:, None]),
                                      prev, up)
                shifted[:, 0] = new_primary
                up = torch.where((do & (pos > 0))[:, None], shifted, up)
            up_primary = new_primary
        return up, up_primary

    def _rows_plain(self, ps: torch.Tensor):
        """(up, up_primary, acting, acting_primary) tensors for seeds ps."""
        spec = self.spec
        W = spec.out_width
        lane = torch.arange(W, device=ps.device)
        upb = self.dev["up"]
        ov = {k: v[ps].long() for k, v in self._ov.items()}
        up, up_primary = self._up_plain(ps, ov)

        # -- pg_temp / primary_temp (reference src/osd/OSDMap.cc:2592)
        acting, acting_primary = up, up_primary
        pt = ov.get("primary_temp")
        if pt is None:
            pt = torch.full_like(up_primary, -1)
        if "temp" in ov:
            trow = _pad_lanes(ov["temp"], W)
            tlen = ov["temp_len"]
            in_row = lane < tlen[:, None]
            t_alive = self._osd_ok(trow, upb) & in_row
            if spec.can_shift:
                filt = _compact(trow, t_alive)
                t_n = t_alive.sum(1)
            else:
                filt = torch.where(t_alive, trow, ITEM_NONE)
                t_n = tlen.clamp(min=0)
            t_primary = torch.where(pt >= 0, pt, first_not_none(filt))
            use_temp = (tlen >= 0) & (t_n > 0)
            acting = torch.where(use_temp[:, None], filt, up)
            acting_primary = torch.where(
                use_temp, t_primary, torch.where(pt >= 0, pt, up_primary))
        else:
            acting_primary = torch.where(pt >= 0, pt, up_primary)
        return up, up_primary, acting, acting_primary

    def _replica(self, device: torch.device) -> "PoolMapper":
        """This mapper with its operands (tables, per-OSD vectors,
        overlays) copied to another device of its mesh."""
        r = copy.copy(self)
        r.device = device
        r.tables = to_device(self.arrays, device)
        r.dev = {k: v.to(device) for k, v in self.dev.items()}
        r._ov = {k: v.to(device) for k, v in self._ov.items()}
        return r

    def mesh_blocks(self, fn, ps: torch.Tensor) -> list:
        """fn(mapper, block) for each contiguous block of the seeds ps
        on its mesh device: [(offset, fn's tuple of tensors)], left on
        the block's device.  Without a mesh, one block on this mapper."""
        if self.mesh is None or self.mesh.size == 1:
            return [(0, tuple(fn(self, ps)))]
        out = []
        off = 0
        for dev, blk in zip(self.mesh.devices,
                            torch.tensor_split(ps, self.mesh.size)):
            n = blk.numel()
            if n:
                pm = self if dev == self.device else self._replica(dev)
                out.append((off, tuple(fn(pm, blk.to(dev)))))
            off += n
        return out

    def _on_mesh(self, fn, ps: torch.Tensor) -> tuple:
        """`mesh_blocks` gathered onto this mapper's device."""
        parts = self.mesh_blocks(fn, ps)
        if len(parts) == 1:
            return parts[0][1]
        return tuple(torch.cat([p[j].to(self.device) for _, p in parts])
                     for j in range(len(parts[0][1])))

    def _map_block(self, ps: torch.Tensor, **span_args):
        """_rows(ps) as one accounted block (dispatch only: no host
        sync inside the span)."""
        n = ps.numel()
        faults.check("map_batch")
        try:
            with obs.span("pipeline.map_block", pgs=n, **span_args), \
                    _L.time("map_block_seconds"):
                out = tuple(t.to(torch.int32) for t in
                            self._on_mesh(lambda pm, b: pm._rows(b), ps))
        except Exception as e:
            # a transport loss surfaces as DeviceLostError, the shape
            # its callers degrade on (the `map_batch` point injects it)
            if faults.looks_like_device_loss(e) and \
                    not isinstance(e, faults.DeviceLostError):
                raise faults.DeviceLostError(
                    f"{type(e).__name__}: {e}"[:200]) from e
            raise
        _L.inc("pgs_mapped", n)
        return out

    def map_batch(self, ps):
        """Map a batch of placement seeds.  Returns numpy int32
        (up[N,W], up_primary[N], acting[N,W], acting_primary[N])."""
        return obs.timed_fetch(_L, "result", self._map_block(self._seeds(ps)))

    def map_all(self):
        """`map_batch` of every PG of the pool."""
        return tuple(t.cpu().numpy() for t in self.map_all_tensors())

    def map_all_tensors(self):
        """(up, up_primary, acting, acting_primary) of every PG of the
        pool, int32 tensors left on the mapper's device."""
        ps = torch.arange(self.spec.pg_num, device=self.device)
        return self._map_block(ps, device_resident=True)

    def map_all_device(self) -> torch.Tensor:
        """`up` rows [pg_num, W] of every PG of the pool, as an int32
        tensor left on the mapper's device, without the overlays: a
        mapper that froze some raises (build it with overlays=False;
        callers scatter in `overlay_fixup_rows`, as the JAX package's
        callers do)."""
        if self.ov.any:
            raise ValueError("map_all_device is an overlay-free path: "
                             "build the PoolMapper with overlays=False")
        ps = torch.arange(self.spec.pg_num, device=self.device)
        with obs.span("pipeline.map_block", pgs=ps.numel(),
                      device_resident=True), _L.time("map_block_seconds"):
            up = self._on_mesh(lambda pm, b: (pm._up(b),),
                               ps)[0].to(torch.int32)
        _L.inc("pgs_mapped", ps.numel())
        return up

    def raw_rows(self, seeds) -> np.ndarray:
        """The rows before the overlays, [K, out_width] int32 numpy:
        equal to `OSDMap._pg_to_raw_osds` (descent + nonexistent-OSD
        removal), NONE-padded."""
        ps = self._seeds(seeds)
        with obs.span("pipeline.map_block", pgs=ps.numel(), raw=True):
            raw = self._on_mesh(lambda pm, b: (pm._raw(b),),
                                ps)[0].to(torch.int32)
        with obs.span("pipeline.fetch"):
            return raw.cpu().numpy()

    def diagnose(self, ps=None, source: str | None = None,
                 record: bool = True) -> dict:
        """Run the rule's diagnostics over the placement seeds of `ps`
        (default: every PG) into the JAX package's placement-diagnostics
        summary: the per-placement retry histogram (the reference
        collect_choose_tries shape), collision / out-of-weight-rejection /
        skip tallies, the bad mappings (CRUSH rows shorter than the pool
        size) and the placements that ran out of retries.  On the card,
        one summary-mode launch of the diagnostics kernel per block of up
        to BLOCK PGs (`crush_rule_diag_summary_cuda`: the placement seed
        and the reductions in the launch, no rows or planes) and one read
        of the bound + 6 counters; on the CPU, its plain version
        (`diag_summary_plain` on `placement_seeds`).  Every lane is
        exact: `diag_exact` is True and `unresolved` 0.

        The summary lands in `obs.placement` (source `source`, default
        "pool<id>") with this mapper's explainer unless record=False."""
        from ceph_tpu_torch.obs import placement

        PL = obs.logger_for("placement")

        if ps is not None:
            ps = self._seeds(ps)
        n = self.spec.pg_num if ps is None else ps.numel()
        prog = self.prog
        bound = min(prog.diag_tries_bound if prog else 0,
                    len(placement.TRIES_BOUNDS) - 1)
        total = torch.zeros(bound + 6, dtype=torch.long, device=self.device)
        if prog is not None:
            for i in range(0, n, BLOCK):
                with obs.span("pipeline.diagnose",
                              pgs=min(BLOCK, n - i)), \
                        PL.time("diagnose_seconds"):
                    # every PG: a range, which reads no seed tensor
                    total += self._diag_block(
                        range(i, min(i + BLOCK, n)) if ps is None
                        else ps[i:i + BLOCK], bound)
        else:  # no rule: every PG trivially bad, nothing decided
            total[bound + 4] = n
        with obs.span("pipeline.fetch"):
            got = total.cpu().tolist()
        hist_v = got[:bound + 1]
        coll, rej, skip, bad, exhausted = got[bound + 1:]
        summary = {
            "pgs": n,
            "pool_id": self.pool_id,
            "tries_histogram": hist_v,
            "tries_bound": bound,
            "diag_exact": True,
            "diag_lanes": prog.diag_lanes if prog else 0,
            "collisions": coll,
            "rejections": rej,
            "skips": skip,
            "bad_mappings": bad,
            "retry_exhausted": exhausted,
            "unresolved": 0,
        }
        if record:
            placement.record(source or f"pool{self.pool_id}", summary)
            placement.register_explainer(f"pool{self.pool_id}",
                                         self._explain_seed)
        return summary

    def _diag_block(self, ps, bound: int) -> torch.Tensor:
        """One block's diagnostics summary, int64 [bound + 6]: on the
        card one summary-mode launch on the PG seeds ps (a tensor, or a
        range), on the CPU the plain version on their placement seeds."""
        if self.device.type == "cuda":
            return crush_rule_diag_summary_cuda(
                self.tables, self.prog, ps,
                kernel_weights(self.rule_weights()), bound,
                self.pool_seeds())
        if isinstance(ps, range):
            ps = torch.arange(ps.start, ps.stop, device=self.device)
        return diag_summary_plain(self.tables, self.prog,
                                  self.placement_seeds(ps),
                                  self.rule_weights(), bound)

    def _explain_seed(self, seed: int) -> dict:
        """Host-oracle replay of one placement seed of this pool (the
        `placement.explain("<pool>.<seed>")` payload)."""
        from ceph_tpu_torch.crush.explain import explain_pool_pg

        return explain_pool_pg(self.m, self.pool_id, seed)


def overlay_fixup_rows(m: OSDMap, pool_id: int, width: int):
    """Host-exact `up` rows for the PGs of `pool_id` that carry a
    pg_upmap / pg_upmap_items entry: (seeds int64[K], rows int32[K,
    width]), both empty when the pool has none.  The overlay-free paths
    (`map_all_device` of a mapper built with overlays=False, and the
    balancer's membership builds) scatter these few rows of the host
    pipeline in, equal to what the overlay stages compute."""
    n = m.pools[pool_id].pg_num
    seeds = sorted({
        pg.seed for pg in list(m.pg_upmap) + list(m.pg_upmap_items)
        if pg.pool == pool_id and pg.seed < n
    })
    rows = np.full((len(seeds), width), ITEM_NONE, np.int32)
    for i, s in enumerate(seeds):
        up, _, _, _ = m.pg_to_up_acting_osds(PgId(pool_id, s))
        rows[i, : min(len(up), width)] = up[:width]
    return np.asarray(seeds, np.int64), rows


def map_cluster(m: OSDMap, device=None) -> dict[int, tuple]:
    """Map every pool; returns {pool_id: (up, up_primary, acting,
    acting_primary)}, the batched equivalent of the osdmaptool
    --test-map-pgs loop (reference src/tools/osdmaptool.cc:630-755)."""
    return {pid: PoolMapper(m, pid, device=device).map_all()
            for pid in sorted(m.pools)}
