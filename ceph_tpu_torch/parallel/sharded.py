"""PG-axis data parallelism over a list of torch devices.

The port of `ceph_tpu/parallel/sharded.py`.  The reference scales batch
placement by sharding pgid ranges over a thread pool (ParallelPGMapper,
reference src/osd/OSDMapMapping.h:18-140) and merges per-shard results.
The JAX package commits the PG axis of the pipeline's inputs to a
`jax.sharding.Mesh` and lets GSPMD partition the one compiled program.
Here a `Mesh` is a tuple of torch devices plus an axis name, and
`osd.pipeline.PoolMapper(mesh=...)` is the one place that splits a
launch: each device maps its contiguous block of the PG axis (one
rule-kernel launch per block) and the rows are gathered onto the mesh's
first device.

- `make_mesh(n)`: a mesh over the first n devices of the acquired
  backend (`torch.cuda.device_count()` cards; the host is one device),
  with requested-vs-actual provenance (`last_mesh_provenance()`): a mesh
  that came up smaller than asked can never pose as a scaling run.
- `default_mesh()`: the `CEPH_TPU_MESH_DEVICES` knob routed through
  `make_mesh`; every consumer (`osd.state.ClusterState`, the balancer's
  `DeviceState`, mgr eval, the lifetime engine, the serving buffer)
  resolves its device and mesh here (`mesh_for`).
- A mesh may repeat a device (`Mesh(["cuda:0"] * 4)`, `Mesh(["cpu"] *
  8)`): the port's stand-in for XLA's forced host devices, so the
  split-block equivalence is testable on one device.

`ShardedClusterMapper` maps and reduces through the PoolMapper's own
pipeline (B.14): per-block histograms (`core.reduce.osd_histogram`) on
each block's device, summed on the first device (the psum), and the
crush-compat rebalance step as float32 torch ops in the JAX order of
operations (`rebalance_update`).
"""

from __future__ import annotations

import copy

import torch

from ceph_tpu_torch import obs
from ceph_tpu_torch.core import reduce
from ceph_tpu_torch.utils import knobs

PG_AXIS = "pg"

_PL = obs.logger_for("pipeline")

# requested-vs-actual record of the LAST make_mesh call: a degraded mesh
# (fewer devices than asked) is visible in every record built on it
_MESH_PROV: dict = {}

# default_mesh() cache, keyed by the knob's current value so tests that
# monkeypatch the env observe the change
_DEFAULT_MESH: dict = {}


class Mesh:
    """A 1-D device mesh: the devices the PG axis splits over, in order,
    and the axis name.  `devices[0]` is where results are gathered."""

    def __init__(self, devices, axis: str = PG_AXIS):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis,)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis_names[0]!r})")


def available_devices() -> list[torch.device]:
    """The acquired backend's devices: every visible card, or the host
    as one device when the ladder descended to `cpu`."""
    from ceph_tpu_torch.utils import ensure_backend

    if ensure_backend() == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(n_devices: int | None = None, axis: str = PG_AXIS,
              allow_fewer: bool = False) -> Mesh:
    """1-D mesh over the first n devices of the acquired backend; the PG
    axis splits over it.

    The backend comes through the runtime ladder (`ensure_backend`), so
    its provenance is in `runtime.last_provenance()`.  allow_fewer:
    degrade to however many devices exist instead of raising.  Either
    way `last_mesh_provenance()` records requested vs actual."""
    from ceph_tpu_torch import runtime
    from ceph_tpu_torch.utils import ensure_backend

    backend = ensure_backend()
    devs = available_devices()
    requested = n_devices
    if n_devices is None:
        n_devices = len(devs)
    if len(devs) < n_devices:
        if not allow_fewer:
            raise RuntimeError(
                f"need {n_devices} devices, have {len(devs)} "
                "(a Mesh of a repeated device splits one device)")
        n_devices = len(devs)
    prov = runtime.last_provenance() or {}
    _MESH_PROV.clear()
    _MESH_PROV.update({
        "backend": backend,
        "requested": requested,
        "actual": n_devices,
        "available": len(devs),
        "degraded": requested is not None and n_devices != requested,
        "fallback_reason": prov.get("fallback_reason"),
    })
    obs.instant("sharded.make_mesh", backend=backend,
                requested=requested, devices=n_devices,
                fallback_reason=prov.get("fallback_reason"))
    return Mesh(devs[:n_devices], axis)


def last_mesh_provenance() -> dict:
    """Requested-vs-actual record of the most recent make_mesh call
    (empty before the first one)."""
    return dict(_MESH_PROV)


def default_mesh(axis: str = PG_AXIS) -> Mesh | None:
    """The process-wide production mesh: CEPH_TPU_MESH_DEVICES routed
    through make_mesh (None when the knob is unset or <= 1: one device,
    the default).  Degrades to the available device count with
    provenance instead of raising; `last_mesh_provenance()["degraded"]`
    says when that happened."""
    val = knobs.get("CEPH_TPU_MESH_DEVICES")
    if not val:
        return None
    try:
        n = int(val)
    except ValueError:
        # a mis-typed knob degrades to one device, visibly
        _MESH_PROV.clear()
        _MESH_PROV.update({"requested": val, "actual": 1,
                           "degraded": True,
                           "fallback_reason": "unparseable knob"})
        obs.instant("sharded.make_mesh", requested=val, devices=1,
                    fallback_reason="unparseable knob")
        return None
    if n <= 1:
        return None
    key = (val, axis)
    mesh = _DEFAULT_MESH.get(key)
    if mesh is None:
        mesh = _DEFAULT_MESH[key] = make_mesh(n, axis, allow_fewer=True)
    return mesh


def mesh_for(device=None, mesh: Mesh | None = None, default: bool = True):
    """A consumer's (device, mesh), by the one rule every `mesh=`
    consumer follows.  The device is `device`, else the mesh's first
    device, resolved (`device.resolve_device`: None is the acquired
    card).  The mesh is `mesh`, else, with `default`, `default_mesh()`
    when the device is a card: a consumer asked onto the host is never
    split over the cards, and asking for the host reads no mesh knob
    and touches no card."""
    from ceph_tpu_torch.device import resolve_device

    if device is None and mesh is not None:
        device = mesh.devices[0]
    device = resolve_device(device)
    if mesh is None and default and device.type == "cuda":
        dm = default_mesh()
        if dm is not None and dm.devices[0].type == "cuda":
            mesh = dm
    return device, mesh


def rebalance_update(hist: torch.Tensor, weight: torch.Tensor,
                     target_w: torch.Tensor, pg_num: int, size: int):
    """One crush-compat rebalance step from a per-OSD histogram (the
    JAX `step`, reference src/osd/OSDMap.cc:4707-4732 and
    pybind/mgr/balancer/module.py:1031): the weight-proportional target
    of the fixed crush weights, the stddev of the deviation, and the
    16.16 adjustment weights times target/hist clipped to [0.5, 2], in
    float32.  Returns (new_weight int64, stddev float32 scalar).

    The weight total is summed exactly in int64 and rounded to float32
    once, so the card and the host give the same target: JAX's float32
    sum is exact wherever its partial sums stay below 2^24."""
    tw = target_w.to(torch.float32)
    tsum = target_w.to(torch.int64).sum().to(torch.float32)
    target = (pg_num * size) * tw / torch.clamp(tsum, min=1.0)
    w = weight.to(torch.float32)
    dev_f = hist.to(torch.float32) - target
    n_in = torch.clamp((target_w > 0).sum(), min=1)
    stddev = torch.sqrt(torch.sum(dev_f * dev_f) / n_in)
    ratio = target / torch.clamp(hist.to(torch.float32), min=1.0)
    ratio = torch.clamp(ratio, 0.5, 2.0)
    new_w = torch.where((w > 0) & (target > 0),
                        torch.clamp(w * ratio, min=1.0), w)
    return new_w.to(torch.int64), stddev


class ShardedClusterMapper:
    """Batched pool mapping + cluster stats over a device mesh, through
    the production pipeline (`PoolMapper(mesh=...)`: one rule-kernel
    launch per block), with only the histogram and weight reductions
    here.

    Usage:
        mesh = make_mesh()
        scm = ShardedClusterMapper(osdmap, pool_id, mesh)
        out = scm.map_stats()          # mapping + per-OSD histograms
        st  = scm.rebalance_step(w)    # one on-device balancer iteration
    """

    def __init__(self, m, pool_id: int, mesh: Mesh):
        from ceph_tpu_torch.osd.pipeline import PoolMapper

        self.mesh = mesh
        self.pm = PoolMapper(m, pool_id, overlays=False, mesh=mesh,
                             device=mesh.devices[0])
        self.n_dev_total = mesh.size
        self.DV = int(self.pm.dev["weight"].shape[0])
        self.pg_num = self.pm.spec.pg_num
        # pad the PG axis to a multiple of the mesh size (cycle-pad: pad
        # lanes repeat early seeds and are masked out of the stats)
        n = self.n_dev_total
        self.pg_padded = ((self.pg_num + n - 1) // n) * n
        # crush-weight target pinned at construction (rebalance_step)
        self._target_w = self.pm.dev["weight"].clone()

    def _ps(self) -> torch.Tensor:
        return torch.arange(self.pg_padded,
                            device=self.mesh.devices[0]) % self.pg_num

    def _map_blocks(self, pm):
        """Every PG's four planes, block by block on the mesh's devices:
        [(offset, (up, up_primary, acting, acting_primary))]."""
        with obs.span("pipeline.map_block", pgs=self.pg_num,
                      sharded=self.n_dev_total):
            parts = pm.mesh_blocks(
                lambda p, b: [t.to(torch.int32) for t in p._rows(b)],
                self._ps())
        _PL.inc("pgs_mapped", self.pg_num)
        return parts

    def _live(self, off: int, n: int, device) -> torch.Tensor:
        return ((off + torch.arange(n, device=device))
                < self.pg_num)[:, None]

    def _hist_sum(self, parts, plane: int, lane=None) -> torch.Tensor:
        """Per-block histograms of one plane on each block's device,
        summed on the first device (the psum)."""
        dev0 = self.mesh.devices[0]
        total = torch.zeros(self.DV, dtype=torch.int32, device=dev0)
        for off, rows in parts:
            ids = rows[plane]
            if ids.dim() == 1:
                ids = ids[:, None]
            elif lane is not None:
                ids = ids[:, lane]
            h = reduce.osd_histogram(
                ids, self.DV, self._live(off, ids.shape[0], ids.device))
            total += h.to(dev0)
        return total

    def _gather(self, parts, plane: int) -> torch.Tensor:
        dev0 = self.mesh.devices[0]
        return torch.cat([rows[plane].to(dev0) for _, rows in parts])

    # -- sharded mapping + stats ------------------------------------------
    def map_stats(self) -> dict:
        """Map all PGs; returns the per-PG planes (pg_padded rows,
        gathered on the first device) and the per-OSD histograms
        (count / primary / first)."""
        parts = self._map_blocks(self.pm)
        return {
            "up": self._gather(parts, 0),
            "up_primary": self._gather(parts, 1),
            "acting": self._gather(parts, 2),
            "acting_primary": self._gather(parts, 3),
            "pgs_per_osd": self._hist_sum(parts, 2),
            "primary_per_osd": self._hist_sum(parts, 3),
            "first_per_osd": self._hist_sum(parts, 2, lane=slice(0, 1)),
        }

    # -- one balancer iteration, on the device ----------------------------
    def rebalance_step(self, weights=None):
        """One balancer iteration: map -> histogram -> deviation ->
        weight update.  `weights` are the adjustment weights to map with
        (default: the map's current in-weights); the deviation target
        always comes from the weights captured at construction.
        Returns (new_weight int64[DV], stddev, pgs_per_osd)."""
        pm = self.pm
        if weights is not None:
            pm = copy.copy(self.pm)
            pm.dev = dict(self.pm.dev, weight=torch.as_tensor(
                weights).to(torch.int64).to(self.mesh.devices[0]))
        parts = self._map_blocks(pm)
        hist = self._hist_sum(parts, 2)
        new_w, stddev = rebalance_update(
            hist, pm.dev["weight"], self._target_w, self.pg_num,
            self.pm.spec.size)
        return new_w, stddev, hist
